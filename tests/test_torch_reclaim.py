"""The port's handoff leases and spot-reclaim plane against the JAX
package's, on the CPU.

- Leases (``engine/kv_manager.py``): for the same operation sequence
  (allocate, register, attach, grant, release, confirm, reap on an
  injected clock), the same refcounts, free list, parked LRU,
  ``ledger_check()`` and audit counts as the JAX ``KvPageManager``;
  the counterpart of
  ``test_prefix_sharing.py::test_manager_refcounted_eviction_and_lease_pins``.
- Planning (``runtime/reclaim.py``): ``plan_triage``,
  ``nearest_survivor``, ``survivors_from_instances`` and
  ``migration_lease_ttl_s`` give the JAX functions' results on
  hypothesis-drawn inputs (floats compared exactly).
- Reclaim on engines (two float32 TINY ``TorchEngine``s, the real TCP
  KV plane, the controller's clock injected and frozen, so no deadline
  depends on the host's speed): a migrated stream and its journal
  continuation on the survivor are token-identical to an uninterrupted
  run across sampling modes, the continuation attaches the transplanted
  prefix; a grace under the margin falls back to the journal;
  ``reclaim_extract`` keeps its lease until confirmed, and an extract
  lease nobody confirms is reaped on the manager's (injected) clock.
  The counterparts of ``test_reclaim.py``'s engine cases.
"""

import asyncio
import time
from dataclasses import replace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu.engine.kv_manager import KvPageManager as JKvPageManager
from dynamo_exp_tpu.parallel.multihost import TopologyCoordinate as JTopo
from dynamo_exp_tpu.runtime import reclaim as jreclaim
from dynamo_exp_tpu.runtime.transports.base import EndpointAddress as JAddress
from dynamo_exp_tpu.runtime.transports.base import InstanceInfo as JInstanceInfo
from dynamo_exp_tpu_torch.disagg.transfer import KvPageReceiver
from dynamo_exp_tpu_torch.engine import EngineConfig, KvPageManager, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.parallel.multihost import TOPOLOGY_KEY, TopologyCoordinate
from dynamo_exp_tpu_torch.runtime import reclaim
from dynamo_exp_tpu_torch.runtime.transports.base import EndpointAddress, InstanceInfo
from dynamo_exp_tpu_torch.telemetry import get_telemetry
from dynamo_exp_tpu_torch.telemetry.fleet import parse_prometheus_text
from dynamo_exp_tpu_torch.tokens import compute_block_hashes_for_seq

PS = 8


# ------------------------------------------------------------------ leases
class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def manager_state(kv) -> dict:
    return {
        "refs": [kv.page_ref(p) for p in range(kv.num_pages)],
        "free": list(kv._free),
        "parked": list(kv._reclaimable),
        "ledger": kv.ledger_check(),
        "leases": kv.active_leases,
        "reclaimed": kv.lease_reclaimed_pages,
        "free_pages": kv.free_pages,
    }


def audit_counts(kv, holders) -> dict:
    a = kv.audit(holders)
    return {k: a[k] for k in ("ok", "counts", "leases", "held_pages", "ref_total")}


@pytest.mark.parametrize("seed", range(8))
def test_lease_operations_match_the_jax_manager(seed):
    rs = np.random.RandomState(seed)
    ct, cj = Clock(), Clock()
    t, j = KvPageManager(12, PS, clock=ct), JKvPageManager(12, PS, clock=cj)
    held: dict[int, int] = {}  # our references by page
    leases: list[tuple[str, str]] = []  # (port id, JAX id)
    reaped: list[int] = []
    chain = compute_block_hashes_for_seq(list(range(1, 12 * PS + 1)), PS)
    registered = 0
    for _ in range(150):
        op = rs.randint(7)
        if op == 0:  # a fresh page
            a, b = t.allocate_page(), j.allocate_page()
            assert a == b
            if a is not None:
                held[a] = held.get(a, 0) + 1
        elif op == 1 and held:  # register a held page under the next block
            pid = int(rs.choice(sorted(held)))
            if t.page_hash(pid) is None and registered < len(chain):
                parent = chain[registered - 1] if registered else None
                t.register_full_page(pid, chain[registered], parent_hash=parent)
                j.register_full_page(pid, chain[registered], parent_hash=parent)
                registered += 1
        elif op == 2 and held:  # grant a lease on some held pages
            pids = [int(p) for p in rs.choice(sorted(held), size=rs.randint(1, 3))]
            ttl = float(rs.choice([0.5, 2.0, 30.0]))
            leases.append((t.grant_lease(pids, ttl), j.grant_lease(pids, ttl)))
        elif op == 3 and held:  # release one of our references
            pid = int(rs.choice(sorted(held)))
            t.release_sequence([pid])
            j.release_sequence([pid])
            held[pid] -= 1
            if not held[pid]:
                del held[pid]
        elif op == 4 and leases:  # confirm (possibly a reaped one: a no-op)
            lt, lj = leases[rs.randint(len(leases))]
            assert t.confirm_lease(lt) == j.confirm_lease(lj)
        elif op == 5:  # time passes, the reaper runs
            dt = float(rs.choice([0.1, 0.6, 3.0]))
            ct.t += dt
            cj.t += dt
            n = t.reap_expired()
            assert n == j.reap_expired()
            assert [p for _, p in t.last_reaped] == [p for _, p in j.last_reaped]
            reaped.append(n)
        elif op == 6:  # re-attach a resident registered block
            resident = [h for h in chain[:registered] if t.resident_page(h) is not None]
            if resident:
                h = resident[rs.randint(len(resident))]
                pid = t.resident_page(h)
                assert pid == j.resident_page(h)
                t.attach_page(pid)
                j.attach_page(pid)
                held[pid] = held.get(pid, 0) + 1
        assert manager_state(t) == manager_state(j)
        holders = {f"seq:{p}": [p] * n for p, n in held.items()}
        assert audit_counts(t, holders) == audit_counts(j, holders)
        assert t.ledger_check() == []
    assert sum(reaped) == t.lease_reclaimed_pages


def test_leased_page_survives_eviction_until_confirmed():
    """The counterpart of ``test_manager_refcounted_eviction_and_lease_pins``
    on the port's manager: a page pinned by a lease leaves the device
    tier only once the lease is confirmed."""
    kv = KvPageManager(num_pages=4, page_size=4)
    hashes = compute_block_hashes_for_seq([1, 2, 3, 4], 4)
    a = kv.allocate_sequence([1, 2, 3, 4], max_pages=8)
    kv.register_full_page(a.page_ids[0], hashes[0])
    b = kv.allocate_sequence([1, 2, 3, 4, 9], max_pages=8)
    assert b.page_ids[0] == a.page_ids[0]
    lease = kv.grant_lease(a.page_ids[:1], ttl_s=60.0)
    kv.release_sequence(a.page_ids)
    kv.release_sequence(b.page_ids)
    assert kv.allocate_page() is not None
    assert kv.allocate_page() is not None
    assert kv.allocate_page() is not None
    assert kv.allocate_page() is None  # only the leased page remains
    assert kv.resident_page(hashes[0]) == a.page_ids[0]
    assert kv.audit({})["counts"]["leased"] == 1 and kv.ledger_check() == []
    assert kv.confirm_lease(lease) and not kv.confirm_lease(lease)
    assert kv.allocate_page() is not None  # now evictable


# ---------------------------------------------------------------- planning
TOPOS = st.one_of(st.none(), st.tuples(st.integers(0, 1), st.integers(0, 1),
                                       st.integers(0, 1)))
SNAPS = st.lists(st.tuples(st.integers(0, 2), st.integers(0, 40)), max_size=8)
SURVS = st.lists(st.tuples(st.sampled_from(["s-a", "s-b", "s-c"]), TOPOS,
                           st.sampled_from([1e6, 1e7, 1e8, None])), max_size=4)


def _topo(mod, t):
    return None if t is None else mod(*t)


def _plan_key(plan):
    return [(d.seq.request_id, d.action, d.dest.instance if d.dest else None, d.est_s, d.eta_s)
            for d in plan]


@settings(max_examples=150, deadline=None)
@given(SNAPS, SURVS, st.sampled_from([0.2, 1.0, 2.5, 10.0]), st.sampled_from([0.0, 0.5, 1.0]),
       TOPOS)
def test_triage_planning_matches_jax(snaps, survs, grace, margin, origin):
    page = 2 * 1024 * 1024
    bws = {name: bw for name, _, bw in survs}

    def est(src, dst, n):
        bw = bws.get(dst)
        return None if bw is None else n / bw

    plans = []
    for mod, topo in ((reclaim, TopologyCoordinate), (jreclaim, JTopo)):
        seqs = [mod.SequenceSnapshot(f"r{i}", priority=p, full_pages=n, kv_bytes=n * page)
                for i, (p, n) in enumerate(snaps)]
        survivors = [mod.SurvivorInfo(name, i, topology=_topo(topo, tp), migrate_addr=f"h:{i}")
                     for i, (name, tp, _) in enumerate(survs)]
        plans.append(_plan_key(mod.plan_triage(
            seqs, survivors, grace, origin="dying", est_fn=est,
            origin_topo=_topo(topo, origin), margin_s=margin)))
        nearest = mod.nearest_survivor("dying", _topo(topo, origin), survivors, 3 * page, est)
        plans.append((nearest[0].instance if nearest[0] else None, nearest[1]))
        plans.append(mod.migration_lease_ttl_s(0.25, grace, margin))
    assert plans[:3] == plans[3:]


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 6), st.sampled_from(["", "0/0/1", "1/2", "x/y"]),
                          st.booleans(), st.booleans(), st.booleans()), max_size=6),
       st.integers(1, 6))
def test_survivors_from_instances_matches_jax(rows, self_id):
    outs = []
    for info_t, addr_t, mod in ((InstanceInfo, EndpointAddress, reclaim),
                                (JInstanceInfo, JAddress, jreclaim)):
        infos = []
        for iid, topo, draining, reclaiming, migrate in rows:
            md = {"instance": f"host:{iid}", TOPOLOGY_KEY: topo}
            if draining:
                md["draining"] = True
            if reclaiming:
                md["reclaiming"] = True
            if migrate:
                md["migrate_addr"] = f"127.0.0.1:{9000 + iid}"
            infos.append(info_t(addr_t("ns", "worker", "generate"), iid, metadata=md))
        outs.append([(s.instance, s.instance_id, s.topology.encode() if s.topology else None,
                      s.migrate_addr)
                     for s in mod.survivors_from_instances(infos, self_id)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("raw", ["", "2", "1/3", "0/0/1", " 4/5/6 ", "x/y", "1//2", None])
def test_topology_coordinate_matches_jax(raw, monkeypatch):
    t, j = TopologyCoordinate.parse(raw), JTopo.parse(raw)
    assert (t and t.encode()) == (j and j.encode())
    if t is not None:
        for other in ("0/0/0", "0/0/1", "0/1/0", "1/0/0"):
            assert t.distance(TopologyCoordinate.parse(other)) == j.distance(JTopo.parse(other))
    monkeypatch.setenv("DYN_TOPOLOGY", raw or "")
    assert TopologyCoordinate.from_env().encode() == JTopo.from_env().encode()


# ----------------------------------------------------------------- engines
CFG = replace(TINY, dtype="float32")


def make_engine(**kw) -> TorchEngine:
    cfg = EngineConfig(model=CFG, max_decode_slots=4, page_size=PS, num_pages=64,
                       max_model_len=128, eos_token_ids=[], kv_dtype="float32",
                       decode_window=4, kv_lease_ttl_s=0.25, **kw)
    return TorchEngine(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def engines():
    """A (the spot instance), its consume slowed so a stream stays in
    flight through the triage, and B (the survivor): the same seeded
    weights, so B's uninterrupted runs are the oracles."""
    a, b = make_engine(), make_engine()
    consume = a._consume_windowed

    def slow(pending):
        time.sleep(0.05)
        return consume(pending)

    a._consume_windowed = slow
    yield a, b
    a.stop()
    b.stop()


def request(prompt, n, resume_offset=None, **sampling) -> dict:
    body = {"token_ids": list(prompt), "stop_conditions": {"max_tokens": n, "ignore_eos": True}}
    if resume_offset is not None:
        body["resume_offset"] = resume_offset
    if sampling:
        body["sampling_options"] = sampling
    return body


async def run_engine(eng, prompt, n, request_id=None, resume_offset=None, **sampling):
    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext

    ctx = AsyncEngineContext(request_id) if request_id else None
    stream = await eng.generate(request(prompt, n, resume_offset, **sampling), ctx)
    return [t async for item in stream for t in (item.get("token_ids") or [])]


async def wait_inflight(eng, request_id, min_pages):
    """Until the stream is active with ``min_pages`` complete pages (a
    condition, not a time: the stream outlasts it by construction)."""
    while True:
        for snap in await eng.reclaim_inflight():
            if snap["request_id"] == request_id and snap["full_pages"] >= min_pages:
                return snap
        await asyncio.sleep(0.002)


async def migrate_inflight(eng_a, eng_b, prompt, n, rid, grace_s=10.0, margin_s=0.05,
                           survivors=None, **sampling):
    """A stream on A, live-migrated to B mid-flight over TCP by a
    controller whose clock is frozen; A finishes it. Returns (tokens,
    summary, sink)."""
    receiver = KvPageReceiver()
    await receiver.start()
    sink = reclaim.MigrationSink(eng_b, receiver)

    async def survivors_fn():
        return survivors or [reclaim.SurvivorInfo(
            "eng-b", 2, topology=TopologyCoordinate(0, 0, 1), migrate_addr=receiver.address)]

    ctl = reclaim.ReclaimController(
        eng_a, instance="eng-a", topology=TopologyCoordinate(0, 0, 0), margin_s=margin_s,
        survivors_fn=survivors_fn, est_fn=lambda src, dst, nb: nb / 1e9, clock=lambda: 0.0)
    task = asyncio.ensure_future(run_engine(eng_a, prompt, n, request_id=rid, **sampling))
    try:
        await wait_inflight(eng_a, rid, min_pages=2)
        summary = await ctl.run(grace_s=grace_s)
        tokens = await asyncio.wait_for(task, 120)
        await sink.drain()
    finally:
        task.cancel()
        sink.close()
        await receiver.close()
    return tokens, summary, sink


def shared_hits(eng) -> int:
    return eng.metrics()["kv_prefix_hits"]["shared"]


@pytest.mark.parametrize("so", [
    {},  # greedy
    dict(temperature=0.9, top_p=0.9, seed=12345),  # seeded sampling
    dict(presence_penalty=5.0),  # penalty counts across the splice
], ids=["greedy", "seeded", "penalized"])
def test_migrated_stream_token_identical_across_sampling_modes(engines, so):
    eng_a, eng_b = engines
    prompt = [7, 3, 19, 28, 41, 13]
    n, k = 48, 24
    rid = "mig-" + ("-".join(sorted(so)) or "plain")

    def fresh_b():
        with eng_b.hold_admission():
            eng_b.reset_prefix_cache()

    async def scenario():
        fresh_b()
        tokens, summary, sink = await migrate_inflight(eng_a, eng_b, prompt, n, rid, **so)
        before = shared_hits(eng_b)
        cont = await run_engine(eng_b, prompt + tokens[:k], n - k,
                                resume_offset=k if "presence_penalty" in so else None, **so)
        hits = shared_hits(eng_b) - before
        fresh_b()
        oracle = await run_engine(eng_b, prompt, n, **so)
        return oracle, tokens, summary, sink, hits, cont

    oracle, tokens, summary, sink, hits, cont = asyncio.run(asyncio.wait_for(scenario(), 300))
    assert tokens == oracle  # the stream the migration read from, undisturbed
    assert summary["migrated"] == 1 and summary["deadline_degraded"] == 0
    assert summary["migrated_pages"] >= 2 and sink.seeded_blocks == summary["migrated_pages"]
    # The continuation (prompt + confirmed tokens) attaches the
    # transplanted prefix and goes on as the uninterrupted run.
    assert hits >= 2
    if "presence_penalty" in so:
        # The splice token is drawn by the prefill from the raw
        # distribution (the JAX engine's caveat); every later draw sees
        # the rebuilt counts.
        assert cont[1:] == oracle[k + 1:]
    else:
        assert cont == oracle[k:]


def test_too_short_grace_falls_back_to_the_journal(engines):
    eng_a, eng_b = engines
    prompt = [2, 4, 8, 16, 32, 64]
    n, k = 48, 16
    dead = [reclaim.SurvivorInfo("eng-b", 2, migrate_addr="127.0.0.1:1")]  # never dialled

    async def scenario():
        tokens, summary, _ = await migrate_inflight(
            eng_a, eng_b, prompt, n, "mig-short-grace", grace_s=0.2, margin_s=1.0,
            survivors=dead)
        oracle = await run_engine(eng_b, prompt, n)
        cont = await run_engine(eng_b, prompt + oracle[:k], n - k)
        return tokens, summary, oracle, cont

    tokens, summary, oracle, cont = asyncio.run(asyncio.wait_for(scenario(), 300))
    assert summary["planned"] >= 1 and summary["migrated"] == 0
    assert summary["failover"] == summary["planned"]
    assert tokens == oracle and cont == oracle[k:]


def test_reclaim_extract_keeps_its_lease_until_confirmed(engines):
    eng_a, _ = engines
    prompt = [9, 1, 9, 2, 9, 3]
    rid = "mig-lease"

    async def scenario():
        oracle = await run_engine(eng_a, prompt, 48)
        task = asyncio.ensure_future(run_engine(eng_a, prompt, 48, request_id=rid))
        await wait_inflight(eng_a, rid, min_pages=1)
        res = await eng_a.reclaim_extract(rid, ttl_s=30.0)
        assert res is not None
        hashes, pages, lease_id = res
        assert len(hashes) == len(pages) >= 1
        active = eng_a.metrics()["kv_leases_active"]
        assert active >= 1
        await asyncio.wait_for(task, 120)  # the stream finished: the lease still pins
        assert eng_a.metrics()["kv_leases_active"] == active
        eng_a.confirm_kv_lease(lease_id)
        while eng_a.metrics()["kv_leases_active"] >= active:
            await asyncio.sleep(0.005)
        # Unknown request: None, not an exception.
        assert await eng_a.reclaim_extract("no-such-request", 1.0) is None
        return pages, hashes, oracle

    pages, hashes, oracle = asyncio.run(asyncio.wait_for(scenario(), 300))
    # The block hashes are those of the stream's own tokens.
    assert hashes == compute_block_hashes_for_seq(prompt + oracle, PS)[: len(hashes)]
    assert tuple(pages[0][0].shape) == (CFG.num_layers, PS, CFG.num_kv_heads * CFG.head_dim_)
    with eng_a.hold_admission():
        audit = eng_a.kv_audit()
    assert audit["ok"] and audit["leases"] == 0, audit


def test_unconfirmed_extract_lease_is_reaped_on_the_manager_clock():
    """A prefill worker's extract whose receiver never confirms: its
    pinned pages come back once the lease's TTL passes on the manager's
    clock (advanced here by hand), counted on
    ``dynamo_kv_lease_reclaims_total`` and in the flight ring."""
    eng = make_engine()
    clock = Clock()
    eng.kv.clock = clock
    tel = get_telemetry()
    prompt = [int(t) for t in np.random.RandomState(4).randint(3, 200, size=3 * PS + 2)]

    def reclaims() -> float:
        return parse_prometheus_text(tel.render().decode()).get(
            "dynamo_kv_lease_reclaims_total", 0.0)

    async def scenario():
        free0 = eng.kv.free_pages
        first, pages, lease_id = await eng.prefill_extract(request(prompt, 8))
        assert len(pages) == 4 and lease_id
        before = reclaims()
        assert eng.kv.active_leases == 1 and eng.kv.free_pages == free0 - 4
        clock.t += 0.1  # within the TTL (0.25 s): nothing is reaped
        await asyncio.sleep(0.1)
        assert eng.kv.active_leases == 1
        clock.t += 0.2
        eng._wake.set()
        while eng.kv.active_leases:
            await asyncio.sleep(0.005)
        return free0, before

    try:
        free0, before = asyncio.run(asyncio.wait_for(scenario(), 120))
        assert reclaims() - before == 4
        assert eng.kv.lease_reclaimed_pages == 4 and eng.kv.free_pages == free0
        kinds = [e["kind"] for e in eng.flight.snapshot()]
        assert kinds.count("lease_grant") == 1 and kinds.count("lease_reap") == 1
        with eng.hold_admission():
            assert eng.kv_audit()["ok"]
    finally:
        eng.stop()


async def test_a_second_reclaim_notice_waits_for_the_first_triage():
    """An operator's ``llmctl reclaim`` notice, then the platform's
    SIGTERM (a second notice): the second returns only once the first's
    triage has run, the triage runs once, and the watch task that
    started it dying does not cut it short."""
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime

    drt = DistributedRuntime.detached()
    try:
        async def handler(req, ctx):
            yield {"ok": True}

        served = await drt.namespace("ns").component("w").endpoint("gen").serve_endpoint(handler)
        runs, gate = [], asyncio.Event()

        async def on_reclaim(grace_s):
            runs.append(grace_s)
            await gate.wait()
            runs.append("done")

        served.on_reclaim = on_reclaim
        first = asyncio.ensure_future(served.reclaim(7.0))
        await asyncio.sleep(0.05)
        second = asyncio.ensure_future(served.reclaim(3.0))
        await asyncio.sleep(0.05)
        assert served.is_reclaiming and runs == [7.0] and not second.done()
        first.cancel()
        await asyncio.sleep(0.05)
        assert not second.done()
        gate.set()
        await asyncio.wait_for(second, 5)
        assert runs == [7.0, "done"]
        await asyncio.wait_for(served.reclaim(1.0), 5)  # a third: already done
        assert runs == [7.0, "done"]
    finally:
        await drt.close()
