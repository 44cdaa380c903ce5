"""The port's G3 persistent KV tier (``kv/persistent.py``) against the
JAX package's, mirroring 18 of ``tests/test_kv_persist.py``'s 19 cases
(the nineteenth, the sim restart drill, waits for ``sim/``).

- Store units: the same operations on both stores give the same
  answers, counters and ledger, and leave byte-identical directories
  (page files, manifest, quarantine).
- Cross-package adoption: a directory the JAX store wrote is adopted by
  the port's with equal bytes, and one the port wrote by the JAX store.
- The engine: ``TorchEngine`` at TINY widths, float32 (the G3 round
  trip is bit-exact), hard-killed and rebooted over its store, with the
  persist hit and token identity (greedy, held to ``TPUEngine`` on the
  same weights, and seeded); the stop() drain; seeded storage faults
  (bit flip, torn write, ENOSPC, slow reads, a missing directory)
  contained token-identically.

Tolerances: none; every comparison is exact (bytes, counters, tokens).
"""

import asyncio
import os
import time
import zlib
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.kv import persistent as jpersist
from dynamo_exp_tpu.runtime.transports import chaos as jchaos
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.kv import persistent as tpersist
from dynamo_exp_tpu_torch.kv.persistent import _HEADER, PersistentKvStore
from dynamo_exp_tpu_torch.models import TINY, params_from_jax
from dynamo_exp_tpu_torch.protocols.common import BackendInput
from dynamo_exp_tpu_torch.runtime.transports.chaos import StorageChaos

PS = 8
SHAPE = (2, 4, 8)
TCFG = replace(TINY, dtype="float32")


# ------------------------------------------------------------- store units
class Both:
    """The JAX store and the port's, driven in lockstep over sibling
    directories; every call returns both answers."""

    def __init__(self, root, cap=8, chaos=None):
        self.root = root
        self.j = jpersist.PersistentKvStore(
            str(root / "jax"), cap, SHAPE, np.float32,
            chaos=None if chaos is None else chaos(jchaos.StorageChaos))
        self.t = tpersist.PersistentKvStore(
            str(root / "torch"), cap, SHAPE, torch.float32,
            chaos=None if chaos is None else chaos(StorageChaos))

    def store(self, h, i):
        a = self.j.store(h, *_np_page(i))
        b = self.t.store(h, *_page(i))
        assert a == b, (h, a, b)
        return b

    def fetch(self, h):
        a, b = self.j.fetch(h), self.t.fetch(h)
        assert (a is None) == (b is None), h
        if b is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y.numpy())
        return b

    def match_chain(self, hashes):
        a, b = self.j.match_chain(hashes), self.t.match_chain(hashes)
        assert a == b
        return b

    def boot_scan(self):
        a, b = self.j.boot_scan(), self.t.boot_scan()
        assert a == b
        return b

    def same(self):
        """Equal ledgers, equal counters, byte-identical directories."""
        assert self.j.ledger() == self.t.ledger()
        assert self.j.chaos is None or self.j.chaos.injected == self.t.chaos.injected
        assert _tree(self.root / "jax") == _tree(self.root / "torch")

    def close(self):
        self.j.close()
        self.t.close()


def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _np_page(i):
    return np.full(SHAPE, float(i), np.float32), np.full(SHAPE, float(-i), np.float32)


def _page(i):
    k, v = _np_page(i)
    return torch.from_numpy(k), torch.from_numpy(v)


def _tear(path):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])


def test_store_roundtrip_refresh_and_lru_eviction(tmp_path):
    st = Both(tmp_path, cap=2)
    assert st.store(1, 1) and st.store(2, 2)
    k, v = st.fetch(1)
    assert torch.equal(k, _page(1)[0]) and torch.equal(v, _page(1)[1])
    assert st.store(1, 1)  # a refresh, never a duplicate
    assert st.t.refreshes == 1 and st.t.stores == 2
    assert st.store(3, 3)  # evicts the coldest: hash 2
    assert st.t.evictions == 1
    assert st.fetch(2) is None and st.t.misses == 1
    assert 2 not in st.t and 1 in st.t and 3 in st.t
    assert st.t.ledger_check() == []
    st.same()
    st.close()


def test_match_chain_is_contiguous_prefix_only(tmp_path):
    st = Both(tmp_path)
    for h in (10, 11, 13):
        st.store(h, h)
    assert st.match_chain([10, 11, 12, 13]) == [10, 11]
    assert st.match_chain([12, 13]) == []
    assert st.match_chain([]) == []
    st.same()
    st.close()


def test_boot_scan_adopts_survivors_and_quarantines_torn_tail(tmp_path):
    st = Both(tmp_path)
    for h in (1, 2, 3):
        st.store(h, h)
    st.close()
    for side in ("jax", "torch"):
        _tear(tmp_path / side / f"{2:016x}.kv")
    st2 = Both(tmp_path)
    assert st2.boot_scan() == 2
    assert st2.t.torn_pages == 1 and st2.t.adopted == 2
    assert (tmp_path / "torch" / "quarantine" / f"{2:016x}.kv").exists()
    assert st2.match_chain([1, 2, 3]) == [1]
    assert torch.equal(st2.fetch(1)[0], _page(1)[0])
    assert st2.t.ledger_check() == []
    st2.same()
    st2.close()


def test_boot_scan_sweeps_tmp_orphans(tmp_path):
    st = Both(tmp_path)
    st.store(1, 1)
    st.close()
    for side in ("jax", "torch"):
        with open(tmp_path / side / f"{9:016x}.kv.tmp", "wb") as f:
            f.write(b"half a page")
    st2 = Both(tmp_path)
    assert st2.boot_scan() == 1
    assert not (tmp_path / "torch" / f"{9:016x}.kv.tmp").exists()
    assert 9 not in st2.t
    st2.same()
    st2.close()


def test_boot_scan_tolerates_torn_manifest_tail(tmp_path):
    st = Both(tmp_path)
    for h in (1, 2):
        st.store(h, h)
    st.close()
    for side in ("jax", "torch"):
        with open(tmp_path / side / "manifest.jsonl", "a") as f:
            f.write('{"op": "put", "ha')
    st2 = Both(tmp_path)
    assert st2.boot_scan() == 2
    assert st2.t.manifest_torn == 1
    assert st2.match_chain([1, 2]) == [1, 2]
    st2.same()
    st2.close()


def test_bitflip_fetch_quarantines_and_bars_readmission(tmp_path):
    st = Both(tmp_path, chaos=lambda cls: cls(7).bitflip_read(times=1))
    st.store(5, 5)
    assert st.fetch(5) is None
    assert st.t.checksum_failures == 1 and st.t.quarantined == 1 and st.t.misses == 1
    assert st.t.chaos.injected == ["store_read:bitflip"]
    assert os.listdir(tmp_path / "torch" / "quarantine") == [f"{5:016x}.kv"]
    assert not st.store(5, 5)
    assert st.match_chain([5]) == [] and st.fetch(5) is None
    assert st.t.ledger_check() == []
    st.same()
    st.close()
    st2 = Both(tmp_path)
    assert st2.boot_scan() == 0
    assert st2.match_chain([5]) == []
    st2.close()


def test_enospc_degrades_to_noop_writes(tmp_path):
    st = Both(tmp_path, chaos=lambda cls: cls(3).enospc(times=1))
    assert not st.store(1, 1)
    assert st.t.degraded and st.t.store_errors == 1
    assert not st.store(2, 2)
    assert st.fetch(1) is None and st.t.resident == 0
    assert st.t.ledger_check() == []
    st.same()
    st.close()


def test_uncreatable_root_degrades_at_construction(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the store dir should go")
    st = PersistentKvStore(str(blocker / "g3"), 8, SHAPE, torch.float32)
    assert st.degraded
    assert not st.store(1, *_page(1))
    assert st.fetch(1) is None and st.boot_scan() == 0
    assert st.match_chain([1]) == [] and st.ledger_check() == []
    st.close()


def test_ledger_conservation_across_all_transitions(tmp_path):
    st = Both(tmp_path, cap=2, chaos=lambda cls: cls(11).bitflip_read(times=1))
    for h in (1, 2, 3):
        st.store(h, h)
    st.fetch(2)  # bit-flipped: quarantined
    st.store(2, 2)  # refused
    st.store(4, 4)
    led = st.t.ledger()
    assert led["violations"] == []
    assert led["resident"] == led["adopted"] + led["stores"] - led["evictions"] - led["quarantined"]
    assert led["resident"] == 2 and led["quarantined"] == 1
    st.same()
    st.close()
    st2 = Both(tmp_path, cap=2)
    st2.boot_scan()
    assert st2.t.adopted == 2 and st2.t.ledger()["violations"] == []
    st2.same()
    st2.close()


def test_wire_checksum_rejects_corrupt_frame():
    from dynamo_exp_tpu.disagg import transfer as jtransfer
    from dynamo_exp_tpu_torch.disagg import transfer

    pages = [_page(1), _page(2)]
    header, payload = transfer.encode_pages(pages)
    jheader, jpayload = jtransfer.encode_pages([_np_page(1), _np_page(2)])
    assert header["sums"] == jheader["sums"] and bytes(payload) == bytes(jpayload)
    out = transfer.decode_pages(header, payload)
    assert torch.equal(out[1][1], pages[1][1])
    before = transfer.wire_checksum_failures()
    corrupt = bytearray(payload)
    corrupt[len(corrupt) // 2] ^= 0x10
    with pytest.raises(ValueError, match="wire checksum"):
        transfer.decode_pages(header, bytes(corrupt))
    assert transfer.wire_checksum_failures() == before + 1
    legacy = dict(header)
    del legacy["sums"]
    assert len(transfer.decode_pages(legacy, payload)) == 2


def test_page_file_header_crc_covers_meta_and_payload(tmp_path):
    st = Both(tmp_path)
    st.store(1, 1)
    blob = open(tmp_path / "torch" / f"{1:016x}.kv", "rb").read()
    _magic, crc, _h, _meta_len = _HEADER.unpack_from(blob)
    assert crc == zlib.crc32(blob[_HEADER.size:])
    st.same()
    st.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_directories_cross_adopt_between_packages(tmp_path, dtype):
    """A directory the JAX store wrote is adopted by the port's (equal
    bytes back out), and one the port wrote by the JAX store. bf16 pages
    travel as raw bytes named ``bfloat16`` in the meta."""
    import ml_dtypes

    rs = np.random.RandomState(5)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    pages = {h: (rs.randn(*SHAPE).astype(jdt), rs.randn(*SHAPE).astype(jdt))
             for h in (2**63 + 5, 77, 123456789)}

    def as_torch(a):
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16) \
            if dtype == "bfloat16" else torch.from_numpy(a)

    j = jpersist.PersistentKvStore(str(tmp_path / "a"), 8, SHAPE, jdt)
    for h, (k, v) in pages.items():
        j.store(h, k, v)
    j.close()
    t = PersistentKvStore(str(tmp_path / "a"), 8, SHAPE, tdt)
    assert t.boot_scan() == len(pages)
    for h, (k, v) in pages.items():
        got = t.fetch(h)
        assert torch.equal(got[0], as_torch(k)) and torch.equal(got[1], as_torch(v))
    t.close()

    t = PersistentKvStore(str(tmp_path / "b"), 8, SHAPE, tdt)
    for h, (k, v) in pages.items():
        t.store(h, as_torch(k), as_torch(v))
    t.close()
    j = jpersist.PersistentKvStore(str(tmp_path / "b"), 8, SHAPE, jdt)
    assert j.boot_scan() == len(pages)
    for h, (k, v) in pages.items():
        got = j.fetch(h)
        assert got[0].tobytes() == k.tobytes() and got[1].tobytes() == v.tobytes()
    j.close()
    # And both packages write the same bytes and manifest for the same pages.
    j = jpersist.PersistentKvStore(str(tmp_path / "c"), 8, SHAPE, jdt)
    for h, (k, v) in pages.items():
        j.store(h, k, v)
    j.close()
    assert _tree(tmp_path / "b") == _tree(tmp_path / "c")


# -------------------------------------------------------------- engine e2e
@pytest.fixture(scope="module")
def np_params():
    from dynamo_exp_tpu.models import TINY as JTINY
    from dynamo_exp_tpu.models import llama as jllama

    return jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(0), replace(JTINY, dtype="float32")))


def make_engine(np_params, store_dir=None, pages=20, host_pages=6, slots=2,
                store_pages=256, chaos=None, **kw):
    cfg = EngineConfig(
        model=TCFG, max_decode_slots=slots, page_size=PS, num_pages=pages,
        max_model_len=256, eos_token_ids=[], prefix_sharing=True,
        host_cache_pages=host_pages, kv_dtype="float32",
        kv_store_dir="" if store_dir is None else str(store_dir),
        kv_store_pages=store_pages, kv_store_chaos=chaos, **kw,
    )
    return TorchEngine(cfg, model=params_from_jax(np_params, TCFG, device="cpu"),
                       device="cpu")


async def run_req(engine, prompt, n=6, seed=None, temperature=None):
    b = BackendInput(token_ids=list(prompt))
    b.stop_conditions.max_tokens = n
    b.stop_conditions.ignore_eos = True
    if seed is not None:
        b.sampling_options.seed = seed
    if temperature is not None:
        b.sampling_options.temperature = temperature
    stream = await engine.generate(b.to_dict())
    tokens = []
    async for item in stream:
        tokens.extend(item.get("token_ids", []))
    return tokens


def hard_kill(engine):
    """A crash: the loop thread ends with no teardown (no offload flush,
    no G2 -> G3 drain, no manifest seal). What the demotion write-through
    committed is all the next boot gets."""
    engine._running = False
    engine._wake.set()
    if engine._watchdog is not None:
        engine._watchdog.stop()
        engine._watchdog = None
    if engine._thread is not None:
        engine._thread.join(timeout=30)
        assert not engine._thread.is_alive()
        engine._thread = None
    if engine.copy_stream is not None:
        engine.copy_stream.stop()
        engine.copy_stream = None


def convo_and_churn(seed, n_churn=2):
    rs = np.random.RandomState(seed)
    convo = [int(x) for x in rs.randint(3, 200, size=3 * PS)]
    churn = [[int(x) for x in rs.randint(3, 200, size=16 * PS)] for _ in range(n_churn)]
    return convo, churn


async def seed_store(engine, convo, churn, n=6, **sampling):
    want = await run_req(engine, convo, n=n, **sampling)
    for p in churn:
        await run_req(engine, p, n=2)
    return want


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


def test_restart_resume_identity_greedy(tmp_path, np_params):
    """Kill an engine mid-conversation, boot a fresh one over the same
    directory: the conversation re-attaches its persisted prefix (the
    persist hits) with the pre-crash tokens, which are the JAX engine's
    on the same weights."""
    from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
    from dynamo_exp_tpu.engine import TPUEngine
    from dynamo_exp_tpu.models import TINY as JTINY
    from dynamo_exp_tpu.parallel import single_device_mesh

    convo, churn = convo_and_churn(7)

    async def go():
        eng = make_engine(np_params, store_dir=tmp_path / "g3")
        eng.start()
        want = await seed_store(eng, convo, churn)
        assert eng.g3_store.resident > 0
        hard_kill(eng)
        eng2 = make_engine(np_params, store_dir=tmp_path / "g3")
        assert eng2.g3_store.adopted > 0
        eng2.start()
        try:
            got = await run_req(eng2, convo, n=6)
            m = eng2.metrics()
            audit = eng2.kv_audit()
        finally:
            eng2.stop()
        jeng = TPUEngine(
            JEngineConfig(model=replace(JTINY, dtype="float32"), max_decode_slots=2,
                          page_size=PS, num_pages=20, max_model_len=256, eos_token_ids=[],
                          kv_dtype="float32", attention_impl="xla"),
            params=jax.tree.map(jax.numpy.asarray, np_params), mesh=single_device_mesh())
        jeng.start()
        try:
            jwant = await run_req(jeng, convo, n=6)
        finally:
            jeng.stop()
        return want, got, jwant, m, audit

    want, got, jwant, m, audit = _run(go())
    assert got == want == jwant
    assert m["kv_prefix_hits_persist"] > 0 and m["kv_store_promotes"] > 0
    assert m["kv_store_checksum_failures"] == 0 and m["kv_store_degraded"] == 0
    assert m["kv_ledger_violations"] == 0
    assert audit["ok"], audit["violations"]
    assert audit["g3"]["violations"] == []


def test_restart_resume_identity_seeded(tmp_path, np_params):
    convo, churn = convo_and_churn(11)
    sampling = dict(seed=123, temperature=0.8)

    async def go():
        eng = make_engine(np_params, store_dir=tmp_path / "g3")
        eng.start()
        want = await seed_store(eng, convo, churn, n=8, **sampling)
        assert eng.g3_store.resident > 0
        hard_kill(eng)
        eng2 = make_engine(np_params, store_dir=tmp_path / "g3")
        eng2.start()
        try:
            return want, await run_req(eng2, convo, n=8, **sampling), eng2.kv.prefix_hits
        finally:
            eng2.stop()

    want, got, hits = _run(go())
    assert got == want
    assert hits["persist"] > 0


def test_stop_drains_pending_g2_demotions_through_g3(tmp_path, np_params):
    """A graceful stop demotes the whole warm G2 set and seals the
    manifest, so the next boot adopts it; a wedged loop skips the drain."""
    convo, churn = convo_and_churn(13, n_churn=3)
    eng = make_engine(np_params, store_dir=tmp_path / "g3", host_pages=64)
    eng.start()
    _run(seed_store(eng, convo, churn))
    assert eng.host_pool.resident > 0
    warm_g2 = eng.host_pool.resident
    before = eng.g3_store.stores

    class Wedged:
        def join(self, timeout=None):
            pass

        def is_alive(self):
            return True

    real = eng._thread
    eng._thread = Wedged()
    eng.stop()
    assert eng.g3_store.stores == before
    assert eng.copy_stream is not None  # teardown never ran
    eng._thread = real
    eng.stop()
    assert eng.g3_store.stores >= before + warm_g2
    drained = eng.g3_store.resident
    eng2 = make_engine(np_params, store_dir=tmp_path / "g3")
    assert eng2.g3_store.adopted == drained
    eng2.start()
    eng2.stop()


@pytest.mark.parametrize("seed", [7])
def test_corrupt_page_containment_token_identical(tmp_path, np_params, seed):
    """Bit-flipped G3 reads at restart: the fetch checksum-fails and
    quarantines, the block re-prefills, tokens equal the fault-free run."""
    convo, churn = convo_and_churn(seed)
    chaos = StorageChaos(seed).bitflip_read(times=2)

    async def go():
        eng = make_engine(np_params, store_dir=tmp_path / "g3")
        eng.start()
        want = await seed_store(eng, convo, churn)
        eng.stop()
        eng2 = make_engine(np_params, store_dir=tmp_path / "g3", chaos=chaos)
        assert eng2.g3_store.adopted > 0
        eng2.start()
        try:
            return want, await run_req(eng2, convo, n=6), eng2.metrics(), eng2.kv_audit()
        finally:
            eng2.stop()

    want, got, m, audit = _run(go())
    assert got == want
    assert m["kv_store_checksum_failures"] > 0 and m["kv_store_quarantined"] > 0
    assert chaos.injected
    assert audit["ok"], audit["violations"]
    assert audit["g3"]["violations"] == []


@pytest.mark.parametrize("seed", [7])
def test_torn_write_containment_token_identical(tmp_path, np_params, seed):
    convo, churn = convo_and_churn(seed + 1)
    chaos = StorageChaos(seed).torn_write(times=2)

    async def go():
        eng = make_engine(np_params, store_dir=tmp_path / "g3", chaos=chaos)
        eng.start()
        want = await seed_store(eng, convo, churn)
        assert chaos.injected
        hard_kill(eng)
        eng2 = make_engine(np_params, store_dir=tmp_path / "g3")
        assert eng2.g3_store.torn_pages > 0
        eng2.start()
        try:
            return want, await run_req(eng2, convo, n=6), eng2.metrics()
        finally:
            eng2.stop()

    want, got, m = _run(go())
    assert got == want
    assert m["kv_store_torn"] > 0


@pytest.mark.parametrize("seed", [7])
def test_enospc_and_slow_reads_degrade_never_stall(tmp_path, np_params, seed):
    convo, churn = convo_and_churn(seed + 2, n_churn=4)

    async def go():
        eng = make_engine(np_params, store_dir=tmp_path / "g3",
                          chaos=StorageChaos(seed).enospc(times=1))
        eng.start()
        try:
            want = await seed_store(eng, convo, churn)
            assert eng.g3_store.degraded
            m = eng.metrics()
            assert m["kv_store_degraded"] == 1 and m["kv_store_errors"] >= 1
            assert await run_req(eng, convo, n=6) == want
        finally:
            t0 = time.monotonic()
            eng.stop()
            assert time.monotonic() - t0 < 30.0
        eng3 = make_engine(np_params, store_dir=tmp_path / "slow")
        eng3.start()
        want3 = await seed_store(eng3, convo, churn)
        eng3.stop()
        eng4 = make_engine(np_params, store_dir=tmp_path / "slow",
                           chaos=StorageChaos(seed).delay_read(0.02, times=3))
        eng4.start()
        try:
            assert await run_req(eng4, convo, n=6) == want3
        finally:
            eng4.stop()

    _run(go())


def test_missing_store_dir_runs_g2_only(tmp_path, np_params):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    eng = make_engine(np_params, store_dir=blocker / "g3")
    assert eng.g3_store.degraded
    eng.start()
    try:
        convo, _ = convo_and_churn(5, n_churn=0)

        async def go():
            first = await run_req(eng, convo, n=6)
            assert await run_req(eng, convo, n=6) == first

        _run(go())
        assert eng.metrics()["kv_store_degraded"] == 1
    finally:
        eng.stop()


def test_llmctl_audit_renders_the_g3_block_as_jax(tmp_path, np_params, capsys):
    """A flight dump of an engine that ran the tier: the port's ``llmctl
    audit`` prints the JAX CLI's output, ``g3 store`` line included."""
    from dynamo_exp_tpu.llmctl import main as jllmctl
    from dynamo_exp_tpu_torch.llmctl import main as llmctl

    convo, churn = convo_and_churn(3)
    dump = str(tmp_path / "flight.jsonl")
    eng = make_engine(np_params, store_dir=tmp_path / "g3", flight_dump_path=dump)
    eng.start()
    try:
        _run(seed_store(eng, convo, churn))
        assert eng.g3_store.stores > 0
        eng._dump_flight("test")
    finally:
        eng.stop()
    assert llmctl(["audit", dump]) == 0
    out = capsys.readouterr().out
    assert "g3 store: resident=" in out and "CONSERVED" in out
    assert jllmctl(["audit", dump]) == 0
    assert capsys.readouterr().out == out
