"""The port's KV router (``dynamo_exp_tpu_torch/kv_router/``) against the
JAX package's, on the CPU.

- The same ``RouterEvent`` stream (numpy-seeded: chained stores on
  shared prefixes, removals mid-chain, re-stores, an unknown hash
  version) through both ``KvIndexer`` s and both ``KvIndexerSharded`` s
  gives equal ``OverlapScores`` for every query.
- A hypothesis property: both ``DefaultWorkerSelector`` s pick the same
  worker from the same metrics and overlaps under equally seeded
  ``random.Random`` s, ties included.
- ``KvRouter`` / ``KvPushRouter`` in static mode, each package with its
  own workers' stats and events: the same decisions, the same
  ``kv-hit-rate`` events, the deadline checked at stage ``router``.
- Real events: a float32 ``TorchEngine`` on the CPU, its page manager's
  events through ``KvEventPublisher``, land in a JAX ``KvIndexer``
  whose overlap for the prompt covers every full page, with block
  hashes equal to the JAX package's own hashing of the prompt.
"""

import asyncio
import random
from dataclasses import replace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import dynamo_exp_tpu.kv_router as jkv
import dynamo_exp_tpu.runtime as jrt
from dynamo_exp_tpu import tokens as jtokens
from dynamo_exp_tpu_torch import kv_router as tkv
from dynamo_exp_tpu_torch import runtime as trt
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcEventPlane
from dynamo_exp_tpu_torch.telemetry import get_telemetry

BLOCK = 4


def event_stream(seed: int, n_events: int = 300):
    """Stored / removed events of 4 workers over 3 shared prefixes, as
    dicts (the wire form), and the token sequences behind them."""
    rs = np.random.RandomState(seed)
    bases = [rs.randint(0, 500, size=BLOCK * 8).tolist() for _ in range(3)]
    seqs = [b[: BLOCK * rs.randint(2, 5)] + rs.randint(0, 500, size=BLOCK * 4).tolist()
            for b in bases for _ in range(3)]
    held = {w: [] for w in range(4)}
    events = []
    for _ in range(n_events):
        w = int(rs.randint(4))
        if held[w] and rs.rand() < 0.3:
            h = held[w].pop(rs.randint(len(held[w])))
            events.append({"worker_id": w, "kind": "removed", "block_hashes": [h],
                           "parent_hash": None, "hash_version": 2})
            continue
        seq = seqs[rs.randint(len(seqs))]
        hashes = jtokens.compute_block_hashes_for_seq(seq, BLOCK)
        k = int(rs.randint(1, len(hashes) + 1))
        start = int(rs.randint(0, k))
        events.append({"worker_id": w, "kind": "stored", "block_hashes": hashes[start:k],
                       "parent_hash": hashes[start - 1] if start else None,
                       "hash_version": 2 if rs.rand() > 0.05 else 1})
        held[w].extend(hashes[start:k])
    return events, seqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexers_give_equal_overlap_scores(seed):
    events, seqs = event_stream(seed)
    rs = np.random.RandomState(seed + 100)
    pairs = [(jkv.KvIndexer(BLOCK), tkv.KvIndexer(BLOCK)),
             (jkv.KvIndexerSharded(BLOCK, 3), tkv.KvIndexerSharded(BLOCK, 3))]
    nonzero = 0
    for i, ev in enumerate(events):
        for j, t in pairs:
            j.apply(jkv.RouterEvent.from_dict(ev))
            t.apply(tkv.RouterEvent.from_dict(ev))
        if i % 10 == 9:
            for seq in seqs + [rs.randint(0, 500, size=17).tolist()]:
                for j, t in pairs:
                    want = j.find_matches_for_request(seq).scores
                    assert t.find_matches_for_request(seq).scores == want
                    nonzero += bool(want)
            w = int(rs.randint(4))
            if rs.rand() < 0.1:
                for j, t in pairs:
                    j.remove_worker(w)
                    t.remove_worker(w)
    assert nonzero > 50
    assert pairs[0][1].index.num_blocks == pairs[0][0].index.num_blocks


METRICS = st.fixed_dictionaries({
    "request_active_slots": st.integers(0, 8),
    "request_total_slots": st.sampled_from([0, 4, 8]),
    "kv_active_blocks": st.integers(0, 100),
    "kv_total_blocks": st.just(100),
    "num_requests_waiting": st.integers(0, 5),
    "gpu_cache_usage_perc": st.sampled_from([0.0, 0.25, 0.5, 0.75]),
    "gpu_prefix_cache_hit_rate": st.floats(0, 1),
})


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.integers(0, 2**40), METRICS, min_size=1, max_size=6),
       st.dictionaries(st.integers(0, 2**40), st.integers(0, 8), max_size=6),
       st.integers(0, 64), st.sampled_from([4, 16]), st.integers(0, 2**31),
       st.sampled_from([0.0, 1.0, 2.5]))
def test_selectors_pick_equal_workers(metrics, overlaps, isl, block, seed, qw):
    jsel = jkv.DefaultWorkerSelector(random.Random(seed), queue_weight=qw)
    tsel = tkv.DefaultWorkerSelector(random.Random(seed), queue_weight=qw)
    jend = jkv.ProcessedEndpoints({w: jkv.ForwardPassMetrics.from_dict(m)
                                   for w, m in metrics.items()})
    tend = tkv.ProcessedEndpoints({w: tkv.ForwardPassMetrics.from_dict(m)
                                   for w, m in metrics.items()})
    for _ in range(3):
        assert tsel.select_worker(tend, tkv.OverlapScores(dict(overlaps)), isl, block) == \
            jsel.select_worker(jend, jkv.OverlapScores(dict(overlaps)), isl, block)


def test_protocol_dicts_equal_jax():
    m = {"request_active_slots": 3, "request_total_slots": 8, "kv_active_blocks": 9,
         "kv_total_blocks": 64, "num_requests_waiting": 1, "gpu_cache_usage_perc": 0.5,
         "gpu_prefix_cache_hit_rate": 0.25, "extra": 1}
    assert tkv.ForwardPassMetrics.from_dict(m).to_dict() == \
        jkv.ForwardPassMetrics.from_dict(m).to_dict()
    ev = {"worker_id": 5, "kind": "stored", "block_hashes": [1, 2], "parent_hash": 9,
          "hash_version": 2}
    assert tkv.RouterEvent.from_dict(ev).to_dict() == jkv.RouterEvent.from_dict(ev).to_dict()
    assert tkv.KVHitRateEvent(1, 2, 3).to_dict() == jkv.KVHitRateEvent(1, 2, 3).to_dict()
    assert (tkv.kv_events_subject("ns/components/w"), tkv.KV_HIT_RATE_SUBJECT) == (
        jkv.kv_events_subject("ns/components/w"), jkv.KV_HIT_RATE_SUBJECT)


# ---------------------------------------------------------- KvPushRouter
async def _kv_route_script(rt, kv) -> dict:
    drt = rt.DistributedRuntime.detached()
    comp = drt.namespace("ns").component("w")
    ep = comp.endpoint("gen")
    load = [{"request_active_slots": 0, "request_total_slots": 4},
            {"request_active_slots": 2, "request_total_slots": 4}]

    def engine(tag):
        async def fn(req, ctx):
            yield {"tag": tag, "est": req.get("estimated_prefix_hit_num_blocks")}

        return rt.LambdaEngine(fn)

    insts = []
    for tag in range(2):
        async def handler(req, ctx, _e=engine(tag)):
            async for f in rt.annotated_stream(_e, req, ctx):
                yield f

        insts.append(await ep.serve_endpoint(handler, stats_handler=lambda t=tag: load[t]))
    hits = await drt.event_plane.subscribe(kv.KV_HIT_RATE_SUBJECT)
    router = kv.KvRouter(comp, BLOCK, selector=kv.DefaultWorkerSelector(random.Random(3)))
    client = await ep.client()
    push = kv.KvPushRouter(rt.PushRouter(client, rt.RouterMode.DIRECT), router)
    await router.start()
    prompt = list(range(40))
    hashes = jtokens.compute_block_hashes_for_seq(prompt, BLOCK)
    # Worker 1 holds the prompt's first 6 blocks.
    await drt.event_plane.publish(kv.kv_events_subject(comp.path), {
        "worker_id": insts[1].instance_id, "kind": "stored", "block_hashes": hashes[:6],
        "parent_hash": None, "hash_version": 2})
    for _ in range(100):
        if router.indexer.events_applied:
            break
        await asyncio.sleep(0.01)
    obs = {"tags": []}
    for p in (prompt, prompt[:8] + [999] * 8, list(range(100, 120))):
        obs["tags"].append([f async for f in await push.generate({"token_ids": p})])
    obs["hits"] = []
    for _ in range(3):
        h = await asyncio.wait_for(anext(hits), 5)
        h["worker_id"] = [i.instance_id for i in insts].index(h["worker_id"])
        obs["hits"].append(h)
    late = rt.AsyncEngineContext()
    late.start_timeout(-1.0)
    try:
        await push.generate({"token_ids": prompt}, late)
    except rt.DeadlineExceededError:
        obs["deadline"] = True
    await router.stop()
    client.close()
    for inst in insts:
        await inst.close()
    await drt.close()
    return obs


async def test_kv_push_router_matches_jax():
    before = get_telemetry().deadline_exceeded.labels("router").get()
    want = await _kv_route_script(jrt, jkv)
    got = await _kv_route_script(trt, tkv)
    assert got == want
    assert got["tags"][0] == [{"tag": 1, "est": 6}]
    assert got["hits"][0] == {"worker_id": 1, "isl_blocks": 10, "overlap_blocks": 6}
    assert got["deadline"] and get_telemetry().deadline_exceeded.labels("router").get() == \
        before + 1


# --------------------------------------------------------- real KV events
async def test_torch_engine_events_land_in_a_jax_indexer():
    cfg = EngineConfig(model=replace(TINY, dtype="float32"), max_decode_slots=2, page_size=8,
                       num_pages=32, max_model_len=128, prefill_chunk=16, decode_window=4,
                       kv_dtype="float32", eos_token_ids=[])
    eng = TorchEngine(cfg, device="cpu")
    plane = InProcEventPlane()
    sub = await plane.subscribe(tkv.kv_events_subject("ns/components/w"))
    pub = tkv.KvEventPublisher(plane, "ns/components/w", worker_id=42,
                               loop=asyncio.get_running_loop())
    eng.kv.event_cb = pub.engine_callback()
    prompt = np.random.RandomState(4).randint(0, TINY.vocab_size, size=37).tolist()
    try:
        stream = await eng.generate({"token_ids": prompt,
                                     "stop_conditions": {"max_tokens": 3, "ignore_eos": True}})
        [f async for f in stream]
    finally:
        eng.stop()
    jindex = jkv.KvIndexer(8)
    stored = []
    while pub.published and len(stored) < pub.published:
        ev = await asyncio.wait_for(anext(sub), 5)
        stored.append(ev)
        jindex.apply(jkv.RouterEvent.from_dict(ev))
    want = jtokens.compute_block_hashes_for_seq(prompt, 8)
    got = [h for ev in stored if ev["kind"] == "stored" for h in ev["block_hashes"]]
    assert got[: len(want)] == want and len(want) == 4
    assert jindex.find_matches_for_request(prompt).scores == {42: 4}
