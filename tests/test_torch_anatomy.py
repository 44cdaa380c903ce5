"""The port's request anatomy and workload fingerprint against the JAX
package's (``telemetry/anatomy.py``, ``telemetry/fingerprint.py``).

- The checked-in span fixture: the port's fingerprint hashes to the
  digest the JAX tests pin, and its anatomies and renderings equal
  JAX's.
- Hypothesis-drawn span trees, flight-dump event streams and
  fingerprint feeds: ``anatomy_from_spans``, ``anatomy_from_flight``,
  ``anatomy_from_timing``, ``drift_score``, ``replay_workload`` and the
  renderers give JAX's results.
- The live taps: both engines give equal fingerprint digests on the same
  requests, every live anatomy sums to its edge latency, the
  ``dynamo_request_seconds`` family holds the engine's totals, and a
  pinned ``DYN_WORKLOAD_REF`` drives the drift gauge.
"""

import asyncio
import json
import os
import random
from dataclasses import replace

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu import telemetry as J
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import telemetry as T
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY, params_from_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "anatomy_trace.jsonl")
FIXTURE_DIGEST = "cc4c9acebff3d398e80362e750157f64"  # pinned by tests/test_anatomy.py

JCFG = replace(JTINY, dtype="float32")
TCFG = replace(TINY, dtype="float32")
STAGES = ("http_request", "queue_wait", "prefill", "decode", "kv_transfer_send",
          "kv_transfer_recv", "preemption", "recovery", "remote_prefill", "preprocess")
FLIGHT_KINDS = ("admit", "first_token", "preempt", "stall_start", "stall_end", "finish")


def both_spans(events):
    return ([J.Span.from_event(e) for e in events], [T.Span.from_event(e) for e in events])


def by_trace(spans):
    out = {}
    for s in spans:
        out.setdefault(s.trace_id, []).append(s)
    return out


# ------------------------------------------------------------- the fixture
def test_fixture_fingerprint_digest_is_pinned():
    fp = T.fingerprint_from_spans(T.load_spans([FIXTURE]))
    assert fp.n == 3
    assert fp.digest()[:32] == FIXTURE_DIGEST
    assert fp.to_dict() == J.fingerprint_from_spans(J.load_spans([FIXTURE])).to_dict()


def test_fixture_anatomies_and_renderings_equal_jax():
    jt, tt = by_trace(J.load_spans([FIXTURE])), by_trace(T.load_spans([FIXTURE]))
    assert sorted(jt) == sorted(tt) and len(tt) == 3
    ja, ta = [], []
    for tid in sorted(tt):
        a, b = J.anatomy_from_spans(jt[tid]), T.anatomy_from_spans(tt[tid])
        assert b.to_dict() == a.to_dict()
        assert b.total_s == pytest.approx(b.edge_latency_s, abs=1e-5)
        assert T.render_anatomy(b) == J.render_anatomy(a)
        ja.append(a)
        ta.append(b)
    for by in ("edge", "ttft", "itl"):
        assert T.render_slow(ta, n=2, by=by) == J.render_slow(ja, n=2, by=by)
    fp = T.fingerprint_from_spans(T.load_spans([FIXTURE]))
    assert T.render_fingerprint(fp) == J.render_fingerprint(
        J.fingerprint_from_spans(J.load_spans([FIXTURE])))


# ----------------------------------------------------------- drawn inputs
ATTRS = st.fixed_dictionaries({}, optional={
    "compile_s": st.floats(0, 3), "swap_stall_s": st.floats(0, 3),
    "dispatch_p50_s": st.floats(0, 0.05), "host_gap_p50_s": st.floats(0, 0.05),
    "prompt_tokens": st.integers(0, 5000), "cached_tokens": st.integers(0, 500),
    "generated_tokens": st.integers(0, 900), "pages": st.integers(0, 64),
    "priority": st.integers(0, 2), "ttft_s": st.floats(0, 5), "itl_s": st.floats(0, 1),
    "request_id": st.sampled_from(["req-a", "req-b"]),
    "instance": st.sampled_from(["h:1", "h:2", "h:3"]),
    "spec_tokens_per_dispatch": st.floats(0, 6),
})


@st.composite
def span_events(draw):
    n = draw(st.integers(1, 9))
    events = []
    for i in range(n):
        a = draw(st.floats(0, 10))
        d = draw(st.floats(0, 4))
        events.append({
            "type": "span", "stage": draw(st.sampled_from(STAGES)),
            "trace_id": draw(st.sampled_from(["t" * 32, "u" * 32])), "span_id": f"s{i}",
            "parent_span_id": draw(st.sampled_from(["", "s0", "s1", "gone"])),
            "start": a, "end": a + d, "attrs": draw(ATTRS),
        })
    return events


@settings(max_examples=80, deadline=None)
@given(span_events())
def test_drawn_span_trees_decompose_and_render_as_jax(events):
    js, ts = both_spans(events)
    for tid, group in by_trace(ts).items():
        jgroup = [s for s in js if s.trace_id == tid]
        a, b = J.anatomy_from_spans(jgroup), T.anatomy_from_spans(group)
        assert b.to_dict() == a.to_dict()
        assert T.render_anatomy(b) == J.render_anatomy(a)
        assert b.total_s == pytest.approx(b.edge_latency_s, abs=1e-5)
    assert T.fingerprint_from_spans(ts).to_dict() == J.fingerprint_from_spans(js).to_dict()


@st.composite
def flight_blocks(draw):
    events, t = [], 0.0
    for seq in range(draw(st.integers(0, 30))):
        t += draw(st.floats(0, 2))
        ev = {"seq": seq, "t": t, "kind": draw(st.sampled_from(FLIGHT_KINDS)),
              "req": draw(st.sampled_from(["r1", "r2", "r3"]))}
        if ev["kind"] == "admit":
            ev.update(prompt=draw(st.integers(0, 99)), cached=draw(st.integers(0, 9)),
                      priority=draw(st.integers(0, 2)))
        if ev["kind"] == "finish":
            ev.update(generated=draw(st.integers(0, 50)), pages=draw(st.integers(0, 9)))
        events.append(ev)
    return {"events": draw(st.permutations(events))}


@settings(max_examples=80, deadline=None)
@given(flight_blocks(), st.sampled_from([None, "r1", "r3"]))
def test_drawn_flight_blocks_replay_as_jax(block, req):
    want = [a.to_dict() for a in J.anatomy_from_flight(block, req)]
    got = [a.to_dict() for a in T.anatomy_from_flight(block, req)]
    assert got == want
    for a in T.anatomy_from_flight(block, req):
        assert a.total_s == pytest.approx(a.edge_latency_s, abs=1e-5)


TIMING = st.fixed_dictionaries({
    k: st.floats(0, 5) for k in ("queue_s", "prefill_s", "decode_s", "compile_s", "swap_s",
                                  "preempt_s", "edge_latency_s", "page_seconds")
} | {"gap_frac": st.floats(0, 1), "generated_tokens": st.integers(0, 99)})


@settings(max_examples=60, deadline=None)
@given(TIMING)
def test_anatomy_from_timing_and_the_ring_equal_jax(kw):
    a = J.anatomy_from_timing("req-t", **kw)
    b = T.anatomy_from_timing("req-t", **kw)
    assert b.to_dict() == a.to_dict()
    assert T.RequestAnatomy.from_dict(b.to_dict()).to_dict() == b.to_dict()
    jr, tr = J.AnatomyRing(capacity=3), T.AnatomyRing(capacity=3)
    for i in range(6):
        edge = kw["edge_latency_s"] + (i * 7919 % 5)
        jr.offer(J.anatomy_from_timing(f"r{i}", **{**kw, "edge_latency_s": edge}))
        tr.offer(T.anatomy_from_timing(f"r{i}", **{**kw, "edge_latency_s": edge}))
    assert tr.snapshot() == jr.snapshot()


FEED = st.lists(st.tuples(st.integers(1, 9000), st.integers(0, 500), st.integers(0, 2),
                          st.floats(0, 50), st.integers(1, 3000), st.floats(0, 6)),
                min_size=1, max_size=40)


def feed(mod, rows):
    b = mod.FingerprintBuilder()
    for isl, cached, prio, t, osl, spec in rows:
        b.observe_admit(isl, cached, prio, 100.0 + t)
        b.observe_finish(osl, spec)
    return b.snapshot()


@settings(max_examples=60, deadline=None)
@given(FEED, FEED, st.integers(0, 9))
def test_fingerprint_drift_and_replay_equal_jax(a, b, seed):
    ja, jb, ta, tb = feed(J, a), feed(J, b), feed(T, a), feed(T, b)
    assert ta.to_dict() == ja.to_dict() and tb.to_dict() == jb.to_dict()
    assert T.drift_score(ta, tb) == J.drift_score(ja, jb)
    assert T.render_fingerprint(ta) == J.render_fingerprint(ja)
    assert T.WorkloadFingerprint.from_dict(ta.to_dict()).digest() == ta.digest()
    got = T.replay_workload(ta, seed=seed, n=12)
    want = J.replay_workload(ja, seed=seed, n=12)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    # Order of observation never changes the digest.
    rows = list(a)
    random.Random(seed).shuffle(rows)
    assert feed(T, rows).digest() == ta.digest()


def test_drift_watch_waits_for_min_n_as_jax():
    ref = feed(T, [(128, 0, 1, float(i), 32, 0.0) for i in range(32)])
    live = T.FingerprintBuilder()
    watch = T.WorkloadDriftWatch(live, ref, min_n=8)
    assert watch.score() == 0.0
    for i in range(8):
        live.observe_admit(4096, priority=0, arrival_t=20.0 + i)
        live.observe_finish(512)
    jref = J.WorkloadFingerprint.from_dict(ref.to_dict())
    jlive = J.WorkloadFingerprint.from_dict(live.snapshot().to_dict())
    assert watch.score() == J.drift_score(jlive, jref) > T.fingerprint.DRIFT_ALERT_THRESHOLD
    assert T.WorkloadDriftWatch(live, None).score() == 0.0


# ------------------------------------------------------------ the engines
PS = 8


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), JCFG))


def jax_engine(np_params, **kw):
    return TPUEngine(JEngineConfig(model=JCFG, attention_impl="xla", **kw),
                     params=jax.tree.map(jax.numpy.asarray, np_params),
                     mesh=single_device_mesh())


def torch_engine(np_params, **kw):
    return TorchEngine(EngineConfig(model=TCFG, **kw),
                       model=params_from_jax(np_params, TCFG, device="cpu"), device="cpu")


async def _plain(eng, prompt, max_tokens):
    req = {"token_ids": list(prompt),
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    stream = await eng.generate(req)
    async for _ in stream:
        pass


ENGINE_KW = dict(max_decode_slots=2, page_size=PS, num_pages=64, max_model_len=128,
                 eos_token_ids=[], kv_dtype="float32")
LIVE_PROMPTS = [list(range(3, 3 + n)) for n in (12, 40, 70)]


def test_engines_give_equal_digests_and_whole_anatomies(np_params):
    digests = {}
    for name, make in (("jax", jax_engine), ("torch", torch_engine)):
        eng = make(np_params, **ENGINE_KW)
        try:
            async def burst():
                await asyncio.gather(*(_plain(eng, p, 4 + i) for i, p in enumerate(LIVE_PROMPTS)))

            _run(burst())
            m = eng.metrics()
        finally:
            eng.stop()
        assert m["anatomy_requests"] == 3 and m["workload_requests"] == 3
        assert set(m["anatomy_totals"]) == set(T.COMPONENTS)
        for d in m["anatomy_slow"]:
            assert sum(d["components"].values()) == pytest.approx(d["edge_latency_s"], abs=1e-5)
        assert sorted((d["prompt_tokens"], d["generated_tokens"]) for d in m["anatomy_slow"]) == [
            (12, 4), (40, 5), (70, 6)]
        digests[name] = m["workload_fingerprint"]
    assert digests["torch"] == digests["jax"]


def test_request_seconds_family_holds_the_totals_and_drift_gauge(np_params, tmp_path,
                                                                 monkeypatch):
    ref = T.FingerprintBuilder()
    for i in range(16):
        ref.observe_admit(4096, priority=2, arrival_t=5.0 + i)
        ref.observe_finish(1024)
    ref_path = tmp_path / "ref.json"
    ref_path.write_text(json.dumps(ref.snapshot().to_dict()))
    monkeypatch.setenv("DYN_WORKLOAD_REF", str(ref_path))
    tel = T.get_telemetry()
    before = {k: tel.request_seconds.labels(k).get() for k in T.COMPONENTS}
    eng = torch_engine(np_params, **ENGINE_KW)
    eng.anatomy_ring = T.AnatomyRing(capacity=2)
    try:
        assert eng.drift_watch.reference is not None

        async def burst():
            await asyncio.gather(*(_plain(eng, [3 + i] * 9, 2) for i in range(8)))

        _run(burst())
        m = eng.metrics()
    finally:
        eng.stop()
    assert len(m["anatomy_slow"]) == 2
    assert m["workload_drift_score"] > T.fingerprint.DRIFT_ALERT_THRESHOLD
    assert tel.workload_drift_score._only().get() == m["workload_drift_score"]
    for comp, total in m["anatomy_totals"].items():
        assert tel.request_seconds.labels(comp).get() - before[comp] == pytest.approx(
            total, abs=1e-5)
