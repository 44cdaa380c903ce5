"""Chained decode windows in the port, on the CPU.

``chained_decode`` (the default) launches window N+1 from window N's
carry before the host consumes N. These tests hold that:

- chained and unchained engines stream the same tokens (greedy, seeded
  and penalized rows, and a request that arrives while a chain runs and
  joins it), and chaining happened;
- a stop found while a successor window is in flight defers the finish:
  the successor is consumed before the row's pages are released, no
  page is ever released while an unconsumed window writes to it, and
  the page audit is clean afterwards;
- under KV pressure (8 pages, the overload tests' fixture) the chain
  breaks and the streams still equal the requests run alone;
- at float32 TINY the port's tokens equal ``TPUEngine``'s, chaining on
  both sides.
"""

import asyncio
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import params_from_jax

CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
)
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11, 44, 2, 9]
P3 = [12, 60, 3, 3, 90]
SAMPLING = [
    {},
    {"temperature": 0.8, "seed": 21, "top_k": 30},
    {"temperature": 0.7, "seed": 5, "frequency_penalty": 0.5, "presence_penalty": 0.3,
     "repetition_penalty": 1.2},
]


def _run(coro):
    """Run ``coro`` to its end, failing after 300 s instead of hanging."""
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


async def _collect(eng, prompt, max_tokens, stop_ids=(), **sampling):
    stream = await eng.generate({
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": not stop_ids,
                            "stop_token_ids": list(stop_ids)},
        "sampling_options": sampling,
    })
    tokens, final = [], None
    async for item in stream:
        tokens.extend(item.get("token_ids", []))
        if item.get("finish_reason"):
            final = item
    return tokens, final["finish_reason"]


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))


def _engine(np_params, **kw):
    cfg = EngineConfig(model=CFG, **{**ENGINE_KW, **kw})
    return TorchEngine(cfg, model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")


class _Tracker:
    """Wraps an engine's window launches, consumes and page releases:
    records the pages each unconsumed window writes, fails a release of
    any of them, and counts consumes that ran while a successor window
    was already in flight (nested consumes: deferred finishes)."""

    def __init__(self, eng):
        self.eng, self.open, self.nested, self.depth, self.bad = eng, {}, 0, 0, []
        launch, consume, release = eng._launch_window, eng._consume_windowed, eng.kv.release_sequence

        def launch_w(rows, *a, **kw):
            p = launch(rows, *a, **kw)
            self.open[id(p)] = {pid for e in rows for pid in e.seq.page_ids}
            return p

        def consume_w(p):
            # A window's writes are done once its consume has synced,
            # which is the consume's first step.
            self.open.pop(id(p), None)
            self.depth += 1
            self.nested += self.depth > 1
            try:
                consume(p)
            finally:
                self.depth -= 1

        def release_w(pids):
            for pages in self.open.values():
                if pages & set(pids):
                    self.bad.append(sorted(pages & set(pids)))
            return release(pids)

        eng._launch_window, eng._consume_windowed = launch_w, consume_w
        eng.kv.release_sequence = release_w


def _audit_clean(eng):
    with eng.hold_admission():
        audit = eng.kv_audit()
    assert audit["ok"], audit["violations"]
    assert audit["counts"]["active"] == 0, audit["counts"]


async def _burst_with_late_arrival(eng, n=24):
    """P1 and P2 admitted together; P3 arrives once a chain runs (or,
    unchained, once as many windows have run) and joins the batch."""
    jobs = [asyncio.create_task(_collect(eng, p, n, **so))
            for p, so in zip((P1, P2), SAMPLING)]
    while eng.dispatches["windowed"] < 3:
        await asyncio.sleep(0.002)
    jobs.append(asyncio.create_task(_collect(eng, P3, n, **SAMPLING[2])))
    return await asyncio.gather(*jobs)


def test_chained_and_unchained_streams_identical(np_params):
    out = {}
    for chained in (False, True):
        eng = _engine(np_params, chained_decode=chained)
        try:
            got = _run(_burst_with_late_arrival(eng))
            out[chained] = (got, dict(eng.dispatches))
            _audit_clean(eng)
        finally:
            eng.stop()
    assert out[True][0] == out[False][0]
    assert all(len(t) == 24 and f == "length" for t, f in out[True][0])
    assert out[True][1]["chained"] > 0 and out[False][1]["chained"] == 0
    # Each solo request streams the same tokens, chained or not.
    eng = _engine(np_params)
    try:
        for (toks, _), p, so in zip(out[True][0], (P1, P2, P3), SAMPLING):
            assert _run(_collect(eng, p, 24, **so))[0] == toks
    finally:
        eng.stop()


def test_stop_with_a_successor_in_flight_defers_the_finish(np_params):
    """P2 stops at a token first sampled at index k of its free run
    while P1 runs on. A window that ends on a page's last slot breaks
    the chain (its carry is dead), so only some windows have a successor
    in flight: k walks the candidates until the stop is found in one
    that has. P2's pages are released only after the successor is
    consumed."""
    eng = _engine(np_params)
    tr = _Tracker(eng)
    try:
        free, _ = _run(_collect(eng, P2, 40))
        want1, _ = _run(_collect(eng, P1, 40))

        async def pair(stop):
            return await asyncio.gather(
                _collect(eng, P2, 40, stop_ids=[stop]), _collect(eng, P1, 40))

        for k in [i for i, t in enumerate(free) if i >= 4 and t not in free[:i]][:6]:
            chained, nested = eng.dispatches["chained"], tr.nested
            (t2, f2), (t1, f1) = _run(pair(free[k]))
            assert eng.dispatches["chained"] > chained
            assert t2 == free[: k + 1] and f2 == "eos"
            assert t1 == want1 and f1 == "length"
            assert not tr.bad, tr.bad  # no page released under an unconsumed window
            if tr.nested > nested:
                break  # the stop's window had a successor in flight
        assert tr.nested > 0
        _audit_clean(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", ["greedy", "seeded"])
def test_chain_breaks_under_pressure_and_tokens_equal_solo(np_params, mode):
    """The overload tests' fixture (8 pages of 8, two rows of 40 tokens):
    the pool runs dry mid-chain, the chain breaks (None from the chained
    dispatch), rows are preempted and resume, and every stream equals
    its solo run."""
    eng = _engine(np_params, num_pages=8, preempt_stall_grace_s=0.05)
    tr = _Tracker(eng)
    sos = ({}, {}) if mode == "greedy" else (
        dict(temperature=0.9, top_p=0.9, seed=7), dict(temperature=0.8, seed=8))
    prompts = ([5, 9, 17, 23, 4, 31, 8, 2], [7, 3, 19, 28, 41, 13, 6, 11])
    try:
        solo = [_run(_collect(eng, p, 40, **so))[0] for p, so in zip(prompts, sos)]
        chained, preempted = eng.dispatches["chained"], eng.preempted

        async def burst():
            return await asyncio.gather(*(_collect(eng, p, 40, **so) for p, so in zip(prompts, sos)))

        got = _run(burst())
        assert eng.dispatches["chained"] > chained and eng.preempted > preempted
        assert [t for t, _ in got] == solo
        assert not tr.bad, tr.bad
        _audit_clean(eng)
    finally:
        eng.stop()


CHAIN_SAMPLING = [{"temperature": 0.9, "seed": 3, "top_p": 0.9}, *SAMPLING[1:]]


def test_tokens_equal_tpu_engine_chained(np_params):
    """float32 TINY, chained_decode=True on both sides: three rows in
    one sampler partition (seeded, top-k, penalized), so the windows
    are solo and chain."""
    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", chained_decode=True, **ENGINE_KW),
        params=jax.tree.map(jax.numpy.asarray, np_params), mesh=single_device_mesh(),
    )

    async def burst(eng):
        return await asyncio.gather(
            *(_collect(eng, p, 24, **so) for p, so in zip((P1, P2, P3), CHAIN_SAMPLING)))

    try:
        want = _run(burst(jeng))
    finally:
        jeng.stop()
    for impl in ("reference", "kernel"):
        eng = _engine(np_params, attention_impl=impl)
        try:
            assert _run(burst(eng)) == want, impl
            assert eng.dispatches["chained"] > 0
        finally:
            eng.stop()
