"""KV pressure in the port's engine, on the CPU (float32 TINY).

The JAX package's ``tests/test_overload.py`` scenario: an 8-page pool
where two 8-token prompts decoding 40 tokens each need 12 pages, while
one alone (6 pages) never stalls. So a request run alone on the same
engine is the oracle of the pressured burst: counter-based sampling
makes tokens a function of the request, not of the pool.

- Without a host tier the engine preempts (the stalled rows no longer
  park forever): both streams finish with the solo runs' tokens, greedy
  and seeded, and those equal ``TPUEngine``'s on the same weights; usage
  stays the original request's.
- A negative grace parks both rows; restoring it drains them.
- A context that outgrows the whole pool finishes ``length`` at its
  capacity; a prompt larger than the pool is refused.
- With a host tier, swapping takes over from preemption (swapped_out >
  0, preempted == 0), token-identically; a host tier too small to keep
  the swapped pages falls back to preemption.
- A continuation request (``resume_offset``, presence_penalty 5.0) gives
  ``TPUEngine``'s tokens: the penalty counts rebuild over the journaled
  completion.
- The page manager's audit is clean after every scenario.
"""

import asyncio
import time
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY, params_from_jax

PS = 8
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11]
N = 40
JCFG = replace(JTINY, dtype="float32")
TCFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=PS, num_pages=8, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
)
SEEDED = (dict(temperature=0.9, top_p=0.9, seed=7), dict(temperature=0.8, seed=8))


def _run(coro):
    """Run ``coro`` to its end, failing after 300 s instead of hanging."""
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


async def _collect(eng, prompt, max_tokens, resume_offset=None, **sampling):
    req = {
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
        "sampling_options": sampling,
    }
    if resume_offset is not None:
        req["resume_offset"] = resume_offset
    stream = await eng.generate(req)
    tokens, final = [], None
    async for item in stream:
        tokens.extend(item.get("token_ids", []))
        if item.get("finish_reason"):
            final = item
    return tokens, final


async def _burst(eng, *runs):
    return await asyncio.gather(*(_collect(eng, *r[:2], **r[2]) for r in runs))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), JCFG))


def _engine(np_params, **kw):
    cfg = EngineConfig(model=TCFG, **{**ENGINE_KW, "preempt_stall_grace_s": 0.05, **kw})
    return TorchEngine(cfg, model=params_from_jax(np_params, TCFG, device="cpu"), device="cpu")


def _audit_clean(eng):
    with eng.hold_admission():
        audit = eng.kv_audit()
    assert audit["ok"], audit["violations"]
    assert audit["counts"]["active"] == 0, audit["counts"]


@pytest.fixture(scope="module")
def pressure_engine(np_params):
    eng = _engine(np_params)
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def tpu_tokens(np_params):
    """``TPUEngine`` on the same weights, each request alone (no
    pressure): P1 and P2 greedy and seeded, P1 with presence_penalty
    5.0, and that run's continuation after 6 tokens (resume_offset 6)."""
    jeng = TPUEngine(
        JEngineConfig(model=JCFG, attention_impl="xla", **ENGINE_KW),
        params=jax.tree.map(jax.numpy.asarray, np_params),
        mesh=single_device_mesh(),
    )
    try:
        out = {
            "greedy": [_run(_collect(jeng, p, N))[0] for p in (P1, P2)],
            "seeded": [_run(_collect(jeng, p, N, **so))[0] for p, so in zip((P1, P2), SEEDED)],
        }
        pen = _run(_collect(jeng, P1, 12, presence_penalty=5.0))[0]
        out["journal"] = pen[:6]
        out["continuation"] = _run(_collect(
            jeng, P1 + pen[:6], 10, resume_offset=6, presence_penalty=5.0))[0]
    finally:
        jeng.stop()
    return out


@pytest.mark.parametrize("mode", ["greedy", "seeded"])
def test_pressured_burst_finishes_with_the_solo_and_tpu_tokens(pressure_engine, tpu_tokens, mode):
    """The repair: without a host tier the stalled rows are preempted
    and resume as continuations, token-identically, where the parent
    engine parked both forever."""
    eng = pressure_engine
    opts = SEEDED if mode == "seeded" else ({}, {})
    solo = [_run(_collect(eng, p, N, **so))[0] for p, so in zip((P1, P2), opts)]
    before = eng.preempted
    (r1, f1), (r2, f2) = _run(_burst(eng, (P1, N, opts[0]), (P2, N, opts[1])))
    assert eng.preempted > before  # pressure bit
    assert [r1, r2] == solo == tpu_tokens[mode]
    for f, p in ((f1, P1), (f2, P2)):
        assert f["finish_reason"] == "length"
        assert f["completion_tokens"] == N and f["prompt_tokens"] == len(p)
    _audit_clean(eng)


def test_capacity_exceeding_requests_finish_instead_of_hanging(pressure_engine):
    eng = pressure_engine
    capacity = eng.cfg.num_pages * PS  # 64 tokens of KV
    prompt = [5, 9, 17, 23, 4, 31]
    (n1, f1), (n2, f2) = _run(_burst(eng, (prompt, 60, {}), ([7, 3, 19, 28, 41, 13], 60, {})))
    assert f1["finish_reason"] == "length" and f2["finish_reason"] == "length"
    assert len(n1) == len(n2) == capacity - len(prompt) + 1
    toks, final = _run(_collect(eng, list(range(3, 3 + capacity + 6)), 4))
    assert toks == [] and final["finish_reason"] == "error"
    _audit_clean(eng)


def test_negative_grace_parks_both_rows_until_restored(pressure_engine):
    eng = pressure_engine
    before = eng.preempted
    eng.cfg.preempt_stall_grace_s = -1.0

    async def scenario():
        task = asyncio.ensure_future(_burst(eng, (P1, N, {}), (P2, N, {})))
        try:
            deadline = time.time() + 60
            while time.time() < deadline and eng.metrics()["request_stalled_slots"] < 2:
                await asyncio.sleep(0.02)
            assert eng.metrics()["request_stalled_slots"] >= 2
            await asyncio.sleep(0.3)  # well past the usual grace
            assert eng.preempted == before and not task.done()
        finally:
            eng.cfg.preempt_stall_grace_s = 0.05
        return await task

    (r1, _), (r2, _) = _run(scenario())
    assert len(r1) == len(r2) == N and eng.preempted > before
    _audit_clean(eng)


def test_resume_offset_continuation_equals_tpu_engine(pressure_engine, tpu_tokens):
    """The second repair: a penalized continuation rebuilds its penalty
    counts over the journaled tokens, as ``TPUEngine`` does."""
    got, final = _run(_collect(
        pressure_engine, P1 + tpu_tokens["journal"], 10, resume_offset=6,
        presence_penalty=5.0))
    assert got == tpu_tokens["continuation"] and final["completion_tokens"] == 10


@pytest.mark.parametrize("mode", ["greedy", "seeded_penalized"])
def test_swap_takes_over_from_preemption(np_params, mode):
    eng = _engine(np_params, host_cache_pages=64, preempt_stall_grace_s=0.5)
    so = dict(temperature=0.8, top_k=20, seed=1234, frequency_penalty=0.3)
    opts = (so, dict(so, seed=77)) if mode != "greedy" else ({}, {})
    try:
        (t1, _), (t2, _) = _run(_burst(eng, (P1, N, opts[0]), (P2, N, opts[1])))
        m = eng.metrics()
        assert m["preempted"] == 0 and m["swapped_out"] > 0 and m["swapped_in"] > 0
        solo = [_run(_collect(eng, p, N, **o))[0] for p, o in zip((P1, P2), opts)]
        assert [t1, t2] == solo
        _audit_clean(eng)
    finally:
        eng.stop()


def test_swap_miss_falls_back_to_preemption(np_params):
    """A host tier too small to keep the swapped pages: the swap-in
    misses, the row preempts, and both streams still finish with their
    solo tokens."""
    eng = _engine(np_params, host_cache_pages=1, preempt_stall_grace_s=0.5)
    try:
        (t1, _), (t2, _) = _run(_burst(eng, (P1, N, {}), (P2, N, {})))
        m = eng.metrics()
        assert m["swapped_out"] > 0 and m["preempted"] > 0
        assert [t1, t2] == [_run(_collect(eng, p, N))[0] for p in (P1, P2)]
        _audit_clean(eng)
    finally:
        eng.stop()
