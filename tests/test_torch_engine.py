"""The port's engine as a whole, on the CPU.

- ``TorchEngine(device="cpu")`` and the JAX package's ``TPUEngine``
  (attention_impl="xla"), both float32 TINY with the same weights
  (through ``params_from_jax``), emit identical tokens for staggered
  concurrent requests (one prompt longer than ``prefill_chunk``, one
  request joining late): greedy, and seeded at temperature 0.8 with
  top-k/top-p on two of the requests (the port draws ``jax.random``'s
  threefry bits).
- The port's mixed and windowed dispatch shapes agree: a request decodes
  the same tokens alone (windowed decode) as next to a late joiner
  (decode steps inside mixed dispatches).
- Prefix reuse hits, and block hashes equal ``dynamo_exp_tpu.tokens``'.
- A stream whose caller's event loop has closed is cancelled.
"""

import asyncio
import time
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu import tokens as jtokens
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import tokens as ttokens
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.scheduler import SeqState
from dynamo_exp_tpu_torch.models import params_from_jax

CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4,
    page_size=8,
    num_pages=64,
    max_model_len=128,
    prefill_chunk=16,
    decode_window=4,
    kv_dtype="float32",
    eos_token_ids=[],
)


def _np_params(seed=0):
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), CFG))


def _torch_engine(np_params, **kw):
    cfg = EngineConfig(model=CFG, **{**ENGINE_KW, **kw})
    return TorchEngine(cfg, model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")


async def _collect(engine, prompt, max_tokens, sampling=None):
    stream = await engine.generate(
        {
            "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
            "sampling_options": dict(sampling or {}),
        }
    )
    toks, finish = [], None
    async for item in stream:
        toks.extend(item.get("token_ids", []))
        finish = item.get("finish_reason", finish)
    return toks, finish


def _run(coro):
    """Run ``coro`` to its end, failing after 300 s instead of hanging."""
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


def _prompts():
    rs = np.random.RandomState(7)
    # The second prompt is longer than prefill_chunk (16): chunked.
    return [list(rs.randint(3, 250, size=n)) for n in (5, 23, 9, 12)]


async def _staggered(engine, prompts, max_tokens=10, sampling=None):
    """The first three arrive 20 ms apart; the last joins once the first
    request has streamed tokens (its chunk rides a mixed dispatch next
    to decode rows). ``sampling`` holds each request's options."""
    sampling = sampling or [None] * len(prompts)
    jobs = []
    for p, so in zip(prompts[:3], sampling):
        jobs.append(asyncio.create_task(_collect(engine, p, max_tokens, so)))
        await asyncio.sleep(0.02)
    while engine.steps < 3:
        await asyncio.sleep(0.005)
    jobs.append(
        asyncio.create_task(_collect(engine, prompts[3], max_tokens, sampling[3]))
    )
    return await asyncio.wait_for(asyncio.gather(*jobs), timeout=300)


# Every request seeded at temperature 0.8; two also cut by top-k/top-p.
SEEDED = [
    {"temperature": 0.8, "seed": 11},
    {"temperature": 0.8, "seed": 12, "top_k": 20},
    {"temperature": 0.8, "seed": 13},
    {"temperature": 0.8, "seed": 2**31 - 1, "top_p": 0.9},
]


def _identical_to_tpu_engine(sampling):
    np_params = _np_params()
    prompts = _prompts()
    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", **ENGINE_KW),
        params=jax.tree.map(jax.numpy.asarray, np_params),
        mesh=single_device_mesh(),
    )
    try:
        want = _run(_staggered(jeng, prompts, sampling=sampling))
    finally:
        jeng.stop()
    for impl in ("reference", "kernel"):
        teng = _torch_engine(np_params, attention_impl=impl)
        try:
            got = _run(_staggered(teng, prompts, sampling=sampling))
        finally:
            teng.stop()
        for (g, gf), (w, wf) in zip(got, want):
            assert len(g) == 10 and gf == "length"
            assert g == w, (impl, g, w)
        assert teng.dispatches["mixed"] > 0 and teng.dispatches["windowed"] > 0
    return want


def test_greedy_tokens_identical_to_tpu_engine():
    _identical_to_tpu_engine(None)


def test_seeded_tokens_identical_to_tpu_engine():
    _identical_to_tpu_engine(SEEDED)


def test_mixed_and_windowed_shapes_agree():
    np_params = _np_params(1)
    prompts = _prompts()
    alone = _torch_engine(np_params)
    try:
        solo, _ = _run(_collect(alone, prompts[1], 16))
    finally:
        alone.stop()
    # After the prompt, the solo run decodes in windows only.
    assert alone.dispatches["windowed"] >= 3

    eng = _torch_engine(np_params)

    async def crowded():
        first = asyncio.create_task(_collect(eng, prompts[1], 16))
        while eng.steps < 2:  # decoding has started
            await asyncio.sleep(0.001)
        mixed_before = eng.dispatches["mixed"]
        late = await _collect(eng, list(range(3, 60)), 4)  # 4 chunks of prefill
        return (await first)[0], late, eng.dispatches["mixed"] - mixed_before

    try:
        together, late, mixed_during = _run(crowded())
    finally:
        eng.stop()
    assert late[1] == "length"
    assert mixed_during >= 4  # the first row's decode steps rode those
    assert together == solo


def test_prefix_reuse_hits_and_block_hashes_match():
    rs = np.random.RandomState(3)
    for n in (0, 7, 8, 33):
        toks = list(rs.randint(0, 1 << 20, size=n))
        assert ttokens.compute_block_hashes_for_seq(
            toks, 8
        ) == jtokens.compute_block_hashes_for_seq(toks, 8)
        assert ttokens.compute_block_hash(toks) == jtokens.compute_block_hash(toks)
    assert ttokens.chain_hash(None, 5) == jtokens.chain_hash(None, 5)

    events = []
    np_params = _np_params(2)
    cfg = EngineConfig(model=CFG, **ENGINE_KW)
    eng = TorchEngine(
        cfg, model=params_from_jax(np_params, CFG, device="cpu"), device="cpu",
        kv_event_cb=events.append,
    )
    shared = list(rs.randint(3, 250, size=24))  # three full pages
    p1, p2 = shared + [5, 6, 7], shared + [9, 10]
    try:
        first, _ = _run(_collect(eng, p1, 6))
        hits0 = eng.kv.hits
        second, _ = _run(_collect(eng, p2, 6))
    finally:
        eng.stop()
    assert hits0 == 0 and eng.kv.hits == 3
    stored = [h for e in events if e.kind == "stored" for h in e.seq_hashes]
    for h in jtokens.compute_block_hashes_for_seq(shared, 8):
        assert h in stored
    # Reuse changes nothing in the stream: a fresh engine agrees.
    fresh = _torch_engine(np_params)
    try:
        assert _run(_collect(fresh, p2, 6))[0] == second
    finally:
        fresh.stop()


def test_stream_of_a_closed_event_loop_is_cancelled():
    """A caller's event loop that closes mid-stream does not leave its
    row decoding to max_tokens: the engine cancels it and frees its slot
    and pages on its next passes."""
    eng = _torch_engine(_np_params(3))
    loop = asyncio.new_event_loop()

    async def first_tokens():
        stream = await eng.generate({
            "token_ids": _prompts()[0],
            "stop_conditions": {"max_tokens": 100, "ignore_eos": True},
        })
        async for item in stream:
            if item.get("token_ids"):
                return stream

    try:
        loop.run_until_complete(asyncio.wait_for(first_tokens(), timeout=300))
        with eng.hold_admission():
            (seq,) = [s for s in eng.sched.slots if s is not None]
            at_close = seq.generated
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()
        deadline = time.monotonic() + 60
        while seq.state is not SeqState.FINISHED and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert seq.state is SeqState.FINISHED
    # One more window was dispatched (its emit found the loop closed),
    # then the row was cancelled; with chained windows (the default) its
    # successor was already in flight when that emit failed.
    windows = 1 + eng.cfg.chained_decode
    assert seq.generated <= at_close + windows * ENGINE_KW["decode_window"] < 100
    assert eng.sched.slots == [None] * ENGINE_KW["max_decode_slots"]
    assert eng.kv.active_pages == 0


def test_cuda_requested_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(model=CFG, **ENGINE_KW))
