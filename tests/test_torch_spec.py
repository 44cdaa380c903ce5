"""Speculative decoding in the port, on the CPU, against the JAX package.

- The drafters and the adaptive controller (``dynamo_exp_tpu_torch.spec``)
  give the JAX package's proposals, draft lengths and backoff on the
  same token lists.
- ``spec_accept_length`` / ``spec_verify_tokens`` equal JAX's exactly on
  the same numpy inputs: targets, emit counts and penalty counts.
- ``TorchEngine`` with ``spec_mode="ngram"`` emits the tokens it emits
  without speculation: greedy, seeded, penalized, a stop token found
  inside a verify span, and a greedy row beside a sampled one. Verify
  spans are 9 tokens at most, so with ``attention_impl="kernel"`` (the
  plain version on the CPU, spans aligned to q_tile 8) a span takes two
  tiles.
- At float32 TINY the port's tokens equal ``TPUEngine``'s with
  ``spec_mode="ngram"``; rewinds leak no page; a pressured burst with
  speculation on resumes from preemption with the reference engine's
  tokens.
"""

import asyncio
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu import spec as jspec
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.ops import sampling as jsampling
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import spec as tspec
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import params_from_jax
from dynamo_exp_tpu_torch.ops import sampling as tsampling

CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
)
REPEAT = [5, 9, 17, 3] * 5  # gives the n-gram lookup something to hit
OTHER = [7, 3, 19, 7, 3, 19, 7, 3, 19, 28]
SEEDED = dict(temperature=0.9, top_p=0.9, seed=777)
PENALIZED = dict(temperature=0.8, seed=424242, frequency_penalty=0.4,
                 presence_penalty=0.2, repetition_penalty=1.15)


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


@pytest.fixture(scope="module")
def engines(np_params):
    """(no speculation, ngram with the plain version, ngram with the
    kernel wrappers' q_tile-aligned spans)."""
    engs = (
        _engine(np_params),
        _engine(np_params, spec_mode="ngram", attention_impl="reference"),
        _engine(np_params, spec_mode="ngram", attention_impl="kernel"),
    )
    yield engs
    for e in engs:
        e.stop()


# --------------------------------------------------- drafter and controller
@pytest.mark.parametrize(
    "tokens,max_len,ngram",
    [
        (REPEAT, 4, (3, 1)),
        ([1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3], 3, (3, 1)),
        ([4, 4, 4, 4], 8, (2, 1)),
        ([1, 2, 3, 4, 5], 4, (3, 1)),
        ([8, 1, 8, 2, 8], 2, (1, 1)),
        (OTHER, 0, (3, 2)),
    ],
)
def test_drafters_propose_as_jax(tokens, max_len, ngram):
    hi, lo = ngram
    got = tspec.NgramDrafter(hi, lo).propose(tokens, max_len)
    assert got == jspec.NgramDrafter(hi, lo).propose(tokens, max_len)
    assert tspec.StaticDrafter([9, 8, 7]).propose(tokens, max_len) == \
        jspec.StaticDrafter([9, 8, 7]).propose(tokens, max_len)
    assert tspec.registered_drafters() == jspec.registered_drafters()


class _Seq:
    def __init__(self, tokens, request_id="r"):
        self.tokens, self.request_id = list(tokens), request_id


def test_controller_adapts_as_jax():
    """The same propose/record sequence gives the same draft lengths,
    proposals and miss backoff, adaptive and pinned."""
    rs = np.random.RandomState(3)
    for adaptive in (True, False):
        kw = dict(spec_mode="ngram", spec_adaptive=adaptive, spec_miss_limit=2,
                  spec_retry_tokens=5)
        jm = jspec.SpecManager(JEngineConfig(model=TINY, **kw))
        tm = tspec.SpecManager(EngineConfig(model=TINY, **kw))
        js, ts = _Seq(REPEAT[:6]), _Seq(REPEAT[:6])
        for step in range(40):
            assert tm.wants_draft(ts) == jm.wants_draft(js)
            if jm.wants_draft(js):
                d = tm.propose(ts)
                assert d == jm.propose(js)
                if d:
                    acc = int(rs.randint(0, len(d) + 1))
                    jm.record(js, len(d), acc)
                    tm.record(ts, len(d), acc)
            assert tm.draft_len(ts) == jm.draft_len(js), step
            tok = int(rs.randint(0, 40)) if step % 3 else REPEAT[step % 4]
            js.tokens.append(tok)
            ts.tokens.append(tok)
        tm.retain([])
        jm.retain([])
        assert len(tm) == len(jm) == 0
    with pytest.raises(ValueError, match="bad spec draft bounds"):
        EngineConfig(model=TINY, spec_min_draft=3, spec_max_draft=2)
    cfg = EngineConfig(model=TINY, spec_draft_len=20, spec_max_draft=6)
    assert cfg.spec_draft_len == JEngineConfig(model=TINY, spec_draft_len=20,
                                               spec_max_draft=6).spec_draft_len == 6


# ------------------------------------------------------- acceptance rules
def _verify_inputs(seed, B=4, T=5, V=40):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, V).astype(np.float32) * 2
    targets = logits.argmax(-1)
    # Drafts equal the greedy target for a random prefix, then differ.
    drafts = np.full((B, T - 1), -1, np.int32)
    n_drafts = rs.randint(0, T, size=B).astype(np.int32)
    for b in range(B):
        good = rs.randint(0, n_drafts[b] + 1)
        for i in range(n_drafts[b]):
            drafts[b, i] = targets[b, i] if i < good else (targets[b, i] + 1) % V
    positions = np.arange(T, dtype=np.int32)[None] + rs.randint(0, 50, size=(B, 1)).astype(np.int32)
    positions[B - 1] = -1  # a pad row
    seeds = rs.randint(0, 2**31 - 1, size=B).astype(np.int32)
    temp = np.array([0.0, 0.9, 0.7, 0.8], np.float32)[:B]
    top_k = np.array([0, 0, 8, 0], np.int32)[:B]
    top_p = np.array([1.0, 0.9, 1.0, 1.0], np.float32)[:B]
    counts = rs.randint(0, 3, size=(B, V)).astype(np.int32)
    freq = np.array([0.0, 0.3, 0.0, 0.5], np.float32)[:B]
    pres = np.array([0.0, 0.2, 0.4, 0.0], np.float32)[:B]
    rep = np.array([1.0, 1.1, 1.0, 1.3], np.float32)[:B]
    return (logits, drafts, n_drafts, seeds, positions, temp, top_k, top_p,
            counts, freq, pres, rep)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_length_and_verify_tokens_equal_jax(seed):
    args = _verify_inputs(seed)
    logits, drafts, n_drafts = args[:3]
    targets = logits.argmax(-1).astype(np.int32)
    want = np.asarray(jsampling.spec_accept_length(
        jnp.asarray(targets), jnp.asarray(drafts), jnp.asarray(n_drafts)))
    got = tsampling.spec_accept_length(
        torch.from_numpy(targets), torch.from_numpy(drafts), torch.from_numpy(n_drafts))
    np.testing.assert_array_equal(got.numpy(), want)
    jt, jn, jc = (np.asarray(x) for x in jsampling.spec_verify_tokens(
        *(jnp.asarray(a) for a in args)))
    tt, tn, tc = (x.numpy() for x in tsampling.spec_verify_tokens(
        *(torch.from_numpy(a) for a in args)))
    # Targets past a row's emitted prefix are teacher-forced garbage.
    for b in range(len(jn)):
        np.testing.assert_array_equal(tt[b, : jn[b]], jt[b, : jn[b]])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert jn[-1] == 0  # the pad row emits nothing


def test_multi_position_draws_equal_jax():
    """``sample_tokens_seeded_multi`` draws JAX's tokens for every (row,
    offset) of a verify-shaped batch, and each equals the single-step
    draw keyed by the same position."""
    logits, _, _, seeds, positions, temp, top_k, top_p = _verify_inputs(5)[:8]
    want = np.asarray(jsampling.sample_tokens_seeded_multi(
        *(jnp.asarray(a) for a in (logits, seeds, positions, temp, top_k, top_p))))
    got = tsampling.sample_tokens_seeded_multi(
        *(torch.from_numpy(a) for a in (logits, seeds, positions, temp, top_k, top_p)))
    np.testing.assert_array_equal(got.numpy(), want)
    for t in range(logits.shape[1]):
        step = tsampling.sample_tokens_seeded(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
                logits[:, t], seeds, positions[:, t], temp, top_k, top_p)))
        np.testing.assert_array_equal(step.numpy(), got.numpy()[:, t])


# ------------------------------------------------- the engine, spec on/off
class _Oracle(tspec.Drafter):
    """Proposes the stream's own continuation (``want`` after
    ``prompt``), with every third proposal's last draft corrupted: long
    accepted spans and rejections in one run."""

    name = "oracle"

    def __init__(self, prompt, want):
        self.prompt, self.want, self.calls = list(prompt), list(want), 0

    def propose(self, tokens, max_len):
        i = len(tokens) - len(self.prompt)
        drafts = self.want[i : i + max_len]
        self.calls += 1
        if drafts and self.calls % 3 == 0:
            drafts[-1] = (drafts[-1] + 1) % CFG.vocab_size
        return drafts


@pytest.mark.parametrize(
    "case", ["greedy", "seeded", "penalized", "eos", "mixed"]
)
def test_spec_on_equals_spec_off(engines, case):
    """Greedy and mixed rows draft by n-gram lookup; the seeded,
    penalized and stopping rows (whose streams rarely repeat the prompt
    on random weights) by their own continuation with some drafts wrong,
    so penalty counts thread past rejections and the stop token lands
    inside a verify span."""
    plain, *specs = engines
    so = {"seeded": SEEDED, "penalized": PENALIZED}.get(case, {})
    free, _ = _run(_collect(plain, REPEAT, 20, **so))
    # eos: a token first sampled past the first spans stops the row.
    stop = next(t for i, t in enumerate(free) if i >= 6 and t not in free[:i])

    async def run(eng):
        if case == "mixed":
            return await asyncio.gather(
                _collect(eng, REPEAT, 12), _collect(eng, OTHER, 12, **SEEDED))
        if case == "eos":
            return await _collect(eng, REPEAT, 20, stop_ids=[stop])
        return await _collect(eng, REPEAT, 20, **so)

    want = _run(run(plain))
    if case == "eos":
        assert want[0][-1] == stop and len(want[0]) < 20 and want[1] == "eos"
    for eng in specs:
        before = eng.spec_row_dispatches
        ngram = eng._spec.drafter
        if case in ("seeded", "penalized", "eos"):
            eng._spec.drafter = _Oracle(REPEAT, free)
        try:
            assert _run(run(eng)) == want, (case, eng.attn_impl)
        finally:
            eng._spec.drafter = ngram
        assert eng.spec_row_dispatches > before  # speculation engaged
    m = specs[1].metrics()
    assert m["spec_accepted_tokens"] > 0 and m["spec_draft_tokens"] >= m["spec_accepted_tokens"]
    assert m["spec_emitted_tokens"] / m["spec_row_dispatches"] > 1.0


def test_tokens_equal_tpu_engine_with_ngram_spec(np_params, engines):
    """float32 TINY, ``spec_mode="ngram"`` on both sides: greedy and
    seeded streams of two rows running together are the reference's."""
    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", spec_mode="ngram", **ENGINE_KW),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )

    async def pair(eng):
        return await asyncio.gather(
            _collect(eng, REPEAT, 16), _collect(eng, OTHER, 16, **SEEDED))

    try:
        want = _run(pair(jeng))
        assert jeng.spec_accepted_tokens > 0
    finally:
        jeng.stop()
    for eng in engines[1:]:
        accepted = eng.spec_accepted_tokens
        assert _run(pair(eng)) == want, eng.attn_impl
        assert eng.spec_accepted_tokens > accepted


def test_no_page_leak_after_rewinds(np_params):
    """Pages provisioned for rejected drafts go back: after the streams
    finish, the audit is clean and every page is free or parked."""
    eng = _engine(np_params, spec_mode="ngram", num_pages=32, attention_impl="kernel")
    try:
        async def pair():
            return await asyncio.gather(
                _collect(eng, REPEAT, 30), _collect(eng, OTHER, 30, **PENALIZED))

        _run(pair())
        assert eng.spec_draft_tokens > eng.spec_accepted_tokens > 0  # some were rejected
        with eng.hold_admission():
            audit = eng.kv_audit()
        assert audit["ok"], audit["violations"]
        assert audit["counts"]["active"] == 0 and eng.kv.active_pages == 0
        assert eng.kv.free_pages == eng.kv.num_pages
    finally:
        eng.stop()


def test_preempt_resume_identity_with_spec_on(np_params):
    """KV pressure with speculation on (8 pages, two rows of 40 tokens):
    the preempted stream resumes as a continuation and both streams are
    the reference engine's, which runs the same pressured burst."""
    kw = dict(spec_mode="ngram", num_pages=8, preempt_stall_grace_s=0.05)
    prompts = [REPEAT[:8], [9, 2, 9, 2, 9, 2, 9, 5]]
    sos = [{}, dict(temperature=0.9, seed=99)]

    async def burst(eng):
        return await asyncio.gather(*(_collect(eng, p, 40, **so) for p, so in zip(prompts, sos)))

    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", **{**ENGINE_KW, **kw}),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )
    try:
        want = _run(burst(jeng))
    finally:
        jeng.stop()
    eng = _engine(np_params, **kw)
    try:
        got = _run(burst(eng))
        assert eng.preempted > 0 and eng.spec_row_dispatches > 0
    finally:
        eng.stop()
    assert got == want
    assert all(len(t) == 40 and f == "length" for t, f in got)


@pytest.mark.parametrize("spec_mode", ["off", "ngram"])
def test_penalized_resume_equals_tpu_engine(np_params, spec_mode):
    """A penalized continuation (the journal of a penalized run
    re-prefilled with ``resume_offset``, as failover and preemption
    build it) rebuilds its penalty counts and streams the reference
    engine's tokens, with speculation off and on, chained windows on."""
    so = dict(temperature=0.8, seed=31, presence_penalty=1.5, frequency_penalty=0.5)

    async def resume(eng):
        first, _ = await _collect(eng, REPEAT, 10, **so)
        stream = await eng.generate({
            "token_ids": REPEAT + first[:6], "resume_offset": 6,
            "stop_conditions": {"max_tokens": 14, "ignore_eos": True},
            "sampling_options": so,
        })
        rest = [t async for item in stream for t in item.get("token_ids", [])]
        return first, rest

    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", spec_mode=spec_mode, **ENGINE_KW),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )
    try:
        want = _run(resume(jeng))
    finally:
        jeng.stop()
    eng = _engine(np_params, spec_mode=spec_mode, attention_impl="kernel")
    try:
        assert _run(resume(eng)) == want
    finally:
        eng.stop()
