"""Mixed dispatches on the JAX ragged lattice, on the CPU.

- (a) ``aot.lattice.resolve_mixed_key``'s token bucket is the JAX
  ``EngineConfig.ragged_tokens_bucket_for(n, mixed=True)`` for every
  stream length up to ``ragged_max_tokens``, over slot, chunk and draft
  settings.
- (b) ``build_manifest``'s mixed keys are the JAX ``ragged_variants(cfg,
  "pallas")`` non-windowed variants (explicit ``attention_impl="pallas"``,
  so no small-bucket downgrade) projected to (tokens, full sampler,
  logprobs, verify spans), with speculation off and on; on the kernel
  path the page bound leaves the key, as on the Pallas path.
- (c) One burst through ``TPUEngine`` and ``TorchEngine`` (float32 TINY,
  the same weights): prefill chunks with decode rows beside them,
  verify spans (``spec_mode="ngram"``), a seeded row and a logprobs row
  give equal tokens and logprobs. The port's plain path (``reference``,
  tight spans as the JAX engine's ``xla``) dispatches the JAX engine's
  mixed token buckets, key for key; with the kernel wrappers
  (q_tile-aligned spans) every mixed key it dispatches is in its
  manifest.
"""

import asyncio
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_exp_tpu.aot import lattice as jlattice
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch.aot import build_manifest, lattice
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import params_from_jax

CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
)
REPEAT = [5, 9, 17, 3] * 5  # the n-gram drafter finds its continuation
LONG = [7, 3, 19, 28, 41, 13, 6, 11, 44, 2, 9, 12, 60, 3, 3, 90] * 3  # three chunks
OTHER = [12, 60, 3, 3, 90, 21]
SEEDED = dict(temperature=0.9, top_p=0.9, seed=777)
# (slots, prefill chunk, widest draft, q_tile)
SETTINGS = [(1, 16, 8, 8), (3, 16, 4, 8), (4, 16, 8, 8), (8, 512, 8, 8), (6, 64, 31, 8),
            (2, 8, 8, 1)]


def _cfgs(slots, chunk, draft, q_tile, jax_impl="auto", **kw):
    kw = {**ENGINE_KW, "max_decode_slots": slots, "prefill_chunk": chunk,
          "spec_max_draft": draft, "ragged_q_tile": q_tile, **kw}
    return (EngineConfig(model=CFG, **kw),
            JEngineConfig(model=CFG, attention_impl=jax_impl, **kw))


@pytest.mark.parametrize("slots,chunk,draft,q_tile", SETTINGS)
def test_token_bucket_is_the_jax_mixed_bucket(slots, chunk, draft, q_tile):
    tcfg, jcfg = _cfgs(slots, chunk, draft, q_tile)
    top = lattice.ragged_max_tokens(tcfg)
    assert top == jcfg.ragged_max_tokens
    for n in range(1, top + 1):
        key = lattice.resolve_mixed_key(tcfg, "kernel", n, 1, False, False, False)
        assert key.tokens == jcfg.ragged_tokens_bucket_for(n, mixed=True), n
    with pytest.raises(ValueError, match="exceeds ragged_max_tokens"):
        lattice.resolve_mixed_key(tcfg, "kernel", top + 1, 1, False, False, False)


@pytest.mark.parametrize("spec_mode", ["off", "ngram"])
@pytest.mark.parametrize("slots,chunk,draft,q_tile", SETTINGS[2:4])
def test_manifest_mixed_keys_equal_the_jax_lattice(slots, chunk, draft, q_tile, spec_mode):
    tcfg, jcfg = _cfgs(slots, chunk, draft, q_tile, jax_impl="pallas", spec_mode=spec_mode)
    want = {
        (v.nb, v.full_sampler, v.want_lp, v.with_spec)
        for v in jlattice.ragged_variants(jcfg, "pallas") if not v.windowed
    }
    mixed = build_manifest(tcfg, "kernel").mixed
    assert all(k.pages is None for k in mixed)
    got = [(k.tokens, k.full_sampler, k.want_lp, k.with_spec) for k in mixed]
    assert len(got) == len(set(got)) and set(got) == want
    assert any(k.with_spec for k in mixed) == (spec_mode != "off")
    # The plain version reads a page bound: the window page buckets.
    plain = build_manifest(tcfg, "reference").mixed
    assert {k.pages for k in plain} == set(lattice.page_bound_buckets(tcfg))
    assert len(plain) == len(mixed) * len(lattice.page_bound_buckets(tcfg))


def test_manifest_lists_40_or_80_mixed_keys_at_the_smoke_shape():
    """The smoke's llama-8b engine: 8 slots, chunk 512, q_tile 8: ten
    buckets 16..8192, 40 mixed keys without speculation, 80 with it,
    beside 112 window keys."""
    from dynamo_exp_tpu_torch.models import LLAMA_8B

    for spec_mode, n in (("off", 40), ("ngram", 80)):
        cfg = EngineConfig(model=LLAMA_8B, max_decode_slots=8, page_size=16,
                           max_model_len=2192, num_pages=1096, spec_mode=spec_mode)
        m = build_manifest(cfg, "kernel")
        assert sorted({k.tokens for k in m.mixed}) == [16 << i for i in range(10)]
        assert (len(m.mixed), len(m.windows)) == (n, 112)


# ------------------------------------------------- (c) the same burst
@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))


async def _collect(eng, prompt, n, **sampling):
    stream = await eng.generate({
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": n, "ignore_eos": True},
        "sampling_options": sampling,
    })
    tokens, lps = [], []
    async for item in stream:
        tokens.extend(item.get("token_ids", []))
        lps.extend(item.get("logprobs") or [])
    return tokens, lps


async def _burst(eng):
    """A greedy row whose stream the n-gram drafter predicts (verify
    spans), a seeded row, and a three-chunk prompt asking for logprobs
    that prefills while the others decode. All three are queued before
    the loop starts (``generate`` starts no loop while ``_running`` is
    set), so both engines admit them together and schedule alike."""
    eng._running = True
    jobs = [asyncio.ensure_future(c) for c in (
        _collect(eng, REPEAT, 16), _collect(eng, OTHER, 16, **SEEDED),
        _collect(eng, LONG, 12, logprobs=2),
    )]
    await asyncio.sleep(0)
    eng._running = False
    eng.start()
    return await asyncio.gather(*jobs)


def _port_run(np_params, impl):
    cfg = EngineConfig(model=CFG, attention_impl=impl, spec_mode="ngram", **ENGINE_KW)
    eng = TorchEngine(cfg, model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")
    keys, launch = [], eng._launch_mixed

    def spy(key, host):
        keys.append(key)
        return launch(key, host)

    eng._launch_mixed = spy
    try:
        out = asyncio.run(asyncio.wait_for(_burst(eng), 300))
    finally:
        eng.stop()
    return out, keys, eng


def test_burst_equals_tpu_engine_on_the_jax_buckets(np_params):
    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", spec_mode="ngram", **ENGINE_KW),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )
    jkeys, ragged_fn = [], jeng._ragged_fn

    def spy(nb, pages, windowed, full_sampler, want_lp, with_spec=False):
        if not windowed:
            jkeys.append((nb, full_sampler, want_lp, with_spec))
        return ragged_fn(nb, pages, windowed, full_sampler, want_lp, with_spec)

    jeng._ragged_fn = spy
    try:
        want = asyncio.run(asyncio.wait_for(_burst(jeng), 300))
        assert jeng.spec_accepted_tokens > 0
    finally:
        jeng.stop()
    assert [len(t) for t, _ in want] == [16, 16, 12] and len(want[2][1]) == 12
    for impl in ("reference", "kernel"):
        got, keys, eng = _port_run(np_params, impl)
        assert [t for t, _ in got] == [t for t, _ in want], impl
        for (_, lps), (_, wlps) in zip(got, want):
            np.testing.assert_allclose(lps, wlps, atol=1e-5)
        m = eng.metrics()
        assert m["spec_row_dispatches"] > 0 and m["dispatches"]["mixed"] == len(keys)
        assert any(k.with_spec for k in keys) and any(k.want_lp for k in keys)
        assert any(k.full_sampler for k in keys)
        assert set(keys) <= set(build_manifest(eng.cfg, eng.attn_impl).mixed), impl
        if impl == "reference":
            # Tight spans on both sides: the same dispatches, the same
            # mixed buckets and variant keys, one for one.
            assert [(k.tokens, k.full_sampler, k.want_lp, k.with_spec) for k in keys] == jkeys
        else:
            assert {k.pages for k in keys} == {None}
