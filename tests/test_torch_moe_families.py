"""Port parity for the mixtral, qwen3_moe and qwen2_moe families.

Each family's config comes from one HF ``config.json`` dict
(``tests/test_torch_moe.py``'s ``HF_CONFIGS``: tiny widths, several
experts, top-k with and without renormalisation, qwen2_moe's shared
expert) read by both packages' ``ModelConfig.from_hf_config``, which
must agree. The same float32 weights (JAX init, norms and biases
perturbed with numpy noise) go through ``params_from_jax`` into the
port: the logits and KV of both forward shapes agree with the JAX
package's within atol 1e-4 (float32 on the CPU: summation order only),
and ``TorchEngine`` emits the JAX ``TPUEngine``'s greedy tokens through
chunked prefill, mixed dispatches and decode windows, and the same
tokens with speculation's verify spans as without.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models.config import TINY_MOE as J_TINY_MOE
from dynamo_exp_tpu_torch.models import convert, llama as tllama
from dynamo_exp_tpu_torch.models.config import TINY_MOE as T_TINY_MOE
from tests.test_torch_moe import FAMILIES, _cfgs, _params

ATOL = 1e-4
PS = 8


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_configs_read_like_the_jax_package(family):
    jcfg, tcfg = _cfgs(family)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.is_moe
    assert dataclasses.asdict(T_TINY_MOE) == dataclasses.asdict(J_TINY_MOE)


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_family_logits_match_both_forward_shapes(family):
    """A prefill of two rows then a decode step (``forward``), and a
    mixed flat stream (``forward_ragged``): the port's logits and KV are
    the JAX package's."""
    jcfg, tcfg = _cfgs(family)
    np_params = _params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = convert.params_from_jax(np_params, tcfg, device="cpu")
    layer = model.layers[0]
    E, Ie = tcfg.num_experts, tcfg.expert_intermediate_size
    assert layer.w_gate.shape == (E, Ie, tcfg.hidden_size)
    assert layer.w_down.shape == (E, tcfg.hidden_size, Ie)
    assert (layer.shared_router is not None) == (family == "qwen2_moe")
    jk, jv = jllama.init_kv_cache(jcfg, 16, PS, dtype=jnp.float32)
    tk, tv = tllama.init_kv_cache(tcfg, 16, PS, torch.float32, device="cpu")
    rs = np.random.RandomState(1)
    table = np.array([[3, 5, 7, 9], [2, 4, 6, 8]], np.int32)
    tokens = np.zeros((2, 11), np.int32)
    positions = np.full((2, 11), -1, np.int32)
    for b, n in enumerate((11, 7)):
        tokens[b, :n] = rs.randint(1, jcfg.vocab_size, size=n)
        positions[b, :n] = np.arange(n)
    jl, jk, jv = jllama.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                jnp.asarray(table), jk, jv)
    tl, tk, tv = tllama.forward(model, tcfg, _t(tokens), _t(positions),
                                _t(table, torch.int32), tk, tv)
    live = positions >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    # A mixed stream: row 0 decodes one token at 11, row 1 feeds 4 more.
    toks = np.asarray(list(rs.randint(1, jcfg.vocab_size, size=5)), np.int32)
    poss = np.asarray([11, 7, 8, 9, 10], np.int32)
    rows = np.asarray([0, 1, 1, 1, 1], np.int32)
    last = np.asarray([0, 4], np.int32)
    jl2, _, jv = jllama.forward_ragged(jparams, jcfg, *(jnp.asarray(a) for a in (toks, poss, rows)),
                                       jnp.asarray(table), jk, jv, jnp.asarray(last))
    tl2, _, tv = tllama.forward_ragged(model, tcfg, _t(toks), _t(poss, torch.int32),
                                       _t(rows, torch.int32), _t(table, torch.int32), tk, tv,
                                       _t(last))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_family_engine_tokens_identical_to_tpu_engine(family):
    """The slice as a whole on the CPU: ``TorchEngine`` and the JAX
    ``TPUEngine`` on the same float32 weights emit the same greedy
    tokens for staggered requests (chunked prefill, mixed dispatches,
    decode windows)."""
    from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
    from dynamo_exp_tpu.engine import TPUEngine
    from dynamo_exp_tpu.parallel import single_device_mesh
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
    from tests.test_torch_engine import ENGINE_KW, _prompts, _run, _staggered

    jcfg, tcfg = _cfgs(family)
    np_params = _params(jcfg)
    prompts = _prompts()
    jeng = TPUEngine(JEngineConfig(model=jcfg, attention_impl="xla", **ENGINE_KW),
                     params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh())
    try:
        want = _run(_staggered(jeng, prompts))
    finally:
        jeng.stop()
    teng = TorchEngine(EngineConfig(model=tcfg, **ENGINE_KW),
                       model=convert.params_from_jax(np_params, tcfg, device="cpu"),
                       device="cpu")
    try:
        got = _run(_staggered(teng, prompts))
    finally:
        teng.stop()
    assert [g for g, _ in got] == [w for w, _ in want]
    assert all(f == "length" and len(g) == 10 for g, f in got)
    assert teng.dispatches["mixed"] > 0 and teng.dispatches["windowed"] > 0


def test_moe_layers_under_speculation_verify_spans():
    """Speculation's verify spans (a row's last token and its drafts in
    one mixed dispatch) run the MoE layers too: drafts of the row's own
    continuation, every third one's last draft wrong (the spec tests'
    oracle), give the tokens decoded without speculation (float32,
    qwen2_moe with its shared expert)."""
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
    from tests.test_torch_engine import ENGINE_KW, _collect, _run
    from tests.test_torch_spec import _Oracle

    jcfg, tcfg = _cfgs("qwen2_moe")
    model = convert.params_from_jax(_params(jcfg), tcfg, device="cpu")
    prompt = [int(t) for t in np.random.RandomState(5).randint(3, 250, size=12)]
    out = {}
    for mode in ("off", "ngram"):
        eng = TorchEngine(EngineConfig(model=tcfg, spec_mode=mode, **ENGINE_KW), model=model,
                          device="cpu")
        if mode == "ngram":
            eng._spec.drafter = _Oracle(prompt, out["off"][0])
        try:
            out[mode] = _run(_collect(eng, prompt, 16))
        finally:
            eng.stop()
        if mode == "ngram":
            assert eng.spec_row_dispatches > 0 and eng.metrics()["spec_accepted_tokens"] > 0
    assert out["ngram"] == out["off"] and out["off"][1] == "length"
