"""Port parity for the gemma, gemma2, gemma3, windowed mistral and phi3
families: the PyTorch model's logits against the JAX package's.

Each family's config comes from one HF ``config.json`` dict read by both
packages' ``ModelConfig.from_hf_config`` (which must agree), cut to a
few layers of narrow width: gemma at head dim 256 with one kv head;
gemma2 with a window shorter than the streams on its even layers, both
softcaps small enough to bite and a ``query_pre_attn_scalar`` other than
the head dim; gemma3 with a 5:1 ``layer_types`` pattern, q/k norms and a
local rope base; mistral and phi3 with a window on every layer. The same
float32 weights (JAX init, every norm perturbed with numpy noise,
including the post norms and q/k norms) go through ``params_from_jax``
into the port, and the same token streams through both packages'
``forward`` (a prefill chunk, then a T=1 decode step) and
``forward_ragged`` (a mixed flat stream, also in the kernel's q-tile
layout). Both run float32 on the CPU, so the only differences are
summation order: logits agree to atol=1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models.config import ModelConfig as JConfig
from dynamo_exp_tpu_torch.models import convert, llama as tllama
from dynamo_exp_tpu_torch.models.config import ModelConfig as TConfig

ATOL = 1e-4
PS = 8
_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512, torch_dtype="float32")
_GEMMA = dict(hidden_activation="gelu_pytorch_tanh", rms_norm_eps=1e-6,
              tie_word_embeddings=True)
HF_CONFIGS = {
    "gemma": {**_TINY, **_GEMMA, "model_type": "gemma", "num_hidden_layers": 2,
              "num_key_value_heads": 1, "head_dim": 256},
    "gemma2": {**_TINY, **_GEMMA, "model_type": "gemma2", "num_hidden_layers": 4,
               "head_dim": 32, "sliding_window": 5, "attn_logit_softcapping": 2.0,
               "final_logit_softcapping": 3.0, "query_pre_attn_scalar": 20},
    "gemma3_text": {**_TINY, **_GEMMA, "model_type": "gemma3_text", "num_hidden_layers": 6,
                    "head_dim": 32, "sliding_window": 4, "query_pre_attn_scalar": 32,
                    "layer_types": ["sliding_attention"] * 5 + ["full_attention"],
                    "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0},
    "mistral": {**_TINY, "model_type": "mistral", "num_hidden_layers": 2,
                "sliding_window": 5, "rope_theta": 1000000.0},
    "phi3": {**_TINY, "model_type": "phi3", "num_hidden_layers": 2, "sliding_window": 6,
             "hidden_act": "silu", "rms_norm_eps": 1e-5},
}
FAMILIES = sorted(HF_CONFIGS)


def _cfgs(family):
    hf = HF_CONFIGS[family]
    return JConfig.from_hf_config(hf), TConfig.from_hf_config(hf)


def _params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    layers = params["layers"]
    for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "post_attn_norm",
                 "post_ffn_norm", "bq", "bk", "bv"):
        if name in layers:
            layers[name] = (
                layers[name] + 0.1 * rs.standard_normal(layers[name].shape)
            ).astype(np.float32)
    params["final_norm"] = (
        params["final_norm"] + 0.1 * rs.standard_normal(params["final_norm"].shape)
    ).astype(np.float32)
    return params


def _both(family):
    jcfg, tcfg = _cfgs(family)
    np_params = _params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = convert.params_from_jax(np_params, tcfg, device="cpu")
    jk, jv = jllama.init_kv_cache(jcfg, 16, PS, dtype=jnp.float32)
    tk, tv = tllama.init_kv_cache(tcfg, 16, PS, torch.float32, device="cpu")
    return jcfg, tcfg, jparams, model, (jk, jv), (tk, tv)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_read_like_the_jax_package(family):
    jcfg, tcfg = _cfgs(family)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_gemma3_sliding_window_pattern_reads_like_the_jax_package():
    """Older gemma3 configs give ``sliding_window_pattern`` (every 6th
    layer full), not ``layer_types``."""
    hf = {k: v for k, v in HF_CONFIGS["gemma3_text"].items() if k != "layer_types"}
    hf.update(sliding_window_pattern=6, num_hidden_layers=12)
    jcfg, tcfg = JConfig.from_hf_config(hf), TConfig.from_hf_config(hf)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.layer_types.count("full_attention") == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_prefill_then_decode_logits_match(family):
    jcfg, tcfg, jparams, model, (jk, jv), (tk, tv) = _both(family)
    rs = np.random.RandomState(1)
    table = np.array([[3, 5, 7, 9], [2, 4, 6, 8]], np.int32)
    lens = [11, 7]
    T = max(lens)
    tokens = np.zeros((2, T), np.int32)
    positions = np.full((2, T), -1, np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rs.randint(1, jcfg.vocab_size, size=n)
        positions[b, :n] = np.arange(n)
    jl, jk, jv = jllama.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(table),
        jk, jv,
    )
    tl, tk, tv = tllama.forward(
        model, tcfg, _t(tokens), _t(positions), _t(table, torch.int32), tk, tv,
    )
    live = positions >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)

    # A decode step past the window: the plain path and the decode
    # kernel's wrapper (the plain version on a CPU tensor).
    nxt = np.array([[5], [9]], np.int32)
    pos = np.array([[11], [7]], np.int32)
    jl2, _, _ = jllama.forward(
        jparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(table), jk, jv
    )
    for impl in ("reference", "kernel"):
        k2, v2 = tk.clone(), tv.clone()
        tl2, _, _ = tllama.forward(
            model, tcfg, _t(nxt), _t(pos), _t(table, torch.int32), k2, v2, attn_impl=impl,
        )
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_ragged_logits_match(family):
    """A mixed flat stream past the windows: row 0 prefills 13 tokens,
    row 1 feeds a 5-token chunk after a 6-token prefix, row 2 one decode
    token after 20."""
    jcfg, tcfg, jparams, model, (jk, jv), (tk, tv) = _both(family)
    rs = np.random.RandomState(2)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    spans0 = [(1, 6, 0), (2, 20, 0)]  # (row, n tokens, start pos)
    spans1 = [(0, 13, 0), (1, 5, 6), (2, 1, 20)]

    def stream(spans, align):
        toks, poss, rows, last = [], [], [], []
        for r, n, s in spans:
            toks += list(rs.randint(1, jcfg.vocab_size, size=n))
            poss += list(range(s, s + n))
            rows += [r] * n
            last.append(len(toks) - 1)
            pad = (-n) % align
            toks += [0] * pad
            poss += [-1] * pad
            rows += [r] * pad
        return [np.asarray(a, np.int32) for a in (toks, poss, rows, last)]

    for spans in (spans0, spans1):
        state = rs.get_state()
        toks, poss, rows, last = stream(spans, 1)
        jl, jk, jv = jllama.forward_ragged(
            jparams, jcfg, *(jnp.asarray(a) for a in (toks, poss, rows)),
            jnp.asarray(table), jk, jv, jnp.asarray(last),
        )
        want = np.asarray(jl)
        k8, v8 = tk.clone(), tv.clone()
        tl, tk, tv = tllama.forward_ragged(
            model, tcfg, _t(toks), _t(poss, torch.int32), _t(rows, torch.int32),
            _t(table, torch.int32), tk, tv, _t(last),
        )
        np.testing.assert_allclose(tl.numpy(), want, atol=ATOL)
        # The kernel wrapper's q_tile-aligned layout of the same stream.
        rs.set_state(state)
        toks8, poss8, rows8, last8 = stream(spans, 8)
        tl8, _, _ = tllama.forward_ragged(
            model, tcfg, _t(toks8), _t(poss8, torch.int32), _t(rows8, torch.int32),
            _t(table, torch.int32), k8, v8, _t(last8), attn_impl="kernel", q_tile=8,
        )
        np.testing.assert_allclose(tl8.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("family", ["gemma2", "gemma3_text"])
def test_family_bf16_embedding_scale_rounds_like_the_jax_package(family):
    """gemma multiplies the embeddings by sqrt(hidden) rounded to bf16
    (8.0 is exact at hidden 64; 3584's 59.866... rounds to 60.0), in
    bf16: the same bits as the JAX package's."""
    hf = dict(HF_CONFIGS[family], torch_dtype="bfloat16", hidden_size=3584,
              num_hidden_layers=1, layer_types=None)
    jcfg, tcfg = JConfig.from_hf_config(hf), TConfig.from_hf_config(hf)
    rs = np.random.RandomState(3)
    emb = rs.standard_normal((4, 3584)).astype(np.float32)
    want = np.asarray(jllama._maybe_scale_embeds(jcfg, jnp.asarray(emb, jnp.bfloat16)),
                      np.float32)
    model = tllama.Llama(tcfg, device="meta")
    model.embed = torch.nn.Parameter(torch.from_numpy(emb).bfloat16(), requires_grad=False)
    got = tllama._embed(model, tcfg, torch.arange(4)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_layer_attention_reads_windows_rope_bases_and_scale():
    """gemma2: window on even layers; gemma3: window and local rope base
    on the sliding layers; mistral: window everywhere; scale from
    ``query_pre_attn_scalar``."""
    _, g2 = _cfgs("gemma2")
    per = tllama._layer_attention(g2, "cpu")
    assert [w for _, w, _, _ in per] == [5, None, 5, None]
    assert all(c == 2.0 and s == 20**-0.5 for _, _, c, s in per)
    _, g3 = _cfgs("gemma3_text")
    per = tllama._layer_attention(g3, "cpu")
    assert [w for _, w, _, _ in per] == [4] * 5 + [None]
    local, full = per[0][0], per[5][0]
    torch.testing.assert_close(local[1], torch.tensor(10000.0 ** (-2 / 32)))
    torch.testing.assert_close(full[1], torch.tensor(1000000.0 ** (-2 / 32)))
    _, mi = _cfgs("mistral")
    assert [(w, c, s) for _, w, c, s in tllama._layer_attention(mi, "cpu")] == [
        (5, None, None)] * 2


@pytest.mark.parametrize("family", ["gemma2", "gemma3_text"])
def test_family_engine_tokens_identical_to_tpu_engine(family):
    """The slice as a whole: ``TorchEngine`` on the CPU (plain path and
    the kernel wrappers' plain versions) and the JAX package's
    ``TPUEngine`` on the same weights emit the same greedy tokens for
    staggered requests whose contexts run past the window, through
    chunked prefill, mixed dispatches and decode windows."""
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
    for impl in ("reference", "kernel"):
        teng = TorchEngine(EngineConfig(model=tcfg, attention_impl=impl, **ENGINE_KW),
                           model=convert.params_from_jax(np_params, tcfg, device="cpu"),
                           device="cpu")
        try:
            got = _run(_staggered(teng, prompts))
        finally:
            teng.stop()
        assert [g for g, _ in got] == [w for w, _ in want], impl
        assert all(f == "length" and len(g) == 10 for g, f in got)
        assert teng.dispatches["mixed"] > 0 and teng.dispatches["windowed"] > 0


def test_engine_resolves_the_kernels_for_every_dense_family_preset():
    """On a card, the engine's attention resolves to the kernels at
    gemma's head dim 256 (one kv head, and gemma2's 16 / 8), and at
    mistral's window, in both pool dtypes; a head dim the kernels do
    not take still raises, never falling back to the plain version."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.engine import EngineConfig, resolve_attn_impl
    from dynamo_exp_tpu_torch.models import GEMMA2_9B, GEMMA_2B, MISTRAL_7B

    cuda = torch.device("cuda", 0)  # resolving touches no device
    for mcfg in (GEMMA_2B, GEMMA2_9B, MISTRAL_7B):
        for kv in ("bfloat16", "float32"):
            assert resolve_attn_impl(EngineConfig(model=mcfg, kv_dtype=kv), cuda) == "kernel"
    with pytest.raises(ValueError, match="D=96"):
        resolve_attn_impl(EngineConfig(model=replace(GEMMA2_9B, head_dim=96)), cuda)
