"""Port parity: the PyTorch model's logits against the JAX package's.

The same float32 weights (JAX init, norms and biases perturbed with
numpy noise so every weight matters) go through ``params_from_jax`` into
the port; the same token streams go through both packages' ``forward``
(prefill chunk, then a T=1 decode step) and ``forward_ragged`` (a mixed
flat stream). Both run float32 on the CPU, so the only differences are
summation order: logits agree to atol=1e-4.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import TINY, TINY_QWEN2, TINY_QWEN3
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu_torch.models import convert, llama as tllama
from dynamo_exp_tpu_torch.models.config import PRESETS as T_PRESETS

ATOL = 1e-4
PS = 8


def _params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    layers = params["layers"]
    for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        if name in layers:
            layers[name] = (
                layers[name] + 0.1 * rs.standard_normal(layers[name].shape)
            ).astype(np.float32)
    params["final_norm"] = (
        params["final_norm"] + 0.1 * rs.standard_normal(params["final_norm"].shape)
    ).astype(np.float32)
    return params


def _both(cfg):
    np_params = _params(cfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = convert.params_from_jax(np_params, cfg, device="cpu")
    jk, jv = jllama.init_kv_cache(cfg, 16, PS, dtype=jnp.float32)
    tk, tv = tllama.init_kv_cache(cfg, 16, PS, torch.float32, device="cpu")
    return jparams, model, (jk, jv), (tk, tv)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


CFGS = [
    replace(TINY, dtype="float32"),
    replace(TINY_QWEN2, dtype="float32"),
    replace(TINY_QWEN3, dtype="float32"),
]


@pytest.mark.parametrize("cfg", CFGS, ids=["llama", "qwen2", "qwen3"])
def test_forward_prefill_then_decode_logits_match(cfg):
    jparams, model, (jk, jv), (tk, tv) = _both(cfg)
    rs = np.random.RandomState(1)
    table = np.array([[3, 5, 7, 9], [2, 4, 6, 8]], np.int32)
    lens = [11, 7]
    T = max(lens)
    tokens = np.zeros((2, T), np.int32)
    positions = np.full((2, T), -1, np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rs.randint(1, cfg.vocab_size, size=n)
        positions[b, :n] = np.arange(n)
    jl, jk, jv = jllama.forward(
        jparams, cfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(table), jk, jv,
    )
    tl, tk, tv = tllama.forward(
        model, cfg, _t(tokens), _t(positions), _t(table, torch.int32), tk, tv,
    )
    live = positions >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)

    # One decode step at T=1, through the plain path and the kernel
    # wrapper (which computes the plain version on a CPU tensor).
    nxt = np.array([[5], [9]], np.int32)
    pos = np.array([[11], [7]], np.int32)
    jl2, _, _ = jllama.forward(
        jparams, cfg, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(table), jk, jv
    )
    for impl in ("reference", "kernel"):
        k2, v2 = tk.clone(), tv.clone()
        tl2, _, _ = tllama.forward(
            model, cfg, _t(nxt), _t(pos), _t(table, torch.int32), k2, v2,
            attn_impl=impl,
        )
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


@pytest.mark.parametrize("cfg", CFGS, ids=["llama", "qwen2", "qwen3"])
def test_forward_ragged_logits_match(cfg):
    """A mixed flat stream: row 0 prefills 13 tokens, row 1 feeds a
    5-token chunk after a 6-token prefix, row 2 one decode token."""
    jparams, model, (jk, jv), (tk, tv) = _both(cfg)
    rs = np.random.RandomState(2)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    # Prefix for rows 1 and 2 written by a first ragged pass.
    spans0 = [(1, 6, 0), (2, 20, 0)]  # (row, n tokens, start pos)
    spans1 = [(0, 13, 0), (1, 5, 6), (2, 1, 20)]

    def stream(spans, align):
        toks, poss, rows, last = [], [], [], []
        for r, n, s in spans:
            toks += list(rs.randint(1, cfg.vocab_size, size=n))
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
            jparams, cfg, *(jnp.asarray(a) for a in (toks, poss, rows)),
            jnp.asarray(table), jk, jv, jnp.asarray(last),
        )
        want = np.asarray(jl)
        k_ref = tk.clone(), tv.clone()
        tl, tk, tv = tllama.forward_ragged(
            model, cfg, _t(toks), _t(poss, torch.int32), _t(rows, torch.int32),
            _t(table, torch.int32), tk, tv, _t(last),
        )
        np.testing.assert_allclose(tl.numpy(), want, atol=ATOL)
        # The kernel's q_tile-aligned layout of the same stream (the
        # wrapper's CPU path) projects the same logits.
        rs.set_state(state)
        toks8, poss8, rows8, last8 = stream(spans, 8)
        k8, v8 = k_ref
        tl8, _, _ = tllama.forward_ragged(
            model, cfg, _t(toks8), _t(poss8, torch.int32), _t(rows8, torch.int32),
            _t(table, torch.int32), k8, v8, _t(last8), attn_impl="kernel", q_tile=8,
        )
        np.testing.assert_allclose(tl8.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_forward_kernel_takes_single_token_steps_only():
    """The kernel (asked for, or ``auto`` on CUDA) has no multi-token
    ``forward`` path: T>1 raises instead of quietly running the plain
    attention; ``auto`` on the CPU is the plain version at any T."""
    cfg = CFGS[0]
    _, model, _, (tk, tv) = _both(cfg)
    table = _t([[1, 2, 3, 4]], torch.int32)
    toks, pos = _t([[5, 6, 7]]), _t([[0, 1, 2]])
    with pytest.raises(ValueError, match="T=1"):
        tllama.forward(model, cfg, toks, pos, table, tk, tv, attn_impl="kernel")
    with pytest.raises(ValueError, match="attn_impl"):
        tllama.forward(model, cfg, toks, pos, table, tk, tv, attn_impl="xla")
    assert tllama.resolve_attn("auto", torch.device("cpu")) == "reference"
    assert tllama.resolve_attn("auto", torch.device("cuda", 0)) == "kernel"
    auto, _, _ = tllama.forward(model, cfg, toks, pos, table, tk.clone(), tv.clone())
    ref, _, _ = tllama.forward(
        model, cfg, toks, pos, table, tk.clone(), tv.clone(), attn_impl="reference"
    )
    torch.testing.assert_close(auto, ref, atol=0, rtol=0)


def test_params_from_jax_transposes_to_out_in_layout():
    cfg = CFGS[0]
    np_params = _params(cfg)
    model = convert.params_from_jax(np_params, cfg, device="cpu")
    np.testing.assert_array_equal(
        model.layers[1].wq.numpy(), np_params["layers"]["wq"][1].T
    )
    np.testing.assert_array_equal(model.lm_head.numpy(), np_params["lm_head"].T)
    assert model.layers[0].w_down.shape == (cfg.hidden_size, cfg.intermediate_size)


@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-8x7b"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllama.Llama(T_PRESETS[name], device="meta")
