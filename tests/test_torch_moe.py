"""Port parity for the sparse-MoE FFN and the three MoE families.

``ops/moe.py``'s ``moe_router`` and ``moe_ffn`` against the JAX
package's ``moe_ffn`` and ``moe_ffn_reference`` on the same numpy inputs
from a seed: float32 within atol 1e-5 (the same products summed in
another order), bf16 within two bf16 ulps of the output's scale (both
round the expert products to bf16 at the same points and sum the
replicas in float32). Cases: several expert counts and top-k, with and
without renormalisation, one token, one expert taking every token, and
experts no token picks.

A MoE checkpoint of the mixtral, qwen3_moe and qwen2_moe families
(tiny widths, from HF ``config.json`` dicts both packages read alike),
written by the port under the HF names, reads back through both
packages' loaders to the same weights. The families' forward and engine
parity is in ``tests/test_torch_moe_families.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models import loader as jloader
from dynamo_exp_tpu.models.config import ModelConfig as JConfig
from dynamo_exp_tpu.ops import moe as jmoe
from dynamo_exp_tpu_torch.models import convert, loader as tloader
from dynamo_exp_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_exp_tpu_torch.ops import launches as tlaunches
from dynamo_exp_tpu_torch.ops import moe as tmoe

_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512, torch_dtype="float32",
             num_hidden_layers=2)
HF_CONFIGS = {
    "mixtral": {**_TINY, "model_type": "mixtral", "num_local_experts": 4,
                "num_experts_per_tok": 2, "rope_theta": 1000000.0},
    "qwen3_moe": {**_TINY, "model_type": "qwen3_moe", "num_experts": 8,
                  "num_experts_per_tok": 4, "moe_intermediate_size": 48,
                  "norm_topk_prob": True, "head_dim": 16},
    "qwen2_moe": {**_TINY, "model_type": "qwen2_moe", "num_experts": 6,
                  "num_experts_per_tok": 3, "moe_intermediate_size": 40,
                  "norm_topk_prob": False, "shared_expert_intermediate_size": 96},
}
FAMILIES = sorted(HF_CONFIGS)

# (E, K, norm_topk_prob, N, routing)
CASES = [
    (4, 2, True, 13, "random"),
    (8, 2, True, 1, "random"),
    (8, 4, False, 9, "random"),
    (6, 3, True, 7, "skewed"),
    (16, 2, False, 3, "random"),
    (5, 1, True, 6, "random"),
]


def _moe_inputs(E, K, N, routing, seed=0, D=32, I=24):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((N, D)).astype(np.float32)
    router = (rs.standard_normal((D, E)) * D**-0.5).astype(np.float32)  # JAX [D, E]
    if routing == "skewed":
        # Every token's largest logit is expert 2's by a wide margin.
        x[:, 0] = 3.0
        router[0, 2] = 3.0
    wg = (rs.standard_normal((E, D, I)) * D**-0.5).astype(np.float32)
    wu = (rs.standard_normal((E, D, I)) * D**-0.5).astype(np.float32)
    wd = (rs.standard_normal((E, I, D)) * I**-0.5).astype(np.float32)
    return x, router, wg, wu, wd


def _port_args(x, router, wg, wu, wd, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return (t(x), t(router.T), t(wg.transpose(0, 2, 1)), t(wu.transpose(0, 2, 1)),
            t(wd.transpose(0, 2, 1)))


@pytest.mark.parametrize("E,K,norm,N,routing", CASES,
                         ids=[f"E{c[0]}-K{c[1]}-{'norm' if c[2] else 'raw'}-N{c[3]}-{c[4]}"
                              for c in CASES])
def test_moe_ffn_matches_jax(E, K, norm, N, routing):
    ins = _moe_inputs(E, K, N, routing)
    jx = [jnp.asarray(a) for a in ins]
    jw, jids = jmoe.moe_router(jx[0], jx[1], K, norm)
    targs = _port_args(*ins, torch.float32)
    tw, tids = tmoe.moe_router(targs[0], targs[1], K, norm)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    if routing == "skewed":
        assert (tids[:, 0] == 2).all()
    if E > N * K:
        assert len(set(tids.reshape(-1).tolist())) < E  # some experts take no token
    want = np.asarray(jmoe.moe_ffn(*jx, K, norm))
    np.testing.assert_allclose(np.asarray(jmoe.moe_ffn_reference(*jx, K, norm)), want,
                               atol=1e-5)
    got = tmoe.moe_ffn(*targs, K, norm)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tmoe.moe_ffn_reference(*targs, K, norm).numpy(), want,
                               atol=1e-5)
    # bf16: the same inputs rounded, through both packages.
    jb = [jnp.asarray(a, jnp.bfloat16) for a in ins]
    want_b = np.asarray(jmoe.moe_ffn(*jb, K, norm).astype(jnp.float32))
    got_b = tmoe.moe_ffn(*_port_args(*ins, torch.bfloat16), K, norm).float().numpy()
    scale = np.abs(want_b).max()
    np.testing.assert_allclose(got_b, want_b, atol=2 * 2**-8 * scale)
    assert tmoe.LAUNCHES["grouped_mm"] == 0  # the CPU path launches nothing


def test_grouped_linear_plain_version_is_the_per_expert_product():
    rs = np.random.RandomState(3)
    w = torch.from_numpy(rs.standard_normal((4, 5, 6)).astype(np.float32))
    xs = torch.from_numpy(rs.standard_normal((7, 6)).astype(np.float32))
    counts = torch.tensor([3, 0, 4, 0], dtype=torch.int32)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    out = tmoe.grouped_linear(xs, w, counts, ends)
    np.testing.assert_allclose(out[:3].numpy(), (xs[:3] @ w[0].T).numpy(), atol=1e-6)
    np.testing.assert_allclose(out[3:].numpy(), (xs[3:] @ w[2].T).numpy(), atol=1e-6)
    with tlaunches.record() as rec:
        tmoe.grouped_linear(xs, w, counts, ends)
    assert rec["moe"] == {"grouped_mm": 0}


def _cfgs(family):
    hf = HF_CONFIGS[family]
    return JConfig.from_hf_config(hf), TConfig.from_hf_config(hf)


def _params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    layers = params["layers"]
    for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        if name in layers:
            layers[name] = (
                layers[name] + 0.1 * rs.standard_normal(layers[name].shape)
            ).astype(np.float32)
    return params


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_checkpoint_round_trips_through_both_loaders(tmp_path, family):
    """The port writes a MoE model under the HF names (each expert its
    own tensors; qwen2_moe's shared-expert gate ``[1, D]``); its loader
    reads back the same bits, and the JAX loader's parameters carried
    over by ``convert`` are the same weights."""
    jcfg, tcfg = _cfgs(family)
    hf = dict(HF_CONFIGS[family], torch_dtype="bfloat16")
    (tmp_path / "config.json").write_text(json.dumps(hf))
    tcfg = TConfig.from_hf_config(hf)
    written = convert.params_from_jax(_params(jcfg, seed=5), tcfg, device="cpu")
    names = tloader.hf_tensor_names(tcfg)
    if family == "mixtral":
        assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in names
    else:
        assert "model.layers.1.mlp.experts.0.down_proj.weight" in names
    tensors = {n: tloader.model_tensor(written, li, a) for n, (li, a) in names.items()}
    if family == "qwen2_moe":
        assert tensors["model.layers.0.mlp.shared_expert_gate.weight"].shape == (
            1, tcfg.hidden_size)
    half = len(tensors) // 2
    items = sorted(tensors.items())
    tloader.save_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"),
                             dict(items[:half]))
    tloader.save_safetensors(str(tmp_path / "model-00002-of-00002.safetensors"),
                             dict(items[half:]))
    back, cfg = tloader.load_params(str(tmp_path), device="cpu")
    assert cfg.model_type == family
    for (n, a), (_, b) in zip(written.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), n
    jparams, _ = jloader.load_params(str(tmp_path), JConfig.from_hf_config(hf))
    carried = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for (n, a), (_, b) in zip(back.state_dict().items(), carried.state_dict().items()):
        assert torch.equal(a, b), n
