"""The port's GGUF reader and loader against the JAX package's, on the CPU.

Both packages read the same files, written from JAX-initialised weights
as llama.cpp lays them out (the JAX tests' recipe,
``tests/test_hub_gguf.py``: ``[out, in]`` weights, q/k rope-permuted for
the llama architecture, stacked ``ffn_*_exps`` experts for mixtral):

- metadata equal to the JAX ``GGUFFile``'s, and every tensor of all four
  encodings (F32, F16, BF16, Q8_0) decoded bit-equal to its float32;
- ``config_from_gguf`` equal field by field for llama, qwen2 with QKV
  bias, qwen3 with ``attention.key_length`` and the mixtral experts;
- the port's model from ``load_params_from_gguf`` gives the logits of
  the JAX ``load_params_from_gguf`` through the JAX forward, at float32
  within atol 1e-4: a dense llama file in Q8_0 / F16 / BF16 / F32, a
  qwen2 file with biases (not un-permuted) and a mixtral file;
- an unknown quantisation and a tensor of the wrong shape are refused.
"""

import dataclasses
import struct
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import TINY, TINY_MOE, TINY_QWEN2
from dynamo_exp_tpu.models import gguf as jgguf
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu_torch.models import gguf as tgguf
from dynamo_exp_tpu_torch.models import llama as tllama

import chip_smoke as cs

PS = 8


def gguf_tensors(cfg, params, arch: str) -> dict[str, np.ndarray]:
    """JAX parameters as a GGUF's float32 tensors (llama.cpp's layout)."""
    hd = cfg.head_dim_

    def permute(w, heads):
        if arch != "llama":
            return w
        out, inner = w.shape
        return w.reshape(heads, 2, hd // 2, inner).swapaxes(1, 2).reshape(out, inner)

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    lp = params["layers"]
    t = {"token_embd.weight": f32(params["embed"]),
         "output_norm.weight": f32(params["final_norm"])}
    if "lm_head" in params:
        t["output.weight"] = f32(params["lm_head"]).T
    for i in range(cfg.num_layers):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = f32(lp["attn_norm"][i])
        t[p + "attn_q.weight"] = permute(f32(lp["wq"][i]).T, cfg.num_heads)
        t[p + "attn_k.weight"] = permute(f32(lp["wk"][i]).T, cfg.num_kv_heads)
        t[p + "attn_v.weight"] = f32(lp["wv"][i]).T
        t[p + "attn_output.weight"] = f32(lp["wo"][i]).T
        t[p + "ffn_norm.weight"] = f32(lp["mlp_norm"][i])
        if cfg.attention_bias:
            for b in ("q", "k", "v"):
                t[p + f"attn_{b}.bias"] = f32(lp[f"b{b}"][i])
        if cfg.is_moe:
            t[p + "ffn_gate_inp.weight"] = f32(lp["router"][i]).T
            for name, key in (("gate", "w_gate"), ("up", "w_up"), ("down", "w_down")):
                t[p + f"ffn_{name}_exps.weight"] = f32(lp[key][i]).swapaxes(1, 2)
        else:
            for name, key in (("gate", "w_gate"), ("up", "w_up"), ("down", "w_down")):
                t[p + f"ffn_{name}.weight"] = f32(lp[key][i]).T
    return t


def gguf_metadata(cfg, arch: str) -> dict:
    a = arch
    md = {
        "general.architecture": a, f"{a}.embedding_length": cfg.hidden_size,
        f"{a}.block_count": cfg.num_layers, f"{a}.attention.head_count": cfg.num_heads,
        f"{a}.attention.head_count_kv": cfg.num_kv_heads,
        f"{a}.feed_forward_length": cfg.intermediate_size,
        f"{a}.rope.dimension_count": cfg.head_dim_, f"{a}.rope.freq_base": cfg.rope_theta,
        f"{a}.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
        f"{a}.context_length": cfg.max_position_embeddings, f"{a}.vocab_size": cfg.vocab_size,
    }
    if cfg.is_moe:
        md[f"{a}.expert_count"] = cfg.num_experts
        md[f"{a}.expert_used_count"] = cfg.num_experts_per_tok
    return md


def encode_mixed(tensors: dict[str, np.ndarray]) -> dict:
    """The smoke's encodings: 2-D weights Q8_0, norms and biases F32,
    ``token_embd`` F16, ``output`` BF16."""
    out = {}
    for name, a in tensors.items():
        w = torch.from_numpy(np.array(a))
        if name == "token_embd.weight":
            out[name] = cs.gguf_encode(torch, w, "F16")[0]
        elif name == "output.weight":
            out[name] = cs.gguf_encode(torch, w, "BF16")[0]
        elif a.ndim >= 2:
            out[name] = cs.gguf_encode(torch, w, "Q8_0")[0]
        else:
            out[name] = a
    return out


def write_model(tmp_path, cfg, arch, seed, mixed: bool):
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), cfg))
    tensors = gguf_tensors(cfg, params, arch)
    path = str(tmp_path / f"{arch}.gguf")
    tgguf.write_gguf(path, gguf_metadata(cfg, arch), encode_mixed(tensors) if mixed else tensors)
    return path


def logits_both(path, cfg):
    """Float32 logits of an 11-token prompt: the JAX loader through the
    JAX forward, the port's loader through the port's."""
    jparams, _ = jgguf.load_params_from_gguf(path, cfg)
    model, _ = tgguf.load_params_from_gguf(path, cfg, device="cpu")
    rs = np.random.RandomState(1)
    n = 11
    tokens = rs.randint(1, cfg.vocab_size, size=(1, n)).astype(np.int32)
    positions = np.arange(n, dtype=np.int32)[None]
    table = np.array([[1, 2]], np.int32)
    jk, jv = jllama.init_kv_cache(cfg, 4, PS, dtype=jnp.float32)
    jl, _, _ = jllama.forward(jparams, cfg, jnp.asarray(tokens), jnp.asarray(positions),
                              jnp.asarray(table), jk, jv)
    tk, tv = tllama.init_kv_cache(cfg, 4, PS, torch.float32, device="cpu")
    tl, _, _ = tllama.forward(model, cfg, torch.as_tensor(tokens).long(),
                              torch.as_tensor(positions).long(), torch.as_tensor(table), tk, tv)
    return np.asarray(jl, np.float32), tl.numpy()


CASES = {
    "llama_q8_0": (replace(TINY, dtype="float32"), "llama", True),
    "qwen2_bias": (replace(TINY_QWEN2, dtype="float32"), "qwen2", False),
    "mixtral": (replace(TINY_MOE, dtype="float32"), "llama", False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_gguf_logits_equal_the_jax_loader(tmp_path, name):
    cfg, arch, mixed = CASES[name]
    path = write_model(tmp_path, cfg, arch, seed=3, mixed=mixed)
    jg, tg = jgguf.GGUFFile.parse(path), tgguf.GGUFFile.parse(path)
    assert tg.metadata == jg.metadata and tg.alignment == jg.alignment
    assert {k: dataclasses.astuple(v) for k, v in tg.tensors.items()} == {
        k: dataclasses.astuple(v) for k, v in jg.tensors.items()}
    types = {v.ggml_type for v in tg.tensors.values()}
    assert types == ({tgguf.GGML_F32, tgguf.GGML_F16, tgguf.GGML_BF16, tgguf.GGML_Q8_0}
                     if mixed else {tgguf.GGML_F32})
    for k in tg.tensors:  # every tensor decodes bit-equal
        want, got = jg.tensor(k), tg.tensor(k)
        assert got.dtype == np.float32 and got.shape == want.shape, k
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k
    jcfg, tcfg = jgguf.config_from_gguf(jg), tgguf.config_from_gguf(tg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.attention_bias == cfg.attention_bias and tcfg.num_experts == cfg.num_experts
    want, got = logits_both(path, replace(jcfg, dtype="float32"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_llama_q_k_are_unpermuted_and_q8_0_dequantizes(tmp_path):
    """A llama file's q/k rows come back in HF order, and a Q8_0 weight
    is its blocks' int8 values times their f16 scales."""
    cfg = replace(TINY, dtype="float32", num_layers=1)
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(4), cfg))
    tensors = gguf_tensors(cfg, params, "llama")
    path = str(tmp_path / "q.gguf")
    tgguf.write_gguf(path, gguf_metadata(cfg, "llama"), encode_mixed(tensors))
    model, _ = tgguf.load_params_from_gguf(path, cfg, device="cpu")
    wq = np.asarray(params["layers"]["wq"][0]).T  # HF order [out, in]
    enc = cs.gguf_encode(torch, torch.from_numpy(tensors["blk.0.attn_q.weight"].copy()),
                         "Q8_0")[0]
    blocks = np.asarray(enc.data).reshape(-1, 34)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    deq = (blocks[:, 2:].view(np.int8).astype(np.float32) * scales).reshape(enc.shape)
    hd, inner = cfg.head_dim_, wq.shape[1]
    want = deq.reshape(cfg.num_heads, hd // 2, 2, inner).swapaxes(1, 2).reshape(wq.shape)
    assert np.array_equal(model.layers[0].wq.numpy(), want)
    err = np.abs(want - wq).max()  # rounding to int8 steps of the block's scale
    assert 0 < err <= np.abs(wq).max() / 127 / 2 * 1.01


def test_configs_equal_field_by_field(tmp_path):
    """qwen3's head dim from ``attention.key_length`` (2560 / 32 heads
    would give 80), its q/k norms from the tensors; qwen2's bias."""
    files = {
        "qwen3": ({"general.architecture": "qwen3", "qwen3.embedding_length": 2560,
                   "qwen3.block_count": 1, "qwen3.attention.head_count": 32,
                   "qwen3.attention.head_count_kv": 8, "qwen3.attention.key_length": 128,
                   "qwen3.feed_forward_length": 9728, "qwen3.vocab_size": 1000},
                  {"blk.0.attn_q_norm.weight": np.ones(128, np.float32)}),
        "qwen2": ({"general.architecture": "qwen2", "qwen2.embedding_length": 64,
                   "qwen2.block_count": 2, "qwen2.attention.head_count": 4,
                   "qwen2.feed_forward_length": 128,
                   "tokenizer.ggml.tokens": ["a", "b", "c"]},
                  {"blk.0.attn_q.bias": np.zeros(64, np.float32),
                   "output.weight": np.zeros((3, 64), np.float32)}),
    }
    for arch, (md, tensors) in files.items():
        path = str(tmp_path / f"{arch}.gguf")
        tgguf.write_gguf(path, md, tensors)
        tcfg = tgguf.config_from_gguf(tgguf.GGUFFile.parse(path))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(
            jgguf.config_from_gguf(jgguf.GGUFFile.parse(path)))
    assert tcfg.attention_bias and tcfg.vocab_size == 3 and not tcfg.tie_word_embeddings
    with pytest.raises(ValueError, match="unsupported GGUF architecture"):
        tgguf.write_gguf(str(tmp_path / "p.gguf"), {"general.architecture": "phi2"}, {})
        tgguf.config_from_gguf(tgguf.GGUFFile.parse(str(tmp_path / "p.gguf")))


def test_unknown_quantisation_and_wrong_shapes_are_refused(tmp_path):
    head = bytearray(b"GGUF" + struct.pack("<IQQ", 3, 1, 0))
    head += struct.pack("<Q", 1) + b"w" + struct.pack("<IQ", 1, 32)
    head += struct.pack("<IQ", 2, 0)  # Q4_0
    head += b"\0" * ((-len(head)) % 32) + b"\0" * 64
    (tmp_path / "bad.gguf").write_bytes(bytes(head))
    for mod in (tgguf, jgguf):
        with pytest.raises(ValueError, match="unsupported GGUF encoding 2 "):
            mod.GGUFFile.parse(str(tmp_path / "bad.gguf")).tensor("w")
    (tmp_path / "not.gguf").write_bytes(b"GGML" + b"\0" * 60)
    with pytest.raises(ValueError, match="not a GGUF file"):
        tgguf.GGUFFile.parse(str(tmp_path / "not.gguf"))
    cfg = replace(TINY, dtype="float32", num_layers=1)
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(5), cfg))
    tensors = gguf_tensors(cfg, params, "llama")
    tensors["blk.0.ffn_up.weight"] = tensors["blk.0.ffn_up.weight"][:-1]
    path = str(tmp_path / "shape.gguf")
    tgguf.write_gguf(path, gguf_metadata(cfg, "llama"), tensors)
    with pytest.raises(ValueError, match="ffn_up.weight.*the model wants"):
        tgguf.load_params_from_gguf(path, cfg, device="cpu")
    del tensors["blk.0.ffn_up.weight"]
    tgguf.write_gguf(path, gguf_metadata(cfg, "llama"), tensors)
    with pytest.raises(KeyError, match="ffn_up.weight"):
        tgguf.load_params_from_gguf(path, cfg, device="cpu")
