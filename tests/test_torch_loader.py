"""The port's safetensors loader against the JAX package's, on the CPU.

A tiny checkpoint in HF layout (2 layers, hidden 64) is written from
JAX-initialised weights by the numpy writer below, split over two
shards, and cross-read with ``safetensors.safe_open`` where that
package is importable. ``dynamo_exp_tpu.models.loader.load_params`` and
``dynamo_exp_tpu_torch.models.loader.load_params`` read the same
directory: their weights are equal (bit-equal for a bf16 checkpoint)
and their float32 logits agree within 1e-5, for llama, qwen2 (biases),
qwen3 (q/k norms) and tied embeddings. For gemma, gemma2, gemma3 (four
norms a layer, q/k norms) and phi3 (packed ``qkv_proj`` and
``gate_up_proj``) the port writes the checkpoint under the HF names with
``save_safetensors``, and its ``load_params`` gives the logits of the
JAX loader's parameters carried over by ``convert``. Malformed files
raise, naming what is wrong; the MoE types load (a missing expert
tensor raises naming it).
``run.py --model-path <dir>`` without ``--random-weights`` serves the
checkpoint: tokens equal ``TPUEngine``'s on the JAX loader's weights.
"""

import asyncio
import json
import os
import struct
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY, TINY_QWEN2, TINY_QWEN3
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models import loader as jloader
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.models import llama as tllama
from dynamo_exp_tpu_torch.models import loader as tloader

PS = 8
# HF tensor name (per layer) -> (JAX layer key, transposed in JAX).
_LAYER = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
}
_ST_DTYPE = {np.dtype(np.float32): "F32", np.dtype(ml_dtypes.bfloat16): "BF16",
             np.dtype(np.float16): "F16"}


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """A safetensors file from numpy arrays (the format's own layout:
    u64 header length, JSON header padded to 8 bytes, packed data)."""
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": _ST_DTYPE[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-(8 + len(head)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).tobytes())


def hf_config(cfg) -> dict:
    out = {
        "model_type": cfg.model_type, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": cfg.dtype,
        "head_dim": cfg.head_dim_,
    }
    if cfg.model_type == "qwen2":
        out["attention_bias"] = True
    return out


def hf_tensors(cfg, params, dtype=np.float32) -> dict[str, np.ndarray]:
    """JAX params (stacked, ``x @ W``) as HF tensors (``[out, in]``)."""
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].T
    for hf, (key, transposed) in _LAYER.items():
        if key not in params["layers"]:
            continue
        for i in range(cfg.num_layers):
            w = params["layers"][key][i]
            out[f"model.layers.{i}.{hf}"] = w.T if transposed else w
    return {k: np.ascontiguousarray(v).astype(dtype) for k, v in out.items()}


def jax_params(cfg, seed=0) -> dict:
    """JAX init, norms and biases perturbed so every weight matters."""
    p = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed),
                                                    replace(cfg, dtype="float32")))
    rs = np.random.RandomState(seed)
    for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        if name in p["layers"]:
            p["layers"][name] = p["layers"][name] + 0.1 * rs.standard_normal(
                p["layers"][name].shape).astype(np.float32)
    return p


def write_checkpoint(path, cfg, params, dtype=np.float32) -> str:
    """``config.json`` and the tensors split over two shards."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    tensors = hf_tensors(cfg, params, dtype)
    names = sorted(tensors)
    half = len(names) // 2
    write_safetensors(os.path.join(path, "model-00001-of-00002.safetensors"),
                      {k: tensors[k] for k in names[:half]})
    write_safetensors(os.path.join(path, "model-00002-of-00002.safetensors"),
                      {k: tensors[k] for k in names[half:]})
    return path


def port_weights(model) -> dict[str, np.ndarray]:
    """The port's weights under the HF names (``[out, in]``), float32."""
    out = {}
    for name, (li, attr) in tloader.hf_tensor_names(model.cfg).items():
        t = getattr(model if li is None else model.layers[li], attr)
        out[name] = t.detach().float().numpy()
    return out


def forward_both(cfg, jparams, model):
    """Logits of a 11-token prompt through both packages' forward."""
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


CFGS = {
    "llama": replace(TINY, dtype="float32"),
    "qwen2": replace(TINY_QWEN2, dtype="float32"),
    "qwen3": replace(TINY_QWEN3, dtype="float32"),
    "tied": replace(TINY, dtype="float32", tie_word_embeddings=True),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_port_loader_equals_the_jax_loader(name, tmp_path):
    cfg = CFGS[name]
    params = jax_params(cfg)
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    path = write_checkpoint(str(tmp_path), cfg, params)
    jp, jcfg = jloader.load_params(path)
    model, tcfg = tloader.load_params(path, device="cpu")
    assert tcfg.model_type == jcfg.model_type == cfg.model_type
    assert tcfg.tie_word_embeddings == cfg.tie_word_embeddings
    assert (model.lm_head is None) == cfg.tie_word_embeddings
    want = hf_tensors(cfg, jax.tree.map(np.asarray, jp))
    got = port_weights(model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jl, tl = forward_both(jcfg, jp, model)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)


def test_shards_cross_read_with_the_safetensors_package(tmp_path):
    safetensors = pytest.importorskip("safetensors")
    cfg = CFGS["qwen2"]
    path = write_checkpoint(str(tmp_path), cfg, jax_params(cfg))
    files, index = tloader._open_safetensors(path)
    assert len(files) == 2
    seen = 0
    for sf in files:
        with safetensors.safe_open(sf.path, framework="numpy") as ref:
            assert set(ref.keys()) == set(sf.tensors)
            for k in ref.keys():
                np.testing.assert_array_equal(sf.get(k).numpy(), ref.get_tensor(k), err_msg=k)
                seen += 1
    assert seen == len(index)


def test_port_writer_is_read_by_the_safetensors_package(tmp_path):
    """``save_safetensors`` (the smoke's checkpoint writer) gives files
    the safetensors package reads, in all three dtypes."""
    safetensors = pytest.importorskip("safetensors")
    rs = np.random.RandomState(0)
    tensors = {
        "a": torch.from_numpy(rs.standard_normal((3, 5)).astype(np.float32)).bfloat16(),
        "b": torch.from_numpy(rs.standard_normal((7,)).astype(np.float32)),
        "c": torch.from_numpy(rs.standard_normal((2, 3)).astype(np.float16)),
    }
    path = str(tmp_path / "x.safetensors")
    tloader.save_safetensors(path, tensors, {"format": "pt"})
    sf = tloader.SafetensorsFile(path)
    with safetensors.safe_open(path, framework="pt") as ref:
        for k, t in tensors.items():
            assert torch.equal(ref.get_tensor(k), t) and torch.equal(sf.get(k), t), k


def test_bf16_checkpoint_is_bit_equal_to_the_jax_loader(tmp_path):
    cfg = replace(TINY_QWEN3, dtype="bfloat16")
    params = jax_params(cfg)
    path = write_checkpoint(str(tmp_path), cfg, params, dtype=ml_dtypes.bfloat16)
    jp, _ = jloader.load_params(path)
    model, tcfg = tloader.load_params(path, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    want = hf_tensors(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    got = port_weights(model)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # And bit-equal to the file's bf16 bits.
    raw = hf_tensors(cfg, params, ml_dtypes.bfloat16)
    for k in raw:
        np.testing.assert_array_equal(got[k], raw[k].astype(np.float32), err_msg=k)


def _one_tensor_file(path, header_edit=None, body=None, dtype="F32"):
    a = np.arange(6, dtype=np.float32)
    header = {"w": {"dtype": dtype, "shape": [2, 3], "data_offsets": [0, 24]}}
    if header_edit:
        header_edit(header)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + (a.tobytes() if body is None else body))
    return str(path)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda p: p.write_bytes(b"\x01\x02"), "not a safetensors file"),
        (lambda p: p.write_bytes(struct.pack("<Q", 1 << 40) + b"{}"), "overruns the file"),
        (lambda p: p.write_bytes(struct.pack("<Q", 4) + b"{no!"), "not JSON"),
        (lambda p: _one_tensor_file(p, body=b"\0" * 20), r"'w'.*overrun"),
        (lambda p: _one_tensor_file(p, lambda h: h["w"].update(shape=[2, 2])), r"'w'.*span"),
        (lambda p: _one_tensor_file(p, dtype="I8"), r"'w'.*dtype I8"),
        (lambda p: _one_tensor_file(p, lambda h: h["w"].pop("data_offsets")), r"'w'.*malformed"),
    ],
    ids=["short", "header-overrun", "not-json", "data-overrun", "shape-span", "dtype",
         "no-offsets"],
)
def test_malformed_files_raise_naming_the_file_and_tensor(tmp_path, make, match):
    p = tmp_path / "bad.safetensors"
    make(p)
    with pytest.raises(ValueError, match=match) as err:
        tloader.SafetensorsFile(str(p))
    assert str(p) in str(err.value)


def test_good_file_reads_back(tmp_path):
    sf = tloader.SafetensorsFile(_one_tensor_file(tmp_path / "ok.safetensors"))
    assert torch.equal(sf.get("w"), torch.arange(6, dtype=torch.float32).reshape(2, 3))


def test_missing_or_misshapen_tensor_raises(tmp_path):
    cfg = CFGS["llama"]
    path = write_checkpoint(str(tmp_path / "a"), cfg, jax_params(cfg))
    # Drop one tensor from the second shard.
    shard = os.path.join(path, "model-00002-of-00002.safetensors")
    sf = tloader.SafetensorsFile(shard)
    kept = {k: sf.get(k).clone() for k in sorted(sf.tensors)[1:]}  # off the mapping
    dropped = sorted(sf.tensors)[0]
    sf.close()
    tloader.save_safetensors(shard, kept)
    with pytest.raises(KeyError, match=dropped.replace(".", r"\.")):
        tloader.load_params(path, device="cpu")
    with open(os.path.join(path, "config.json")) as f:
        conf = json.load(f)
    conf["intermediate_size"] = 64
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    with pytest.raises((ValueError, KeyError), match="shape|no tensor"):
        tloader.load_params(path, device="cpu")


@pytest.mark.parametrize("model_type,item", [("mixtral", "item 7"), ("qwen3_moe", "item 7")])
def test_unsupported_model_types_raise_naming_their_roadmap_item(tmp_path, model_type, item):
    """The MoE types the port once refused (ROADMAP Queue 1 ``item``)
    load now: a checkpoint missing an expert's tensors raises naming
    that tensor, not a ROADMAP item, and the whole checkpoint written
    under the HF names (each expert's own tensors) comes back bit-equal."""
    from dynamo_exp_tpu_torch.models import ModelConfig as TModelConfig

    conf = hf_config(CFGS["llama"])
    conf["model_type"] = model_type
    conf.update(num_local_experts=4, num_experts=4, num_experts_per_tok=2,
                moe_intermediate_size=64)
    (tmp_path / "config.json").write_text(json.dumps(conf))
    mcfg = TModelConfig.from_pretrained(str(tmp_path))
    gen = torch.Generator()
    gen.manual_seed(3)
    want = tllama.init_params(mcfg, gen, "cpu")
    tensors = {n: tloader.model_tensor(want, li, a)
               for n, (li, a) in tloader.hf_tensor_names(mcfg).items()}
    shard = str(tmp_path / "model.safetensors")
    tloader.save_safetensors(shard, {n: t for n, t in tensors.items() if ".experts.3." not in n})
    with pytest.raises(KeyError, match=r"experts\.3\.") as err:
        tloader.load_params(str(tmp_path), device="cpu")
    assert "ROADMAP" not in str(err.value) and item not in str(err.value)
    tloader.save_safetensors(shard, tensors)
    got, cfg = tloader.load_params(str(tmp_path), device="cpu")
    assert cfg.model_type == model_type and cfg.is_moe
    mine = dict(got.named_parameters())
    for name, p in want.named_parameters():
        assert torch.equal(mine[name], p), name


@pytest.mark.parametrize("family", ["gemma", "gemma2", "gemma3_text", "phi3", "mistral"])
def test_family_checkpoint_loads_like_the_jax_loader(tmp_path, family):
    """The port writes a family's weights under the HF names (phi3's
    packed, gemma2/3's four norms); the JAX loader and the port's read
    the directory back: the port's weights are the JAX loader's carried
    over by ``convert``, bit for bit, and their logits agree."""
    from dynamo_exp_tpu_torch.models import ModelConfig as TModelConfig, convert
    from tests.test_torch_families import HF_CONFIGS
    from tests.test_torch_families import _params as family_params

    hf = HF_CONFIGS[family]
    (tmp_path / "config.json").write_text(json.dumps(hf))
    jcfg = JModelConfig.from_hf_config(hf)
    written = convert.params_from_jax(family_params(jcfg, seed=4),
                                      TModelConfig.from_hf_config(hf), device="cpu")
    names = tloader.hf_tensor_names(written.cfg)
    if family == "phi3":
        assert {"self_attn.qkv_proj.weight", "mlp.gate_up_proj.weight"} <= {
            n.split(".", 3)[-1] for n in names}
    if family in ("gemma2", "gemma3_text"):
        assert "model.layers.0.post_feedforward_layernorm.weight" in names
    keys = sorted(names)
    for i, part in enumerate((keys[::2], keys[1::2])):
        tloader.save_safetensors(str(tmp_path / f"model-{i}.safetensors"),
                                 {k: tloader.model_tensor(written, *names[k]) for k in part})
    jp, _ = jloader.load_params(str(tmp_path))
    model, tcfg = tloader.load_params(str(tmp_path), device="cpu")
    want = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for (name, got), (_, ref) in zip(model.named_parameters(), want.named_parameters()):
        assert torch.equal(got, ref), name
    jl, tl = forward_both(jcfg, jp, model)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ run.py
SMALL = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32", "--max-tokens", "6"]


@pytest.fixture(scope="module")
def served_dir(tiny_model_dir, tmp_path_factory):
    """The fixture's tokenizer and config (float32) with JAX-initialised
    weights as a two-shard checkpoint."""
    path = str(tmp_path_factory.mktemp("ckpt"))
    for name in os.listdir(tiny_model_dir):
        if name != "config.json":
            os.symlink(os.path.join(tiny_model_dir, name), os.path.join(path, name))
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        conf = json.load(f)
    conf["torch_dtype"] = "float32"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    cfg = JModelConfig.from_pretrained(path)
    tensors = hf_tensors(cfg, jax_params(cfg, seed=3))
    names = sorted(tensors)
    write_safetensors(os.path.join(path, "model-00001-of-00002.safetensors"),
                      {k: tensors[k] for k in names[: len(names) // 2]})
    write_safetensors(os.path.join(path, "model-00002-of-00002.safetensors"),
                      {k: tensors[k] for k in names[len(names) // 2:]})
    return path


async def _tokens(engine, prompts, n):
    async def one(p):
        stream = await engine.generate({
            "token_ids": p, "stop_conditions": {"max_tokens": n, "ignore_eos": True}})
        out = []
        async for item in stream:
            out.extend(item.get("token_ids") or [])
        return out

    return await asyncio.gather(*(one(p) for p in prompts))


def test_run_serves_the_checkpoint_as_tpu_engine_does(served_dir):
    opts = run.parse_args(["in=http", "out=cuda", "--device", "cpu", "--model-path",
                           served_dir, *SMALL])
    engine, mdc = run.build_cuda_engine(opts)
    jp, jcfg = jloader.load_params(served_dir)
    jeng = TPUEngine(
        JEngineConfig(model=jcfg, attention_impl="xla", max_decode_slots=2, page_size=8,
                      max_model_len=128, num_pages=64, kv_dtype="float32", eos_token_ids=[]),
        params=jp, mesh=single_device_mesh(),
    )
    prompts = [[5, 9, 17, 23, 4], [7, 3, 19, 28, 41, 13, 6, 11, 2]]
    try:
        got = asyncio.run(asyncio.wait_for(_tokens(engine, prompts, 12), 300))
        want = asyncio.run(asyncio.wait_for(_tokens(jeng, prompts, 12), 300))
    finally:
        engine.stop()
        jeng.stop()
    assert got == want and all(len(t) == 12 for t in got)


def test_run_batch_serves_the_checkpoint(served_dir, tmp_path, capsys):
    prompts = tmp_path / "p.jsonl"
    prompts.write_text('{"text": "hello world"}\n{"text": "the quick fox"}\n')
    opts = run.parse_args([f"in=batch:{prompts}", "out=cuda", "--device", "cpu",
                           "--model-path", served_dir, *SMALL])
    asyncio.run(asyncio.wait_for(run.main_async(opts), timeout=300))
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 2 and stats["output_tokens"] > 0
