"""Tensor parallelism of the port on the CPU, against the JAX package.

- Shards: rank r's weights from ``params_from_jax(..., rank=r, tp=2)``,
  put back in the JAX layout, equal the JAX arrays'
  ``addressable_shards`` on tp rank r under ``param_shardings`` on
  ``build_mesh(tp=2)``, bit for bit: llama, qwen2 (biases, tied head),
  gemma2 (tied head, post-norms, softcaps), mixtral and qwen2_moe
  (shared expert).
- Forward: the port at tp=2, two gloo CPU processes, gives logits
  within atol 1e-4 of JAX ``forward(..., mesh=build_mesh(tp=2))`` (as
  ``tests/test_model.py:108`` runs it) and of the port at tp=1, through
  both forward shapes; the ranks' logits are the same gathered logits.
- Engine: ``TorchEngine`` at tp=2 (two processes) emits the JAX
  ``TPUEngine``'s tokens at ``EngineConfig(tp=2)`` on the CPU's
  virtual devices, greedy and seeded rows, and with ``ngram``
  speculation; both ranks' output digests agree.
- Weights: each rank's slice loaded from a safetensors checkpoint
  (phi3's packed tensors, qwen2_moe's experts) and from a Q8_0 GGUF
  equals the same slice of the tp=1 load.
- Refusals: what tp > 1 does not serve yet (CUDA graphs) raises with its
  ROADMAP item; an uneven split raises as the JAX ``device_put`` refuses
  one. The KV tiers under tp are ``tests/test_torch_tp_tiers.py``'s.
"""

import asyncio
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models.config import ModelConfig as JConfig
from dynamo_exp_tpu.parallel import build_mesh, shard_pytree
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import convert, llama as tllama
from dynamo_exp_tpu_torch.models.config import ModelConfig as TConfig

from .test_torch_families import HF_CONFIGS as DENSE_HF
from .test_torch_moe import HF_CONFIGS as MOE_HF
from .torch_ranks import engine_tokens, forward_logits, run_ranks

ATOL = 1e-4
_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512, torch_dtype="float32",
             num_hidden_layers=2)
HF = {
    "llama": {**_TINY, "model_type": "llama"},
    "qwen2": {**_TINY, "model_type": "qwen2", "attention_bias": True,
              "tie_word_embeddings": True},
    "gemma2": DENSE_HF["gemma2"],
    "mixtral": MOE_HF["mixtral"],
    "qwen2_moe": MOE_HF["qwen2_moe"],
}
FAMILIES = sorted(HF)


def _cfgs(family):
    hf = HF[family]
    return JConfig.from_hf_config(hf), TConfig.from_hf_config(hf)


def _params(cfg, seed=0):
    """JAX init in float32 with every norm and bias perturbed, so a
    replicated weight mixed up with another would show."""
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), cfg))
    rs = np.random.RandomState(seed)
    for tree in (params["layers"], params):
        for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "post_attn_norm",
                     "post_ffn_norm", "bq", "bk", "bv", "final_norm", "shared_router"):
            if name in tree:
                tree[name] = (tree[name] + 0.1 * rs.standard_normal(tree[name].shape)
                              ).astype(np.float32)
    return params


def _jax_layout(model) -> dict:
    """The port's (shard of the) model in the JAX parameter layout."""
    def arr(t, transpose):
        t = t.detach().float()
        return (t.transpose(-1, -2) if transpose else t).numpy()

    out = {"embed": arr(model.embed, False), "final_norm": arr(model.final_norm, False)}
    if model.lm_head is not None:
        out["lm_head"] = arr(model.lm_head, True)
    layers = {}
    for name, transpose in convert._LAYER_KEYS.items():
        ts = [getattr(layer, name) for layer in model.layers]
        if ts[0] is not None:
            layers[name] = np.stack([arr(t, transpose) for t in ts])
    out["layers"] = layers
    return out


def _shard_on(arr, device) -> np.ndarray:
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("family", FAMILIES)
def test_rank_shards_equal_the_jax_addressable_shards(family):
    jcfg, tcfg = _cfgs(family)
    np_params = _params(jcfg)
    mesh = build_mesh(tp=2)
    sharded, _ = shard_pytree(mesh, jax.tree.map(jnp.asarray, np_params),
                              jllama.param_shardings(jcfg))
    flat_j = jax.tree_util.tree_flatten_with_path(sharded)[0]
    for rank, device in enumerate(mesh.devices.reshape(-1)):
        mine = _jax_layout(convert.params_from_jax(np_params, tcfg, "cpu", rank=rank, tp=2))
        assert jax.tree.structure(mine) == jax.tree.structure(np_params)
        flat_m = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
        for path, arr in flat_j:
            want = _shard_on(arr, device)
            got = flat_m[path]
            assert got.shape == want.shape, (rank, path, got.shape, want.shape)
            assert np.array_equal(got, want), (rank, path)


def _jax_tp2_logits(jcfg, np_params, tokens, ps=8):
    """JAX ``forward`` over a tp=2 mesh, as ``tests/test_model.py:108``."""
    mesh = build_mesh(tp=2)
    sp, _ = shard_pytree(mesh, jax.tree.map(jnp.asarray, np_params),
                         jllama.param_shardings(jcfg))
    T = len(tokens)
    pages = -(-T // ps)
    kspec, vspec = jllama.kv_cache_shardings()
    k, v = jllama.init_kv_cache(jcfg, pages + 1, ps, dtype=jnp.float32)
    k = jax.device_put(k, NamedSharding(mesh, kspec))
    v = jax.device_put(v, NamedSharding(mesh, vspec))
    fwd = jax.jit(jllama.forward, static_argnums=(1,))
    logits, _, _ = fwd(sp, jcfg, jnp.array([tokens], jnp.int32),
                       jnp.arange(T, dtype=jnp.int32)[None],
                       jnp.arange(1, pages + 1, dtype=jnp.int32)[None], k, v)
    return np.asarray(logits[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_forward_matches_jax_tp2_and_the_port_at_tp1(family):
    jcfg, tcfg = _cfgs(family)
    np_params = _params(jcfg)
    tokens = [int(t) for t in np.random.RandomState(1).randint(1, tcfg.vocab_size, size=11)]
    want = _jax_tp2_logits(jcfg, np_params, tokens)
    one, one_ragged = _tp1_logits(np_params, tcfg, tokens)
    (l0, r0), (l1, r1) = run_ranks(forward_logits, 2, np_params, tcfg, tokens, timeout=150)
    assert np.array_equal(l0, l1) and np.array_equal(r0, r1)  # the same gathered logits
    np.testing.assert_allclose(l0, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(r0, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(l0, one, atol=ATOL, rtol=0)
    np.testing.assert_allclose(r0, one_ragged, atol=ATOL, rtol=0)


def _tp1_logits(np_params, tcfg, tokens, ps=8):
    model = convert.params_from_jax(np_params, tcfg, device="cpu")
    T = len(tokens)
    pages = -(-T // ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    toks = torch.tensor([tokens])
    pos = torch.arange(T, dtype=torch.int32)[None]
    k, v = tllama.init_kv_cache(tcfg, pages + 1, ps, torch.float32, "cpu")
    logits, _, _ = tllama.forward(model, tcfg, toks, pos, table, k, v, attn_impl="reference")
    k, v = tllama.init_kv_cache(tcfg, pages + 1, ps, torch.float32, "cpu")
    ragged, _, _ = tllama.forward_ragged(model, tcfg, toks[0], pos[0],
                                         torch.zeros(T, dtype=torch.int32), table, k, v,
                                         torch.arange(T), attn_impl="reference")
    return logits[0].numpy(), ragged.numpy()


# ------------------------------------------------------------------ engine
ENGINE_KW = dict(max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
                 prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[])


def _requests(vocab: int) -> list[dict]:
    rs = np.random.RandomState(7)
    lens = (5, 23, 9, 12)
    reqs = [{"token_ids": [int(t) for t in rs.randint(3, vocab - 1, size=n)],
             "stop_conditions": {"max_tokens": 10, "ignore_eos": True},
             "sampling_options": {}} for n in lens]
    reqs[1]["sampling_options"] = {"temperature": 0.8, "seed": 11}
    reqs[3]["sampling_options"] = {"temperature": 0.8, "seed": 12, "top_k": 20}
    block = [int(t) for t in rs.randint(3, vocab - 1, size=6)]
    reqs.append({"token_ids": block * 4, "stop_conditions": {"max_tokens": 12,
                                                            "ignore_eos": True},
                 "sampling_options": {}})  # repeats: the ngram drafter proposes
    return reqs


async def _jax_tokens(jeng, requests):
    async def one(r):
        stream = await jeng.generate(dict(r))
        toks = []
        async for item in stream:
            toks += item.get("token_ids", [])
        return toks

    try:
        return await asyncio.wait_for(asyncio.gather(*[one(r) for r in requests]), 300)
    finally:
        jeng.stop()


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_engine_tp2_emits_the_jax_engines_tokens_at_tp2(spec):
    jcfg, tcfg = _cfgs("llama")
    np_params = _params(jcfg)
    requests = _requests(tcfg.vocab_size)
    jeng = TPUEngine(JEngineConfig(model=jcfg, tp=2, attention_impl="xla", spec_mode=spec,
                                   **ENGINE_KW),
                     params=jax.tree.map(jnp.asarray, np_params))
    assert jeng.mesh.shape["tp"] == 2
    want = asyncio.run(_jax_tokens(jeng, requests))
    ecfg = EngineConfig(model=tcfg, tp=2, spec_mode=spec, **ENGINE_KW)
    (got, reports, metrics), follower = run_ranks(engine_tokens, 2, np_params, ecfg,
                                                  requests, timeout=200)
    assert got == want
    assert metrics["tp"] == 2
    if spec == "ngram":
        assert metrics["spec_accepted_tokens"] > 0
    assert reports == follower  # both ranks return the gathered reports
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["digest"] == reports[1]["digest"] and reports[0]["dispatches"] > 0
    calls = reports[1]["comm"]["calls"]
    # Two sums a layer and one for the embedding per forward; the logits
    # gathered once per forward.
    assert calls["all_reduce"] == (2 * tcfg.num_layers + 1) * calls["all_gather"] > 0


# ------------------------------------------------------------------ weights
def _slices_equal(sharded, whole, rank, tp):
    for name, p in sharded.named_parameters():
        want = tllama.tp_slice(dict(whole.named_parameters())[name], name.split(".")[-1],
                               rank, tp)
        assert p.shape == want.shape, name
        assert torch.equal(p, want), name


@pytest.mark.parametrize("family", ["llama", "phi3", "qwen2_moe"])
def test_each_rank_loads_its_slice_of_a_safetensors_checkpoint(tmp_path, family):
    from dynamo_exp_tpu_torch.models import loader

    hf = {"phi3": DENSE_HF["phi3"], **HF}[family]
    hf = dict(hf, torch_dtype="bfloat16")
    (tmp_path / "config.json").write_text(json.dumps(hf))
    cfg = TConfig.from_hf_config(hf)
    gen = torch.Generator().manual_seed(3)
    written = tllama.init_params(cfg, gen, "cpu")
    loader.save_safetensors(str(tmp_path / "model.safetensors"), {
        name: loader.model_tensor(written, li, attr)
        for name, (li, attr) in loader.hf_tensor_names(cfg).items()})
    whole, _ = loader.load_params(str(tmp_path), device="cpu")
    for rank in range(2):
        part, _ = loader.load_params(str(tmp_path), device="cpu", rank=rank, tp=2)
        assert (part.tp, part.rank) == (2, rank)
        _slices_equal(part, whole, rank, 2)


def test_each_rank_loads_its_slice_of_a_q8_0_gguf(tmp_path):
    from dynamo_exp_tpu.models import TINY
    from dynamo_exp_tpu_torch.models import gguf

    from .test_torch_gguf import write_model

    path = write_model(tmp_path, TINY, "llama", seed=4, mixed=True)
    assert gguf.GGML_Q8_0 in {t.ggml_type for t in gguf.GGUFFile.parse(path).tensors.values()}
    whole, _ = gguf.load_params_from_gguf(path, device="cpu")
    for rank in range(2):
        part, _ = gguf.load_params_from_gguf(path, device="cpu", rank=rank, tp=2)
        _slices_equal(part, whole, rank, 2)


def test_random_shards_are_the_parts_of_the_tp1_model():
    """``init_params`` draws each whole weight on every rank: the shards
    of one seed are the tp=1 model's parts (so tp=2 serves tp=1's weights)."""
    _, cfg = _cfgs("qwen2_moe")
    whole = tllama.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    for rank in range(2):
        part = tllama.init_params(cfg, torch.Generator().manual_seed(9), "cpu", rank=rank, tp=2)
        _slices_equal(part, whole, rank, 2)


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,item", [
    ({"cuda_graphs": True}, "item 7(b)"),
    # Item 7(c), the ring prefill, is served by forward_ring_prefill,
    # which the engine's refusal of sp > 1 names.
    ({"sp": 2}, "forward_ring_prefill"),
], ids=["kw2-item 7(b)", "kw3-item 7(c)"])
def test_engine_config_refuses_what_tp_does_not_serve(kw, item):
    _, tcfg = _cfgs("llama")
    tp = 1 if "sp" in kw else 2
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(").replace(")", r"\)")):
        EngineConfig(model=tcfg, tp=tp, **kw)


@pytest.mark.parametrize("field,value", [
    ("num_kv_heads", 3), ("num_heads", 3), ("vocab_size", 255), ("intermediate_size", 127),
])
def test_an_uneven_split_is_refused(field, value):
    _, tcfg = _cfgs("llama")
    cfg = dataclasses.replace(tcfg, **{field: value})
    with pytest.raises(ValueError, match=field):
        EngineConfig(model=cfg, tp=2)
    with pytest.raises(ValueError, match=field):
        tllama.Llama(cfg, device="cpu", tp=2)


def test_an_uneven_expert_split_is_refused():
    _, tcfg = _cfgs("qwen2_moe")
    for field in ("moe_intermediate_size", "shared_expert_intermediate_size"):
        with pytest.raises(ValueError, match="intermediate_size"):
            EngineConfig(model=dataclasses.replace(tcfg, **{field: 41}), tp=2)


def _rank0_engine():
    """A tp=2 rank-0 engine over a stand-in comm (no process group: what
    the tests below do issues no collective)."""
    _, tcfg = _cfgs("llama")
    comm = types.SimpleNamespace(rank=0, world=2, device=torch.device("cpu"))
    return TorchEngine(EngineConfig(model=tcfg, tp=2, **ENGINE_KW), device="cpu", comm=comm)


def test_a_ranks_pools_and_page_bytes_hold_its_kv_heads():
    """A rank's pools hold its Hkv/tp heads; a page off the card is the
    whole page at any tp (``kv_page_nbytes``: the host tier's, the
    store's and the wire's)."""
    eng = _rank0_engine()
    m = eng.cfg.model
    assert eng.k_cache.shape[-1] == m.num_kv_heads // 2 * m.head_dim_
    assert eng.kv_page_nbytes() == 2 * m.num_layers * eng.cfg.page_size * (
        m.num_kv_heads) * m.head_dim_ * 4
    assert eng.metrics()["tp"] == 2


def test_graphs_and_prewarm_are_refused_under_tp():
    from dynamo_exp_tpu_torch.aot import prewarm_engine
    from dynamo_exp_tpu_torch.engine.graphs import DispatchGraphs

    eng = _rank0_engine()
    assert eng.graphs is None  # cuda_graphs=None resolves to eager under tp > 1
    with pytest.raises(NotImplementedError, match=r"item 7\(b\)"):
        DispatchGraphs(eng)
    with pytest.raises(NotImplementedError, match=r"item 7\(b\)"):
        prewarm_engine(eng)


def test_a_tp_engine_needs_its_comm_and_a_matching_model():
    _, tcfg = _cfgs("llama")
    with pytest.raises(ValueError, match="needs a comm"):
        TorchEngine(EngineConfig(model=tcfg, tp=2, **ENGINE_KW), device="cpu")
    comm = types.SimpleNamespace(rank=1, world=2, device=torch.device("cpu"))
    whole = tllama.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="rank 0 of tp=1"):
        TorchEngine(EngineConfig(model=tcfg, tp=2, **ENGINE_KW), model=whole, device="cpu",
                    comm=comm)
    follower = TorchEngine(EngineConfig(model=tcfg, tp=2, **ENGINE_KW), device="cpu", comm=comm)
    with pytest.raises(RuntimeError, match="follow"):
        follower.start()
