"""Ring attention and the sequence-parallel prefill of the port against
the JAX package's (``ops/ring_attention.py``,
``models/llama.forward_ring_prefill``).

The port's sp ranks are processes over gloo (``tests/torch_ranks.py``,
every wait with a deadline); the JAX ring runs under ``shard_map`` on
the forced host devices. The same numpy inputs go to both:

- ``ring_attention`` with GQA heads and with trailing padding rows
  (position -1, zeros out) at sp = 2 and 4: the shards put back
  together equal JAX's ring within atol 1e-5 (float32 both sides);
- ``forward_ring_prefill`` at sp = 2 and at sp x tp = 2 x 2: logits
  and K/V equal the port's paged ``forward`` and JAX's ring prefill,
  within the JAX tests' tolerances (logits atol 2e-3 / rtol 1e-3
  against the paged path, 2e-4 / 1e-4 at 2 x 2; K/V atol 1e-5);
- the three refusals, with the JAX messages.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import init_params as jinit_params
from dynamo_exp_tpu.models.llama import forward_ring_prefill as jring_prefill
from dynamo_exp_tpu.ops.ring_attention import ring_attention as jring_attention
from dynamo_exp_tpu.parallel import build_mesh, shard_map
from dynamo_exp_tpu_torch.models import TINY, convert, llama as tllama
from dynamo_exp_tpu_torch.parallel import RankLayout, rank_layout
from dynamo_exp_tpu_torch.parallel.comm import Comm, Ring

from .torch_ranks import ring_cases, ring_cases_and_prefill, ring_prefill, run_ranks

F32 = dataclasses.replace(TINY, dtype="float32")
JF32 = dataclasses.replace(JTINY, dtype="float32")
T = 64
PS = 8


def _jax_ring(sp, q, k, v, pos):
    seq4, seq2 = P(None, "sp", None, None), P(None, "sp")
    fn = shard_map(partial(jring_attention, axis_name="sp", axis_size=sp),
                   mesh=build_mesh(sp=sp), in_specs=(seq4, seq4, seq4, seq2, seq2),
                   out_specs=seq4, check_vma=False)
    return np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v, pos, pos))))


def _cases():
    """(q, k, v, pos): GQA over a full sequence, then trailing padding
    (19 valid positions: not a multiple of any shard size)."""
    rs = np.random.RandomState(0)
    B, H, Hkv, D = 2, 4, 2, 16
    gqa = [rs.randn(B, T, h, D).astype(np.float32) for h in (H, Hkv, Hkv)]
    gqa.append(np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy())
    pad = [rs.randn(1, 32, 2, 8).astype(np.float32) for _ in range(3)]
    pos = np.full((1, 32), -1, np.int32)
    pos[:, :19] = np.arange(19)
    return [tuple(gqa), (*pad, pos)]


def _np_params():
    return jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), JF32))


def _tokens():
    return np.random.RandomState(2).randint(3, F32.vocab_size, size=(1, T)).astype(np.int32)


@pytest.fixture(scope="module")
def sp_runs():
    """One spawn per layout: sp=2 runs the attention cases and the
    prefill, sp=4 the attention cases, sp x tp = 2 x 2 the prefill."""
    params, tokens, cases = _np_params(), _tokens(), _cases()
    return {
        2: run_ranks(ring_cases_and_prefill, 1, cases, params, F32, tokens.tolist(), sp=2),
        4: run_ranks(ring_cases, 1, 4, cases, sp=4),
        (2, 2): run_ranks(ring_prefill, 2, params, F32, tokens.tolist(), 2, 2, sp=2),
    }


def _cases_of(sp, runs):
    return [r[0] for r in runs[sp]] if sp == 2 else runs[sp]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax_gqa_and_padding(sp, sp_runs):
    per_rank = _cases_of(sp, sp_runs)
    # One rotation a ring step: sp - 1 a case.
    assert all(calls == (sp - 1) * len(_cases()) for _, calls in per_rank)
    for i, (q, k, v, pos) in enumerate(_cases()):
        got = np.concatenate([outs[i] for outs, _ in per_rank], axis=1)
        want = _jax_ring(sp, q, k, v, pos)
        np.testing.assert_allclose(got, want, atol=1e-5)
        pad = pos[0] < 0
        assert not got[:, pad].any()  # rows that see no key are zeros


def _paged():
    """The port's paged single-rank forward over the same prompt: logits
    [1, T, V] and the pools as [L, B, T, Hkv, D]."""
    model = convert.params_from_jax(_np_params(), F32, device="cpu")
    k, v = tllama.init_kv_cache(F32, T // PS, PS, torch.float32, device="cpu")
    table = torch.arange(T // PS, dtype=torch.int32)[None]
    logits, k, v = tllama.forward(model, F32, torch.from_numpy(_tokens()).long(),
                                  torch.arange(T)[None], table, k, v, attn_impl="reference")
    shape = (F32.num_layers, 1, T, F32.num_kv_heads, F32.head_dim_)
    return logits.numpy(), k.numpy().reshape(shape), v.numpy().reshape(shape)


def _joined(shards, sp, tp):
    """Rank shards (rank = sp rank x tp + tp rank) back to whole arrays:
    logits over T, K/V over T and kv heads."""
    logits = np.concatenate([shards[s * tp][0] for s in range(sp)], axis=1)
    kv = []
    for j in (1, 2):
        rows = [np.concatenate([shards[s * tp + t][j] for t in range(tp)], axis=3)
                for s in range(sp)]
        kv.append(np.concatenate(rows, axis=2))
    return logits, kv[0], kv[1]


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=["sp2", "sp2xtp2"])
def test_ring_prefill_matches_paged_forward_and_jax(layout, sp_runs):
    sp, tp = layout
    shards = [r[1] for r in sp_runs[2]] if tp == 1 else sp_runs[(2, 2)]
    logits, k, v = _joined(shards, sp, tp)
    want_logits, want_k, want_v = _paged()
    atol, rtol = (2e-3, 1e-3) if tp == 1 else (2e-4, 1e-4)
    np.testing.assert_allclose(logits, want_logits, atol=atol, rtol=rtol)
    np.testing.assert_allclose(k, want_k, atol=1e-5)
    np.testing.assert_allclose(v, want_v, atol=1e-5)
    if tp > 1:  # every tp rank holds the full-vocab logits
        np.testing.assert_array_equal(shards[1][0], shards[0][0])
    jl, jk, jv = jring_prefill(jax.tree.map(jnp.asarray, _np_params()), JF32,
                               jnp.asarray(_tokens()),
                               jnp.arange(T, dtype=jnp.int32)[None],
                               build_mesh(sp=sp, tp=tp))
    np.testing.assert_allclose(logits, np.asarray(jl), atol=atol, rtol=rtol)
    np.testing.assert_allclose(k, np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v, np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("case", ["window", "seq", "kv_heads"])
def test_ring_prefill_refusals_name_what_they_refuse(case):
    model = convert.params_from_jax(_np_params(), F32, device="cpu")
    cfg, comm, ring, n = F32, None, Ring(0, [0, 1], "cpu", staged=False), T
    if case == "window":
        cfg, match = dataclasses.replace(F32, sliding_window=8), "sliding-window"
    elif case == "seq":
        n, match = 30, r"seq len 30 not divisible by sp=4"
        ring = Ring(0, [0, 1, 2, 3], "cpu", staged=False)
    else:
        cfg = dataclasses.replace(F32, num_kv_heads=3)
        comm, match = Comm(0, 2, "gloo", "cpu"), r"kv heads 3 not divisible by tp=2"
    toks = torch.zeros(1, n, dtype=torch.long)
    with pytest.raises(ValueError, match=match):
        tllama.forward_ring_prefill(model, cfg, toks, toks, ring=ring, comm=comm)


def test_rank_layout_lays_sp_over_tp():
    lay = rank_layout(tp=2, rank=3, sp=2)
    assert (lay.world_size, lay.sp_rank, lay.tp_rank) == (4, 1, 1)
    assert RankLayout(tp=2, rank=0, num_nodes=2, sp=2).local_world == 2
    with pytest.raises(ValueError, match="outside"):
        RankLayout(tp=2, rank=4, sp=2)
    with pytest.raises(ValueError, match=r"item 7\(d\)"):
        rank_layout(ep=2)
