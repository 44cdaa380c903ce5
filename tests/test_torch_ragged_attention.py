"""Port parity: ragged paged attention against the JAX package's.

Inputs are made with numpy from a seed at the shapes of
``tests/test_ragged_attention.py`` (ragged spans, page boundaries, GQA,
the decode shape with inactive rows, a bf16 cache) and go through:

- the port's plain ``ragged_paged_attention_ref`` against JAX's
  ``ragged_paged_attention_ref``;
- the port's kernel wrappers on CPU tensors (which compute the plain
  version) against JAX's Pallas kernel in interpret mode, including
  exact zeros for a fully empty tile and for inactive decode rows.

float32 compares at atol=rtol=1e-5 on valid tokens: both sides compute
the same float32 sums in a different order. The bf16-cache case rounds
q, the probabilities and the output to bf16 on both sides with sums in
another order, so it compares at atol=2e-2 (the JAX suite's own bf16
tolerance). The CUDA kernel itself is held against the plain version
on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.ops import ragged_attention as jra
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

F32 = dict(atol=1e-5, rtol=1e-5)


def _flat_batch(seed, spans, H, Hkv, D, P, ps, pmax, q_tile, empty_tiles=0):
    """A q_tile-aligned flat stream from per-row (q_len, kv_len) spans
    over a scrambled page pool, plus ``empty_tiles`` all-padding tiles."""
    rs = np.random.RandomState(seed)
    k = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    v = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    perm = rs.permutation(P)
    table = np.zeros((len(spans) + 1, pmax), np.int32)
    used = 0
    row_of, positions = [], []
    for r, (q_len, kv_len) in enumerate(spans):
        n = max(1, -(-max(kv_len, 1) // ps))
        table[r, :n] = perm[used : used + n]
        used += n
        pad = (-q_len) % q_tile
        row_of += [r] * (q_len + pad)
        positions += list(range(kv_len - q_len, kv_len)) + [-1] * pad
    row_of += [len(spans)] * (q_tile * empty_tiles)
    positions += [-1] * (q_tile * empty_tiles)
    q = rs.standard_normal((len(row_of), H, D)).astype(np.float32)
    return q, k, v, table, np.asarray(row_of, np.int32), np.asarray(positions, np.int32)


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a) for a in arrays]


def _torch(*arrays, dtype=torch.float32):
    return [
        torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
        for a in arrays
    ]


SPANS = [
    [(1, 17), (5, 5), (3, 20)],
    [(8, 16), (9, 25), (1, 8)],  # page-boundary spans
    [(13, 13)],
    [(1, 64), (32, 32)],
]


@pytest.mark.parametrize("spans", SPANS)
def test_plain_version_matches_jax_reference(spans):
    H, Hkv, D, ps, pmax = 8, 4, 64, 16, 8
    arrs = _flat_batch(0, spans, H, Hkv, D, 64, ps, pmax, q_tile=1)
    want = jra.ragged_paged_attention_ref(*_jax(*arrs), num_kv_heads=Hkv)
    got = tra.ragged_paged_attention_ref(*_torch(*arrs), num_kv_heads=Hkv)
    live = arrs[-1] >= 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **F32)


@pytest.mark.parametrize("spans", SPANS)
def test_wrapper_matches_pallas_kernel_interpret(spans):
    H, Hkv, D, ps, pmax, qt = 8, 4, 64, 16, 8, 8
    arrs = _flat_batch(1, spans, H, Hkv, D, 64, ps, pmax, q_tile=qt, empty_tiles=1)
    want = np.asarray(
        jra.ragged_paged_attention(
            *_jax(*arrs), num_kv_heads=Hkv, q_tile=qt, interpret=True
        )
    )
    got = tra.ragged_paged_attention(*_torch(*arrs), num_kv_heads=Hkv, q_tile=qt).numpy()
    positions = arrs[-1]
    live = positions >= 0
    np.testing.assert_allclose(got[live], want[live], **F32)
    empty = np.repeat(positions.reshape(-1, qt).max(axis=1) < 0, qt)
    assert empty.sum() == qt
    assert (want[empty] == 0.0).all() and (got[empty] == 0.0).all()


def test_decode_shape_zeroes_inactive_rows():
    lengths = np.asarray([1, 17, 0, 5], np.int32)
    H, Hkv, D, ps, pmax = 4, 4, 32, 8, 8
    spans = [(1, max(int(n), 1)) for n in lengths]
    q, k, v, table, _, _ = _flat_batch(2, spans, H, Hkv, D, 64, ps, pmax, q_tile=1)
    table = table[: len(lengths)]
    want = np.asarray(
        jra.ragged_decode_attention(
            *_jax(q, k, v, table, lengths), num_kv_heads=Hkv, interpret=True
        )
    )
    got = tra.ragged_decode_attention(
        *_torch(q, k, v, table, lengths), num_kv_heads=Hkv
    ).numpy()
    active = lengths > 0
    np.testing.assert_allclose(got[active], want[active], **F32)
    assert (got[~active] == 0.0).all() and (want[~active] == 0.0).all()


def test_gqa_grouping():
    # 8 query heads over 2 kv heads: groups must read their own kv head.
    spans = [(2, 23), (3, 7)]
    H, Hkv, D, ps, pmax = 8, 2, 32, 16, 8
    arrs = _flat_batch(3, spans, H, Hkv, D, 16, ps, pmax, q_tile=8)
    want = np.asarray(
        jra.ragged_paged_attention(*_jax(*arrs), num_kv_heads=Hkv, q_tile=8, interpret=True)
    )
    got = tra.ragged_paged_attention(*_torch(*arrs), num_kv_heads=Hkv, q_tile=8).numpy()
    live = arrs[-1] >= 0
    np.testing.assert_allclose(got[live], want[live], **F32)


def test_bfloat16_cache():
    spans = [(1, 19), (6, 60), (2, 33)]
    H, Hkv, D, ps, pmax = 4, 4, 64, 32, 16
    arrs = _flat_batch(4, spans, H, Hkv, D, 32, ps, pmax, q_tile=8)
    want = jra.ragged_paged_attention_ref(*_jax(*arrs, dtype=jnp.bfloat16), num_kv_heads=Hkv)
    got = tra.ragged_paged_attention(
        *_torch(*arrs, dtype=torch.bfloat16), num_kv_heads=Hkv, q_tile=8
    )
    assert got.dtype == torch.bfloat16
    live = arrs[-1] >= 0
    np.testing.assert_allclose(
        got.float().numpy()[live], np.asarray(want, np.float32)[live], atol=2e-2
    )


def test_ragged_supported_gate():
    assert tra.ragged_supported(16, 8, 128, torch.bfloat16, 32, 8)
    assert tra.ragged_supported(16, 8, 64, torch.float32, 32, 1)
    assert not tra.ragged_supported(16, 8, 256, torch.bfloat16, 32, 8)  # D
    assert not tra.ragged_supported(16, 8, 128, torch.float16, 32, 8)  # dtype
    assert not tra.ragged_supported(16, 8, 128, torch.bfloat16, 32, 4)  # q_tile
    assert not tra.ragged_supported(16, 1, 128, torch.bfloat16, 16, 8)  # 128 rows

