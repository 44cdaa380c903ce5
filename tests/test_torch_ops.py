"""Port parity: paged KV writes, rope and the plain paged attention.

The same numpy inputs (from a seed) go through the JAX package's ops and
the port's, both float32 on the CPU:

- ``write_kv_pages`` drops invalid rows (padding and positions past the
  page table) rather than clamping them into another page: the pools
  must be bit-identical, since both sides only copy values;
- rope with llama3 and linear scaling agrees to atol=rtol=1e-5 (float32
  sin/cos of the same angles);
- ``paged_attention`` with a sliding window, a softcap and a custom
  sm_scale agrees to atol=rtol=1e-5 on live queries (float32 sums in
  another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.ops import attention as jatt
from dynamo_exp_tpu.ops import rope as jrope
from dynamo_exp_tpu_torch.models.llama import _write_coords
from dynamo_exp_tpu_torch.ops import attention as tatt
from dynamo_exp_tpu_torch.ops import rope as trope

F32 = dict(atol=1e-5, rtol=1e-5)


def test_write_kv_pages_drops_invalid_rows():
    rs = np.random.RandomState(0)
    P, ps, fused, pmax = 6, 4, 8, 2
    k0 = rs.standard_normal((P, ps, fused)).astype(np.float32)
    v0 = rs.standard_normal((P, ps, fused)).astype(np.float32)
    table = np.array([[2, 4], [5, 1]], np.int32)
    # Row 0: positions 0..2 and one past its table (8 = page 2 of 2);
    # row 1: padding, then positions 5 and 7 (its second page).
    rows = np.array([0, 0, 0, 0, 1, 1, 1], np.int32)
    positions = np.array([0, 1, 2, 8, -1, 5, 7], np.int32)
    k_new = rs.standard_normal((len(rows), fused)).astype(np.float32)
    v_new = rs.standard_normal((len(rows), fused)).astype(np.float32)

    # The JAX package's coordinates (models/llama.py forward_ragged).
    safe = np.maximum(positions, 0)
    valid = (positions >= 0) & (safe // ps < pmax)
    page_ids = table[rows, np.minimum(safe // ps, pmax - 1)]
    jk, jv = jatt.write_kv_pages(
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(page_ids), jnp.asarray(safe % ps), jnp.asarray(valid),
    )

    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    pids, offs, idx = _write_coords(
        torch.from_numpy(positions), torch.from_numpy(rows), torch.from_numpy(table), ps
    )
    assert idx.tolist() == [0, 1, 2, 5, 6]
    out = tatt.write_kv_pages(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), pids, offs, idx
    )
    assert out[0] is tk  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # A boolean mask drops the same rows as the index vector.
    tk2, tv2 = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tatt.write_kv_pages(
        tk2, tv2, torch.from_numpy(k_new), torch.from_numpy(v_new), pids, offs,
        torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(jk))
    # Pages the invalid rows would have clamped into are untouched.
    np.testing.assert_array_equal(tk.numpy()[[0, 3]], k0[[0, 3]])
    np.testing.assert_array_equal(tk.numpy()[4, 1:], k0[4, 1:])


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        {"type": "linear", "factor": 4.0},
    ],
    ids=["plain", "llama3", "linear"],
)
def test_rope_matches_jax(scaling):
    head_dim, theta = 128, 500000.0
    want_f = np.asarray(jrope.rope_frequencies(head_dim, theta, scaling))
    got_f = trope.rope_frequencies(head_dim, theta, scaling, device="cpu")
    np.testing.assert_allclose(got_f.numpy(), want_f, **F32)

    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 5, 4, head_dim)).astype(np.float32)
    pos = rs.randint(0, 100000, size=(2, 5)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(want_f)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), got_f)
    # Angles reach 1e5 rad: float32 sin/cos of the same angle agree to
    # a few ulps of the angle, hence the looser bound at large positions.
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)
    small = pos < 64
    np.testing.assert_allclose(got.numpy()[small], want[small], **F32)


def test_rope_keeps_dtype_and_rejects_unknown_scaling():
    x = torch.randn(1, 3, 2, 8, dtype=torch.bfloat16)
    f = trope.rope_frequencies(8, 10000.0, device="cpu")
    assert trope.apply_rope(x, torch.arange(3)[None], f).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="rope_scaling"):
        trope.rope_frequencies(
            8, 10000.0, {"rope_type": "yarn", "factor": 2.0}, device="cpu"
        )


@pytest.mark.parametrize(
    "window,softcap,sm_scale",
    [(None, None, None), (5, None, None), (None, 30.0, None), (7, 20.0, 0.1)],
    ids=["plain", "window", "softcap", "all"],
)
def test_paged_attention_matches_jax(window, softcap, sm_scale):
    rs = np.random.RandomState(2)
    B, T, H, Hkv, D, P, ps, pmax = 2, 6, 8, 2, 32, 16, 4, 5
    q = rs.standard_normal((B, T, H, D)).astype(np.float32)
    k = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    v = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    table = rs.permutation(P)[: B * pmax].reshape(B, pmax).astype(np.int32)
    positions = np.array(
        [[10, 11, 12, 13, 14, 15], [0, 1, 2, -1, -1, -1]], np.int32
    )
    want = np.asarray(
        jatt.paged_attention(
            *(jnp.asarray(a) for a in (q, k, v, table, positions)),
            sm_scale=sm_scale, window=window, softcap=softcap,
        )
    )
    got = tatt.paged_attention(
        *(torch.from_numpy(a) for a in (q, k, v, table, positions)),
        sm_scale=sm_scale, window=window, softcap=softcap,
    ).numpy()
    live = positions >= 0
    np.testing.assert_allclose(got[live], want[live], **F32)
