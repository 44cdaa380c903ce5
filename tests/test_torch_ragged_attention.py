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

import json
import os

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


@pytest.mark.parametrize("qt", tra.SUPPORTED_Q_TILES)
@pytest.mark.parametrize("spans", SPANS)
def test_wrapper_matches_pallas_kernel_interpret(spans, qt):
    """Every q_tile of the tuning grid (1, 4, 8, 16), as the TPU kernel
    takes it, with one all-padding tile."""
    H, Hkv, D, ps, pmax = 8, 4, 64, 16, 8
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
    assert tra.ragged_supported(16, 8, 256, torch.bfloat16, 16, 8)  # gemma2-9b
    assert tra.ragged_supported(16, 1, 256, torch.float32, 8, 8)  # gemma-2b
    assert not tra.ragged_supported(16, 8, 96, torch.bfloat16, 32, 8)  # D
    assert not tra.ragged_supported(16, 8, 512, torch.bfloat16, 32, 8)  # D
    assert not tra.ragged_supported(16, 8, 128, torch.float16, 32, 8)  # dtype
    # The tuning grid's q tiles (1, 4, 8, 16); llama-8b at 16 fills 64 rows.
    for qt in (1, 4, 8, 16):
        assert tra.ragged_supported(16, 8, 128, torch.bfloat16, 32, qt)
        assert tra.ragged_supported(16, 8, 256, torch.float32, 16, qt)  # gemma2-9b
    assert not tra.ragged_supported(16, 8, 128, torch.bfloat16, 32, 2)  # q_tile
    assert not tra.ragged_supported(16, 8, 128, torch.bfloat16, 32, 32)  # q_tile
    assert not tra.ragged_supported(16, 4, 128, torch.bfloat16, 32, 16)  # 128 rows
    assert not tra.ragged_supported(16, 1, 128, torch.bfloat16, 16, 8)  # 128 rows



def test_kernel_library_is_rebuilt_when_any_source_is_newer(tmp_path, monkeypatch):
    """The library holds every ``csrc/*.cu``; a library whose stamp
    (the SHA-256 of every source, header and nvcc flag at its build)
    equals the sources' hashes is reused without ``nvcc``, whatever the
    files' mtimes, and one built from other bytes (a header included)
    or with no stamp is rebuilt, which here, without nvcc, raises
    instead of loading a stale library."""
    names = {os.path.basename(f) for f in tra.KERNEL_SOURCES}
    assert {"ragged_attention.cu", "ragged_mixed_tc.cu", "ragged_decode_split.cu"} <= names
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(tra, "_LIB_PATH", str(lib))
    monkeypatch.setattr(tra, "_BUILD_DIR", str(tmp_path))

    def stamp(path, hashes):
        (tmp_path / (path.name + ".sources.json")).write_text(json.dumps(hashes))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tra, "_nvcc", no_nvcc)
    stamp(lib, tra.source_hashes())
    # Older than every source by mtime, yet built from their bytes.
    os.utime(lib, (1, 1))
    assert tra.build_kernel() == str(lib)
    # Another set of sources into another library, by the same rule.
    other = tmp_path / "other.so"
    other.write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc"):  # no stamp yet
        tra.build_kernel(sources=tra.KERNEL_SOURCES[:1], lib_path=str(other))
    stamp(other, tra.source_hashes(tra.KERNEL_SOURCES[:1]))
    assert tra.build_kernel(sources=tra.KERNEL_SOURCES[:1], lib_path=str(other)) == str(other)
    # A header the library was not built from: rebuilt, though no .cu changed.
    header = tmp_path / "touched.cuh"
    header.write_text("")
    monkeypatch.setattr(tra, "_HEADERS", tra._HEADERS + (str(header),))
    with pytest.raises(RuntimeError, match="nvcc"):
        tra.build_kernel()
    # A header whose bytes changed since the build.
    stamp(lib, tra.source_hashes())
    assert tra.build_kernel() == str(lib)
    header.write_text("// edited\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        tra.build_kernel()


# (window, softcap, sm_scale): gemma2's sliding layer (a window shorter
# than the rows, a softcap small enough to bite, a query scale other than
# D**-0.5), its global layer, and mistral's window alone.
WINDOWED = {
    "sliding_softcap_scale": (5, 2.0, 0.1),
    "softcap_scale": (None, 50.0, 20**-0.5),
    "window": (7, None, None),
}
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=0))}


@pytest.mark.parametrize("case", sorted(WINDOWED))
@pytest.mark.parametrize("D,H,Hkv", [(256, 4, 1), (128, 8, 2)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_windows_and_softcaps_match_jax_reference(case, D, H, Hkv, dtype):
    """Both entry points' plain versions (the mixed wrapper's, and the
    decode wrapper's on CPU tensors) with window, softcap and scale,
    against the JAX reference given the same arguments."""
    window, softcap, scale = WINDOWED[case]
    jdt, tdt, tol = DTYPES[dtype]
    kw = dict(num_kv_heads=Hkv, sm_scale=scale, window=window, softcap=softcap)
    spans = [(1, 17), (9, 25), (5, 5), (3, 20)]
    arrs = _flat_batch(5, spans, H, Hkv, D, 64, 8, 8, q_tile=1)
    want = np.asarray(jra.ragged_paged_attention_ref(*_jax(*arrs, dtype=jdt), **kw), np.float32)
    got = tra.ragged_paged_attention_ref(*_torch(*arrs, dtype=tdt), **kw).float().numpy()
    live = arrs[-1] >= 0
    np.testing.assert_allclose(got[live], want[live], **tol)

    lengths = np.asarray([17, 0, 25, 5], np.int32)
    q, k, v, table = arrs[0][:4], arrs[1], arrs[2], arrs[3][:4]
    want = np.asarray(jra.ragged_paged_attention_ref(
        *_jax(q, k, v, table, np.arange(4, dtype=np.int32), lengths - 1, dtype=jdt), **kw),
        np.float32)
    got = tra.ragged_decode_attention(*_torch(q, k, v, table, lengths, dtype=tdt), **kw)
    active = lengths > 0
    np.testing.assert_allclose(got.float().numpy()[active], want[active], **tol)
    assert (got[~torch.from_numpy(active)] == 0).all()


def test_no_window_is_the_jax_packages_full_layer_window():
    """The JAX package passes ``1 << 30`` for a full layer; the port takes
    it, and None, as no window at all."""
    arrs = _flat_batch(6, [(9, 40), (1, 33)], 4, 2, 64, 16, 8, 8, q_tile=1)
    t = _torch(*arrs)
    none = tra.ragged_paged_attention_ref(*t, num_kv_heads=2)
    wide = tra.ragged_paged_attention_ref(*t, num_kv_heads=2, window=1 << 30)
    want = jra.ragged_paged_attention_ref(*_jax(*arrs), num_kv_heads=2, window=1 << 30)
    assert torch.equal(none, wide)
    live = arrs[-1] >= 0
    np.testing.assert_allclose(none.numpy()[live], np.asarray(want)[live], **F32)
