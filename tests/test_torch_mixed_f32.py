"""The float32 mixed kernel's arithmetic, emulated on the CPU.

``dynamo_exp_tpu_torch/csrc/ragged_attention.cu`` runs float32 pools on
Hopper's tensor cores in 3xTF32, which needs the card. This file keeps
its arithmetic testable without one: ``emulate`` repeats the kernel's
design in plain PyTorch, step for step:

- every product is split as x = hi + lo, hi = x rounded to TF32 (10-bit
  mantissa, to nearest with ties away from zero, as ``cvt.rna``), lo the
  float32 remainder as the tensor core reads it (its low 13 bits
  dropped); QK and PV take hi.hi + hi.lo + lo.hi (``terms=3``) or hi.hi
  alone (``terms=1``, plain TF32). Products of TF32 values are exact in
  float64, so each term's sum is taken there and rounded to float32 once
  per softmax step;
- blocks take runs of q tiles by the kernel's rule (a tile leads a run
  if its index is a multiple of ``run`` or its row differs from the
  previous tile's), hold 64 query rows in (query, q head) order and
  walk the kv positions in steps of 32 at absolute positions, up to the
  run's horizon; each 16-row m-tile keeps two online-softmax states,
  one for the even steps and one for the odd ones (the kernel's two
  warps of an m-tile), which skip the steps past the m-tile's horizon,
  mask only where a row's causal bound falls, and are combined at the
  end in a fixed order;
- the online softmax is the kernel's: scores scaled by scale * log2(e),
  exp2, a rescale factor of exactly 1 when the max stays, per-thread
  partial sums (4 threads a row) reduced at the end.

Held here, on inputs made from a numpy seed:

- at llama-8b's heads (H 32, Hkv 8, D 128, page 16), a 512-query chunk
  at context 2,048 beside a 2,049-token decode row: the 3xTF32 emulation
  against the JAX package's ``ragged_paged_attention_ref`` in float32
  within atol 1e-4 (the kernel's tolerance against the plain version on
  the card), and one-term TF32's error at least 100x larger;
- bit for bit, a row computed alone equals the same row inside a mixed
  batch, where it falls in other runs, warps and horizons;
- on smaller layouts (Qwen2-7B's 7 q heads per kv head, D 64), the
  emulation against the port's plain version within atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.ops import ragged_attention as jra
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

ATOL = 1e-4
ROWS = 64  # query rows a block takes at most
WARP_ROWS = 16  # rows of an m-tile
SPLIT = 2  # states (warps) of an m-tile: step i goes to state i % SPLIT
STEP = 32  # kv tokens per softmax step
MAX_RUN = 8
LOG2E = 1.4426950408889634


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 to nearest, ties away from zero (``cvt.rna``):
    add half of the 13 dropped bits to the magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low mantissa bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def tf32_mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b from TF32 halves: each term's products are exact in float64
    (at most 22 significant bits), its sum taken there; the terms added
    in a fixed order and rounded to float32 once."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + (ah.double() @ bl.double()) + (al.double() @ bh.double())
    return out.float()


def runs_of(row_of: np.ndarray, q_tile: int, run: int) -> list[tuple[int, int]]:
    """(first token, queries) of each block's run of q tiles."""
    n_tiles = len(row_of) // q_tile
    out = []
    for t in range(n_tiles):
        row = row_of[t * q_tile]
        if t % run and row_of[(t - 1) * q_tile] == row:
            continue
        n = 1
        limit = min(n_tiles, (t // run + 1) * run)
        while t + n < limit and row_of[(t + n) * q_tile] == row:
            n += 1
        out.append((t * q_tile, n * q_tile))
    return out


def emulate(q, k, v, table, row_of, positions, num_kv_heads, q_tile=8, terms=3):
    """The float32 mixed kernel's output for float32 tensors ``q [N, H,
    D]``, pools ``[P, ps, Hkv * D]``, ``table [R, Pmax]``, ``row_of`` and
    ``positions [N]`` (int32): see the module docstring."""
    N, H, D = q.shape
    Hkv = num_kv_heads
    qpk = H // Hkv
    ps, pmax = k.shape[1], table.shape[1]
    run = max(1, min(MAX_RUN, ROWS // (qpk * q_tile)))
    rows_np, pos_np = row_of.numpy(), positions.numpy()
    runs = runs_of(rows_np, q_tile, run)
    R = len(runs)
    # Each run's query rows r = i * qpk + g (query i, q head g of the kv head).
    qr = torch.zeros(R, Hkv, ROWS, D)
    qpos = torch.full((R, ROWS), -1, dtype=torch.int64)
    kvlen = torch.zeros(R, dtype=torch.int64)
    for j, (t0, nq) in enumerate(runs):
        qr[j, :, : nq * qpk] = (
            q[t0 : t0 + nq].reshape(nq, Hkv, qpk, D).permute(1, 0, 2, 3).reshape(Hkv, -1, D))
        qpos[j, : nq * qpk] = torch.from_numpy(pos_np[t0 : t0 + nq]).repeat_interleave(qpk)
        kvlen[j] = min(int(pos_np[t0 : t0 + nq].max()) + 1, pmax * ps)
    run_rows = torch.tensor([int(rows_np[t0]) for t0, _ in runs], dtype=torch.int64)
    wq = qpos.view(R, ROWS // WARP_ROWS, WARP_ROWS)
    whor = torch.minimum(kvlen[:, None], wq.max(-1).values + 1)  # [R, warps]
    sl2 = np.float32(D**-0.5) * np.float32(LOG2E)  # as the kernel, in float32

    # Per state: running max, per-thread partial sums, accumulators.
    ms = [torch.full((R, Hkv, ROWS), -1e30) for _ in range(SPLIT)]
    lparts = [torch.zeros(R, Hkv, ROWS, 4) for _ in range(SPLIT)]
    accs = [torch.zeros(R, Hkv, ROWS, D) for _ in range(SPLIT)]
    kf, vf = k.view(-1, Hkv, D), v.view(-1, Hkv, D)
    for c0 in range(0, int(kvlen.max()), STEP):
        tok = c0 + torch.arange(STEP)
        # The staged tokens: zeros past the run's horizon.
        ok = tok[None] < kvlen[:, None]  # [R, STEP]
        page = table[run_rows[:, None], torch.clamp(tok // ps, max=pmax - 1)[None]].long()
        slot = torch.where(ok, page * ps + tok % ps, 0)
        kc = torch.where(ok[..., None, None], kf[slot], 0.0).permute(0, 2, 3, 1)  # [R,Hkv,D,S]
        vc = torch.where(ok[..., None, None], vf[slot], 0.0).permute(0, 2, 1, 3)  # [R,Hkv,S,D]
        live = ok[:, None, :] & (tok[None, None, :] <= qpos[:, :, None])  # [R, ROWS, S]
        part = (c0 // STEP) % SPLIT
        m, lpart, acc = ms[part], lparts[part], accs[part]
        s = tf32_mm(qr, kc, terms) * sl2
        s = torch.where(live[:, None], s, torch.tensor(-1e30))
        mn = torch.maximum(m, s.max(-1).values)
        alpha = torch.where(mn == m, torch.ones(()), torch.exp2(m - mn))
        p = torch.where(live[:, None], torch.exp2(s - mn[..., None]), torch.zeros(()))
        # Thread t of a row holds tokens 8n + 2t and 8n + 2t + 1, summed
        # in order of n, then of the pair.
        pt = p.view(R, Hkv, ROWS, STEP // 8, 4, 2)
        tsum = torch.zeros(R, Hkv, ROWS, 4)
        for n in range(STEP // 8):
            for j in range(2):
                tsum = tsum + pt[..., n, :, j]
        new_l = lpart * alpha[..., None] + tsum
        new_acc = ((acc * alpha[..., None]).double() + tf32_mm(p, vc, terms).double()).float()
        # M-tiles with no token of this step (past their horizon) skip it.
        run_it = (c0 < whor).repeat_interleave(WARP_ROWS, 1)[:, None, :]  # [R, 1, ROWS]
        ms[part] = torch.where(run_it, mn, m)
        lparts[part] = torch.where(run_it[..., None], new_l, lpart)
        accs[part] = torch.where(run_it[..., None], new_acc, acc)
    # The states combine in order: 0 takes 1, 2, ...
    m, lpart, acc = ms[0], lparts[0], accs[0]
    for m2, l2, acc2 in zip(ms[1:], lparts[1:], accs[1:]):
        mn = torch.maximum(m, m2)
        a = torch.where(m == mn, torch.ones(()), torch.exp2(m - mn))
        b = torch.where(m2 == mn, torch.ones(()), torch.exp2(m2 - mn))
        lpart = lpart * a[..., None] + l2 * b[..., None]
        acc = acc * a[..., None] + acc2 * b[..., None]
        m = mn
    lsum = (lpart[..., 0] + lpart[..., 1]) + (lpart[..., 2] + lpart[..., 3])
    res = acc / torch.where(lsum == 0, torch.ones(()), lsum)[..., None]
    out = torch.zeros(N, H, D)
    for j, (t0, nq) in enumerate(runs):
        blk = res[j, :, : nq * qpk].reshape(Hkv, nq, qpk, D).permute(1, 0, 2, 3)
        out[t0 : t0 + nq] = blk.reshape(nq, H, D)
    return out


def flat_batch(seed, spans, H, Hkv, D, ps=16, q_tile=8):
    """A q_tile-aligned flat stream over a scrambled page pool, one empty
    tile at the end; numpy arrays (q, k, v, table, row_of, positions)."""
    rs = np.random.RandomState(seed)
    pmax = max(-(-max(kv, 1) // ps) for _, kv in spans)
    pages = sum(-(-max(kv, 1) // ps) for _, kv in spans) + 4
    k = rs.standard_normal((pages, ps, Hkv * D)).astype(np.float32)
    v = rs.standard_normal((pages, ps, Hkv * D)).astype(np.float32)
    perm = rs.permutation(pages)
    table = np.zeros((len(spans) + 1, pmax), np.int32)
    used, row_of, positions = 0, [], []
    for r, (q_len, kv_len) in enumerate(spans):
        n = -(-max(kv_len, 1) // ps)
        table[r, :n] = perm[used : used + n]
        used += n
        pad = (-q_len) % q_tile
        row_of += [r] * (q_len + pad)
        positions += list(range(kv_len - q_len, kv_len)) + [-1] * pad
    row_of += [len(spans)] * q_tile
    positions += [-1] * q_tile
    q = rs.standard_normal((len(row_of), H, D)).astype(np.float32)
    return (q, k, v, table, np.asarray(row_of, np.int32), np.asarray(positions, np.int32))


def as_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def jax_reference(arrays, num_kv_heads, slice_len=8):
    """JAX's plain version in float32, a few query tokens a call (it
    gathers each token's pages)."""
    q, k, v, table, row_of, positions = arrays
    fn = jax.jit(lambda q, r, p, k, v, t: jra.ragged_paged_attention_ref(
        q, k, v, t, r, p, num_kv_heads=num_kv_heads))
    kj, vj, tj = jnp.asarray(k), jnp.asarray(v), jnp.asarray(table)
    out = []
    for s in range(0, len(q), slice_len):
        sl = slice(s, s + slice_len)
        out.append(np.asarray(fn(jnp.asarray(q[sl]), jnp.asarray(row_of[sl]),
                                 jnp.asarray(positions[sl]), kj, vj, tj)))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def llama_8b_case():
    """A 512-query prefill chunk at context 2,048 beside a 2,049-token
    decode row, llama-8b heads: (valid tokens, JAX reference, 3xTF32 and
    one-term TF32 emulations)."""
    arrays = flat_batch(0, [(512, 2048), (1, 2049)], 32, 8, 128)
    args = as_torch(arrays)
    valid = arrays[5] >= 0
    want = jax_reference(arrays, 8)[valid]
    got = {terms: emulate(*args, num_kv_heads=8, terms=terms).numpy()[valid]
           for terms in (3, 1)}
    return want, got


def test_3xtf32_emulation_matches_jax_reference_at_llama_8b_heads(llama_8b_case):
    want, got = llama_8b_case
    err = np.abs(got[3] - want).max()
    assert np.isfinite(got[3]).all() and err <= ATOL, f"3xTF32 error {err}"


def test_one_term_tf32_error_is_100x_the_3xtf32_error(llama_8b_case):
    want, got = llama_8b_case
    err3 = np.abs(got[3] - want).max()
    err1 = np.abs(got[1] - want).max()
    assert err1 >= 100 * err3, (err1, err3)
    assert err1 > ATOL  # plain TF32 would not hold the float32 tolerance


LAYOUTS = [(32, 8, 128), (28, 4, 128), (8, 4, 64)]
# Rows at offsets that are not multiples of a run, so a row alone falls
# in other runs, warps and horizons than in the batch.
SPANS = [(40, 100), (1, 70), (9, 133), (17, 17), (64, 64), (1, 1), (24, 300)]


@pytest.mark.parametrize("H,Hkv,D", LAYOUTS)
def test_row_alone_equals_row_in_batch_bitwise(H, Hkv, D):
    arrays = flat_batch(1, SPANS, H, Hkv, D)
    q, k, v, table, row_of, pos = as_torch(arrays)
    batch = emulate(q, k, v, table, row_of, pos, num_kv_heads=Hkv)
    for r in range(len(SPANS)):
        idx = torch.nonzero(row_of == r)[:, 0]
        alone = emulate(q[idx], k, v, table[r : r + 1], torch.zeros_like(row_of[idx]),
                        pos[idx], num_kv_heads=Hkv)
        assert torch.equal(alone, batch[idx]), f"row {SPANS[r]}"


@pytest.mark.parametrize("H,Hkv,D", LAYOUTS)
@pytest.mark.parametrize("q_tile", [1, 8])
def test_emulation_matches_plain_version(H, Hkv, D, q_tile):
    """The emulation against the port's plain version (its wrapper on CPU
    tensors), with exact zeros at padding slots and the empty tile."""
    args = as_torch(flat_batch(2, SPANS[:4], H, Hkv, D, q_tile=q_tile))
    got = emulate(*args, num_kv_heads=Hkv, q_tile=q_tile)
    want = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=q_tile)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert (got[args[5] < 0] == 0).all()


def test_tf32_split():
    """hi is x to 10 mantissa bits, ties away from zero; lo keeps the
    rest to 10 more bits, so hi + lo is within 2^-21 of x."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0, 1 / 3, -7.1e-5])
    hi, lo = split(x)
    assert hi[:4].tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]
    assert (tf32_round(hi) == hi).all() and (tf32_trunc(lo) == lo).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0**-21 * x.abs()).all()
