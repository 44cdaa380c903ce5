"""Ring attention: causal attention with the sequence sharded over sp
ranks, K/V blocks rotating around the ring.

Counterpart of ``dynamo_exp_tpu/ops/ring_attention.py``. There the
function runs inside ``shard_map`` and ``lax.ppermute`` passes the
blocks; here each sp rank is a process of its own and
``parallel.comm.Ring.rotate`` sends its block to the next rank and
receives the previous rank's (point to point, over the process group).
Each rank holds T/sp of the sequence, so peak activation memory scales
1/sp.

Math: flash-style online softmax, as in JAX. Each ring step merges one
K/V block into the running (max, denominator, numerator) triple; masked
entries are multiplied out, so fully-masked (query, block) pairs
contribute exactly zero and rows that never see a valid key return
zeros. The blockwise products are plain torch ops in float32 (XLA
einsums in JAX; no Pallas kernel).
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _merge_block(qg, k, v, q_pos, kv_pos, m, l, o, scale):
    """Merge one K/V block into the online-softmax state.

    qg:     [B, Tq, Hkv, G, D] float32 (grouped query heads)
    k, v:   [B, Tk, Hkv, D]
    q_pos:  [B, Tq] int (-1 = padding)
    kv_pos: [B, Tk] int (-1 = padding)
    m, l:   [B, Hkv, G, Tq] running max / denominator
    o:      [B, Hkv, G, Tq, D] running numerator
    """
    kf = k.to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale  # [B,Hkv,G,Tq,Tk]
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = (kp >= 0) & (qp >= 0) & (kp <= qp)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # Multiplicative mask: an all-masked block keeps m at the -1e30
    # floor, where exp(scores - m_new) would be 1; the mask zeroes it.
    p = torch.exp(scores - m_new[..., None]) * mask
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum(
        "bkgts,bskd->bkgtd", p, v.to(torch.float32)
    )
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,  # [B, Tq_local, H, D]
    k: torch.Tensor,  # [B, Tk_local, Hkv, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Tq_local] global positions, -1 = padding
    kv_pos: torch.Tensor,  # [B, Tk_local]
    ring=None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention over a ring-sharded sequence.

    Every rank starts with its own K/V block and passes it around the
    ring ``ring.size - 1`` times (``ring``: a ``parallel.comm.Ring``;
    None = one rank, the local block only); positions travel with the
    blocks, so the causal mask is global-position-exact whatever the
    ring layout. Returns [B, Tq_local, H, D] in q's dtype.
    """
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else D**-0.5
    qg = q.reshape(B, Tq, Hkv, G, D).to(torch.float32)

    m = torch.full((B, Hkv, G, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hkv, G, Tq, D), dtype=torch.float32, device=q.device)

    # Local block first, then rotate-and-merge size-1 times: a
    # merge-then-rotate loop would end with a dead rotation.
    m, l, o = _merge_block(qg, k, v, q_pos, kv_pos, m, l, o, scale)
    steps = ring.size - 1 if ring is not None else 0
    k_c, v_c, pos_c = k, v, kv_pos
    for _ in range(steps):
        k_c, v_c, pos_c = ring.rotate(k_c, v_c, pos_c)
        m, l, o = _merge_block(qg, k_c, v_c, q_pos, pos_c, m, l, o, scale)
    out = o / torch.clamp(l, min=1e-20)[..., None]  # zero rows stay zero
    # [B,Hkv,G,Tq,D] -> [B,Tq,H,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)
