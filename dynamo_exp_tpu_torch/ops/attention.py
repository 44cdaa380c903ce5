"""Paged KV writes and the plain paged attention.

Counterpart of ``dynamo_exp_tpu/ops/attention.py``. The KV cache is a
page pool per layer, ``[num_pages, page_size, Hkv*D]`` with (kv head,
head_dim) fused into the last dim, the JAX package's layout. A step
first writes its new K/V at (page_table[pos // ps], pos % ps), then
attends over the sequence's pages masked by position (write-then-
gather), so prefill and decode share one path.

``paged_attention`` is the plain version: a gather plus a masked
softmax, always correct, and the reference the ragged kernel is held
against. Matmuls take the cache dtype's values and accumulate in
float32, softmax runs in float32 — the JAX path's numeric contract
(``preferred_element_type=float32``) written out with explicit casts.
"""

from __future__ import annotations

import torch


def write_kv_pages(
    k_cache: torch.Tensor,  # [P, ps, Hkv*D], updated in place
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [N, Hkv*D] flattened new tokens
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [N] int global page id per new token
    offsets: torch.Tensor,  # [N] int in-page offset per new token
    valid: torch.Tensor | None,  # [N] bool, int64 indices of the valid rows, or None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into the page pool, in place (JAX donates
    the pools to the same effect). Invalid rows are DROPPED, not
    clamped, as JAX's ``mode="drop"`` scatter writes nothing for an
    out-of-range page: either only the valid rows reach ``index_put_``
    (``valid`` a mask, or the precomputed index vector of the valid
    rows, so a forward over many layers selects them, one host sync,
    once), or ``valid`` is None and the caller already routed invalid
    rows to a scratch page no page table holds (no host sync)."""
    if valid is not None:
        rows = valid.nonzero().squeeze(1) if valid.dtype == torch.bool else valid
        page_ids, offsets = page_ids[rows], offsets[rows]
        k_new, v_new = k_new[rows], v_new[rows]
    k_cache.index_put_((page_ids, offsets), k_new.to(k_cache.dtype))
    v_cache.index_put_((page_ids, offsets), v_new.to(v_cache.dtype))
    return k_cache, v_cache


def paged_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [P, ps, Hkv*D]
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int
    q_positions: torch.Tensor,  # [B, T] int global position of each query
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Causal attention of queries against their sequences' pages.

    Returns [B, T, H, D] in q's dtype. Keys past a query's position are
    masked, so stale slots never leak. ``window`` additionally masks
    keys older than ``q_pos - window + 1`` (mistral/gemma2); ``softcap``
    applies gemma2's tanh cap to the scores before masking."""
    B, T, H, D = q.shape
    ps = k_cache.shape[1]
    Hkv = k_cache.shape[2] // D
    S = page_table.shape[1] * ps
    scale = sm_scale if sm_scale is not None else D**-0.5

    k = k_cache[page_table].reshape(B, S, Hkv, D).to(torch.float32)
    v = v_cache[page_table].reshape(B, S, Hkv, D)
    qpk = H // Hkv
    qg = q.reshape(B, T, Hkv, qpk, D).to(k_cache.dtype).to(torch.float32)
    scores = torch.einsum("bthqd,bshd->bhqts", qg, k) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    kv_pos = torch.arange(S, device=q.device)[None, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    mask = kv_pos <= qp
    if window is not None:
        mask &= kv_pos > qp - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqts,bshd->bthqd",
        probs.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    )
    return out.reshape(B, T, H, D).to(q.dtype)
