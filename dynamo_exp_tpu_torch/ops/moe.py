"""Mixture-of-experts FFN: exact (dropless) top-k routing, in PyTorch.

Counterpart of ``dynamo_exp_tpu/ops/moe.py``: :func:`moe_router` and
:func:`moe_ffn` of its ``:32-90``, and :func:`moe_ffn_reference`, the
dense oracle of its ``:150-166`` (tests only). ``moe_ffn_ep`` (experts
sharded over a mesh axis) is ROADMAP Queue 1 item 7(d); under tensor
parallelism each rank runs this FFN on its part of every expert's ffn
width (``models/llama.py``).

Expert weights are ``[E, out, in]``, each expert's matrix in
``F.linear``'s layout: ``w_gate`` / ``w_up`` ``[E, I, D]``, ``w_down``
``[E, D, I]``, the router ``[E, D]``.

Dispatch, on every device, with no host sync (a CUDA graph captures
it, and the capture runs under sync debug mode "error"): float32 router
logits and a softmax over all experts, then top-k, renormalised with
``norm_topk_prob``; a stable sort of the flattened expert ids puts each
token's k replicas into expert order; group sizes come from
``scatter_add_`` and their ends from ``cumsum``, both on the device
(``bincount`` syncs to size its output); the gate and up products run
group by group, SiLU in float32 cast back before the product with up
(the JAX order of rounding), then the down product; each replica is
scaled by its float32 routing weight, put back in token order and the
k replicas summed in float32, with one cast at the end. Exact: no
capacity factor, no dropped token. The sum over a token's replicas is
a plain reduction, not an atomic scatter, so a rerun gives the same
bits whatever k.

The grouped products are ``jax.lax.ragged_dot`` in the JAX package:
XLA, not a Pallas kernel, so there is no TPU kernel to port here. On a
CUDA tensor :func:`grouped_linear` is ``torch._grouped_mm`` (PyTorch's
grouped GEMM for sm_90, which reads the groups' ends from device
memory); it was chosen once, on an H100 with torch 2.11.0+cu128, where
it exists, equals the per-expert loop bit for bit, runs under sync
debug "error" and replays from a CUDA graph. That holds for bf16 only:
in float32 ``_grouped_mm`` takes a fallback that copies the ends to the
host (a sync, and an error inside a capture; the same probe,
``tools/torch_grouped_mm_probe.py``), so a float32 CUDA tensor raises
until a hand-written float32 grouped product lands (ROADMAP Queue 1
item 7(e)). On a CPU tensor it is the
plain version, :func:`grouped_linear_ref`, a loop over the experts that
reads the group sizes on the host. Bound by bytes at decode (each
touched expert's weights are read once) and by operations at a long
prefill chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import launches

# Launches of the grouped product on a card (ops/launches.py): +1 where
# the wrapper calls torch._grouped_mm, nowhere else.
LAUNCHES = launches.counter("moe", ("grouped_mm",))


def grouped_linear_ref(xs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain grouped product: rows ``xs`` [M, in] in expert order,
    ``counts[e]`` of them for expert ``e``, each group times its
    ``w[e]`` [out, in]; [M, out] in ``xs``' dtype. Reads the counts on
    the host (a sync on a card)."""
    out = xs.new_zeros((xs.shape[0], w.shape[1]))
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            out[start : start + n] = F.linear(xs[start : start + n], w[e])
        start += n
    return out


def grouped_linear(
    xs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """The grouped product of :func:`grouped_linear_ref`, with the
    groups' ends ``ends`` (int32, ``cumsum(counts)``) on the device. A
    CUDA tensor goes through ``torch._grouped_mm`` (counted), a CPU
    tensor through the plain loop. A CUDA tensor other than bf16
    raises: ``_grouped_mm`` syncs on it and cannot be captured."""
    if xs.device.type != "cuda":
        return grouped_linear_ref(xs, w, counts)
    if xs.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the MoE FFN on a card runs in bf16 only, got {xs.dtype} x {w.dtype}: "
            "torch._grouped_mm's fallback for other dtypes copies the group ends to the "
            "host, a sync that a CUDA graph capture refuses (ROADMAP Queue 1 item 7(e))")
    if ends.dtype != torch.int32 or ends.shape != (w.shape[0],):
        raise ValueError(f"ends must be int32 [{w.shape[0]}], got {ends.dtype} {tuple(ends.shape)}")
    launches.count("moe", "grouped_mm")
    return torch._grouped_mm(xs.contiguous(), w.transpose(-1, -2), offs=ends)


def moe_router(
    x: torch.Tensor,  # [N, D]
    router_w: torch.Tensor,  # [E, D]
    num_experts_per_tok: int,
    norm_topk_prob: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: (weights [N, K] float32, expert ids [N, K] int64).
    Softmax over all experts first, then top-k (Mixtral's order); with
    ``norm_topk_prob`` the selected weights sum to 1."""
    logits = F.linear(x.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, num_experts_per_tok, dim=-1)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids


def moe_ffn(
    x: torch.Tensor,  # [N, D] tokens
    router_w: torch.Tensor,  # [E, D]
    w_gate: torch.Tensor,  # [E, I, D]
    w_up: torch.Tensor,  # [E, I, D]
    w_down: torch.Tensor,  # [E, D, I]
    num_experts_per_tok: int,
    norm_topk_prob: bool = True,
) -> torch.Tensor:
    """SwiGLU expert FFN with exact top-k dispatch; [N, D] in ``x``'s
    dtype."""
    N, D = x.shape
    E, K = router_w.shape[0], num_experts_per_tok
    weights, ids = moe_router(x, router_w, K, norm_topk_prob)
    flat_ids = ids.reshape(-1)  # [N*K]
    # Stable: each token's k replicas keep a deterministic order.
    order = torch.sort(flat_ids, stable=True).indices
    xs = x[order // K]  # [N*K, D] in expert order
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32))
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    g = grouped_linear(xs, w_gate, counts, ends)
    u = grouped_linear(xs, w_up, counts, ends)
    h = F.silu(g.to(torch.float32)).to(u.dtype) * u
    out = grouped_linear(h, w_down, counts, ends).to(torch.float32)
    out = out * weights.reshape(-1)[order][:, None]
    # Back to token order (a permutation: no two writes meet), then the
    # sum over each token's k replicas.
    unsorted = torch.empty_like(out).index_copy_(0, order, out)
    return unsorted.view(N, K, D).sum(dim=1).to(x.dtype)


def moe_ffn_reference(
    x, router_w, w_gate, w_up, w_down, num_experts_per_tok, norm_topk_prob=True
) -> torch.Tensor:
    """Dense oracle: every expert computes every token and the combine
    weights mask the unselected ones. E times the FLOPs: tests only."""
    N = x.shape[0]
    E = router_w.shape[0]
    weights, ids = moe_router(x, router_w, num_experts_per_tok, norm_topk_prob)
    combine = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, ids, weights)
    g = torch.einsum("nd,eid->eni", x, w_gate)
    u = torch.einsum("nd,eid->eni", x, w_up)
    h = F.silu(g.to(torch.float32)).to(u.dtype) * u
    out = torch.einsum("eni,edi->end", h, w_down)  # [E, N, D]
    y = torch.einsum("ne,end->nd", combine, out.to(torch.float32))
    return y.to(x.dtype)
