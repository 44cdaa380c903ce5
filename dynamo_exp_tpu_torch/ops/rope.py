"""Rotary position embeddings (Llama-style, with Llama-3 rope scaling).

Counterpart of ``dynamo_exp_tpu/ops/rope.py``: computed in float32 and
cast back to the input dtype (RoPE precision matters for long context).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device


def rope_frequencies(
    head_dim: int,
    theta: float,
    scaling: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] float32 on ``device``, with
    optional llama3 or linear scaling. gemma3's sliding layers take a
    second set at ``rope_local_base_freq`` without scaling
    (``models/llama.py``)."""
    exps = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=resolve_device(device)
    )
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    if not scaling:
        return inv_freq
    kind = scaling.get("rope_type", scaling.get("type"))
    if kind in (None, "default"):
        return inv_freq
    if kind == "linear":
        return inv_freq / scaling["factor"]
    if kind != "llama3":
        raise ValueError(f"unsupported rope_scaling type: {kind!r}")
    factor = scaling["factor"]
    low = scaling.get("low_freq_factor", 1.0)
    high = scaling.get("high_freq_factor", 4.0)
    old_ctx = scaling.get("original_max_position_embeddings", 8192)
    wavelen = 2 * math.pi / inv_freq
    low_wl = old_ctx / low
    high_wl = old_ctx / high
    smooth = (old_ctx / wavelen - low) / (high - low)
    return torch.where(
        wavelen > low_wl,
        inv_freq / factor,
        torch.where(
            wavelen < high_wl,
            inv_freq,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
) -> torch.Tensor:
    """Rotate ``x``: [..., T, H, D] by per-token ``positions``: [..., T].

    The HF "half-split" convention (rotate_half), matching Llama
    checkpoints: pairs are (x[i], x[i + D/2])."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    xf = x.to(torch.float32)
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
