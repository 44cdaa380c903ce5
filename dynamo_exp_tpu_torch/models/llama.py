"""Llama-family transformer over a paged KV cache, in PyTorch.

Counterpart of ``dynamo_exp_tpu/models/llama.py`` for the dense
families: llama, mistral (a sliding window on every layer), qwen2 (QKV
bias), qwen3 (per-head q/k RMSNorm), phi3 (the llama layer; its packed
tensors are split by the loader), gemma (GELU-tanh FFN, ``(1 + w)``
norms, embeddings scaled by ``sqrt(hidden)``), gemma2 (post-attention
and post-FFN norms, attention and final-logit softcaps, a query scale
of its own, a window on even layers) and gemma3 (q/k norms, a window
on the layers ``layer_types`` names sliding, which rope at a local
base). The model is an ``nn.Module`` whose linear weights are stored
``[out, in]`` (``F.linear``'s layout; ``models/convert.py`` transposes
the JAX package's ``x @ W`` weights). Where JAX scans over stacked
layers, this loops over ``model.layers`` in Python. The KV pools
``[L, P, ps, Hkv*D]`` are updated in place where JAX donates them.

Attention goes through the ragged kernel wrappers
(``ops/ragged_attention.py``) when ``attn_impl="kernel"``, or through
the plain ``paged_attention`` / ``ragged_paged_attention_ref`` when
``attn_impl="reference"``. The default, ``"auto"``, is the kernel on
CUDA tensors and the plain version on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import paged_attention, write_kv_pages
from ..ops.ragged_attention import (
    ragged_decode_attention,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from ..ops.rope import apply_rope, rope_frequencies
from .config import ModelConfig

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.bfloat16,  # the JAX package maps float16 to bfloat16 too
}


ATTN_IMPLS = ("auto", "kernel", "reference")


def resolve_attn(attn_impl: str, device: torch.device) -> str:
    """``auto`` is the kernel on CUDA and the plain version on the CPU;
    ``kernel`` and ``reference`` are taken as asked."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if attn_impl == "auto":
        return "kernel" if device.type == "cuda" else "reference"
    return attn_impl


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[str(cfg.dtype)]
    except KeyError:
        raise ValueError(f"unsupported model dtype: {cfg.dtype!r}") from None


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port does not run instead of running it wrongly:
    the sparse-MoE FFN (ROADMAP.md, Queue 1 of the port, item 7)."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP: port Queue 1 item 7, "
            "'tensor/sequence parallelism and MoE')"
        )


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's weights; linear weights are [out, in]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        hd, D = cfg.head_dim_, cfg.hidden_size
        H, Hkv, I = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
        self.attn_norm = _param((D,), dtype, device)
        self.wq = _param((H * hd, D), dtype, device)
        self.wk = _param((Hkv * hd, D), dtype, device)
        self.wv = _param((Hkv * hd, D), dtype, device)
        self.wo = _param((D, H * hd), dtype, device)
        self.mlp_norm = _param((D,), dtype, device)
        self.w_gate = _param((I, D), dtype, device)
        self.w_up = _param((I, D), dtype, device)
        self.w_down = _param((D, I), dtype, device)
        self.bq = self.bk = self.bv = None
        if cfg.attention_bias:  # qwen2: bias on q/k/v, none on o
            self.bq = _param((H * hd,), dtype, device)
            self.bk = _param((Hkv * hd,), dtype, device)
            self.bv = _param((Hkv * hd,), dtype, device)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:  # qwen3, gemma3: per-head q/k RMSNorm before rope
            self.q_norm = _param((hd,), dtype, device)
            self.k_norm = _param((hd,), dtype, device)
        self.post_attn_norm = self.post_ffn_norm = None
        if cfg.post_norms:  # gemma2, gemma3: norms on the blocks' outputs too
            self.post_attn_norm = _param((D,), dtype, device)
            self.post_ffn_norm = _param((D,), dtype, device)


class Llama(nn.Module):
    """The dense Llama-family model: embedding, layers, final norm and
    (untied) vocab head. Construction allocates uninitialised weights
    on ``device``; fill them with :func:`init_params` or
    ``models.convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        dt = model_dtype(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.hidden_size), dt, device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dt, device) for _ in range(cfg.num_layers)
        )
        self.final_norm = _param((cfg.hidden_size,), dt, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((cfg.vocab_size, cfg.hidden_size), dt, device)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head


@torch.no_grad()
def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda"
) -> Llama:
    """Random weights on ``device`` from ``generator`` (which must live
    on that device): normal / sqrt(fan_in) for matrices and biases,
    ones for norms (zeros for the post norms of ``(1 + w)`` families) —
    the JAX package's init scheme (not its bits)."""
    model = Llama(cfg, device=device)

    def fill(p: nn.Parameter, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator, device=p.device)
        p.copy_(w * fan_in**-0.5)

    hd, D = cfg.head_dim_, cfg.hidden_size
    fill(model.embed, D)
    for layer in model.layers:
        for name, fan_in in (
            ("wq", D), ("wk", D), ("wv", D), ("wo", cfg.num_heads * hd),
            ("w_gate", D), ("w_up", D), ("w_down", cfg.intermediate_size),
        ):
            fill(getattr(layer, name), fan_in)
        for name in ("bq", "bk", "bv"):
            b = getattr(layer, name)
            if b is not None:
                fill(b, b.shape[0])
        for name in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
            w = getattr(layer, name)
            if w is not None:
                w.fill_(1.0)
        for name in ("post_attn_norm", "post_ffn_norm"):
            w = getattr(layer, name)
            if w is not None:
                w.fill_(0.0 if cfg.rms_norm_offset else 1.0)
    model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        fill(model.lm_head, D)
    return model


def init_kv_cache(
    cfg: ModelConfig,
    num_pages: int,
    page_size: int,
    dtype: torch.dtype | None = None,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paged KV pools, each [L, num_pages, ps, Hkv*D], zeroed, with
    (kv head, head_dim) fused into the last dim as in the JAX package."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads * cfg.head_dim_)
    dt = dtype or model_dtype(cfg)
    return (
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
    )


def rms_norm(
    x: torch.Tensor, w: torch.Tensor, eps: float, offset: bool = False
) -> torch.Tensor:
    """HF LlamaRMSNorm rounding order: normalise in float32, cast to the
    input dtype, then multiply by the weight. ``offset`` (gemma): the
    scale is ``1 + w`` and the whole product stays float32 until one
    final cast (HF GemmaRMSNorm), as ``1 + w`` in bf16 would round away
    the precision near 1.0 the convention keeps."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    if offset:
        return (normed * (w.to(torch.float32) + 1.0)).to(x.dtype)
    return normed.to(x.dtype) * w


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The FFN's gate activation, on float32 values: GELU-tanh (gemma)
    or SiLU (every other name, as in the JAX package)."""
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _attn_mlp_layer(x, layer: LlamaLayer, cfg, inv_freq, rope_pos, eps, attend):
    """One decoder layer over x [B, T, D]. ``attend(q, k, v)`` is the
    only thing that differs between the forward shapes."""
    B, T = x.shape[:2]
    hd, off = cfg.head_dim_, cfg.rms_norm_offset
    h = rms_norm(x, layer.attn_norm, eps, off)
    q = F.linear(h, layer.wq, layer.bq).reshape(B, T, -1, hd)
    k = F.linear(h, layer.wk, layer.bk).reshape(B, T, -1, hd)
    v = F.linear(h, layer.wv, layer.bv).reshape(B, T, -1, hd)
    if layer.q_norm is not None:  # gemma3 stores these gemma-style too
        q = rms_norm(q, layer.q_norm, eps, off)
        k = rms_norm(k, layer.k_norm, eps, off)
    q = apply_rope(q, rope_pos, inv_freq)
    k = apply_rope(k, rope_pos, inv_freq)
    attn = attend(q, k, v)
    attn_out = F.linear(attn.reshape(B, T, -1), layer.wo)
    if layer.post_attn_norm is not None:
        attn_out = rms_norm(attn_out, layer.post_attn_norm, eps, off)
    x = x + attn_out
    h = rms_norm(x, layer.mlp_norm, eps, off)
    # The activation in float32, then back to the activation dtype.
    gate = _act(F.linear(h, layer.w_gate).to(torch.float32), cfg.hidden_act).to(x.dtype)
    ffn_out = F.linear(gate * F.linear(h, layer.w_up), layer.w_down)
    if layer.post_ffn_norm is not None:
        ffn_out = rms_norm(ffn_out, layer.post_ffn_norm, eps, off)
    return x + ffn_out


def _final_logits(model: Llama, cfg, x, eps) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, eps, cfg.rms_norm_offset)
    head = model.head
    logits = F.linear(x, head).to(torch.float32)
    if head.dtype == torch.bfloat16:
        # Pin the logits to bf16 precision (the JAX package's
        # reduce_precision(..., 8, 7)), so greedy ties break the same
        # way whatever fused the matmul and the argmax.
        logits = logits.to(torch.bfloat16).to(torch.float32)
    if cfg.final_logit_softcap is not None:  # gemma2
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def _embed(model: Llama, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; gemma scales them by sqrt(hidden) rounded to the
    parameter dtype first, and multiplies in that dtype, as the JAX
    package does."""
    x = model.embed[tokens.long()]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    return x


def _layer_attention(cfg: ModelConfig, device) -> list[tuple]:
    """Per layer, as the JAX package's forward reads the config:
    (inverse rope frequencies, sliding window or None, softcap, scale).
    The sliding layers are gemma3's ``layer_types`` ones, gemma2's even
    layers (``alt_sliding_window``) or every layer (mistral, phi3);
    they take ``sliding_window`` where it is set, and gemma3's rope at
    ``rope_local_base_freq`` (no scaling). Every other layer ropes at
    ``rope_theta`` with ``rope_scaling``. The scale is
    ``query_pre_attn_scalar ** -0.5`` where the config sets it
    (gemma2/3), else the kernels' default."""
    hd = cfg.head_dim_
    inv_freq = rope_frequencies(hd, cfg.rope_theta, cfg.rope_scaling, device)
    local = inv_freq
    if cfg.rope_local_base_freq is not None:
        local = rope_frequencies(hd, cfg.rope_local_base_freq, None, device)
    if cfg.layer_types:
        sliding = [t == "sliding_attention" for t in cfg.layer_types]
    else:
        sliding = [not cfg.alt_sliding_window or i % 2 == 0 for i in range(cfg.num_layers)]
    scale = cfg.query_pre_attn_scalar**-0.5 if cfg.query_pre_attn_scalar else None
    return [
        (local, cfg.sliding_window, cfg.attn_logit_softcap, scale) if s
        else (inv_freq, None, cfg.attn_logit_softcap, scale)
        for s in sliding
    ]


def _write_coords(positions, rows_of, page_table, ps, drop_page=None):
    """Page-write coordinates of a flat token list: (page ids, offsets,
    rows to write). Padding (-1) and positions past the table are
    dropped, never clamped into another row's pages: with ``drop_page``
    (a scratch page past the pool's live pages that no table holds)
    they write there and every row is written, with no host sync;
    without it the valid rows are selected by index (one sync)."""
    safe = torch.clamp(positions, min=0).long()
    page_in_seq = safe // ps
    pmax = page_table.shape[1]
    valid = (positions >= 0) & (page_in_seq < pmax)
    page_ids = page_table[rows_of.long(), torch.clamp(page_in_seq, max=pmax - 1)].long()
    if drop_page is not None:
        return torch.where(valid, page_ids, drop_page), safe % ps, None
    return page_ids, safe % ps, valid.nonzero().squeeze(1)


@torch.no_grad()
def forward(
    model: Llama,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int (0 where pos < 0)
    positions: torch.Tensor,  # [B, T] int, -1 for padding
    page_table: torch.Tensor,  # [B, Pmax] int32
    k_cache: torch.Tensor,  # [L, P, ps, Hkv*D], updated in place
    v_cache: torch.Tensor,
    *,
    attn_pages: int | None = None,
    attn_impl: str = "auto",
    drop_page: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward step; returns (logits [B, T, V] float32, k, v).

    Writes new K/V into the pools first, then attends. The kernel
    (``attn_impl="kernel"``, or ``"auto"`` on CUDA) takes T=1 steps
    only, through ``ragged_decode_attention`` (the decode shape of the
    ragged kernel, one query per row, reading each row's true length);
    a longer step raises: send it through :func:`forward_ragged`. The
    plain version is ``paged_attention`` over the first ``attn_pages``
    table columns, at any T. ``drop_page``: see :func:`_write_coords`."""
    B, T = tokens.shape
    use_kernel = resolve_attn(attn_impl, tokens.device) == "kernel"
    if use_kernel and T != 1:
        raise ValueError(
            f"the kernel's decode shape takes T=1, got T={T}: use forward_ragged "
            "or attn_impl='reference'"
        )
    hd, ps, eps = cfg.head_dim_, k_cache.shape[2], cfg.rms_norm_eps
    per_layer = _layer_attention(cfg, tokens.device)
    rows_of = torch.arange(B * T, device=tokens.device) // T
    page_ids, offsets, valid = _write_coords(
        positions.reshape(-1), rows_of, page_table, ps, drop_page
    )
    x = _embed(model, cfg, tokens)
    rope_pos = torch.clamp(positions, min=0)
    if use_kernel:
        lengths = torch.clamp(positions[:, 0] + 1, min=0).to(torch.int32)
        table = page_table.to(torch.int32).contiguous()
    else:
        attn_table = page_table if attn_pages is None else page_table[:, :attn_pages]
    fused = cfg.num_kv_heads * hd

    for li, layer in enumerate(model.layers):
        kp, vp = k_cache[li], v_cache[li]
        inv_freq, window, softcap, scale = per_layer[li]

        def attend(q, k, v, kp=kp, vp=vp, window=window):
            write_kv_pages(
                kp, vp, k.reshape(B * T, fused), v.reshape(B * T, fused),
                page_ids, offsets, valid,
            )
            if use_kernel:
                return ragged_decode_attention(
                    q[:, 0].contiguous(), kp, vp, table, lengths,
                    num_kv_heads=cfg.num_kv_heads, sm_scale=scale, window=window,
                    softcap=softcap,
                )[:, None]
            return paged_attention(q, kp, vp, attn_table, positions, sm_scale=scale,
                                   window=window, softcap=softcap)

        x = _attn_mlp_layer(x, layer, cfg, inv_freq, rope_pos, eps, attend)
    return _final_logits(model, cfg, x, eps), k_cache, v_cache


@torch.no_grad()
def forward_ragged(
    model: Llama,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [N] int flat query stream (0 where pos < 0)
    positions: torch.Tensor,  # [N] int32 absolute positions, -1 = padding
    row_of: torch.Tensor,  # [N] int32 owning batch row per token
    page_table: torch.Tensor,  # [R, Pmax] int32
    k_cache: torch.Tensor,  # [L, P, ps, Hkv*D], updated in place
    v_cache: torch.Tensor,
    out_idx: torch.Tensor,  # [M] int flat indices projected to logits
    *,
    attn_pages: int | None = None,
    attn_impl: str = "auto",
    q_tile: int = 8,
    drop_page: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over a flat mixed batch (prefill chunks and decode
    steps in one token stream); returns (logits [M, V] float32, k, v).

    Every non-attention op is per token, so the transformer runs on the
    flat [N] stream. Attention is the ragged kernel wrapper
    (``attn_impl="kernel"``, or ``"auto"`` on CUDA; the caller aligned
    each row's span to ``q_tile``) or the plain reference over the
    first ``attn_pages`` table columns. Only ``out_idx`` positions reach
    the vocab head (the engine's verify spans ride there beside each
    row's last position, one projection for all). ``drop_page``: see
    :func:`_write_coords`."""
    attn_impl = resolve_attn(attn_impl, tokens.device)
    N = tokens.shape[0]
    hd, ps, eps = cfg.head_dim_, k_cache.shape[2], cfg.rms_norm_eps
    per_layer = _layer_attention(cfg, tokens.device)
    page_ids, offsets, valid = _write_coords(positions, row_of, page_table, ps, drop_page)
    x = _embed(model, cfg, tokens)[None]  # [1, N, D]
    rope_pos = torch.clamp(positions, min=0)[None]
    fused = cfg.num_kv_heads * hd
    if attn_impl == "kernel":
        table = page_table.to(torch.int32).contiguous()
        rows = row_of.to(torch.int32).contiguous()
        pos = positions.to(torch.int32).contiguous()
    else:
        attn_table = page_table if attn_pages is None else page_table[:, :attn_pages]

    for li, layer in enumerate(model.layers):
        kp, vp = k_cache[li], v_cache[li]
        inv_freq, window, softcap, scale = per_layer[li]

        def attend(q, k, v, kp=kp, vp=vp, window=window):
            write_kv_pages(
                kp, vp, k.reshape(N, fused), v.reshape(N, fused),
                page_ids, offsets, valid,
            )
            attn = {"num_kv_heads": cfg.num_kv_heads, "sm_scale": scale, "window": window,
                    "softcap": softcap}
            if attn_impl == "kernel":
                return ragged_paged_attention(
                    q[0].contiguous(), kp, vp, table, rows, pos, q_tile=q_tile, **attn
                )[None]
            return ragged_paged_attention_ref(
                q[0], kp, vp, attn_table, row_of, positions, **attn
            )[None]

        x = _attn_mlp_layer(x, layer, cfg, inv_freq, rope_pos, eps, attend)
    return _final_logits(model, cfg, x[0][out_idx.long()], eps), k_cache, v_cache
