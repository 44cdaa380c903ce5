"""Llama-family transformer over a paged KV cache, in PyTorch.

Counterpart of ``dynamo_exp_tpu/models/llama.py`` for the dense
families: llama, mistral (a sliding window on every layer), qwen2 (QKV
bias), qwen3 (per-head q/k RMSNorm), phi3 (the llama layer; its packed
tensors are split by the loader), gemma (GELU-tanh FFN, ``(1 + w)``
norms, embeddings scaled by ``sqrt(hidden)``), gemma2 (post-attention
and post-FFN norms, attention and final-logit softcaps, a query scale
of its own, a window on even layers) and gemma3 (q/k norms, a window
on the layers ``layer_types`` names sliding, which rope at a local
base), and the sparse-MoE families: mixtral, qwen3_moe and qwen2_moe
(whose layers add an always-on shared expert blended by a learned
sigmoid gate), their FFN in ``ops/moe.py``. The model is an
``nn.Module`` whose linear weights are stored
``[out, in]`` (``F.linear``'s layout; ``models/convert.py`` transposes
the JAX package's ``x @ W`` weights). Where JAX scans over stacked
layers, this loops over ``model.layers`` in Python. The KV pools
``[L, P, ps, Hkv*D]`` are updated in place where JAX donates them.

Attention goes through the ragged kernel wrappers
(``ops/ragged_attention.py``) when ``attn_impl="kernel"``, or through
the plain ``paged_attention`` / ``ragged_paged_attention_ref`` when
``attn_impl="reference"``. The default, ``"auto"``, is the kernel on
CUDA tensors and the plain version on CPU tensors.

Tensor parallelism (JAX ``param_shardings`` / ``kv_cache_shardings``,
``models/llama.py:108-168``): a ``Llama`` built with ``tp > 1`` holds
one rank's megatron shard (``TP_SPLIT_DIMS``): q/k/v (and their
biases) split over heads, ``wo`` over its input, the FFN's gate/up
over the ffn width and down over its input (each expert alike, and
qwen2_moe's shared expert), ``embed`` and ``lm_head`` over the vocab;
norms, the routers and rope are whole on every rank. Its KV pools hold
its ``Hkv / tp`` heads. ``forward`` / ``forward_ragged`` then take the
ranks' ``parallel.comm.Comm``: a sum over the ranks after ``wo`` and
after ``w_down`` (one for the experts and the shared expert together),
before gemma2's post-norms, as JAX's ``reduce``; a masked local
embedding lookup summed over the ranks; the local logits gathered to
the full vocab. The attention kernels run at the rank's head counts. At
``tp=1`` there is no comm and no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import paged_attention, write_kv_pages
from ..ops.moe import moe_ffn
from ..ops.ring_attention import ring_attention
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


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# The megatron split of each weight over the tp ranks, by name: the dim
# of this package's [out, in] layout that is split, counted from the end
# so a stacked expert weight [E, out, in] splits as one expert's does.
# Every weight not named here is whole on every rank.
TP_SPLIT_DIMS = {
    "embed": -2, "lm_head": -2,
    "wq": -2, "wk": -2, "wv": -2, "bq": -1, "bk": -1, "bv": -1, "wo": -1,
    "w_gate": -2, "w_up": -2, "w_down": -1,
    "shared_gate": -2, "shared_up": -2, "shared_down": -1,
}


def tp_slice(t: torch.Tensor, name: str, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s part (a view) of ``t``, the whole weight ``name``
    (an expert's slot ``"w_gate.3"`` splits as ``w_gate``)."""
    dim = TP_SPLIT_DIMS.get(name.partition(".")[0])
    if tp == 1 or dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def tp_full_shape(shape, name: str, tp: int) -> list[int]:
    """The whole weight's shape of a rank's part of shape ``shape``."""
    full = list(shape)
    dim = TP_SPLIT_DIMS.get(name.partition(".")[0])
    if dim is not None:
        full[dim] *= tp
    return full


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise unless every split width divides by ``tp``: q heads, kv
    heads, the vocab and the ffn width (each expert's, and the shared
    expert's), as the JAX package's ``device_put`` of the shards
    refuses an uneven split."""
    if tp < 1:
        raise ValueError(f"tp must be at least 1, got {tp}")
    widths = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
              "vocab_size": cfg.vocab_size}
    if cfg.is_moe:
        widths["expert_intermediate_size"] = cfg.expert_intermediate_size
        if cfg.shared_expert_intermediate_size:
            widths["shared_expert_intermediate_size"] = cfg.shared_expert_intermediate_size
    else:
        widths["intermediate_size"] = cfg.intermediate_size
    uneven = {k: v for k, v in widths.items() if v % tp}
    if uneven:
        raise ValueError(f"tp={tp} does not divide {uneven}")


class LlamaLayer(nn.Module):
    """One decoder layer's weights (one rank's shard of them at
    ``tp > 1``); linear weights are [out, in]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device, tp: int = 1):
        super().__init__()
        hd, D = cfg.head_dim_, cfg.hidden_size
        H, Hkv, I = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.intermediate_size // tp
        self.attn_norm = _param((D,), dtype, device)
        self.wq = _param((H * hd, D), dtype, device)
        self.wk = _param((Hkv * hd, D), dtype, device)
        self.wv = _param((Hkv * hd, D), dtype, device)
        self.wo = _param((D, H * hd), dtype, device)
        self.mlp_norm = _param((D,), dtype, device)
        self.router = None
        self.shared_gate = self.shared_up = self.shared_down = self.shared_router = None
        if cfg.is_moe:  # stacked experts, each [out, in]
            E, Ie = cfg.num_experts, cfg.expert_intermediate_size // tp
            self.router = _param((E, D), dtype, device)
            self.w_gate = _param((E, Ie, D), dtype, device)
            self.w_up = _param((E, Ie, D), dtype, device)
            self.w_down = _param((E, D, Ie), dtype, device)
            if cfg.shared_expert_intermediate_size:  # qwen2_moe
                Is = cfg.shared_expert_intermediate_size // tp
                self.shared_gate = _param((Is, D), dtype, device)
                self.shared_up = _param((Is, D), dtype, device)
                self.shared_down = _param((D, Is), dtype, device)
                self.shared_router = _param((D,), dtype, device)
        else:
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
    """The Llama-family model: embedding, layers, final norm and
    (untied) vocab head; with ``tp > 1``, rank ``rank``'s shard of it.
    Construction allocates uninitialised weights on ``device``; fill
    them with :func:`init_params` or ``models.convert.params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device="cuda", tp: int = 1, rank: int = 0):
        super().__init__()
        check_tp(cfg, tp)
        if not 0 <= rank < tp:
            raise ValueError(f"rank {rank} is outside tp={tp}")
        dt = model_dtype(cfg)
        self.cfg, self.tp, self.rank = cfg, tp, rank
        # This rank's attention heads (the kernels' head counts).
        self.num_heads, self.num_kv_heads = cfg.num_heads // tp, cfg.num_kv_heads // tp
        V = cfg.vocab_size // tp
        self.embed = _param((V, cfg.hidden_size), dt, device)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dt, device, tp) for _ in range(cfg.num_layers)
        )
        self.final_norm = _param((cfg.hidden_size,), dt, device)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((V, cfg.hidden_size), dt, device)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head


@torch.no_grad()
def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda", rank: int = 0, tp: int = 1
) -> Llama:
    """Random weights on ``device`` from ``generator`` (which must live
    on that device): normal / sqrt(fan_in) for matrices and biases,
    ones for norms (zeros for the post norms of ``(1 + w)`` families) —
    the JAX package's init scheme (not its bits). A stacked expert
    weight is filled one expert at a time, so the float32 temporary is
    one expert's matrix. With ``tp > 1`` every rank draws each whole
    weight and keeps its part, so the ranks' shards of one seed are
    the parts of the ``tp=1`` model of that seed, bit for bit."""
    model = Llama(cfg, device=device, tp=tp, rank=rank)

    def fill(name: str, p: nn.Parameter, fan_in: int | None) -> None:
        if p.dim() == 3:
            for e in range(p.shape[0]):
                fill(name, p[e], fan_in)
            return
        full = tp_full_shape(p.shape, name, tp)
        w = torch.randn(full, generator=generator, device=p.device)
        # A bias's fan-in is its whole length.
        p.copy_(tp_slice(w, name, rank, tp) * (fan_in or full[0]) ** -0.5)

    hd, D = cfg.head_dim_, cfg.hidden_size
    ffn = cfg.expert_intermediate_size if cfg.is_moe else cfg.intermediate_size
    fill("embed", model.embed, D)
    for layer in model.layers:
        for name, fan_in in (
            ("wq", D), ("wk", D), ("wv", D), ("wo", cfg.num_heads * hd),
            ("w_gate", D), ("w_up", D), ("w_down", ffn), ("router", D),
            ("shared_gate", D), ("shared_up", D),
            ("shared_down", cfg.shared_expert_intermediate_size), ("shared_router", D),
        ):
            p = getattr(layer, name)
            if p is not None:
                fill(name, p, fan_in)
        for name in ("bq", "bk", "bv"):
            b = getattr(layer, name)
            if b is not None:
                fill(name, b, None)
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
        fill("lm_head", model.lm_head, D)
    return model


def init_kv_cache(
    cfg: ModelConfig,
    num_pages: int,
    page_size: int,
    dtype: torch.dtype | None = None,
    device="cuda",
    tp: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paged KV pools, each [L, num_pages, ps, Hkv*D], zeroed, with
    (kv head, head_dim) fused into the last dim as in the JAX package;
    a tp rank's hold its ``Hkv / tp`` heads (the JAX pools' shard)."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads // tp * cfg.head_dim_)
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


def _attn_mlp_layer(x, layer: LlamaLayer, cfg, inv_freq, rope_pos, eps, attend, reduce=None):
    """One decoder layer over x [B, T, D]. ``attend(q, k, v)`` is the
    only thing that differs between the forward shapes. Head counts
    come from the weights' shapes, so a tp shard runs the same body;
    ``reduce`` (the sum over the tp ranks) is applied to the two
    row-sharded products' outputs, before gemma2's post-norms and the
    residual adds. None: the weights are whole."""
    red = reduce if reduce is not None else (lambda y: y)
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
    attn_out = red(F.linear(attn.reshape(B, T, -1), layer.wo))
    if layer.post_attn_norm is not None:
        attn_out = rms_norm(attn_out, layer.post_attn_norm, eps, off)
    x = x + attn_out
    h = rms_norm(x, layer.mlp_norm, eps, off)
    if layer.router is not None:
        return x + red(_moe_mlp(h, layer, cfg))
    # The activation in float32, then back to the activation dtype.
    gate = _act(F.linear(h, layer.w_gate).to(torch.float32), cfg.hidden_act).to(x.dtype)
    ffn_out = red(F.linear(gate * F.linear(h, layer.w_up), layer.w_down))
    if layer.post_ffn_norm is not None:
        ffn_out = rms_norm(ffn_out, layer.post_ffn_norm, eps, off)
    return x + ffn_out


def _moe_mlp(h, layer: LlamaLayer, cfg) -> torch.Tensor:
    """The sparse-MoE FFN of h [B, T, D] (JAX ``models/llama.py:255-293``):
    the routed experts, plus qwen2_moe's shared expert scaled by the
    sigmoid of its gate logit in float32, added before the residual. No
    post-FFN norm, as in the JAX package. On a tp shard the routers are
    whole (every rank routes alike) and each expert's ffn width is the
    rank's part: the caller's one sum covers experts and shared expert
    (the blend is the same on every rank, so it commutes with it)."""
    B, T = h.shape[:2]
    y = moe_ffn(
        h.reshape(B * T, -1), layer.router, layer.w_gate, layer.w_up, layer.w_down,
        cfg.num_experts_per_tok, cfg.norm_topk_prob,
    ).reshape(B, T, -1)
    if layer.shared_gate is not None:
        sg = _act(F.linear(h, layer.shared_gate).to(torch.float32), cfg.hidden_act).to(h.dtype)
        s_out = F.linear(sg * F.linear(h, layer.shared_up), layer.shared_down)
        blend = torch.sigmoid((h @ layer.shared_router).to(torch.float32))[..., None]
        y = y + (blend * s_out.to(torch.float32)).to(h.dtype)
    return y


def _final_logits(model: Llama, cfg, x, eps, comm=None) -> torch.Tensor:
    """The vocab head's float32 logits: on a tp shard the rank's part of
    the vocab, pinned and capped, then gathered to the full vocab."""
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
    if comm is not None:
        logits = comm.all_gather(logits, dim=-1)
    return logits


def _embed(model: Llama, cfg, tokens: torch.Tensor, comm=None,
           token_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings; gemma scales them by sqrt(hidden) rounded to the
    parameter dtype first, and multiplies in that dtype, as the JAX
    package does. On a tp shard each rank looks up the ids in its part
    of the vocab, zeros the others, and the ranks' rows are summed
    (exact: one rank holds each row). ``token_embeds`` (same leading
    shape as ``tokens``, hidden last) replaces the lookup, cast to the
    embedding's dtype, whole on every rank."""
    ids = tokens.long()
    if token_embeds is not None:
        x = token_embeds.to(model.embed.dtype)
    elif comm is not None:
        V = model.embed.shape[0]
        local = ids - model.rank * V
        mine = (local >= 0) & (local < V)
        x = model.embed[torch.where(mine, local, 0)] * mine[..., None].to(model.embed.dtype)
        x = comm.all_reduce(x)
    else:
        x = model.embed[ids]
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


def _tp_comm(model: Llama, comm):
    """The comm a forward of ``model`` reduces over: None for a whole
    model, else ``comm``, which must span the model's ranks."""
    if model.tp == 1:
        return None
    if comm is None or comm.world != model.tp or comm.rank != model.rank:
        raise ValueError(f"a tp={model.tp} shard (rank {model.rank}) needs its ranks' comm")
    return comm


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
    comm=None,
    token_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward step; returns (logits [B, T, V] float32, k, v).

    Writes new K/V into the pools first, then attends. The kernel
    (``attn_impl="kernel"``, or ``"auto"`` on CUDA) takes T=1 steps
    only, through ``ragged_decode_attention`` (the decode shape of the
    ragged kernel, one query per row, reading each row's true length);
    a longer step raises: send it through :func:`forward_ragged`. The
    plain version is ``paged_attention`` over the first ``attn_pages``
    table columns, at any T. ``drop_page``: see :func:`_write_coords`.
    ``comm``: the tp ranks' collectives, for a model that is a shard.
    ``token_embeds`` [B, T, D]: soft tokens in place of the id lookup."""
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
    comm = _tp_comm(model, comm)
    reduce = comm.all_reduce if comm is not None else None
    x = _embed(model, cfg, tokens, comm, token_embeds)
    rope_pos = torch.clamp(positions, min=0)
    if use_kernel:
        lengths = torch.clamp(positions[:, 0] + 1, min=0).to(torch.int32)
        table = page_table.to(torch.int32).contiguous()
    else:
        attn_table = page_table if attn_pages is None else page_table[:, :attn_pages]
    hkv = model.num_kv_heads
    fused = hkv * hd

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
                    num_kv_heads=hkv, sm_scale=scale, window=window,
                    softcap=softcap,
                )[:, None]
            return paged_attention(q, kp, vp, attn_table, positions, sm_scale=scale,
                                   window=window, softcap=softcap)

        x = _attn_mlp_layer(x, layer, cfg, inv_freq, rope_pos, eps, attend, reduce)
    return _final_logits(model, cfg, x, eps, comm), k_cache, v_cache


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
    comm=None,
    token_embeds: torch.Tensor | None = None,
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
    :func:`_write_coords`. ``comm``: as for :func:`forward`.
    ``token_embeds`` [N, D]: soft tokens in place of the id lookup (the
    kernel takes a soft-token prompt of any length, where
    :func:`forward` with the kernel takes T=1 only)."""
    attn_impl = resolve_attn(attn_impl, tokens.device)
    N = tokens.shape[0]
    hd, ps, eps = cfg.head_dim_, k_cache.shape[2], cfg.rms_norm_eps
    per_layer = _layer_attention(cfg, tokens.device)
    page_ids, offsets, valid = _write_coords(positions, row_of, page_table, ps, drop_page)
    comm = _tp_comm(model, comm)
    reduce = comm.all_reduce if comm is not None else None
    x = _embed(model, cfg, tokens, comm, token_embeds)[None]  # [1, N, D]
    rope_pos = torch.clamp(positions, min=0)[None]
    fused = model.num_kv_heads * hd
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
            attn = {"num_kv_heads": model.num_kv_heads, "sm_scale": scale, "window": window,
                    "softcap": softcap}
            if attn_impl == "kernel":
                return ragged_paged_attention(
                    q[0].contiguous(), kp, vp, table, rows, pos, q_tile=q_tile, **attn
                )[None]
            return ragged_paged_attention_ref(
                q[0], kp, vp, attn_table, row_of, positions, **attn
            )[None]

        x = _attn_mlp_layer(x, layer, cfg, inv_freq, rope_pos, eps, attend, reduce)
    return _final_logits(model, cfg, x[0][out_idx.long()], eps, comm), k_cache, v_cache


@torch.no_grad()
def forward_ring_prefill(
    model: Llama,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int, the whole prompt; T must divide by sp
    positions: torch.Tensor,  # [B, T] int, -1 for padding
    *,
    ring=None,
    comm=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-parallel prefill by ring attention, composable with
    tensor parallelism (JAX ``models/llama.py:722``).

    Every rank is given the whole prompt and computes its sequence
    shard: sp rank ``s`` of ``ring`` (a ``parallel.comm.Ring``; None =
    sp 1) holds positions ``[s*T/sp, (s+1)*T/sp)``. Every
    non-attention op is local; attention rotates K/V blocks around the
    ring (``ops/ring_attention.py``), so peak activation memory scales
    1/sp. With a model that is a tp shard, ``comm`` is its tp ranks'
    collectives (``parallel.comm.sp_tp_comms``): projections are
    megatron-sharded, row-sharded products are summed over tp, and the
    embedding is vocab-sharded with a masked lookup and a sum.

    Returns this rank's shard: (logits [B, T/sp, V] float32, full vocab
    on every tp rank; k, v [L, B, T/sp, Hkv/tp, D], roped), for the
    caller to scatter into its page pool or hand to a transfer.
    """
    sp = ring.size if ring is not None else 1
    tp = comm.world if comm is not None else 1
    B, T = tokens.shape
    if cfg.sliding_window is not None:
        raise ValueError(
            "ring prefill does not implement sliding-window attention; "
            "use the paged prefill path for mistral-family models"
        )
    if T % sp:
        raise ValueError(f"seq len {T} not divisible by sp={sp}")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"kv heads {cfg.num_kv_heads} not divisible by tp={tp}")
    comm = _tp_comm(model, comm)
    n = T // sp
    lo = (ring.rank if ring is not None else 0) * n
    tok, pos = tokens[:, lo : lo + n], positions[:, lo : lo + n]
    eps = cfg.rms_norm_eps
    per_layer = _layer_attention(cfg, tokens.device)
    reduce = comm.all_reduce if comm is not None else None
    x = _embed(model, cfg, tok, comm)
    rope_pos = torch.clamp(pos, min=0)
    ks, vs = [], []
    for li, layer in enumerate(model.layers):
        inv_freq, _, _, scale = per_layer[li]

        def attend(q, k, v, scale=scale):
            ks.append(k)
            vs.append(v)
            return ring_attention(q, k, v, pos, pos, ring, sm_scale=scale)

        x = _attn_mlp_layer(x, layer, cfg, inv_freq, rope_pos, eps, attend, reduce)
    return _final_logits(model, cfg, x, eps, comm), torch.stack(ks), torch.stack(vs)
