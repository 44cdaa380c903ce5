"""Model configuration for the port's Llama-family transformers.

A copy of ``dynamo_exp_tpu/models/config.py`` (``ModelConfig``,
``PRESETS``, ``from_pretrained``): the port imports nothing of the JAX
package, so it keeps its own. Family differences are fields, not
subclasses; the port serves the dense families (llama, mistral, qwen2,
qwen3, phi3, gemma, gemma2, gemma3) and raises on the sparse-MoE ones
(``models/llama.py``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


def _layer_types_of(cfg: dict, model_type: str) -> tuple[str, ...] | None:
    """Per-layer attention kinds. Older gemma3 configs ship only
    ``sliding_window_pattern`` (every Nth layer is full attention, HF:
    ``is_sliding = bool((layer_idx + 1) % pattern)``) — derive the
    explicit list rather than silently treating every layer as sliding
    (which would also rope the full layers at the local base)."""
    explicit = cfg.get("layer_types")
    if explicit:
        return tuple(explicit)
    pattern = cfg.get("sliding_window_pattern")
    if model_type == "gemma3_text" and pattern:
        return tuple(
            "sliding_attention" if (i + 1) % pattern else "full_attention"
            for i in range(cfg.get("num_hidden_layers", 32))
        )
    return None


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-transformer architecture hyperparameters. One config class
    covers the supported families — llama (Llama 2/3,
    DeepSeek-R1-Distill-Llama, TinyLlama), mistral (sliding-window
    attention), qwen2 (QKV bias), qwen3 (per-head q/k norm), gemma
    (gelu FFN, +1 norm offset, scaled embeddings), and the sparse-MoE
    line mixtral / qwen2_moe (shared expert) / qwen3_moe — with family
    differences expressed as fields, not subclasses."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    # hash=False: HF rope_scaling is a dict (unhashable); excluded from the
    # dataclass hash so ModelConfig stays hashable.
    rope_scaling: dict | None = field(default=None, hash=False)
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # qwen3: per-head RMSNorm on q and k after projection, before rope.
    qk_norm: bool = False
    # FFN activation: "silu" (llama/qwen/mistral) or "gelu_tanh" (gemma).
    hidden_act: str = "silu"
    # gemma: norm weights are stored as w with scale (1 + w), and the
    # embedding output is scaled by sqrt(hidden_size).
    rms_norm_offset: bool = False
    scale_embeddings: bool = False
    # gemma2: extra norms on the attention and FFN OUTPUTS (4 norms per
    # layer), tanh softcaps on attention scores and final logits, an
    # explicit attention scale, and sliding window on alternating
    # (even) layers only.
    post_norms: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    alt_sliding_window: bool = False
    # gemma3: explicit per-layer attention kinds ("sliding_attention" /
    # "full_attention", 5:1 pattern) and a separate rope base for the
    # sliding layers (full layers use rope_theta + rope_scaling).
    layer_types: tuple[str, ...] | None = None
    rope_local_base_freq: float | None = None
    # Mistral: keys older than (q_pos - sliding_window + 1) are masked.
    # None = full causal attention.
    sliding_window: int | None = None
    # Sparse MoE (mixtral/qwen3_moe): 0 experts = dense FFN.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True
    # qwen3_moe: per-expert ffn width differs from the dense
    # intermediate_size. None = same as intermediate_size (mixtral).
    moe_intermediate_size: int | None = None
    # qwen2_moe: an always-on shared expert of this width, blended via
    # a learned sigmoid gate. None = no shared expert.
    shared_expert_intermediate_size: int | None = None
    dtype: str = "bfloat16"
    model_type: str = "llama"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_intermediate_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @classmethod
    def from_hf_config(cls, cfg: dict) -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict. Family quirks:
        qwen2 always carries QKV bias (its HF config has no
        ``attention_bias`` key); mistral/mixtral carry ``sliding_window``;
        mixtral's experts are ``num_local_experts``."""
        model_type = cfg.get("model_type", "llama")
        if model_type in ("qwen2_moe", "qwen3_moe") and (
            cfg.get("mlp_only_layers") or cfg.get("decoder_sparse_step", 1) != 1
        ):
            # Per-layer dense/sparse mixing (mixed dense+sparse layers)
            # is outside every family this config describes.
            raise ValueError(
                "qwen MoE checkpoints with mlp_only_layers / "
                "decoder_sparse_step != 1 (mixed dense+sparse layers) "
                "are not supported"
            )
        return cls(
            vocab_size=cfg.get("vocab_size", 32000),
            hidden_size=cfg.get("hidden_size", 4096),
            intermediate_size=cfg.get("intermediate_size", 11008),
            num_layers=cfg.get("num_hidden_layers", 32),
            num_heads=cfg.get("num_attention_heads", 32),
            num_kv_heads=cfg.get(
                "num_key_value_heads", cfg.get("num_attention_heads", 32)
            ),
            head_dim=cfg.get("head_dim"),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get(
                "attention_bias", model_type in ("qwen2", "qwen2_moe")
            ),
            qk_norm=model_type in ("qwen3", "qwen3_moe", "gemma3_text"),
            hidden_act=(
                "gelu_tanh"
                if str(
                    cfg.get("hidden_activation")
                    or cfg.get("hidden_act", "silu")
                ).startswith("gelu")
                else "silu"
            ),
            rms_norm_offset=model_type in ("gemma", "gemma2", "gemma3_text"),
            scale_embeddings=model_type in ("gemma", "gemma2", "gemma3_text"),
            post_norms=model_type in ("gemma2", "gemma3_text"),
            attn_logit_softcap=cfg.get("attn_logit_softcapping"),
            final_logit_softcap=cfg.get("final_logit_softcapping"),
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar"),
            alt_sliding_window=model_type == "gemma2",
            layer_types=_layer_types_of(cfg, model_type),
            rope_local_base_freq=cfg.get("rope_local_base_freq"),
            # qwen2 ships a sliding_window value with
            # use_sliding_window=false — honour the switch, or every
            # HF-loaded qwen2 would be refused for a window it never uses.
            sliding_window=(
                cfg.get("sliding_window")
                if cfg.get("use_sliding_window", True)
                else None
            ),
            num_experts=cfg.get(
                "num_local_experts", cfg.get("num_experts", 0)
            ) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            # HF defaults differ per family: Mixtral always renormalizes
            # top-k router weights; Qwen2Moe/Qwen3Moe default to False
            # when config.json omits the key.
            norm_topk_prob=cfg.get("norm_topk_prob", model_type == "mixtral"),
            moe_intermediate_size=cfg.get("moe_intermediate_size"),
            shared_expert_intermediate_size=cfg.get(
                "shared_expert_intermediate_size"
            ),
            dtype=cfg.get("torch_dtype", "bfloat16"),
            model_type=model_type,
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


# Presets used by tests and chip_smoke.py.
TINY = ModelConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    max_position_embeddings=512,
    rms_norm_eps=1e-5,
)

LLAMA_1B = ModelConfig(  # Llama-3.2-1B shape
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    rope_theta=500000.0,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
)

LLAMA_3B = ModelConfig(  # Llama-3.2-3B shape
    vocab_size=128256,
    hidden_size=3072,
    intermediate_size=8192,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
)

LLAMA_8B = ModelConfig(  # Llama-3.1-8B / DeepSeek-R1-Distill-Llama-8B shape
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=500000.0,
    max_position_embeddings=8192,
)

TINY_QWEN2 = ModelConfig(  # qwen2 family shape: QKV bias, tied embeddings
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    max_position_embeddings=512,
    attention_bias=True,
    tie_word_embeddings=True,
    model_type="qwen2",
)

TINY_MOE = ModelConfig(  # mixtral family shape: 4 experts, top-2 routing
    vocab_size=256,
    hidden_size=64,
    intermediate_size=96,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    max_position_embeddings=512,
    num_experts=4,
    num_experts_per_tok=2,
    model_type="mixtral",
)

TINY_QWEN3 = ModelConfig(  # qwen3 family shape: q/k norm, no bias
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    max_position_embeddings=512,
    qk_norm=True,
    tie_word_embeddings=True,
    rms_norm_eps=1e-6,
    model_type="qwen3",
)

QWEN3_8B = ModelConfig(  # Qwen3-8B shape
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    max_position_embeddings=40960,
    qk_norm=True,
    rms_norm_eps=1e-6,
    model_type="qwen3",
)

QWEN2_7B = ModelConfig(  # Qwen2-7B-Instruct shape
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    attention_bias=True,
    rms_norm_eps=1e-6,
    model_type="qwen2",
)

GEMMA_2B = ModelConfig(  # Gemma-2B shape
    vocab_size=256000,
    hidden_size=2048,
    intermediate_size=16384,
    num_layers=18,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    rms_norm_eps=1e-6,
    hidden_act="gelu_tanh",
    rms_norm_offset=True,
    scale_embeddings=True,
    model_type="gemma",
)

GEMMA2_9B = ModelConfig(  # Gemma-2-9B shape
    vocab_size=256000,
    hidden_size=3584,
    intermediate_size=14336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    rms_norm_eps=1e-6,
    hidden_act="gelu_tanh",
    rms_norm_offset=True,
    scale_embeddings=True,
    post_norms=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=256.0,
    sliding_window=4096,
    alt_sliding_window=True,
    model_type="gemma2",
)

MISTRAL_7B = ModelConfig(  # Mistral-7B-v0.1 shape (4k sliding window)
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    sliding_window=4096,
    max_position_embeddings=32768,
    model_type="mistral",
)

MIXTRAL_8X7B = ModelConfig(  # Mixtral-8x7B shape
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    num_experts=8,
    num_experts_per_tok=2,
    model_type="mixtral",
)

PRESETS = {
    "tiny": TINY,
    "tiny-qwen2": TINY_QWEN2,
    "tiny-qwen3": TINY_QWEN3,
    "tiny-moe": TINY_MOE,
    "llama-1b": LLAMA_1B,
    "llama-3b": LLAMA_3B,
    "llama-8b": LLAMA_8B,
    "qwen2-7b": QWEN2_7B,
    "qwen3-8b": QWEN3_8B,
    "gemma-2b": GEMMA_2B,
    "gemma2-9b": GEMMA2_9B,
    "mistral-7b": MISTRAL_7B,
    "mixtral-8x7b": MIXTRAL_8X7B,
}
