from .attention import paged_attention, write_kv_pages
from .ragged_attention import (
    ragged_decode_attention,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from .rope import apply_rope, rope_frequencies
from .sampling import apply_penalties, sample_tokens_seeded, stop_token_hit

__all__ = [
    "paged_attention",
    "write_kv_pages",
    "ragged_paged_attention",
    "ragged_paged_attention_ref",
    "ragged_decode_attention",
    "apply_rope",
    "rope_frequencies",
    "apply_penalties",
    "sample_tokens_seeded",
    "stop_token_hit",
]
