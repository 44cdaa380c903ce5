"""Engine configuration.

Counterpart of ``dynamo_exp_tpu/engine/config.py``, trimmed to the
fields this slice reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.config import ModelConfig

ATTENTION_IMPLS = ("auto", "kernel", "reference")


@dataclass
class EngineConfig:
    model: ModelConfig
    max_decode_slots: int = 8  # rows that can hold a sequence at once
    page_size: int = 16  # tokens per KV page (also the reuse-hash block)
    num_pages: int = 512  # global page pool size
    max_model_len: int = 2048  # per-sequence token capacity
    # Up to ``prefill_batch`` prompts share one dispatch; each is fed
    # ``prefill_chunk`` tokens at a time so decode interleaves.
    prefill_batch: int = 8
    prefill_chunk: int = 512
    # Decode steps per pure-decode dispatch: the host syncs once per
    # window (a row may overshoot its stop by up to window-1 discards).
    decode_window: int = 8
    # Flat-stream alignment of each row's query span for the ragged
    # kernel's mixed shape: every q_tile slice belongs to one row.
    ragged_q_tile: int = 8
    kv_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    default_max_tokens: int = 256
    eos_token_ids: list[int] = field(default_factory=list)
    # Refcounted reuse of registered full pages across sequences.
    prefix_sharing: bool = True
    # "kernel": the ragged CUDA kernel (on a CUDA device; on the CPU its
    # wrapper computes the plain version); "reference": the plain
    # PyTorch attention; "auto": the kernel on CUDA, the plain version
    # on the CPU.
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.kv_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unsupported kv_dtype: {self.kv_dtype!r}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, "
                f"got {self.attention_impl!r}"
            )

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.kv_dtype == "bfloat16" else torch.float32

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_model_len + self.page_size - 1) // self.page_size
