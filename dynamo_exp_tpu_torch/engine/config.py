"""Engine configuration.

Counterpart of ``dynamo_exp_tpu/engine/config.py``, trimmed to the
fields the port reads (the KV-pressure, tiering, chaining and
speculation knobs keep the JAX package's defaults; the ``DYN_*``
environment overrides are not ported, ROADMAP Queue 1 item 4(d)).
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
    # Keep one decode window in flight: dispatch window N+1 straight from
    # window N's carry on the device (tokens, positions) while the host
    # still consumes window N. False forces dispatch -> sync -> consume.
    chained_decode: bool = True
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
    # G2 host-memory KV tier: number of host pages (0 disables offload).
    # Device-evicted pages spill here (pinned memory on a CUDA engine)
    # and are injected back on a prefix match instead of recomputed.
    host_cache_pages: int = 0
    # KV-pressure preemption: once an ACTIVE row has been hard-stalled
    # (cannot feed its next token: the pool is dry) this long, the
    # lowest-priority / youngest ACTIVE sequence releases its pages and
    # requeues as a deterministic continuation. Negative disables it.
    preempt_stall_grace_s: float = 0.5
    # A sequence preempted this many times is exempt from further
    # preemption (no re-prefill live-lock).
    max_preemptions_per_seq: int = 2
    # Footprint-packed admission: admit the first waiting sequence whose
    # lifetime KV forecast (prompt + max_tokens, minus its resident
    # prefix) fits the free pages; never refuses what first-fit would
    # admit (engine/tiering.select_packed_index).
    kv_packing: bool = True
    packing_scan_limit: int = 16  # waiting-queue prefix scanned per pass
    packing_max_defers: int = 64  # bypasses before a seq becomes a barrier
    # G2 -> G1 prefetch of waiting prompts' host-resident prefixes ahead
    # of admission (needs host_cache_pages > 0).
    kv_prefetch: bool = True
    prefetch_depth: int = 4  # waiting sequences scanned per pass
    # Free + parked pages prefetch never consumes (decode growth wins).
    prefetch_reserve_pages: int = 4
    # Proactive cold-tail offload: once a row has been hard-stalled this
    # long, swap the coldest eligible row's pages out to the host tier
    # instead of preempting (bytes kept, resume token-identical).
    # Negative disables; needs a host tier; must be below
    # preempt_stall_grace_s to fire first.
    proactive_offload_grace_s: float = 0.0
    # Speculative decoding: "off", or a drafter name from the spec/
    # registry ("ngram" = prompt lookup, no second model).
    spec_mode: str = "off"
    # Initial per-row draft length; the adaptive controller moves it
    # within [spec_min_draft, spec_max_draft] from the rolling
    # acceptance rate (spec_adaptive=False pins it).
    spec_draft_len: int = 4
    spec_min_draft: int = 1
    spec_max_draft: int = 8
    spec_adaptive: bool = True
    # Prompt-lookup drafter: trailing n-gram widths tried, longest first.
    spec_ngram: int = 3
    spec_ngram_min: int = 1
    # Miss backoff: after this many empty proposals in a row the row is
    # not probed until its context grows by spec_retry_tokens.
    spec_miss_limit: int = 4
    spec_retry_tokens: int = 32

    def __post_init__(self):
        if self.kv_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unsupported kv_dtype: {self.kv_dtype!r}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, "
                f"got {self.attention_impl!r}"
            )
        if self.spec_max_draft < self.spec_min_draft or self.spec_min_draft < 1:
            raise ValueError(
                f"bad spec draft bounds [{self.spec_min_draft}, "
                f"{self.spec_max_draft}]"
            )
        self.spec_draft_len = min(
            max(self.spec_draft_len, self.spec_min_draft), self.spec_max_draft
        )

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.kv_dtype == "bfloat16" else torch.float32

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_model_len + self.page_size - 1) // self.page_size
