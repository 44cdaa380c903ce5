"""Continuous-batching scheduler: sequences, decode slots, admission.

Trimmed counterpart of ``dynamo_exp_tpu/engine/scheduler.py``. Waiting
prompts are admitted to slots as soon as pages are available and then
prefilled in chunks of ``prefill_chunk`` tokens, several sequences per
dispatch, so decode interleaves between the chunks of a long prompt.
Single-writer: all mutation happens on the engine loop thread.

Left out of this slice (ROADMAP): swap and remote KV, the tiering
forecast, preemption, deadlines, and telemetry.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from ..protocols.common import BackendInput, FinishReason
from ..tokens import chain_hash, compute_block_hash
from .config import EngineConfig
from .kv_manager import KvPageManager


class SeqState(enum.Enum):
    WAITING = "waiting"  # queued, no slot/pages yet
    PREFILL = "prefill"  # slot + pages bound, prompt being chunked in
    ACTIVE = "active"  # decoding
    FINISHED = "finished"


@dataclass
class Sequence:
    """One in-flight request's engine-side state."""

    request_id: str
    prompt: list[int]
    stop: BackendInput
    emit: Callable[..., None]  # emit(tokens, finish_reason)
    is_cancelled: Callable[[], bool]
    state: SeqState = SeqState.WAITING
    slot: int = -1
    page_ids: list[int] = field(default_factory=list)
    cached_len: int = 0  # prefix reused from the page pool
    tokens: list[int] = field(default_factory=list)  # prompt + confirmed
    generated: int = 0
    # Prompt tokens already dispatched (including the reused prefix).
    prefill_sent: int = 0
    # Chained hash state for registering full pages.
    parent_hash: int | None = None
    hashed_pages: int = 0
    prompt_hashes: list[int] = field(default_factory=list)
    # Counter-based sampling seed: every draw is keyed by
    # (sample_seed, absolute token position).
    sample_seed: int = 0
    submitted_at: float = 0.0
    first_token_at: float = 0.0

    @property
    def pos(self) -> int:
        """Next token position to be confirmed-written."""
        return len(self.tokens)

    def last_token(self) -> int:
        return self.tokens[-1]


class Scheduler:
    def __init__(self, cfg: EngineConfig, kv: KvPageManager):
        self.cfg = cfg
        self.kv = kv
        self.waiting: deque[Sequence] = deque()
        self.slots: list[Sequence | None] = [None] * cfg.max_decode_slots
        self.active_count = 0  # PREFILL + ACTIVE (slot holders)

    def submit(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return self.active_count > 0 or bool(self.waiting)

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit_next(self) -> Sequence | None:
        """Bind the head waiting sequence to a slot + pages and put it in
        PREFILL. None if nothing can be admitted right now."""
        while self.waiting:
            seq = self.waiting[0]
            if seq.is_cancelled():
                self.waiting.popleft()
                seq.state = SeqState.FINISHED
                seq.emit([], FinishReason.CANCELLED)
                continue
            slot = self.free_slot()
            if slot is None:
                return None
            ps = self.kv.page_size
            if (
                not seq.prompt
                or len(seq.prompt) > self.cfg.max_model_len
                # A prompt needing more pages than the pool has can never
                # be allocated: reject instead of waiting forever.
                or (len(seq.prompt) + ps - 1) // ps > self.kv.num_pages
            ):
                self.waiting.popleft()
                seq.state = SeqState.FINISHED
                seq.emit([], FinishReason.ERROR)
                continue
            alloc = self.kv.allocate_sequence(seq.prompt, self.cfg.max_pages_per_seq)
            if alloc is None:
                return None  # pool exhausted; retry after decode frees pages
            self.waiting.popleft()
            seq.page_ids, seq.cached_len = alloc.page_ids, alloc.cached_len
            seq.prompt_hashes = alloc.hashes
            seq.hashed_pages = alloc.cached_pages
            seq.parent_hash = (
                alloc.hashes[seq.hashed_pages - 1] if seq.hashed_pages else None
            )
            seq.tokens = list(seq.prompt)
            seq.prefill_sent = seq.cached_len
            seq.slot = slot
            seq.state = SeqState.PREFILL
            self.slots[slot] = seq
            self.active_count += 1
            return seq
        return None

    def ensure_pages_until(self, seq: Sequence, position: int) -> bool:
        """Allocate every page a window writing up to ``position``
        (inclusive) crosses into. False if the pool runs dry; pages
        allocated before that stay bound to the sequence."""
        ps = self.kv.page_size
        need = min(position, self.cfg.max_model_len - 1) // ps + 1
        while len(seq.page_ids) < need:
            pid = self.kv.allocate_page()
            if pid is None:
                return False
            seq.page_ids.append(pid)
        return True

    def register_full_pages(self, seq: Sequence) -> None:
        """Register every newly completed page for reuse + KV events.
        Only positions up to ``pos - 1`` have KV written (the newest
        sampled token's KV lands on the next step), hence the -1."""
        ps = self.kv.page_size
        full = (seq.pos - 1) // ps
        while seq.hashed_pages < full:
            i = seq.hashed_pages
            block = seq.tokens[i * ps : (i + 1) * ps]
            if i < len(seq.prompt_hashes):
                seq_hash = seq.prompt_hashes[i]
            else:
                seq_hash = chain_hash(seq.parent_hash, compute_block_hash(block))
            self.kv.register_full_page(
                seq.page_ids[i], seq_hash, parent_hash=seq.parent_hash, tokens=block
            )
            seq.parent_hash = seq_hash
            seq.hashed_pages += 1

    def finish(self, seq: Sequence, reason: FinishReason) -> None:
        if seq.state == SeqState.FINISHED:
            return
        was_bound = seq.state in (SeqState.PREFILL, SeqState.ACTIVE)
        seq.state = SeqState.FINISHED
        if seq.slot >= 0 and was_bound:
            self.slots[seq.slot] = None
            self.active_count -= 1
            seq.slot = -1
        self.kv.release_sequence(seq.page_ids)
        seq.emit([], reason)

    def check_stop(self, seq: Sequence, token: int) -> FinishReason | None:
        sc = seq.stop.stop_conditions
        if seq.generated >= (sc.min_tokens or 0):
            if not sc.ignore_eos and (
                token in self.cfg.eos_token_ids or token in sc.stop_token_ids
            ):
                return FinishReason.EOS
        max_tokens = sc.max_tokens or self.cfg.default_max_tokens
        if seq.generated >= max_tokens:
            return FinishReason.LENGTH
        if seq.pos >= self.cfg.max_model_len:
            return FinishReason.LENGTH
        return None

    def metrics(self) -> dict:
        running = sum(
            1 for s in self.slots if s is not None and s.state is SeqState.ACTIVE
        )
        return {
            "request_active_slots": self.active_count,
            "request_total_slots": self.cfg.max_decode_slots,
            "num_requests_running": running,
            "num_requests_waiting": len(self.waiting),
            "kv_active_blocks": self.kv.active_pages,
            "kv_total_blocks": self.kv.num_pages,
            "gpu_cache_usage_perc": self.kv.usage,
            "gpu_prefix_cache_hit_rate": self.kv.hit_rate(),
        }
