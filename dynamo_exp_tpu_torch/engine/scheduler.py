"""Continuous-batching scheduler: sequences, decode slots, admission.

Trimmed counterpart of ``dynamo_exp_tpu/engine/scheduler.py``. Waiting
prompts are admitted to slots as soon as pages are available and then
prefilled in chunks of ``prefill_chunk`` tokens, several sequences per
dispatch, so decode interleaves between the chunks of a long prompt.
With ``kv_packing`` the next admission is the first waiting sequence
whose lifetime KV forecast fits the free pages (``tiering.py``). Under
KV pressure the engine preempts (:meth:`Scheduler.preempt`): the victim
requeues as a deterministic continuation of itself. Single-writer: all
mutation happens on the engine loop thread.

Left out (ROADMAP): remote KV, deadlines and reaping (Queue 1 item
9(b)), and telemetry.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from itertools import islice
from typing import Callable

from ..protocols.common import BackendInput, FinishReason
from ..tokens import chain_hash, compute_block_hash
from .config import EngineConfig
from .kv_manager import KvPageManager
from .tiering import KvFootprintForecast, SwapRecord, select_packed_index


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
    # Priority class (0 low, 1 normal, 2 high): preemption and swap take
    # low first; packed admission never bypasses a higher class.
    priority: int = 1
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    # The pool ran dry for this row's next window (it may still step).
    stalled: bool = False
    # When a hard stall began (the row cannot feed its next token): the
    # preemption and proactive-offload grace clock. 0.0 = not stalled.
    stalled_since: float = 0.0
    # KV-pressure preemptions so far (bounded by max_preemptions_per_seq).
    preemptions: int = 0
    # G2 -> G1 injections the engine runs right after admission:
    # (page_id, seq_hash, k_page, v_page) per page.
    pending_uploads: list = field(default_factory=list)
    # Cached prompt block hashes for the footprint forecast and the
    # prefetch planner (cleared by preemption: the prompt changes).
    forecast_hashes: list[int] | None = None
    # Times packed admission bypassed this waiting sequence.
    packing_defers: int = 0
    # Swapped out: the row's ledger while its cold pages live in the
    # host tier (None = resident), and when the swap began.
    swap: SwapRecord | None = None
    swapped_since: float = 0.0
    # A stop found while a chained successor window is still in flight:
    # the finish (and its page release) waits until that successor is
    # consumed.
    pending_finish: FinishReason | None = None
    # Speculation counters of this request: verify dispatches it rode,
    # drafts proposed, drafts accepted, tokens emitted by them.
    spec_dispatches: int = 0
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_emitted_tokens: int = 0

    @property
    def pos(self) -> int:
        """Next token position to be confirmed-written."""
        return len(self.tokens)

    def last_token(self) -> int:
        return self.tokens[-1]


def select_preemption_victim(candidates, max_preemptions: int):
    """KV-pressure victim policy: lowest priority first, youngest
    (latest submitted) on ties: the least sunk cost and the weakest
    claim. Sequences at their preemption bound are exempt, as are rows
    with a deferred finish in flight. Returns None when nothing
    qualifies (``dynamo_exp_tpu/engine/scheduler.py``'s function without
    the disaggregation exemption, which the port does not have)."""
    eligible = [
        s
        for s in candidates
        if s is not None
        and s.state is SeqState.ACTIVE
        and s.pending_finish is None
        and s.preemptions < max_preemptions
    ]
    if not eligible:
        return None
    return min(eligible, key=lambda s: (s.priority, -s.submitted_at))


class Scheduler:
    def __init__(self, cfg: EngineConfig, kv: KvPageManager):
        self.cfg = cfg
        self.kv = kv
        self.waiting: deque[Sequence] = deque()
        self.slots: list[Sequence | None] = [None] * cfg.max_decode_slots
        self.active_count = 0  # PREFILL + ACTIVE (slot holders)
        # Footprint-packed admission; None = plain first-fit FIFO.
        self.forecast = KvFootprintForecast(kv, cfg) if cfg.kv_packing else None

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
        """Bind the next admissible waiting sequence to a slot + pages
        and put it in PREFILL. None if nothing can be admitted now."""
        while self.waiting:
            if self.waiting[0].is_cancelled():
                seq = self.waiting.popleft()
                seq.state = SeqState.FINISHED
                seq.emit([], FinishReason.CANCELLED)
                continue
            slot = self.free_slot()
            if slot is None:
                return None
            seq = self._pick_admission()
            ps = self.kv.page_size
            if (
                not seq.prompt
                or len(seq.prompt) > self.cfg.max_model_len
                # A prompt needing more pages than the pool has can never
                # be allocated: reject instead of waiting forever. A
                # preempted sequence's continuation (its whole context)
                # can outgrow a pool smaller than max_model_len.
                or (len(seq.prompt) + ps - 1) // ps > self.kv.num_pages
            ):
                self._remove_waiting(seq)
                seq.state = SeqState.FINISHED
                seq.emit([], FinishReason.ERROR)
                continue
            alloc = self.kv.allocate_sequence(seq.prompt, self.cfg.max_pages_per_seq)
            if alloc is None:
                return None  # pool exhausted; retry after decode frees pages
            self._remove_waiting(seq)
            seq.page_ids, seq.cached_len = alloc.page_ids, alloc.cached_len
            seq.pending_uploads = alloc.uploads
            seq.prompt_hashes = alloc.hashes
            # Registered full pages the hash chain resumes after: G1
            # matches and G2 uploads.
            seq.hashed_pages = alloc.cached_pages
            seq.parent_hash = (
                alloc.hashes[seq.hashed_pages - 1] if seq.hashed_pages else None
            )
            self._register_uploads(seq, alloc.hashes)
            seq.tokens = list(seq.prompt)
            seq.prefill_sent = seq.cached_len
            seq.slot = slot
            seq.state = SeqState.PREFILL
            self.slots[slot] = seq
            self.active_count += 1
            return seq
        return None

    def _remove_waiting(self, seq: Sequence) -> None:
        """Drop one sequence from the waiting deque by identity (packed
        admission can pick past the head)."""
        for i, s in enumerate(self.waiting):
            if s is seq:
                del self.waiting[i]
                return

    def _pick_admission(self) -> Sequence:
        """The head under first-fit; with packing, the first waiting
        sequence whose lifetime forecast fits the free pages, or the
        head when none does (packing never refuses an admission
        first-fit would make). Guards in ``select_packed_index``."""
        head = self.waiting[0]
        if self.forecast is None or len(self.waiting) == 1:
            return head
        headroom = self.forecast.headroom()
        cand = list(islice(self.waiting, self.cfg.packing_scan_limit))
        entries = [
            (self.forecast.forecast(s).fresh_pages <= headroom, s.priority, s.packing_defers)
            for s in cand
        ]
        idx = select_packed_index(entries, self.cfg.packing_max_defers)
        if idx is None or idx == 0:
            return head
        for s in cand[:idx]:
            s.packing_defers += 1
        return cand[idx]

    def _register_uploads(self, seq: Sequence, hashes: list[int]) -> None:
        """Pages coming back from the host tier are device-resident
        again: register them, so G1 matching and KV events see them. The
        engine enqueues their inject right after this admission, ahead
        of every forward that can read them."""
        if not seq.pending_uploads:
            return
        ps = self.kv.page_size
        first = seq.hashed_pages - len(seq.pending_uploads)
        parent = hashes[first - 1] if first > 0 else None
        for j, (pid, seq_hash, _, _) in enumerate(seq.pending_uploads):
            i = first + j
            self.kv.register_full_page(
                pid, seq_hash, parent_hash=parent, tokens=seq.prompt[i * ps : (i + 1) * ps]
            )
            parent = seq_hash

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

    # ------------------------------------------------------------ preemption
    def preemption_victim(self, max_preemptions: int) -> Sequence | None:
        """The sequence KV-pressure preemption evicts next."""
        return select_preemption_victim(self.slots, max_preemptions)

    def preempt(self, seq: Sequence) -> None:
        """Unbind an ACTIVE sequence from its slot, release its pages and
        requeue it at the back as a deterministic continuation of
        itself: the prompt is the full context so far, ``max_tokens`` /
        ``min_tokens`` shrink by what it generated and ``resume_offset``
        accumulates it. Its registered pages park (written back to the
        host tier on eviction), so a re-admission usually prefix-hits
        its own context. Counter-based sampling keys every draw by
        (seed, absolute position), so the resumed stream is the
        uninterrupted one; the client's stream only ever sees tokens
        past the splice, and its usage stays the original request's."""
        k = seq.generated
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            self.active_count -= 1
            seq.slot = -1
        self.kv.release_sequence(seq.page_ids)
        seq.page_ids = []
        stop = seq.stop.copy()
        sc = stop.stop_conditions
        orig_max = sc.max_tokens if sc.max_tokens is not None else self.cfg.default_max_tokens
        sc.max_tokens = max(orig_max - k, 1)
        if sc.min_tokens:
            sc.min_tokens = max(sc.min_tokens - k, 0)
        # How much of the new prompt is journaled completion: the penalty
        # counts rebuild over it at re-prefill (engine._finish_first_token).
        stop.resume_offset = (seq.stop.resume_offset or 0) + k
        stop.token_ids = list(seq.tokens)
        seq.stop = stop
        seq.prompt = list(seq.tokens)
        seq.tokens = []
        seq.generated = 0
        seq.prefill_sent = 0
        seq.cached_len = 0
        seq.stalled = False
        seq.stalled_since = 0.0
        seq.pending_finish = None
        seq.pending_uploads = []
        seq.prompt_hashes = []
        seq.hashed_pages = 0
        seq.parent_hash = None
        # The continuation's prompt is new (forecast hashes stale), its
        # queue history resets, and a swap record dies with the old page
        # table (its host pages age out of the LRU as plain cache).
        seq.forecast_hashes = None
        seq.packing_defers = 0
        seq.swap = None
        seq.swapped_since = 0.0
        seq.preemptions += 1
        seq.state = SeqState.WAITING
        self.waiting.append(seq)

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
            "request_stalled_slots": sum(
                1 for s in self.slots if s is not None and s.stalled
            ),
            # ACTIVE rows whose cold pages live in the host tier.
            "request_swapped_slots": sum(
                1 for s in self.slots if s is not None and s.swap is not None
            ),
            "num_requests_running": running,
            "num_requests_waiting": len(self.waiting),
            "kv_active_blocks": self.kv.active_pages,
            "kv_total_blocks": self.kv.num_pages,
            "gpu_cache_usage_perc": self.kv.usage,
            "gpu_prefix_cache_hit_rate": self.kv.hit_rate(),
            **self.kv.gauges(),
        }
