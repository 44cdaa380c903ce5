"""Continuous-batching scheduler: sequences, decode slots, admission.

Trimmed counterpart of ``dynamo_exp_tpu/engine/scheduler.py``. Waiting
prompts are admitted to slots as soon as pages are available and then
prefilled in chunks of ``prefill_chunk`` tokens, several sequences per
dispatch, so decode interleaves between the chunks of a long prompt.
With ``kv_packing`` the next admission is the first waiting sequence
whose lifetime KV forecast fits the free pages (``tiering.py``). Under
KV pressure the engine preempts (:meth:`Scheduler.preempt`): the victim
requeues as a deterministic continuation of itself. A sequence carries
its request's deadline: :meth:`Scheduler.reap_waiting` drops cancelled
and expired sequences anywhere in the waiting queue, and admission never
binds an expired one. Finishes emit the request's ``decode`` span and,
with the engine's flight recorder, ``finish`` and ``preempt`` events.
Single-writer: all mutation happens on the engine loop thread.

Disaggregation: a sequence carrying :class:`RemoteKv` (prefill computed
by a remote prefill worker) is admitted as any other, then injected
instead of prefilled; a sequence with ``extract_cb`` (a prefill
worker's) hands its prompt pages to the callback at its first token and
is exempt from preemption and swap-out.

Request anatomy (``telemetry/anatomy.py``): a sequence carries the JAX
scheduler's ``anat_*`` accumulators, host clock sums that survive
preemption; :meth:`Scheduler.preempt` closes its open segments, and
:meth:`Scheduler.finish` puts the swap and stall seconds on the decode
span (``swap_stall_s``) and calls the engine's ``on_finish`` tap before
the pages are released.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from itertools import islice
from typing import Callable

from ..protocols.common import BackendInput, FinishReason
from ..telemetry import get_telemetry
from ..tokens import chain_hash, compute_block_hash
from .config import EngineConfig
from .kv_manager import KvPageManager
from .tiering import KvFootprintForecast, SwapRecord, select_packed_index


@dataclass
class RemoteKv:
    """Prefill computed elsewhere (disaggregation): the first sampled
    token and the prompt's KV pages, host tensors ``(k, v)`` of shape
    ``[L, page_size, Hkv*D]`` each (the pools' page layout)."""

    first_token: int
    pages: list
    # Suffix-only transfer: ``pages[i]`` is prompt page ``skip_pages +
    # i``; the first ``skip_pages`` are resident here, pinned under
    # ``pin_lease`` since the routing decision (released at inject).
    skip_pages: int = 0
    pin_lease: str | None = None


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
    # End-to-end deadline (unix seconds, 0 = none), from the request's
    # context at submission.
    deadline_unix: float = 0.0
    # The request's trace context (captured from the submitting task:
    # the loop thread does not share its contextvar) and unix-time stage
    # stamps.
    trace: object | None = None
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    last_emit_at: float = 0.0
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
    # Attached pages another sequence is still filling: the first
    # prefill dispatch waits until their fills are dispatched.
    wait_fill: list = field(default_factory=list)
    # The partial tail attached read-shared (-1 = none): copied before
    # this sequence's first write into it.
    shared_tail_pid: int = -1
    # Prompt pages whose fill this sequence has marked dispatched.
    fill_marked: int = 0
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
    # Disaggregation: the remote prefill's KV to inject at admission
    # instead of prefilling (decode worker), whether the prompt's KV
    # came that way, and the prefill worker's extract hook
    # ``extract_cb(first_token, pages, lease_id)`` with the leading
    # pages it must not ship (the decode side holds them).
    remote_kv: RemoteKv | None = None
    remote_prefilled: bool = False
    extract_cb: Callable[[int, list, str], None] | None = None
    extract_skip: int = 0
    # Request anatomy: host wall-time sums over the request's whole life
    # (preemption resets decode state, never these): first-admission
    # queue wait, prefill and decode wall per life, first-use capture
    # stall inside prefill, swap and stall windows inside decode,
    # preempt -> re-admit requeue time, and the page-residency integral
    # (pages x slot-resident wall, booked at each preempt and finish).
    # anat_compile_mark holds the profiler's capture-seconds total at
    # admission; anat_preempted_at the last preempt's time (0 = not
    # preempted now).
    anat_queue_s: float = 0.0
    anat_prefill_s: float = 0.0
    anat_decode_s: float = 0.0
    anat_compile_s: float = 0.0
    anat_swap_s: float = 0.0
    anat_preempt_s: float = 0.0
    anat_page_s: float = 0.0
    anat_compile_mark: float = 0.0
    anat_preempted_at: float = 0.0

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
    with a deferred finish in flight and extract-mode sequences (a
    prefill worker's: their one token is already sampled). Returns None
    when nothing qualifies (``dynamo_exp_tpu/engine/scheduler.py``'s
    function)."""
    eligible = [
        s
        for s in candidates
        if s is not None
        and s.state is SeqState.ACTIVE
        and s.pending_finish is None
        and s.extract_cb is None
        and s.preemptions < max_preemptions
    ]
    if not eligible:
        return None
    return min(eligible, key=lambda s: (s.priority, -s.submitted_at))


class Scheduler:
    def __init__(self, cfg: EngineConfig, kv: KvPageManager, flight=None):
        self.cfg = cfg
        self.kv = kv
        self.waiting: deque[Sequence] = deque()
        self.slots: list[Sequence | None] = [None] * cfg.max_decode_slots
        self.active_count = 0  # PREFILL + ACTIVE (slot holders)
        # Prompt tokens admitted whose KV the engine computes (the prompt
        # less its cached prefix): the work prefix-aware routing saves.
        self.prefill_tokens = 0
        # The engine's flight recorder (None = recording off).
        self.flight = flight
        # Set by the engine: () -> dispatch-profiler attrs for the
        # decode span.
        self.span_attrs: Callable[[], dict] | None = None
        # Set by the engine: (seq, reason, now, was_bound) -> None, called
        # at finish before the pages are released (the anatomy tap).
        self.on_finish: Callable | None = None
        # Footprint-packed admission; None = plain first-fit FIFO.
        self.forecast = KvFootprintForecast(kv, cfg) if cfg.kv_packing else None

    def submit(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def reap_waiting(self, now: float | None = None) -> int:
        """Drop cancelled and deadline-expired sequences anywhere in the
        waiting queue, so dead requests neither count as queued nor waste
        a prefill when their turn comes. Returns the number reaped."""
        if not self.waiting:
            return 0
        now = time.time() if now is None else now
        kept: list[Sequence] = []
        reaped = 0
        for seq in self.waiting:
            if seq.is_cancelled():
                seq.state = SeqState.FINISHED
                seq.emit([], FinishReason.CANCELLED)
                reaped += 1
            elif seq.deadline_unix and now >= seq.deadline_unix:
                # The client has given up: admitting would burn a slot
                # and a prefill on work nobody reads.
                seq.state = SeqState.FINISHED
                get_telemetry().deadline_exceeded.labels("engine_admission").inc()
                seq.emit([], FinishReason.ERROR)
                reaped += 1
            else:
                kept.append(seq)
        if reaped:
            self.waiting = deque(kept)
        return reaped

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
            head = self.waiting[0]
            if head.deadline_unix and time.time() >= head.deadline_unix:
                # The loop's reap is throttled: expired work never slips
                # through admission in between.
                self.waiting.popleft()
                head.state = SeqState.FINISHED
                get_telemetry().deadline_exceeded.labels("engine_admission").inc()
                head.emit([], FinishReason.ERROR)
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
            alloc = self.kv.allocate_sequence(
                seq.prompt, self.cfg.max_pages_per_seq, seq.request_id
            )
            if alloc is None:
                return None  # pool exhausted; retry after decode frees pages
            self._remove_waiting(seq)
            seq.page_ids, seq.cached_len = alloc.page_ids, alloc.cached_len
            seq.pending_uploads = alloc.uploads
            seq.prompt_hashes = alloc.hashes
            seq.wait_fill = list(alloc.wait_fill)
            seq.shared_tail_pid = alloc.shared_tail[0] if alloc.shared_tail else -1
            n, ps = len(seq.prompt), self.kv.page_size
            if seq.shared_tail_pid < 0 and n and n % ps == 0 and alloc.cached_pages * ps == n:
                # Page-aligned and fully covered: the prefill of the last
                # prompt token rewrites the last slot of a matched page,
                # so that page is treated as a shared tail too.
                seq.shared_tail_pid = alloc.page_ids[alloc.cached_pages - 1]
            # Registered full pages the hash chain resumes after: G1
            # matches and G2 uploads (never the partial tail: that page
            # registers under this sequence's own chain once its copy
            # is full).
            seq.hashed_pages = alloc.cached_pages
            seq.fill_marked = alloc.cached_pages
            seq.parent_hash = (
                alloc.hashes[seq.hashed_pages - 1] if seq.hashed_pages else None
            )
            self._register_uploads(seq, alloc.hashes)
            seq.tokens = list(seq.prompt)
            seq.prefill_sent = seq.cached_len
            self.prefill_tokens += len(seq.prompt) - seq.cached_len
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
        again: register them, so G1 matching and KV events see them, as
        pending fills of this sequence until the engine's inject
        (``_apply_uploads``, right after this admission) marks them
        filled."""
        if not seq.pending_uploads:
            return
        ps = self.kv.page_size
        first = seq.hashed_pages - len(seq.pending_uploads)
        parent = hashes[first - 1] if first > 0 else None
        for j, (pid, seq_hash, _, _) in enumerate(seq.pending_uploads):
            i = first + j
            self.kv.register_full_page(
                pid, seq_hash, parent_hash=parent, tokens=seq.prompt[i * ps : (i + 1) * ps],
                content_ready=False,
            )
            self.kv.begin_fill(pid, seq.request_id)
            parent = seq_hash

    # ----------------------------------------------------------- fill gating
    def fill_ready(self, seq: Sequence) -> bool:
        """True once every attached page this sequence reads has had its
        fill dispatched. An orphan (its filler went away first) is
        claimed here: a fully covered prompt block is filled by this
        sequence itself; an orphaned partial tail is swapped for a
        fresh private page instead (other holders may still need the
        original)."""
        if not seq.wait_fill:
            return True
        ps = self.kv.page_size
        still: list[int] = []
        for pid in seq.wait_fill:
            state = self.kv.fill_state(pid)
            if state == "filled":
                continue
            if state == "pending":
                still.append(pid)
                continue
            idx = seq.page_ids.index(pid)
            if (idx + 1) * ps <= len(seq.prompt) and pid != seq.shared_tail_pid:
                self.kv.claim_fill(pid, seq.request_id)
                seq.fill_marked = min(seq.fill_marked, idx)
            else:
                fresh = self.kv.allocate_page()
                if fresh is None:
                    still.append(pid)  # pool dry: retry next iteration
                    continue
                seq.page_ids[idx] = fresh
                self.kv.release_sequence([pid])
                seq.shared_tail_pid = -1
            seq.prefill_sent = min(seq.prefill_sent, idx * ps)
            seq.cached_len = min(seq.cached_len, idx * ps)
        seq.wait_fill = still
        return not still

    def mark_prefill_filled(self, seq: Sequence) -> None:
        """After a dispatch carrying ``seq``'s prefill chunk: the prompt
        pages it completed are filled in dispatch order, so sharers
        waiting on them may dispatch their reads from the next one on."""
        n_full = min(seq.prefill_sent // self.kv.page_size, len(seq.page_ids))
        if n_full > seq.fill_marked:
            self.kv.mark_filled(seq.page_ids[seq.fill_marked : n_full])
            seq.fill_marked = n_full

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
        now = time.time()
        was_bound = seq.state in (SeqState.PREFILL, SeqState.ACTIVE)
        if seq.first_token_at and seq.extract_cb is None:
            # The request's decode span (first token -> finish), with the
            # trace captured at submission. An extract-mode sequence (a
            # prefill worker's) never decodes.
            get_telemetry().emit_stage(
                "decode", seq.first_token_at, now, seq.trace,
                generated_tokens=seq.generated,
                finish_reason=getattr(reason, "value", str(reason)),
                spec_tokens_per_dispatch=(
                    round(seq.spec_emitted_tokens / seq.spec_dispatches, 4)
                    if seq.spec_dispatches else None
                ),
                pages=len(seq.page_ids),
                priority=seq.priority,
                swap_stall_s=round(seq.anat_swap_s, 6) if seq.anat_swap_s else None,
                **(self.span_attrs() if self.span_attrs is not None else {}),
            )
        if self.flight is not None:
            self.flight.record(
                "finish", req=seq.request_id, slot=seq.slot if was_bound else None,
                reason=getattr(reason, "value", str(reason)), generated=seq.generated,
                pages=len(seq.page_ids), priority=seq.priority,
            )
        # The anatomy tap, with the pages still counted and the decode
        # span's ``now``.
        if self.on_finish is not None:
            self.on_finish(seq, reason, now, was_bound)
        seq.state = SeqState.FINISHED
        if seq.slot >= 0 and was_bound:
            self.slots[seq.slot] = None
            self.active_count -= 1
            seq.slot = -1
        # Fills this sequence owed but never dispatched orphan first so
        # that sharers can claim them; then the references drop.
        self.kv.abort_fills(seq.request_id, seq.page_ids)
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
        now = time.time()
        # Anatomy: close this life's decode (or prefill) segment and any
        # open swap or stall window, book the page residency of the pages
        # about to go, and mark the requeue wait as preemption.
        if seq.first_token_at:
            seq.anat_decode_s += max(now - seq.first_token_at, 0.0)
        elif seq.admitted_at:
            seq.anat_prefill_s += max(now - seq.admitted_at, 0.0)
        if seq.swapped_since:
            seq.anat_swap_s += max(now - seq.swapped_since, 0.0)
        elif seq.stalled_since:
            seq.anat_swap_s += max(now - seq.stalled_since, 0.0)
        if seq.admitted_at:
            seq.anat_page_s += len(seq.page_ids) * max(now - seq.admitted_at, 0.0)
        seq.anat_preempted_at = now
        if self.flight is not None:
            self.flight.record(
                "preempt", req=seq.request_id, slot=seq.slot, generated=k,
                freed_pages=len(seq.page_ids),
            )
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            self.active_count -= 1
            seq.slot = -1
        self.kv.abort_fills(seq.request_id, seq.page_ids)
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
        seq.wait_fill = []
        seq.shared_tail_pid = -1
        seq.fill_marked = 0
        seq.prompt_hashes = []
        seq.hashed_pages = 0
        seq.parent_hash = None
        seq.remote_kv = None
        seq.remote_prefilled = False
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
            "decode_batch_utilization": running / max(self.cfg.max_decode_slots, 1),
            "kv_active_blocks": self.kv.active_pages,
            "kv_total_blocks": self.kv.num_pages,
            "gpu_cache_usage_perc": self.kv.usage,
            "gpu_prefix_cache_hit_rate": self.kv.hit_rate(),
            **self.kv.gauges(),
        }
