"""Continuous-batching paged-KV engine on one CUDA device.

Counterpart of ``dynamo_exp_tpu/engine/engine.py`` (``TPUEngine``) for
this slice. A loop thread owns the scheduler, the page manager and the
device state; ``generate()`` (the ``AsyncEngine`` seam) hands it a
``BackendInput`` dict and streams back ``LLMEngineOutput`` dicts.

One loop iteration admits what it can, then dispatches one ragged batch
per sampler partition (greedy rows apart from rows that need the full
penalty/top-k/top-p sampler), in one of two shapes:

- **mixed**: prefill chunks, single decode steps and speculative verify
  spans in one flat token stream through ``models.llama.forward_ragged``;
  each row samples at its last fed position, a prompt completing its
  last chunk samples its first token in the same dispatch, and a verify
  span (the row's last token and its drafts at consecutive positions)
  is scored at every position and accepted on the device
  (``spec_accept_length`` greedy, ``spec_verify_tokens`` with the full
  sampler). With the kernel, every row's span is aligned to
  ``ragged_q_tile`` slots.
- **windowed**: pure decode, a Python loop of ``decode_window`` steps
  of ``models.llama.forward`` at T=1 (the kernel's decode shape). The
  next tokens and positions stay on the device between steps; a row
  parks at position -1 when it samples a stop token, spends its
  max_tokens budget, or reaches its page capacity. The host syncs once
  per window, when it consumes the window's tokens.

Chaining (``chained_decode``, the JAX loop's order): a window that is
its iteration's only dispatch stays in flight; in steady state (no
arrivals, no prefill, no cancellation, the same rows, no capacity cap,
no speculating row) the next window launches from its carry on the
device before the host consumes it, so the host's consume overlaps the
next window. A stop found while a successor is in flight defers the
finish (and the page release) until the successor is consumed. Host
arrays reach the card through pinned staging with ``non_blocking``
copies and dropped K/V writes go to a scratch page past the pool, so
nothing between a window's dispatch and its consume waits on the card.
Swap, preemption, rewind and page release run only when no window is
in flight.

Logprobs (``sampling_options.logprobs``) are the model distribution's
(``ops.sampling.token_logprobs``), computed only in dispatches that
carry a row asking for them, for every emitted token of both shapes and
of verify spans.

KV pressure (the JAX loop's order): a row that cannot feed its next
token hard-stalls; admission pauses while any row is stalled. With a
host tier (``host_cache_pages``) the engine first swaps a cold row's
pages out to pinned host memory (``_swap_out``) and back in when the
pool can hold them (``_try_swap_in``); once a stall outlasts
``preempt_stall_grace_s`` it preempts (``Scheduler.preempt``): the
victim requeues as a deterministic continuation. Evicted registered
pages are written back to the host tier and injected again on a prefix
match (``_apply_uploads``) or ahead of admission (``_plan_prefetch``).
Device <-> host copies run on side CUDA streams (``offload.py``).

Left out (ROADMAP): the persistent KV tier, partial-tail copy-on-write,
leases, reclaim, request deadlines, telemetry and the flight recorder.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import queue
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import AsyncIterator, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import (
    Llama,
    check_supported,
    forward,
    forward_ragged,
    init_kv_cache,
    init_params,
    resolve_attn,
)
from ..ops.ragged_attention import ragged_supported
from ..ops.sampling import (
    apply_penalties,
    sample_tokens_seeded,
    spec_accept_length,
    spec_verify_tokens,
    stop_token_hit,
    token_logprobs,
)
from ..protocols.common import BackendInput, FinishReason, LLMEngineOutput
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from ..spec import SpecManager
from ..tokens import compute_block_hashes_for_seq
from .config import EngineConfig
from .kv_manager import KvEvent, KvPageManager
from .offload import CopyStream, HostKvPool, pinned_empty
from .scheduler import Scheduler, Sequence, SeqState
from .tiering import SwapRecord, plan_swap_entries

log = logging.getLogger(__name__)

# Width of the per-row stop-token set a decode window checks on the device.
STOP_WIDTH = 8

_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def resolve_attn_impl(cfg: EngineConfig, device: torch.device) -> str:
    """``auto`` is the kernel on CUDA and the plain version on the CPU.
    On CUDA the kernel must take the layout: an unsupported one raises
    rather than quietly serving through the plain version."""
    impl = resolve_attn(cfg.attention_impl, device)
    if impl == "kernel" and device.type == "cuda":
        m = cfg.model
        for q_tile in (1, cfg.ragged_q_tile):
            if not ragged_supported(
                cfg.page_size, m.num_kv_heads, m.head_dim_, cfg.kv_torch_dtype,
                m.num_heads, q_tile,
            ):
                raise ValueError(
                    f"the ragged kernel does not take this layout (D="
                    f"{m.head_dim_}, H={m.num_heads}, Hkv={m.num_kv_heads}, "
                    f"q_tile={q_tile}, kv_dtype={cfg.kv_dtype})"
                )
    return impl


@dataclass
class _RaggedRow:
    """One row of a dispatch: a prefill chunk, a decode step/window or a
    speculative verify span."""

    seq: Sequence
    kind: str  # "decode" | "prefill" | "spec"
    row: int  # per-row array index in the dispatch
    n_valid: int = 0  # decode: window steps the host may keep
    completing: bool = False  # prefill: the prompt finishes this chunk
    n_drafts: int = 0  # spec: drafts fed for verification


@dataclass
class _PendingRagged:
    """One dispatched ragged batch the host has not consumed yet (the
    JAX engine's ``_PendingRagged``).

    ``ys`` are the outputs' host copies, queued behind the dispatch on
    the compute stream (pinned, ``non_blocking``); ``ready`` is the event
    recorded after them (None on the CPU), and consuming waits on it:
    the dispatch's one sync. A windowed batch keeps its final carry
    (``tokens_dev``/``positions_dev``: the next window's inputs over the
    same rows) and the device arrays a chained successor reuses."""

    ys: tuple  # windowed: toks [K, nb] (+lp); mixed: tok0 [B1] (+spec) (+lp)
    ready: object
    rows: list  # [_RaggedRow]
    windowed: bool
    full_sampler: bool
    want_lp: bool
    solo: bool  # the iteration's only dispatch: chainable
    with_spec: bool = False  # mixed: carried verify spans
    nb: int = 0  # windowed: rows in the batch
    tokens_dev: torch.Tensor | None = None
    positions_dev: torch.Tensor | None = None
    # Some row could reach its page/model-length cap inside the window:
    # its carry parks at -1 but the host resumes it after allocating
    # pages, so a chained window would feed a dead carry. No chaining.
    capacity_capped: bool = False
    stop_dev: torch.Tensor | None = None  # [nb, STOP_WIDTH], reused by a chain
    slot_dev: torch.Tensor | None = None  # [nb] counts rows (full sampler)
    sampler_dev: tuple | None = None  # (seeds, temp, top_k, top_p, f, p, r)


class TorchEngine(AsyncEngine):
    """Continuous-batching paged-KV engine on one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        model: Llama | None = None,
        device="cuda",
        kv_event_cb: Callable[[KvEvent], None] | None = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        mcfg = cfg.model
        check_supported(mcfg)
        self.attn_impl = resolve_attn_impl(cfg, self.device)
        if model is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            model = init_params(mcfg, gen, self.device)
        self.model = model
        # KV pools [L, P, ps, Hkv*D], written in place by every forward.
        # One scratch page past the pool (never handed out, in no page
        # table) takes the K/V writes of padding and parked rows, so a
        # forward drops them without selecting rows on the host.
        self._drop_page = cfg.num_pages
        self.k_cache, self.v_cache = init_kv_cache(
            mcfg, cfg.num_pages + 1, cfg.page_size, cfg.kv_torch_dtype, self.device
        )
        # G2 host tier: the pool lives here; the CopyStream (a thread and
        # two side streams) is made by start() and torn down by stop().
        self.host_pool: HostKvPool | None = None
        self.copy_stream: CopyStream | None = None
        # Evictions buffered until the next compute dispatch, then
        # gathered as one batch: (page_id, seq_hash).
        self._pending_offloads: list[tuple[int, int]] = []
        on_evict = None
        if cfg.host_cache_pages > 0:
            self.host_pool = HostKvPool(
                cfg.host_cache_pages,
                (mcfg.num_layers, cfg.page_size, mcfg.num_kv_heads * mcfg.head_dim_),
                cfg.kv_torch_dtype,
                pin_memory=self.device.type == "cuda",
            )

            def on_evict(pid: int, seq_hash: int) -> None:
                self._pending_offloads.append((pid, seq_hash))

        self.kv = KvPageManager(
            cfg.num_pages, cfg.page_size, event_cb=kv_event_cb,
            sharing=cfg.prefix_sharing, host_pool=self.host_pool, on_evict=on_evict,
        )
        self.sched = Scheduler(cfg, self.kv)
        # Prefetch jobs by request id (their target pages are held by the
        # job until injected), completed restores for hit attribution,
        # and the copy thread's results for the loop.
        self._prefetch_inflight: dict[str, dict] = {}
        self._prefetch_served: OrderedDict[str, set] = OrderedDict()
        self._prefetch_done_q: queue.Queue = queue.Queue()
        self._last_prefetch_scan = 0.0
        # Copy-stream counters of streams already stopped (start() makes
        # a new stream after every stop()).
        self._copy_totals: dict[str, float] = {}
        # Penalty counts by slot; row B is the scratch row padding rows
        # gather from and scatter to.
        self._counts = torch.zeros(
            (cfg.max_decode_slots + 1, mcfg.vocab_size), dtype=torch.int32,
            device=self.device,
        )
        # Seeds for requests that pin none (draws are keyed by seed and
        # position, so a pinned seed reproduces a stream anywhere).
        self._seed_rng = random.Random(seed + 1)
        self._submit_q: queue.Queue[Sequence] = queue.Queue()
        self._wake = threading.Event()
        self._running = False
        self._held = False
        self._thread: threading.Thread | None = None
        # Speculation: the drafter and per-row controller (None = off).
        self._spec = SpecManager(cfg) if cfg.spec_mode != "off" else None
        # The unconsumed solo window (chaining), and pinned staging
        # buffers kept until the event after their upload completes.
        self._inflight: _PendingRagged | None = None
        self._staged: deque = deque()
        self.steps = 0  # forward steps dispatched
        self.wasted_steps = 0  # window steps computed past a row's stop
        # Dispatches by shape; "chained" windows are also "windowed".
        self.dispatches = {"mixed": 0, "windowed": 0, "chained": 0}
        self.spec_dispatches = 0  # mixed dispatches carrying verify spans
        self.spec_row_dispatches = 0  # verify spans (rows) consumed
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_emitted_tokens = 0
        self.preempted = 0  # preemptions (KV pressure and swap misses)
        self.swapped_out = 0  # rows swapped out to the host tier
        self.swapped_in = 0  # rows restored from it
        self.prefetched_pages = 0  # pages restored ahead of admission
        self.prefetch_hits = 0  # of those, pages an admission attached

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running or self._held:
            return
        if self.host_pool is not None and self.copy_stream is None:
            self.copy_stream = CopyStream(self.host_pool, device=self.device)
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="torch-engine-loop", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                log.error("engine loop did not exit within 60s")
                return
            self._thread = None
        if self.copy_stream is not None:
            # Write back what the loop buffered, let every queued copy
            # commit (swap records need theirs), then stop the stream.
            self._flush_offloads()
            self.copy_stream.drain()
            self.copy_stream.stop()
            for k, v in self.copy_stream.stats().items():
                self._copy_totals[k] = self._copy_totals.get(k, 0) + v
            error, self.copy_stream = self.copy_stream.error, None
            self._return_prefetches()
            if error is not None:
                raise RuntimeError("the KV copy stream failed") from error

    @contextlib.contextmanager
    def hold_admission(self):
        """Pause the loop thread and queue what arrives meanwhile; on
        exit the loop's first iteration admits it together, as
        :meth:`submit` before :meth:`start` does, so a burst's schedule
        does not depend on its arrival times. Rows in flight pause too."""
        self.stop()
        if self._thread is not None:
            raise RuntimeError("engine loop did not pause; not holding admission")
        self._held = True
        try:
            yield
        finally:
            self._held = False
            self.start()

    def copy_stats(self) -> dict:
        """Pages, bytes and device seconds (CUDA events) moved each way
        by the copy streams since the engine was made."""
        out = dict(self._copy_totals)
        if self.copy_stream is not None:
            for k, v in self.copy_stream.stats().items():
                out[k] = out.get(k, 0) + v
        return out

    def kv_audit(self) -> dict:
        """The page manager's conservation audit with every holder the
        engine knows: bound sequences (``seq:<id>``) and prefetch jobs
        (``prefetch:<id>``). Call with the loop paused."""
        holders: dict[str, list[int]] = {}
        for s in self.sched.slots:
            if s is not None and s.page_ids:
                holders[f"seq:{s.request_id}"] = list(s.page_ids)
        for rid, job in self._prefetch_inflight.items():
            holders[f"prefetch:{rid}"] = list(job["pids"])
        return self.kv.audit(holders)

    def loop_cpu_seconds(self) -> float:
        """CPU seconds the current loop thread has used since it
        started (0 when it is not running)."""
        t = self._thread
        if t is None or t.ident is None:
            return 0.0
        return time.clock_gettime(time.pthread_getcpuclockid(t.ident))

    def queued(self) -> int:
        """Requests submitted and not yet taken by the loop."""
        return self._submit_q.qsize()

    def reset_prefix_cache(self) -> int:
        """Drop the reusable pages of finished requests, so that a
        repeated prompt is prefilled again (call while the loop is not
        running, e.g. inside :meth:`hold_admission`). Returns the number
        of pages dropped."""
        if self._running:
            raise RuntimeError("reset_prefix_cache needs the loop paused")
        return self.kv.reset_prefix_cache()

    async def generate(
        self, request, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        stream = self.submit(request, context)
        self.start()
        return stream

    def submit(
        self, request, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        """Queue a request and return its stream, without starting the
        loop thread (``generate`` is ``submit`` then ``start``). The
        loop's first iteration admits everything queued before
        :meth:`start` together, so the schedule (and every dispatch
        shape) of such a set does not depend on thread timing. Call
        from a running asyncio loop: the stream is fed through it."""
        ctx = context or AsyncEngineContext()
        binput = (
            request.copy()
            if isinstance(request, BackendInput)
            else BackendInput.from_dict(request)
        )
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        orphaned = threading.Event()

        def emit(tokens: list[int], reason: FinishReason | None, logprobs=None) -> None:
            # logprobs: (chosen lps, [{token id: lp}] or None) per token.
            try:
                loop.call_soon_threadsafe(out_q.put_nowait, (tokens, reason, logprobs))
            except RuntimeError:
                # The caller's event loop has closed: nobody reads this
                # stream any more. The loop thread lives on and cancels
                # the row on its next pass, freeing its slot and pages.
                orphaned.set()

        seed = binput.sampling_options.seed
        seq = Sequence(
            request_id=ctx.id,
            prompt=list(binput.token_ids),
            stop=binput,
            emit=emit,
            is_cancelled=lambda: ctx.is_stopped or orphaned.is_set(),
            submitted_at=time.time(),
            sample_seed=int(seed) if seed is not None else self._seed_rng.getrandbits(31),
            priority=binput.priority,
        )
        self._submit_q.put(seq)
        self._wake.set()
        prompt_tokens = len(binput.token_ids)

        async def _gen() -> AsyncIterator[dict]:
            completion = 0
            while True:
                tokens, reason, logprobs = await out_q.get()
                if tokens:
                    completion += len(tokens)
                    yield LLMEngineOutput(
                        token_ids=tokens,
                        logprobs=logprobs[0] if logprobs else None,
                        top_logprobs=logprobs[1] if logprobs else None,
                    ).to_dict()
                if reason is not None:
                    yield LLMEngineOutput(
                        finish_reason=reason,
                        prompt_tokens=prompt_tokens,
                        completion_tokens=completion,
                    ).to_dict()
                    return

        return ResponseStream(_gen(), ctx)

    def metrics(self) -> dict:
        m = self.sched.metrics()
        m["decode_steps"] = self.steps
        m["decode_wasted_steps"] = self.wasted_steps
        m["dispatches"] = dict(self.dispatches)
        m["preempted"] = self.preempted
        m["swapped_out"] = self.swapped_out
        m["swapped_in"] = self.swapped_in
        m["prefetched_pages"] = self.prefetched_pages
        m["prefetch_hits"] = self.prefetch_hits
        # Speculation: acceptance = accepted / draft, tokens per verify
        # row = emitted / row dispatches.
        m["spec_dispatches"] = self.spec_dispatches
        m["spec_row_dispatches"] = self.spec_row_dispatches
        m["spec_draft_tokens"] = self.spec_draft_tokens
        m["spec_accepted_tokens"] = self.spec_accepted_tokens
        m["spec_emitted_tokens"] = self.spec_emitted_tokens
        if self.host_pool is not None:
            m["host_cache_resident"] = self.host_pool.resident
            m["host_cache_hits"] = self.host_pool.hits
            m["host_cache_stores"] = self.host_pool.stores
            m["offload_hits"] = self.kv.offload_hits
            m["offload_misses"] = self.kv.offload_misses
        return m

    # ------------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while self._running:
                if self.copy_stream is not None:
                    if self.copy_stream.error is not None:
                        raise RuntimeError("the KV copy stream failed") from self.copy_stream.error
                    self.copy_stream.poll()
                self._poll_staged()
                if self._inflight is not None:
                    # Steady state: launch the next window from the
                    # in-flight one's device carry, then consume the
                    # in-flight one while the next runs.
                    nxt = self._dispatch_chained(self._inflight) if self._can_chain() else None
                    prev, self._inflight = self._inflight, nxt
                    self._consume_ragged(prev)
                    if self._inflight is not None:
                        continue
                    # Chain broken (arrivals, prefill, a stop, a dry
                    # pool): the full scheduling path follows.
                while True:
                    try:
                        self.sched.submit(self._submit_q.get_nowait())
                    except queue.Empty:
                        break
                if not self.sched.has_work():
                    # Idle: completed prefetches still inject, buffered
                    # evictions still reach the host tier.
                    self._apply_prefetches()
                    self._flush_offloads()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                for seq in list(self.sched.slots):
                    if seq is not None and seq.is_cancelled():
                        self.sched.finish(seq, FinishReason.CANCELLED)
                # KV pressure (no window is in flight here, so no device
                # write can race a release): swap a cold row out first,
                # preempt once a stall outlasts its grace; completed
                # prefetches inject and swapped rows rejoin before
                # admission, which pauses while any row is stalled or
                # swapped out.
                self._maybe_proactive_offload()
                self._maybe_preempt()
                self._apply_prefetches()
                self._try_swap_in()
                if not self._kv_pressure() and not self._swapped_rows():
                    while (admitted := self.sched.admit_next()) is not None:
                        self._on_admitted(admitted)
                # Restore host-resident prefixes of what is still waiting.
                self._plan_prefetch()
                prefilling = [
                    s for s in self.sched.slots
                    if s is not None and s.state is SeqState.PREFILL
                ]
                pendings = self._dispatch_ragged(prefilling[: self.cfg.prefill_batch])
                if len(pendings) == 1 and pendings[0].solo and self.cfg.chained_decode:
                    self._inflight = pendings[0]  # consumed next iteration
                else:
                    # Mixed batches consume in the same iteration: the
                    # next chunks and drafts are planned from the tokens
                    # they just confirmed.
                    for p in pendings:
                        self._consume_ragged(p)
                if not pendings:
                    # Pool dry / everything stalled: yield briefly.
                    self._wake.wait(timeout=0.001)
                    self._wake.clear()
            if self._inflight is not None:
                # Paused (stop / hold_admission): the window's tokens
                # belong to the host state the next loop builds from.
                prev, self._inflight = self._inflight, None
                self._consume_ragged(prev)
        except Exception:  # engine death must not hang clients
            log.exception("engine loop crashed; failing in-flight requests")
            self._running = False
            self._inflight = None
            pending = list(self.sched.slots) + list(self.sched.waiting)
            while not self._submit_q.empty():
                pending.append(self._submit_q.get_nowait())
            for seq in pending:
                if seq is not None:
                    seq.emit([], FinishReason.ERROR)
            raise

    def _on_admitted(self, seq: Sequence) -> None:
        """Inject the admission's G2 pages (before any forward that can
        read them) and count the prefetched pages it attached."""
        self._apply_uploads(seq)
        served = self._prefetch_served.pop(seq.request_id, None)
        if served:
            self.prefetch_hits += sum(
                1 for h in seq.prompt_hashes[: seq.hashed_pages] if h in served
            )

    # ------------------------------------------------------- KV pressure
    def _kv_pressure(self) -> bool:
        """True while any bound row is hard-stalled. Admission pauses: a
        newcomer would take the very pages the stalled rows wait for."""
        return any(s is not None and s.stalled_since for s in self.sched.slots)

    def _swapped_rows(self) -> bool:
        """True while any row's cold pages live in the host tier."""
        return any(s is not None and s.swap is not None for s in self.sched.slots)

    def _stalled_past(self, grace: float) -> bool:
        now = time.time()
        return any(
            s is not None and s.stalled_since and now - s.stalled_since >= grace
            for s in self.sched.slots
        )

    def _maybe_preempt(self) -> None:
        """Once a row has been hard-stalled past ``preempt_stall_grace_s``,
        preempt the lowest-priority / youngest ACTIVE sequence (bounded
        per request by ``max_preemptions_per_seq``)."""
        grace = self.cfg.preempt_stall_grace_s
        if grace < 0 or not self._stalled_past(grace):
            return
        if self.sched.active_count <= 1 and not self.sched.waiting:
            return  # nothing to yield the freed pages to
        victim = self.sched.preemption_victim(self.cfg.max_preemptions_per_seq)
        if victim is None:
            return
        freed, generated = len(victim.page_ids), victim.generated
        self.sched.preempt(victim)
        self.preempted += 1
        log.warning(
            "KV pressure: preempted request %s (priority=%d, %d tokens generated, "
            "%d pages freed, preemption %d/%d); resuming as a deterministic "
            "continuation", victim.request_id, victim.priority, generated, freed,
            victim.preemptions, self.cfg.max_preemptions_per_seq,
        )

    def _maybe_proactive_offload(self) -> None:
        """Once a row has been hard-stalled past
        ``proactive_offload_grace_s``, swap the coldest eligible row out
        to the host tier (bytes kept; preemption stays the fallback). A
        stalled row is eligible only when several rows starve (freeing
        the one starving row feeds nobody). One victim per iteration."""
        grace = self.cfg.proactive_offload_grace_s
        if grace < 0 or self.copy_stream is None or not self._stalled_past(grace):
            return
        n_stalled = sum(1 for s in self.sched.slots if s is not None and s.stalled_since)
        cands = [
            s for s in self.sched.slots
            if s is not None
            and s.state is SeqState.ACTIVE
            and s.swap is None
            and (n_stalled >= 2 or not s.stalled_since)
        ]
        now = time.time()
        for victim in sorted(cands, key=lambda s: (s.priority, -s.submitted_at)):
            swapped = self._swap_out(victim)
            if swapped:
                # Relief landed: restart the stalled rows' grace clocks,
                # so preemption fires only if the freed pages do not do.
                for s in self.sched.slots:
                    if s is not None and s.stalled_since:
                        s.stalled_since = now
                return
            if swapped is None:
                return  # copy stream saturated: stop this pass

    def _swap_out(self, victim: Sequence) -> bool | None:
        """Swap one row's cold pages to the host tier: unregistered
        refcount-1 pages are gathered and written back under their key,
        registered ones park in the LRU (eviction writes them back),
        shared ones stay held, unwritten ones drop. The row keeps its
        slot; its page table shrinks to the kept pages and the
        :class:`SwapRecord` is the restore ledger. False when nothing was
        freeable; None when the copy stream shed the write-back (the
        bytes are not recomputable, so the pages stay)."""
        entries, off_pids, off_keys, park_pids, drop_pids = plan_swap_entries(
            victim.page_ids, victim.tokens, self.cfg.page_size,
            self.kv.page_ref, self.kv.page_hash,
        )
        if not (off_pids or park_pids or drop_pids):
            return False
        record = SwapRecord(entries=entries, committed=not off_pids)
        if off_pids:
            k_b, v_b, ready = self._gather_page_batch(off_pids)

            def committed(rec=record):
                rec.committed = True  # copy thread, after the store

            if not self.copy_stream.offload_batch(
                off_keys, k_b, v_b, on_stored=committed, ready=ready
            ):
                return None
        # The gather is on the compute stream ahead of whatever reuses
        # the freed pages next.
        self.kv.release_sequence(off_pids + park_pids + drop_pids)
        victim.page_ids = [pid for kind, pid in entries if kind == "kept"]
        victim.swap = record
        victim.swapped_since = time.time()
        victim.stalled = False
        victim.stalled_since = 0.0
        self.swapped_out += 1
        log.info(
            "KV pressure: swapped out %d page(s) of request %s to the host tier "
            "(%d kept)", len(off_pids) + len(park_pids) + len(drop_pids),
            victim.request_id, len(victim.page_ids),
        )
        return True

    def _try_swap_in(self) -> None:
        """Restore swapped rows, oldest swap first, once the pool can
        hold their pages: re-attach blocks still resident, fetch the rest
        from the host tier into pinned staging, inject them in one batch.
        A host-tier miss falls back to preemption (the continuation
        re-prefills, token-identically)."""
        swapped = [
            s for s in self.sched.slots
            if s is not None and s.swap is not None and s.state is SeqState.ACTIVE
        ]
        if not swapped or self._kv_pressure():
            # Under pressure the freed pages feed the stalled rows first.
            return
        # Buffered evictions would read as misses: hand them over first.
        self._flush_offloads()
        for seq in sorted(swapped, key=lambda s: s.swapped_since):
            rec = seq.swap
            if not rec.committed:
                continue  # write-back still on the copy thread
            attach: dict[int, int] = {}
            fetch_plan: list[tuple[int, int]] = []
            for i, (kind, val) in enumerate(rec.entries):
                if kind == "hash" and (pid := self.kv.resident_page(val)) is not None:
                    attach[i] = pid
                elif kind != "kept":
                    fetch_plan.append((i, val))
            parked = sum(1 for pid in attach.values() if self.kv.page_ref(pid) == 0)
            if len(fetch_plan) + parked > self.kv.free_pages:
                continue  # not enough room yet
            # Fetch before any mutation: a miss preempts instead.
            k_st, v_st = self._staging(len(fetch_plan))
            miss = any(
                self.host_pool.fetch(key, out=(k_st[:, j], v_st[:, j])) is None
                for j, (_, key) in enumerate(fetch_plan)
            )
            if miss:
                if self.copy_stream.pending:
                    continue  # an eviction write-back may still be in flight
                self._preempt_swapped(seq)
                continue
            for pid in attach.values():
                self.kv.attach_page(pid)
            new_ids: list[int] = []
            inj: list[int] = []
            for i, (kind, val) in enumerate(rec.entries):
                if kind == "kept":
                    new_ids.append(val)
                elif i in attach:
                    new_ids.append(attach[i])
                else:
                    pid = self.kv.allocate_page()  # room checked above
                    new_ids.append(pid)
                    inj.append(pid)
            if inj:
                self._inject_page_batch(inj, k_st, v_st)
            seq.page_ids = new_ids
            seq.swap = None
            seq.swapped_since = 0.0
            self.swapped_in += 1

    def _preempt_swapped(self, seq: Sequence) -> None:
        """Swap-in fallback: the host tier lost a swapped page."""
        self.sched.preempt(seq)
        self.preempted += 1
        log.warning(
            "request %s: swapped KV could not be restored (host-tier miss); "
            "falling back to preemption", seq.request_id,
        )

    # --------------------------------------------------------- G2 -> G1
    def _plan_prefetch(self) -> None:
        """Restore the host-resident prefixes of the waiting queue's head
        ahead of admission: target pages come out of free + parked pages
        beyond ``prefetch_reserve_pages`` (a parked page evicted here is
        written back first, so nothing is lost), are held by the job
        while the copy thread fetches the bytes, and are registered and
        injected by :meth:`_apply_prefetches` before a later dispatch; the
        admission then finds them as a plain G1 prefix hit."""
        cfg = self.cfg
        if (
            not cfg.kv_prefetch
            or self.copy_stream is None
            or not self.kv.sharing
            or not self.sched.waiting
        ):
            return
        now = time.monotonic()
        if now - self._last_prefetch_scan < 0.01:
            return
        self._last_prefetch_scan = now
        budget = self.kv.free_pages - cfg.prefetch_reserve_pages
        ps = cfg.page_size
        for seq in list(self.sched.waiting)[: cfg.prefetch_depth]:
            if budget <= 0:
                return
            rid = seq.request_id
            if rid in self._prefetch_inflight or rid in self._prefetch_served:
                continue
            if seq.forecast_hashes is None:
                seq.forecast_hashes = compute_block_hashes_for_seq(seq.prompt, ps)
            hashes = seq.forecast_hashes
            start = len(self.kv.match_resident_hashes(hashes))
            g2 = self.host_pool.match_chain(hashes[start:])[:budget]
            if not g2:
                continue
            pids: list[int] = []
            for _ in g2:
                pid = self.kv.allocate_page()
                if pid is None:
                    break
                pids.append(pid)
            if not pids:
                return
            g2 = g2[: len(pids)]
            budget -= len(pids)
            job = {
                "req": rid,
                "pids": pids,
                "parent": hashes[start - 1] if start else None,
                "blocks": [
                    list(seq.prompt[(start + j) * ps : (start + j + 1) * ps])
                    for j in range(len(g2))
                ],
            }
            if not self.copy_stream.fetch_batch(g2, job, self._on_prefetched):
                self.kv.release_sequence(pids)  # saturated: retry later
                return
            self._prefetch_inflight[rid] = job

    def _on_prefetched(self, job: dict, fetched: list) -> None:
        """Copy-thread callback: queue the result for the loop thread
        (the page manager's single writer) and wake it."""
        self._prefetch_done_q.put((job, fetched))
        self._wake.set()

    def _apply_prefetches(self) -> None:
        """Register and inject fetched prefetch pages (ahead of this
        iteration's dispatch), then drop the job's hold: registered
        pages park matchable, the rest return to the free list. A block
        whose content became resident meanwhile is skipped."""
        while True:
            try:
                job, fetched = self._prefetch_done_q.get_nowait()
            except queue.Empty:
                return
            if self._prefetch_inflight.pop(job["req"], None) is None:
                continue  # returned by stop() already
            inj: list[tuple[int, torch.Tensor, torch.Tensor]] = []
            served: set[int] = set()
            parent = job["parent"]
            for j, (h, k_pg, v_pg) in enumerate(fetched):
                served.add(h)
                if self.kv.resident_page(h) is None:
                    pid = job["pids"][j]
                    self.kv.register_full_page(
                        pid, h, parent_hash=parent, tokens=job["blocks"][j]
                    )
                    inj.append((pid, k_pg, v_pg))
                parent = h
            if inj:
                self._inject_page_batch(
                    [pid for pid, _, _ in inj], *self._stage([(k, v) for _, k, v in inj])
                )
                self.prefetched_pages += len(inj)
            if served:
                self._prefetch_served[job["req"]] = served
                while len(self._prefetch_served) > 256:
                    self._prefetch_served.popitem(last=False)
            self.kv.release_sequence(job["pids"])

    def _return_prefetches(self) -> None:
        """Release the pages of every prefetch job (the loop is stopped;
        nothing will inject them)."""
        while not self._prefetch_done_q.empty():
            self._prefetch_done_q.get_nowait()
        for job in self._prefetch_inflight.values():
            self.kv.release_sequence(job["pids"])
        self._prefetch_inflight.clear()

    # ---------------------------------------------------- batched page moves
    def _staging(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Host batches [L, n, ps, Hkv*D] for K and V, pinned on a card."""
        m = self.cfg.model
        shape = (m.num_layers, n, self.cfg.page_size, m.num_kv_heads * m.head_dim_)
        return (pinned_empty(shape, self.cfg.kv_torch_dtype, self.device),
                pinned_empty(shape, self.cfg.kv_torch_dtype, self.device))

    def _stage(self, pages: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Host pages (k, v) [L, ps, Hkv*D] copied into one staging batch."""
        k_st, v_st = self._staging(len(pages))
        for j, (k_pg, v_pg) in enumerate(pages):
            k_st[:, j].copy_(k_pg)
            v_st[:, j].copy_(v_pg)
        return k_st, v_st

    def _gather_page_batch(self, pids: list[int]):
        """One gather of ``pids`` into contiguous device batches
        ``[L, n, ps, Hkv*D]`` on the compute stream, and (CUDA) the event
        recorded after it, which the copy stream waits on."""
        (idx,) = self._upload(np.asarray(pids, np.int64))
        k_b = self.k_cache.index_select(1, idx)
        v_b = self.v_cache.index_select(1, idx)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return k_b, v_b, ready

    def _inject_page_batch(self, pids: list[int], k_host: torch.Tensor, v_host: torch.Tensor):
        """Inject host batches ``[L, n, ps, Hkv*D]`` into device pages
        ``pids``: host -> device on the copy stream's side stream, then a
        scatter on the compute stream after it, ahead of every later
        forward. Buffered evictions are gathered first, so a page being
        overwritten reached the host tier's gather before this lands."""
        self._flush_offloads()
        k_dev, v_dev = self.copy_stream.upload(k_host, v_host)
        (idx,) = self._upload(np.asarray(pids, np.int64))
        self.k_cache.index_copy_(1, idx, k_dev)
        self.v_cache.index_copy_(1, idx, v_dev)

    def _flush_offloads(self) -> None:
        """Gather every eviction buffered since the last dispatch and
        hand the batch to the copy stream. Runs right before anything
        that could overwrite the evicted pages (forwards, injects) and on
        the idle path: the gather then reads the old content."""
        if not self._pending_offloads:
            return
        moved, self._pending_offloads = self._pending_offloads, []
        if self.copy_stream is None:
            return
        k_b, v_b, ready = self._gather_page_batch([pid for pid, _ in moved])
        self.copy_stream.offload_batch([h for _, h in moved], k_b, v_b, ready=ready)

    def _apply_uploads(self, seq: Sequence) -> None:
        """Inject an admission's G2 pages into their fresh device pages,
        in one batch, before any forward that reads them."""
        if not seq.pending_uploads:
            return
        ups = seq.pending_uploads
        self._inject_page_batch(
            [pid for pid, _, _, _ in ups], *self._stage([(k, v) for _, _, k, v in ups])
        )
        seq.pending_uploads = []

    def _dispatch_ragged(self, prefill_rows: list[Sequence]) -> list[_PendingRagged]:
        """Assemble and dispatch this iteration's ragged batches, one per
        sampler partition: windowed when the partition is pure decode
        (no prefill chunk, no verify span), mixed otherwise. Nothing
        waits on the card. Returns the pending dispatches; [] when
        nothing could step."""
        cfg = self.cfg
        ps, K = cfg.page_size, cfg.decode_window
        parts: dict[bool, list] = {False: [], True: []}
        for seq in self.sched.slots:
            if seq is None or seq.state is not SeqState.ACTIVE:
                continue
            if seq.swap is not None:
                continue  # swapped out: sits out until _try_swap_in
            wpos = len(seq.tokens) - 1  # position of the token being fed
            self.sched.ensure_pages_until(seq, wpos + K - 1)
            cap = min(cfg.max_model_len, len(seq.page_ids) * ps) - 1
            if cap < wpos:
                if wpos // ps >= self.kv.num_pages:
                    # The row's context exceeds the whole pool: no wait
                    # can ever feed its next token here.
                    self.sched.finish(seq, FinishReason.LENGTH)
                    continue
                # Hard stall: start (or keep) the grace clock.
                seq.stalled = True
                if not seq.stalled_since:
                    seq.stalled_since = time.time()
                continue  # pool dry: the row sits this iteration out
            seq.stalled = len(seq.page_ids) * ps < min(wpos + K, cfg.max_model_len)
            seq.stalled_since = 0.0  # progressing (even if window-capped)
            parts[self._needs_sampler(seq)].append((seq, wpos, cap))
        spec_parts: dict[bool, list] = {False: [], True: []}
        if self._spec is not None:
            for fs in (False, True):
                parts[fs], spec_parts[fs] = self._extract_spec_rows(parts[fs])
            if len(self._spec) > 4 * cfg.max_decode_slots:
                self._spec.retain(s.request_id for s in self.sched.slots if s is not None)
        pf_parts: dict[bool, list[Sequence]] = {False: [], True: []}
        for seq in prefill_rows:
            pf_parts[self._needs_sampler(seq)].append(seq)
        batches = []
        for fs in (False, True):
            dec, spec, pf = parts[fs], spec_parts[fs], pf_parts[fs]
            if dec or spec or pf:
                batches.append((fs, dec, spec, pf, bool(dec) and not spec and not pf))
        # A window is chainable only as the iteration's one dispatch.
        solo = len(batches) == 1 and batches[0][4]
        # Evictions of this iteration's allocations reach their gather
        # before any forward can overwrite the pages.
        self._flush_offloads()
        return [
            self._build_windowed(dec, fs, solo) if windowed
            else self._build_mixed(dec, spec, pf, fs)
            for fs, dec, spec, pf, windowed in batches
        ]

    # ------------------------------------------------------------ row helpers
    @staticmethod
    def _needs_sampler(seq: Sequence) -> bool:
        so = seq.stop.sampling_options
        return bool(
            (so.temperature or 0.0) > 0.0
            or so.frequency_penalty
            or so.presence_penalty
            or (so.repetition_penalty or 1.0) != 1.0
        )

    def _stop_gates(self, seq: Sequence, g0: int) -> tuple[int, int]:
        """Window-step gates for a row with ``g0`` tokens generated: EOS
        counts at t >= eos_gate (check_stop's min_tokens rule) and the
        max_tokens budget runs out after the token sampled at
        t == budget_gate."""
        sc = seq.stop.stop_conditions
        eos_gate = max((sc.min_tokens or 0) - g0 - 1, 0)
        max_tokens = sc.max_tokens or self.cfg.default_max_tokens
        return eos_gate, max(max_tokens - g0 - 1, 0)

    def _stop_set(self, seq: Sequence) -> list[int]:
        sc = seq.stop.stop_conditions
        if sc.ignore_eos:
            return []
        stops = list(self.cfg.eos_token_ids) + list(sc.stop_token_ids)
        return stops[:STOP_WIDTH]

    @staticmethod
    def _sampler_arrays(n: int) -> tuple:
        """(seeds, temp, top_k, top_p, freq, pres, rep) for n rows."""
        return (
            np.zeros(n, np.int64), np.zeros(n, np.float32), np.zeros(n, np.int64),
            np.ones(n, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.ones(n, np.float32),
        )

    @staticmethod
    def _row_sampler_args(seq: Sequence, r: int, arrs: tuple) -> None:
        seeds, temp, top_k, top_p, freq, pres, rep = arrs
        so = seq.stop.sampling_options
        seeds[r] = seq.sample_seed & 0x7FFFFFFF
        temp[r] = so.temperature if so.temperature is not None else 0.0
        top_k[r] = so.top_k or 0
        top_p[r] = so.top_p if so.top_p is not None else 1.0
        freq[r] = so.frequency_penalty or 0.0
        pres[r] = so.presence_penalty or 0.0
        rep[r] = so.repetition_penalty or 1.0

    # ------------------------------------------------------ host <-> device
    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host arrays on the device. On a card: one pinned staging
        buffer, one ``non_blocking`` copy (no host sync), the buffer kept
        until the event after the copy has completed; on the CPU the
        arrays themselves."""
        if self.device.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // 16) * 16
        host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        for a, o in zip(arrays, offs):
            buf[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._staged.append((done, host))
        return [
            dev[o : o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
            for a, o in zip(arrays, offs)
        ]

    def _poll_staged(self) -> None:
        """Drop the staging buffers whose uploads have completed."""
        while self._staged and self._staged[0][0].query():
            self._staged.popleft()

    def _fetch(self, ys: tuple) -> tuple[tuple, object]:
        """Queue host copies of a dispatch's outputs right behind it: on
        a card into pinned buffers, ``non_blocking``, with an event after
        them that consume waits on."""
        if self.device.type != "cuda":
            return ys, None
        hosts = tuple(torch.empty(y.shape, dtype=y.dtype, pin_memory=True) for y in ys)
        for h, y in zip(hosts, ys):
            h.copy_(y, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return hosts, ready

    @staticmethod
    def _host(pending: _PendingRagged) -> list[np.ndarray]:
        """A dispatch's outputs on the host: its one sync."""
        if pending.ready is not None:
            pending.ready.synchronize()
        return [y.numpy() for y in pending.ys]

    # ------------------------------------------------------------ speculation
    def _extract_spec_rows(self, part: list) -> tuple[list, list]:
        """Split one decode partition into (plain rows, speculative
        rows): a row speculates when the controller wants to probe it
        and the drafter proposes at least one token that fits its
        page/model-length capacity. The drafts' pages are provisioned
        here (best effort: a dry pool shortens the draft; a verify span
        always emits at least one token)."""
        ps = self.cfg.page_size
        plain, spec = [], []
        for seq, wpos, cap in part:
            drafts = self._spec.propose(seq) if self._spec.wants_draft(seq) else []
            if drafts:
                self.sched.ensure_pages_until(seq, wpos + len(drafts))
                cap = min(self.cfg.max_model_len, len(seq.page_ids) * ps) - 1
                g = min(len(drafts), cap - wpos, self.cfg.spec_max_draft)
                if g >= 1:
                    spec.append((seq, wpos, cap, drafts[:g]))
                    continue
            plain.append((seq, wpos, cap))
        return plain, spec

    def _rewind_spec_pages(self, seq: Sequence) -> None:
        """After a rejection, pages provisioned for draft positions past
        the accepted prefix go back to the pool. Only unregistered tail
        pages can trail (registration stops at the last full page below
        the confirmed head), so the reuse index is untouched; slots
        inside the kept tail page are overwritten as decode advances."""
        keep = (len(seq.tokens) - 1) // self.cfg.page_size + 1
        if len(seq.page_ids) > keep:
            extra = seq.page_ids[keep:]
            del seq.page_ids[keep:]
            self.kv.release_sequence(extra)

    # --------------------------------------------------------------- logprobs
    @staticmethod
    def _wants_logprobs(seq: Sequence) -> int | None:
        """The request's top_logprobs count (0 = chosen only), or None."""
        return seq.stop.sampling_options.logprobs

    @staticmethod
    def _lp_pack(n_top: int, lps, top_ids, top_lps) -> tuple:
        """Emit payload: each token's chosen logprob and, when asked, its
        top ``n_top`` alternatives as {token id: logprob}."""
        tops = None
        if n_top > 0:
            tops = [
                {int(t): float(lp) for t, lp in zip(tid[:n_top], tlp[:n_top])}
                for tid, tlp in zip(top_ids, top_lps)
            ]
        return [float(x) for x in lps], tops

    # ---------------------------------------------------------------- windowed
    def _build_windowed(self, part: list, full_sampler: bool, solo: bool) -> _PendingRagged:
        """Dispatch one pure-decode window over the rows (no host sync)."""
        cfg = self.cfg
        ps, K = cfg.page_size, cfg.decode_window
        nb = len(part)
        tokens = np.zeros(nb, np.int64)
        positions = np.full(nb, -1, np.int64)
        max_pos = np.full(nb, -1, np.int64)
        table = np.zeros((nb, cfg.max_pages_per_seq), np.int32)
        slot_map = np.full(nb, cfg.max_decode_slots, np.int64)
        stop_set = np.full((nb, STOP_WIDTH), -1, np.int64)
        eos_gate = np.zeros(nb, np.int64)
        budget_gate = np.full(nb, K, np.int64)
        arrs = self._sampler_arrays(nb)
        rows: list[_RaggedRow] = []
        max_pages = 1
        capped = False
        for r, (seq, wpos, cap) in enumerate(part):
            capped = capped or cap < wpos + K
            tokens[r] = seq.last_token()
            positions[r] = wpos
            max_pos[r] = cap
            table[r, : len(seq.page_ids)] = seq.page_ids
            slot_map[r] = seq.slot
            max_pages = max(max_pages, (min(wpos + K, cap + 1) + ps - 1) // ps)
            stops = self._stop_set(seq)
            stop_set[r, : len(stops)] = stops
            eos_gate[r], budget_gate[r] = self._stop_gates(seq, seq.generated)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=min(K, cap - wpos + 1)))
        tok_d, pos_d, max_d, table_d, stop_d, eos_d, budget_d, slot_d, *samp = self._upload(
            tokens, positions, max_pos, table, stop_set, eos_gate, budget_gate, slot_map, *arrs
        )
        return self._launch_window(
            rows, nb, full_sampler, solo, capped, max_pages, tok_d, pos_d,
            max_d, table_d, eos_d, budget_d, stop_d, slot_d, tuple(samp),
        )

    def _launch_window(
        self, rows, nb, full_sampler, solo, capped, max_pages, tok_d, pos_d,
        max_d, table_d, eos_d, budget_d, stop_d, slot_d, samp,
    ) -> _PendingRagged:
        """``decode_window`` decode steps, each step's tokens fed back on
        the device, and the outputs' host copies queued behind them: the
        windowed shape, first or chained."""
        mcfg, K = self.cfg.model, self.cfg.decode_window
        want_lp = any(self._wants_logprobs(e.seq) is not None for e in rows)
        seeds, temp, top_k, top_p, freq, pres, rep = samp
        counts = self._counts[slot_d] if full_sampler else None
        sampled, lps = [], []
        for t in range(K):
            logits, _, _ = forward(
                self.model, mcfg, tok_d[:, None], pos_d[:, None], table_d,
                self.k_cache, self.v_cache, attn_pages=max_pages,
                attn_impl=self.attn_impl, drop_page=self._drop_page,
            )
            logits = logits[:, 0]
            active = pos_d >= 0
            if full_sampler:
                shaped = apply_penalties(logits, counts, freq, pres, rep)
                nxt = sample_tokens_seeded(shaped, seeds, pos_d, temp, top_k, top_p).long()
                counts.scatter_add_(1, nxt[:, None], active.to(torch.int32)[:, None])
            else:
                nxt = torch.argmax(logits, dim=-1)
            if want_lp:
                lps.append(token_logprobs(logits, nxt))
            tok_d = torch.where(active, nxt, tok_d)
            # A row leaves the window (position -1, writes dropped) at a
            # stop token past its min-tokens gate, at its max_tokens
            # budget, or at its page/model-length capacity.
            done = (stop_token_hit(nxt, stop_d) & (t >= eos_d)) | (t >= budget_d)
            pos_d = torch.where(active & ~done & (pos_d < max_d), pos_d + 1, -1)
            sampled.append(nxt)
        if full_sampler:
            self._counts[slot_d] = counts
        ys = (torch.stack(sampled),)
        if want_lp:
            ys += tuple(torch.stack(y) for y in zip(*lps))
        ys, ready = self._fetch(ys)
        self.steps += K
        self.dispatches["windowed"] += 1
        return _PendingRagged(
            ys=ys, ready=ready, rows=rows, windowed=True, full_sampler=full_sampler,
            want_lp=want_lp, solo=solo, nb=nb, tokens_dev=tok_d, positions_dev=pos_d,
            capacity_capped=capped, stop_dev=stop_d, slot_dev=slot_d, sampler_dev=samp,
        )

    # ---------------------------------------------------------------- chaining
    def _can_chain(self) -> bool:
        """Whether the next window may launch from the in-flight one's
        carry before the host consumes it: nothing arrived or waits, no
        row prefills, is cancelled, joined or sat out since the chain
        began, no row was capacity-capped or wants a draft, and some row
        outlives the in-flight window (else the chained window computes
        only discards)."""
        p = self._inflight
        if p is None or not p.solo or not self.cfg.chained_decode or p.capacity_capped:
            return False
        if not self._submit_q.empty() or self.sched.waiting:
            return False
        if self._spec is not None and any(
            e.seq.state is SeqState.ACTIVE and self._spec.wants_draft(e.seq) for e in p.rows
        ):
            # A verify span would cover these positions in one dispatch,
            # and drafts are planned from freshly consumed tokens.
            return False
        stepped = {id(e.seq) for e in p.rows}
        for s in self.sched.slots:
            if s is None:
                continue
            if s.state is SeqState.PREFILL or s.is_cancelled():
                return False
            if s.state is SeqState.ACTIVE and id(s) not in stepped:
                return False  # joined or sat out: rebuild the window
        K = self.cfg.decode_window
        for e in p.rows:
            sc = e.seq.stop.stop_conditions
            max_tokens = sc.max_tokens or self.cfg.default_max_tokens
            if e.n_valid >= K and max_tokens - e.seq.generated > K:
                return True
        return False

    def _dispatch_chained(self, pending: _PendingRagged) -> _PendingRagged | None:
        """Window N+1 over window N's rows from N's carry on the device.
        The host's view of these rows lags one window, so every
        surviving row's position is its host position plus
        ``decode_window`` (a row the device parked carries -1 and
        computes discards). Pages are provisioned one window further;
        None (chain break) when the pool cannot cover a row."""
        cfg = self.cfg
        ps, K = cfg.page_size, cfg.decode_window
        nb = pending.nb
        max_pos = np.full(nb, -1, np.int64)
        table = np.zeros((nb, cfg.max_pages_per_seq), np.int32)
        eos_gate = np.zeros(nb, np.int64)
        budget_gate = np.full(nb, K, np.int64)
        rows: list[_RaggedRow] = []
        max_pages = 1
        capped = False
        for e in pending.rows:
            seq, r = e.seq, e.row
            wpos = len(seq.tokens) - 1 + K  # host view + the in-flight window
            self.sched.ensure_pages_until(seq, wpos + K - 1)
            cap = min(cfg.max_model_len, len(seq.page_ids) * ps) - 1
            if cap < wpos:
                return None  # pool dry: consume and rebuild instead
            capped = capped or cap < wpos + K
            max_pos[r] = cap
            table[r, : len(seq.page_ids)] = seq.page_ids
            max_pages = max(max_pages, (min(wpos + K, cap + 1) + ps - 1) // ps)
            eos_gate[r], budget_gate[r] = self._stop_gates(seq, seq.generated + K)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=min(K, cap - wpos + 1)))
        self._flush_offloads()
        max_d, table_d, eos_d, budget_d = self._upload(max_pos, table, eos_gate, budget_gate)
        nxt = self._launch_window(
            rows, nb, pending.full_sampler, True, capped, max_pages,
            pending.tokens_dev, pending.positions_dev, max_d, table_d, eos_d,
            budget_d, pending.stop_dev, pending.slot_dev, pending.sampler_dev,
        )
        self.dispatches["chained"] += 1
        return nxt

    # ----------------------------------------------------------------- consume
    def _consume_ragged(self, pending: _PendingRagged) -> None:
        if pending.windowed:
            self._consume_windowed(pending)
        else:
            self._consume_mixed(pending)

    def _consume_windowed(self, pending: _PendingRagged) -> None:
        """Emit each row's kept tokens; the host's check_stop is
        authoritative (a row may have computed past its stop). A stop
        found while a chained successor is in flight defers the finish
        (the page release) until the successor is consumed: the device
        already parked the row, so the successor writes nothing for it."""
        host = self._host(pending)
        sampled = host[0]
        if pending.want_lp:
            lps, top_ids, top_lps = host[1:4]
        finishes: list[Sequence] = []
        for e in pending.rows:
            seq, row = e.seq, e.row
            if seq.state is not SeqState.ACTIVE or seq.pending_finish is not None:
                self.wasted_steps += e.n_valid
                continue
            kept: list[int] = []
            reason = None
            for token in sampled[: e.n_valid, row]:
                token = int(token)
                kept.append(token)
                seq.tokens.append(token)
                seq.generated += 1
                reason = self.sched.check_stop(seq, token)
                if reason is not None:
                    break
            self.wasted_steps += e.n_valid - len(kept)
            self.sched.register_full_pages(seq)
            n_top = self._wants_logprobs(seq)
            pack = None
            if n_top is not None and kept:
                n = len(kept)
                pack = self._lp_pack(n_top, lps[:n, row], top_ids[:n, row], top_lps[:n, row])
            seq.emit(kept, None, pack)
            if reason is not None:
                seq.pending_finish = reason
                finishes.append(seq)
        if finishes:
            # No window may be in flight over pages about to be
            # released: consume the successor first.
            succ, self._inflight = self._inflight, None
            if succ is not None:
                self._consume_ragged(succ)
            for seq in finishes:
                reason, seq.pending_finish = seq.pending_finish, None
                self.sched.finish(seq, reason)

    # ------------------------------------------------------------------ mixed
    def _ragged_align(self) -> int:
        """Each row's span in the flat stream is aligned to the kernel's
        q_tile, so every tile belongs to one row; the plain version
        packs tight."""
        return self.cfg.ragged_q_tile if self.attn_impl == "kernel" else 1

    def _build_mixed(
        self, dec: list, spec: list, pf: list[Sequence], full_sampler: bool
    ) -> _PendingRagged:
        """Dispatch one flat stream carrying each prefill row's next
        chunk, each decode row's fed token and each speculative row's
        last token + drafts (no host sync). Every row samples at its
        last fed position (a prompt's first token from the raw
        distribution, decode tokens through their penalty counts); a
        verify span is scored at every position, one vocab projection
        with the last positions, and accepted on the device."""
        cfg, mcfg = self.cfg, self.cfg.model
        ps = cfg.page_size
        B1 = cfg.max_decode_slots + 1
        T_s = cfg.spec_max_draft + 1
        align = self._ragged_align()
        flat_tokens: list[int] = []
        flat_pos: list[int] = []
        flat_row: list[int] = []
        table = np.zeros((B1, cfg.max_pages_per_seq), np.int32)
        q_last = np.zeros(B1, np.int64)
        pos0 = np.full(B1, -1, np.int64)
        is_decode = np.zeros(B1, np.bool_)
        slot_map = np.full(B1, cfg.max_decode_slots, np.int64)
        spec_idx = np.zeros((B1, T_s), np.int64)
        spec_pos = np.full((B1, T_s), -1, np.int64)
        spec_drafts = np.full((B1, T_s - 1), -1, np.int64)
        n_drafts = np.zeros(B1, np.int64)
        arrs = self._sampler_arrays(B1)

        def add_span(toks: list[int], poss, r: int) -> int:
            """Append one row's span, padded to ``align`` with position
            -1 (writes dropped, scores masked, output zeros)."""
            start = len(flat_tokens)
            pad = (-len(toks)) % align
            flat_tokens.extend(list(toks) + [0] * pad)
            flat_pos.extend(list(poss) + [-1] * pad)
            flat_row.extend([r] * (len(toks) + pad))
            return start

        rows: list[_RaggedRow] = []
        max_pages = 1
        r = 0
        for seq in pf:
            n = min(len(seq.prompt) - seq.prefill_sent, cfg.prefill_chunk)
            start = seq.prefill_sent
            qs = add_span(seq.prompt[start : start + n], range(start, start + n), r)
            seq.prefill_sent = start + n
            table[r, : len(seq.page_ids)] = seq.page_ids
            q_last[r] = qs + n - 1
            # The first token's draw is keyed by the prompt's last
            # position, as a decode step feeding that token would be.
            pos0[r] = start + n - 1
            max_pages = max(max_pages, (seq.prefill_sent + ps - 1) // ps)
            self._row_sampler_args(seq, r, arrs)
            rows.append(
                _RaggedRow(seq, "prefill", r, completing=seq.prefill_sent == len(seq.prompt))
            )
            r += 1
        for seq, wpos, _cap in dec:
            qs = add_span([seq.last_token()], [wpos], r)
            table[r, : len(seq.page_ids)] = seq.page_ids
            q_last[r] = qs
            pos0[r] = wpos
            is_decode[r] = True
            slot_map[r] = seq.slot
            max_pages = max(max_pages, wpos // ps + 1)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=1))
            r += 1
        for seq, wpos, _cap, drafts in spec:
            # [last token] + drafts at consecutive positions.
            g = len(drafts)
            qs = add_span([seq.last_token()] + list(drafts), range(wpos, wpos + g + 1), r)
            table[r, : len(seq.page_ids)] = seq.page_ids
            q_last[r] = qs + g
            slot_map[r] = seq.slot
            spec_idx[r, : g + 1] = qs + np.arange(g + 1)
            spec_pos[r, : g + 1] = np.arange(wpos, wpos + g + 1)
            spec_drafts[r, :g] = drafts
            n_drafts[r] = g
            max_pages = max(max_pages, (wpos + g) // ps + 1)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "spec", r, n_drafts=g))
            r += 1

        with_spec = bool(spec)
        out_idx = np.concatenate([q_last, spec_idx.reshape(-1)]) if with_spec else q_last
        # Flat padding goes to the scratch row B1 - 1 (at most
        # max_decode_slots rows hold slots).
        (tokens, positions, row_of, table_d, out_d, pos0_d, dec_d, slot_d,
         spos_d, drafts_d, ndraft_d, *samp) = self._upload(
            np.asarray(flat_tokens, np.int64), np.asarray(flat_pos, np.int32),
            np.asarray(flat_row, np.int32), table, out_idx, pos0, is_decode,
            slot_map, spec_pos, spec_drafts, n_drafts, *arrs,
        )
        seeds, temp, top_k, top_p, freq, pres, rep = samp
        logits_all, _, _ = forward_ragged(
            self.model, mcfg, tokens, positions, row_of, table_d,
            self.k_cache, self.v_cache, out_d, attn_pages=max_pages,
            attn_impl=self.attn_impl, q_tile=align, drop_page=self._drop_page,
        )
        logits0 = logits_all[:B1]
        if full_sampler:
            counts = self._counts[slot_d]
            shaped = apply_penalties(logits0, counts, freq, pres, rep)
            tok0 = sample_tokens_seeded(
                torch.where(dec_d[:, None], shaped, logits0), seeds, pos0_d, temp, top_k, top_p
            ).long()
            counts.scatter_add_(1, tok0[:, None], dec_d.to(torch.int32)[:, None])
        else:
            tok0 = torch.argmax(logits0, dim=-1)
        ys = (tok0,)
        if with_spec:
            spec_logits = logits_all[B1:].reshape(B1, T_s, -1)
            if full_sampler:
                # Penalty counts thread past rejections (a rejected
                # draft leaves no trace).
                targets, n_emit, counts = spec_verify_tokens(
                    spec_logits, drafts_d, ndraft_d, seeds, spos_d, temp, top_k,
                    top_p, counts, freq, pres, rep,
                )
            else:
                targets = torch.argmax(spec_logits, dim=-1)
                n_emit = spec_accept_length(targets, drafts_d, ndraft_d)
            ys += (targets, n_emit)
        if full_sampler:
            self._counts[slot_d] = counts
        want_lp = any(self._wants_logprobs(e.seq) is not None for e in rows)
        if want_lp:
            ys += token_logprobs(logits0, tok0)
            if with_spec:
                lp, tid, tlp = token_logprobs(
                    spec_logits.reshape(B1 * T_s, -1), targets.reshape(-1)
                )
                ys += (lp.reshape(B1, T_s), tid.reshape(B1, T_s, -1), tlp.reshape(B1, T_s, -1))
        ys, ready = self._fetch(ys)
        self.steps += 1
        self.dispatches["mixed"] += 1
        self.spec_dispatches += with_spec
        return _PendingRagged(
            ys=ys, ready=ready, rows=rows, windowed=False, full_sampler=full_sampler,
            want_lp=want_lp, solo=False, with_spec=with_spec,
        )

    def _consume_mixed(self, pending: _PendingRagged) -> None:
        """Decode rows emit their one token, prompts completing their
        last chunk emit their first, speculative rows emit the accepted
        prefix and the correction the device computed (then rewind past
        the rejections), prompts mid-chunk emit nothing. The host's
        check_stop gates every token. Mixed batches are never chained
        over, so finishes release their pages at once."""
        host = self._host(pending)
        tok0, i = host[0], 1
        if pending.with_spec:
            targets, n_emits = host[1], host[2]
            i = 3
        if pending.want_lp:
            lp0, tid0, tlp0 = host[i : i + 3]
            if pending.with_spec:
                s_lps, s_tids, s_tlps = host[i + 3 : i + 6]

        def pack0(seq, r):
            n_top = self._wants_logprobs(seq)
            if not pending.want_lp or n_top is None:
                return None
            return self._lp_pack(n_top, lp0[r : r + 1], tid0[r : r + 1], tlp0[r : r + 1])

        for e in pending.rows:
            seq, r = e.seq, e.row
            if e.kind == "prefill":
                if e.completing:
                    self._finish_first_token(seq, int(tok0[r]), pack0(seq, r))
                continue
            if seq.state is not SeqState.ACTIVE or seq.pending_finish is not None:
                self.wasted_steps += 1
                continue
            if e.kind == "decode":
                token = int(tok0[r])
                seq.tokens.append(token)
                seq.generated += 1
                reason = self.sched.check_stop(seq, token)
                self.sched.register_full_pages(seq)
                seq.emit([token], None, pack0(seq, r))
                if reason is not None:
                    self.sched.finish(seq, reason)
                continue
            # Speculative row: the accepted drafts and the first
            # correction (the rule that also gated the penalty counts).
            g, n_emit = e.n_drafts, int(n_emits[r])
            accepted = n_emit - 1
            kept: list[int] = []
            reason = None
            for j in range(n_emit):
                token = int(targets[r, j])
                kept.append(token)
                seq.tokens.append(token)
                seq.generated += 1
                reason = self.sched.check_stop(seq, token)
                if reason is not None:
                    break
            self.wasted_steps += n_emit - len(kept)  # past a host-found stop
            seq.spec_dispatches += 1
            seq.spec_draft_tokens += g
            seq.spec_accepted_tokens += accepted
            seq.spec_emitted_tokens += len(kept)
            self.spec_row_dispatches += 1
            self.spec_draft_tokens += g
            self.spec_accepted_tokens += accepted
            self.spec_emitted_tokens += len(kept)
            self._spec.record(seq, proposed=g, accepted=accepted)
            self.sched.register_full_pages(seq)
            n_top = self._wants_logprobs(seq)
            pack = None
            if pending.want_lp and n_top is not None and kept:
                n = len(kept)
                pack = self._lp_pack(n_top, s_lps[r, :n], s_tids[r, :n], s_tlps[r, :n])
            seq.emit(kept, None, pack)
            if reason is not None:
                self.sched.finish(seq, reason)
            else:
                self._rewind_spec_pages(seq)

    def _finish_first_token(self, seq: Sequence, token: int, lp_pack=None) -> None:
        """The prompt's first sampled token: start its penalty counts,
        promote the sequence to decode, and emit (with its logprobs)."""
        seq.first_token_at = time.time()
        seq.state = SeqState.ACTIVE
        self._counts[seq.slot] = 0
        self._counts[seq.slot, token] += 1
        resumed = seq.stop.resume_offset or 0
        if resumed and self._needs_sampler(seq):
            # A continuation with penalties: the re-prefilled tail of the
            # prompt is journaled completion, so the counts rebuild over
            # it and every later draw sees the uninterrupted run's
            # counts. (The splice token itself was drawn by the prefill
            # from the raw distribution, the JAX engine's caveat.)
            V = self.cfg.model.vocab_size
            tail = np.clip(np.asarray(seq.prompt[-resumed:], np.int64), 0, V - 1)
            (tail_d,) = self._upload(np.bincount(tail, minlength=V).astype(np.int32))
            self._counts[seq.slot] += tail_d
        seq.tokens.append(token)
        seq.generated = 1
        self.sched.register_full_pages(seq)
        reason = self.sched.check_stop(seq, token)
        seq.emit([token], None, lp_pack)
        if reason is not None:
            self.sched.finish(seq, reason)
