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
  ``ragged_q_tile`` slots. Eager or graphed, on any device, the stream
  is padded to its key's token bucket (``aot.lattice.resolve_mixed_key``,
  the JAX mixed bucket; padding at position -1, owned by the scratch
  row), and on a card the dispatch replays the key's CUDA graph,
  captured as a window's is.
- **windowed**: pure decode, a Python loop of ``decode_window`` steps
  of ``models.llama.forward`` at T=1 (the kernel's decode shape). The
  next tokens and positions stay on the device between steps; a row
  parks at position -1 when it samples a stop token, spends its
  max_tokens budget, or reaches its page capacity. The host syncs once
  per window, when it consumes the window's tokens. Its rows and page
  bound are padded to the window's key (``aot.lattice.resolve_window_key``;
  padding rows at position -1), and on a card the window replays the
  key's CUDA graph (``engine/graphs.py``, ``cuda_graphs``), captured at
  the key's first dispatch or by ``aot.warmup.prewarm_engine``.

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

Deadlines (the JAX loop's three points): a waiting request whose
deadline passed is reaped (``Scheduler.reap_waiting``, throttled, and at
admission), a bound row is finished with ``error`` at its deadline (only
when no window is in flight, so its pages are released safely), and a
chain breaks at a row's deadline so the finish is not deferred. Each
counts on ``dynamo_deadline_exceeded_total{stage}`` (``engine_admission``
/ ``decode``).

Observability (``telemetry/``), every hook on the host side of a
dispatch, never inside a captured graph (a call there runs once, at
capture): the flight recorder at the JAX engine's event sites (admit,
dispatch, consume, first token, finish, preempt, stall, swap, prefetch,
page moves, speculation accept and rewind, chain break, prewarm), the
watchdog and the SIGUSR1 dump registry (both started by :meth:`start`,
after any prewarm), :class:`~..telemetry.dispatch.DispatchProfiler` at
the dispatch and consume points the loop already has (a dispatch that
captures its key's graph is its kind's first use), the engine gauges
published at most twice a second from host state, and the counters and
histograms the JAX engine feeds on the paths the port has.

Disaggregation and reclaim (the JAX engine's entry points): a decode
worker's ``generate(..., remote_kv=)`` admits a sequence whose prompt KV
a prefill worker computed, and the loop injects it (``_run_remote_inject``)
instead of prefilling; a prefill worker's ``prefill_extract`` runs the
prefill alone and hands back the first token and the prompt's pages,
pinned under a handoff lease (``_extract_prompt_pages``) until
``confirm_kv_lease`` or the loop's reaper releases them. ``pin_prefix``
pins a decode worker's resident prefix for a suffix-only transfer.
``reclaim_inflight`` / ``reclaim_extract`` / ``seed_prefix`` serve the
spot-reclaim plane's live KV migration. Every such call queues work for
the loop thread, the page manager's single writer, and the loop serves
it only when no window is in flight (a chain breaks for it): extracts
gather on the compute stream and copy device -> host on the copy
stream's side stream into pinned memory with one sync per sequence;
injects go through the same pinned staging and host -> device leg as
the host tier's uploads. None runs inside a captured graph.

Request anatomy and workload fingerprint (``telemetry/anatomy.py``,
``fingerprint.py``), at the JAX engine's tap sites: admission closes a
request's queue wait (or its preemption requeue) and feeds the live
fingerprint, the first token closes its prefill and books the
profiler's first-use capture seconds since admission as its compile
stall (``compile_s`` on the ``prefill`` span), swap and stall windows
close into its swap stall, and the scheduler's finish tap assembles the
anatomy (``anatomy_from_timing``) into per-component totals
(``dynamo_request_seconds{component}``) and a worst-N exemplar ring
(``metrics()["anatomy_slow"]``). ``DYN_WORKLOAD_REF`` pins a reference
fingerprint that ``metrics()`` scores live traffic against
(``dynamo_workload_drift_score``).
Every tap reads host clocks and counters only: none syncs the card.

Prefix sharing of pages still being filled, and partial tails
(``kv_manager.py``; JAX ``engine.py:1596-1598, 3023-3058``): a prefill
row attached to pages another row is still filling sits out until their
fills are dispatched (``Scheduler.fill_ready``, which also claims
orphans), and a row that attached a shared partial tail has it made
private (``_resolve_shared_tail``: a device-to-device copy of the page
in K and V on the compute stream) before its first write into it.
Unlike the JAX engine, that is before the prefill of the prompt's last
token, which lands in the tail page, and not before the first decode
step: on the card a recompute of that position in another batch shape
can differ in the last bit, so the sharer writes only its own copy and
the owner's page keeps the owner's bytes. For the same reason a
page-aligned prompt matched in full, whose last token's prefill lands
in the last matched page, copies that page first while another row
holds it.

Tensor parallelism (``cfg.tp > 1``, JAX ``engine.py:240``; ``engine/tp.py``):
each rank is a process with its own engine over its shard of the model
and of the pools, and a ``parallel.comm.Comm``. Rank 0's loop is the
loop above; each dispatch's key and host arrays go to the other ranks
just before it launches (``_launch_window``, ``_launch_mixed``), with
the device steps taken since (``_apply_tp_op``: copy-on-write copies,
penalty-count starts), and they run the same ``_window_body`` /
``_mixed_body`` on their shards (:meth:`follow`). Dispatches run
eagerly (no graphs), and what moves pages between tiers or processes
(the G2/G3 tiers, disaggregation, leases, reclaim) is refused.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import queue
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import AsyncIterator, Callable

import numpy as np
import torch

from ..aot.compile import manifest_for_engine
from ..aot.lattice import MixedKey, WindowKey, resolve_mixed_key, resolve_window_key
from ..device import resolve_device
from ..kv.persistent import PersistentKvStore
from ..models.llama import (
    Llama,
    forward,
    forward_ragged,
    init_kv_cache,
    init_params,
    resolve_attn,
)
from ..ops import launches
from ..ops.ragged_attention import ragged_supported
from ..ops.sampling import (
    TOP_LOGPROBS,
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
from ..telemetry import (
    DispatchProfiler,
    FlightRecorder,
    Watchdog,
    current_trace,
    get_telemetry,
    register_dumper,
    unregister_dumper,
)
from ..telemetry.anatomy import COMPONENTS, AnatomyRing, anatomy_from_timing
from ..telemetry.fingerprint import FingerprintBuilder, WorkloadDriftWatch, load_fingerprint
from ..telemetry.flight import default_dump_path
from ..tokens import compute_block_hashes_for_seq
from .config import EngineConfig
from .graphs import DispatchGraphs, pack_layout, views
from .kv_manager import KvEvent, KvPageManager
from .offload import CopyStream, HostKvPool, pinned_empty
from .scheduler import RemoteKv, Scheduler, Sequence, SeqState
from .tiering import SwapRecord, plan_swap_entries
from .tp import TpDriver, follow

log = logging.getLogger(__name__)

# Every KV ledger violation any engine in this process detected (in the
# loop or at stop), so a test suite can assert none happened.
LEDGER_VIOLATIONS: list[str] = []

# Width of the per-row stop-token set a decode window checks on the device.
STOP_WIDTH = 8


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
    the dispatch's one sync. A windowed batch keeps what a chained
    successor needs: its final carry on the device and its host
    inputs."""

    ys: tuple  # windowed: toks [K, rows] (+lp); mixed: tok0 [B1] (+spec) (+lp)
    ready: object
    rows: list  # [_RaggedRow]
    windowed: bool
    dispatched_at: float  # the profiler's dispatch stamp (0.0 without it)
    full_sampler: bool
    want_lp: bool
    solo: bool  # the iteration's only dispatch: chainable
    with_spec: bool = False  # mixed: carried verify spans
    nb: int = 0  # windowed: rows in the batch (before padding to a key's rows)
    # Windowed: the final carry, the next window's tokens and positions
    # over the same rows. Under CUDA graphs these are the graph's
    # outputs, which its next replay overwrites: only a chained
    # successor reads them, on the device, before its own replay.
    tokens_dev: torch.Tensor | None = None
    positions_dev: torch.Tensor | None = None
    # Windowed: the host arrays it was dispatched with; a chained
    # successor re-uploads their per-row constants (stop sets, slots,
    # sampler parameters).
    host_in: dict | None = None
    # Some row could reach its page/model-length cap inside the window:
    # its carry parks at -1 but the host resumes it after allocating
    # pages, so a chained window would feed a dead carry. No chaining.
    capacity_capped: bool = False


class TorchEngine(AsyncEngine):
    """Continuous-batching paged-KV engine on one device; with
    ``cfg.tp > 1``, one rank of a tensor-parallel engine (``engine/tp.py``):
    rank 0 serves and drives, every other rank runs :meth:`follow`."""

    def __init__(
        self,
        cfg: EngineConfig,
        model: Llama | None = None,
        device="cuda",
        kv_event_cb: Callable[[KvEvent], None] | None = None,
        seed: int = 0,
        comm=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        mcfg = cfg.model
        self.attn_impl = resolve_attn_impl(cfg, self.device)
        # Tensor parallelism: the ranks' collectives (None at tp=1, where
        # no process group exists and no collective is issued).
        if (cfg.tp > 1) != (comm is not None) or (comm is not None and comm.world != cfg.tp):
            raise ValueError(f"tp={cfg.tp} needs a comm over its {cfg.tp} ranks (and tp=1 none)")
        self.comm = comm
        rank = comm.rank if comm is not None else 0
        if model is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            model = init_params(mcfg, gen, self.device, rank=rank, tp=cfg.tp)
        if (model.tp, model.rank) != (cfg.tp, rank):
            raise ValueError(f"the model is rank {model.rank} of tp={model.tp}, the engine "
                             f"rank {rank} of tp={cfg.tp}")
        self.model = model
        # KV pools [L, P, ps, Hkv*D] (a rank's Hkv/tp heads), written in
        # place by every forward. One scratch page past the pool (never
        # handed out, in no page table) takes the K/V writes of padding
        # and parked rows, so a forward drops them without selecting rows
        # on the host.
        self._drop_page = cfg.num_pages
        self.k_cache, self.v_cache = init_kv_cache(
            mcfg, cfg.num_pages + 1, cfg.page_size, cfg.kv_torch_dtype, self.device, cfg.tp
        )
        # Rank 0 of tp > 1 drives the other ranks (None otherwise).
        self._tp = TpDriver(comm) if comm is not None and rank == 0 else None
        self.tp_reports: list[dict] | None = None  # every rank's, after stop()
        # KV page moves between the ranks' shards and whole pages (tp > 1,
        # every rank): calls and pages by direction, held equal at stop.
        self.page_moves = {d: {"calls": 0, "pages": 0} for d in ("gather", "scatter")}
        # G2 host tier: the pool lives here; the CopyStream (a thread and
        # two side streams) is made by start() and torn down by stop().
        # Under tp > 1 rank 0 alone holds the tiers, in whole pages (every
        # rank's heads): the other ranks own no page, they move their
        # head slices when rank 0 moves a page (``_gather_page_batch``).
        self.host_pool: HostKvPool | None = None
        self.copy_stream: CopyStream | None = None
        # Evictions buffered until the next compute dispatch, then
        # gathered as one batch: (page_id, seq_hash).
        self._pending_offloads: list[tuple[int, int]] = []
        on_evict = None
        if cfg.host_cache_pages > 0 and rank == 0:
            self.host_pool = HostKvPool(
                cfg.host_cache_pages,
                (mcfg.num_layers, cfg.page_size, mcfg.num_kv_heads * mcfg.head_dim_),
                cfg.kv_torch_dtype,
                pin_memory=self.device.type == "cuda",
            )

            def on_evict(pid: int, seq_hash: int) -> None:
                self._pending_offloads.append((pid, seq_hash))

        # G3 persistent tier: rides the host pool's eviction path (each
        # LRU-demoted G2 page is written through), boot-scanned here so a
        # restarted process re-attaches the prefixes that survived.
        self.g3_store: PersistentKvStore | None = None
        self.g3_boot_seconds = 0.0
        if cfg.kv_store_dir and rank == 0:
            if self.host_pool is None:
                log.warning("kv_store_dir=%r ignored: the G3 tier rides the G2 host pool's "
                            "eviction path (set host_cache_pages > 0)", cfg.kv_store_dir)
            else:
                self.g3_store = PersistentKvStore(
                    cfg.kv_store_dir, cfg.kv_store_pages, self.host_pool.page_shape,
                    cfg.kv_torch_dtype, chaos=cfg.kv_store_chaos,
                )
                t0 = time.perf_counter()
                adopted = self.g3_store.boot_scan()
                self.g3_boot_seconds = time.perf_counter() - t0
                if adopted or self.g3_store.torn_pages:
                    log.info("G3 store %s: adopted %d page(s), quarantined %d torn",
                             cfg.kv_store_dir, adopted, self.g3_store.torn_pages)
                self.host_pool.on_demote = self.g3_store.store
        self.kv = KvPageManager(
            cfg.num_pages, cfg.page_size,
            event_cb=kv_event_cb,
            sharing=cfg.prefix_sharing, host_pool=self.host_pool, on_evict=on_evict,
            g3_store=self.g3_store,
        )
        # Observability: the per-dispatch profiler and the flight
        # recorder's ring (dumped by the watchdog, SIGUSR1 and a crash).
        self.profiler = DispatchProfiler(get_telemetry()) if cfg.profile_dispatches else None
        self.flight = FlightRecorder() if cfg.flight_events else None
        self.sched = Scheduler(cfg, self.kv, flight=self.flight)
        if self.profiler is not None:
            self.sched.span_attrs = self._decode_span_attrs
        # Request anatomy and workload fingerprint: per-component totals
        # over finished requests, the worst-N exemplar ring, the live
        # fingerprint (fed at admission and finish) and its drift from a
        # pinned reference (DYN_WORKLOAD_REF=<fingerprint.json>).
        self.anatomy_totals: dict[str, float] = dict.fromkeys(COMPONENTS, 0.0)
        self.anatomy_requests = 0
        self.anatomy_ring = AnatomyRing()
        self.fingerprint = FingerprintBuilder()
        ref = None
        ref_path = os.environ.get("DYN_WORKLOAD_REF", "")
        if ref_path:
            try:
                ref = load_fingerprint(ref_path)
            except (OSError, ValueError) as e:
                log.warning("DYN_WORKLOAD_REF unreadable (%s): %s", ref_path, e)
        self.drift_watch = WorkloadDriftWatch(self.fingerprint, ref)
        self.sched.on_finish = self._record_anatomy
        self._last_gauge_pub = 0.0  # gauge publish throttle (monotonic)
        self._last_reap = 0.0  # waiting-queue reap throttle (monotonic)
        # Watchdog progress: bumped by every loop iteration that did work
        # and by every graph capture; frozen with work queued = a stall.
        self._progress_mark = 0
        self._watchdog: Watchdog | None = None
        self._flight_handle: int | None = None
        # Prefix-hit totals already published (the counters move by delta),
        # and the G3 store's checksum failures and quarantines.
        self._pub_prefix_hits = dict.fromkeys(self.kv.prefix_hits, 0)
        self._pub_store_checksum_failures = 0
        self._pub_store_quarantined = 0
        # In-loop conservation auditor: violations counted, the kinds of
        # the current episode (a persistent defect counts once), and
        # whether this episode has dumped its flight snapshot.
        self.kv_ledger_violations = 0
        self._ledger_last: tuple = ()
        self._ledger_dumped = False
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
        # Work the asyncio side queues for the loop thread: lease
        # confirms, prefix pins (tokens, loop, future, trace) and reclaim
        # calls (op, payload, loop, future); and the open ``kv_lease``
        # spans by lease id (trace, grant time).
        self._lease_confirm_q: queue.Queue[str] = queue.Queue()
        self._pin_q: queue.Queue[tuple] = queue.Queue()
        self._reclaim_q: queue.Queue[tuple] = queue.Queue()
        self._lease_traces: dict[str, tuple] = {}
        # KV handoff moves: pages and host seconds of the extract legs
        # (gather, device -> host, sync) and pages injected from a wire.
        self.kv_extract_pages = 0
        self.kv_extract_s = 0.0
        self.kv_inject_pages = 0
        self.leases_granted = 0  # handoff leases granted (extracts and pins)
        self.leases_confirmed = 0  # of those, confirmed (the rest reaped)
        self._wake = threading.Event()
        self._running = False
        self._held = False
        self._crashed = False  # the loop died (tp: no collective is safe after)
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
        # CUDA graphs of the dispatches, one per window or mixed key
        # (None: every dispatch runs eagerly). Set by default on a card,
        # except under tp > 1 (gloo collectives cannot be captured).
        use_graphs = cfg.cuda_graphs if cfg.cuda_graphs is not None else (
            self.device.type == "cuda" and cfg.tp == 1
        )
        if use_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, not {self.device}")
        self.graphs: DispatchGraphs | None = DispatchGraphs(self) if use_graphs else None
        self.prewarm_report = None  # aot.warmup.PrewarmReport of a warm boot
        # Config fingerprint for fleet scrapes, published from boot.
        self._build_info = {
            "manifest_hash": manifest_for_engine(self).hash(),
            "jax_version": f"torch-{torch.__version__}",
            "prefix_sharing": bool(cfg.prefix_sharing),
            "spec": cfg.spec_mode,
        }
        get_telemetry().set_build_info(**self._build_info)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running or self._held:
            return
        if self.comm is not None and self._tp is None:
            raise RuntimeError("a follower rank runs follow(), not the engine loop")
        if self._tp is not None and self._tp.closed:
            raise RuntimeError("this engine's tp ranks were stopped; make a new engine")
        if self.host_pool is not None and self.copy_stream is None:
            # The G3 store rides along: prefetch fetches fall through
            # G2 -> G3.
            self.copy_stream = CopyStream(self.host_pool, device=self.device,
                                          store=self.g3_store)
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="torch-engine-loop", daemon=True
        )
        self._thread.start()
        if self.flight is not None:
            self._flight_handle = register_dumper(self._dump_flight)
            if self.cfg.watchdog_stall_s > 0 and self._watchdog is None:
                self._watchdog = Watchdog(
                    self.cfg.watchdog_stall_s,
                    progress=lambda: self._progress_mark,
                    has_work=lambda: self.sched.has_work() or not self._submit_q.empty(),
                    dump_fn=self._dump_flight,
                )
                self._watchdog.start()

    def stop(self) -> None:
        """Stop the loop and the copy stream, then run the final ledger
        check and, with a G3 store, demote the whole warm G2 set into it
        and seal its manifest (the next boot's cache is as warm as this
        process was). Under tp > 1, rank 0 then stops the other ranks and
        gathers their reports (``tp_reports``), raising if their outputs
        differ from its own."""
        self._halt()
        if self._thread is not None:
            return  # a wedged loop: leave its state alone
        if self._tp is not None and not self._tp.closed and not self._crashed:
            self.tp_reports = self._tp.close(self)
        if self.cfg.kv_ledger_check:
            # Only violation kinds the in-loop check has not counted.
            seen = set(self._ledger_last)
            final = [v for v in self._ledger_violations()
                     if v.split(":", 1)[0] not in seen]
            if final:
                self.kv_ledger_violations += len(final)  # dynlint: thread-ownership(loop thread joined before teardown flush)
                LEDGER_VIOLATIONS.extend(final)
                get_telemetry().kv_ledger_violations.inc(len(final))
                for v in final:
                    log.error("KV ledger violation at stop: %s", v)
        if self.g3_store is not None:
            for h, k_page, v_page in self.host_pool.snapshot():
                self.g3_store.store(h, k_page, v_page)
            self.g3_store.seal()

    def rank_reports(self) -> list[dict]:
        """Every tp rank's report so far, in rank order (``engine/tp.py``:
        its outputs' digest, kernel launches, page moves, collectives);
        the ranks go on. Rank 0 of tp > 1 only, with the loop paused
        (:meth:`hold_admission`): a command is sent from one thread at a
        time."""
        if self._tp is None:
            raise RuntimeError("rank_reports() is rank 0's of an engine at tp > 1")
        if self._thread is not None:
            raise RuntimeError("rank_reports() needs the loop paused (hold_admission)")
        return self._tp.reports(self)

    def _halt(self) -> None:
        """Stop the loop thread and the copy stream (``hold_admission``
        pauses through this, without the G3 drain)."""
        self._running = False
        self._wake.set()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._flight_handle is not None:
            unregister_dumper(self._flight_handle)
            self._flight_handle = None
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                log.error("engine loop did not exit within 60s")
                return
            self._thread = None
        self._drain_pin_q()
        self._drain_reclaim_q()
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
        self._halt()
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
        report = self.kv.audit(holders)  # leases join as ``lease:<id>``
        if self.g3_store is not None:
            # The G3 store's own ledger (resident == adopted + stores -
            # evictions - quarantined), rendered by ``llmctl audit``.
            g3 = self.g3_store.ledger()
            report["g3"] = g3
            if g3["violations"]:
                report["ok"] = False
        return report

    def _ledger_violations(self) -> list[str]:
        violations = self.kv.ledger_check()
        if self.g3_store is not None:
            violations = violations + self.g3_store.ledger_check()
        return violations

    def _check_ledger(self) -> None:
        """One in-loop conservation check: counter arithmetic on the
        host, no device access. Only a new set of violation kinds counts
        (a persistent defect re-observed each cycle with drifting values
        must not melt the counter), and the first violation of an
        episode dumps a flight snapshot carrying the full audit."""
        violations = self._ledger_violations()
        sig = tuple(sorted({v.split(":", 1)[0] for v in violations}))
        if sig == self._ledger_last:
            return
        self._ledger_last = sig
        if not violations:
            self._ledger_dumped = False  # episode over: re-arm the dump
            return
        self.kv_ledger_violations += len(violations)
        LEDGER_VIOLATIONS.extend(violations)
        get_telemetry().kv_ledger_violations.inc(len(violations))
        for v in violations:
            log.error("KV ledger violation: %s", v)
        if self.flight is not None:
            self.flight.record("ledger_violation", count=len(violations))
        if not self._ledger_dumped:
            self._ledger_dumped = True
            self._dump_flight("kv_ledger")

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
        self, request, context: AsyncEngineContext | None = None,
        remote_kv: RemoteKv | None = None,
    ) -> ResponseStream[dict]:
        """Stream a request. ``remote_kv``: its prompt KV was computed
        by a prefill worker (disaggregation); the loop injects it at
        admission and goes straight to decode."""
        stream = self.submit(request, context, remote_kv=remote_kv)
        self.start()
        return stream

    def submit(
        self, request, context: AsyncEngineContext | None = None,
        remote_kv: RemoteKv | None = None,
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
            trace=current_trace(),
            submitted_at=time.time(),
            sample_seed=int(seed) if seed is not None else self._seed_rng.getrandbits(31),
            priority=binput.priority,
            deadline_unix=ctx.deadline or 0.0,
            remote_kv=remote_kv,
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

    # ------------------------------------------------------- disaggregation
    async def prefill_extract(
        self, request, context: AsyncEngineContext | None = None, skip_pages: int = 0,
    ) -> tuple[int, list, str]:
        """Run prefill only; hand back ``(first_token, pages, lease_id)``:
        the prompt's KV pages (host tensors, one ``(k, v)`` pair a page)
        for a decode worker to inject via ``generate(..., remote_kv=)``.
        ``skip_pages`` leading pages (the decode side's pinned resident
        prefix) are neither gathered nor shipped; the whole prompt is
        still prefilled here. The shipped device pages stay pinned under
        the lease until :meth:`confirm_kv_lease` or the reaper."""
        ctx = context or AsyncEngineContext()
        binput = (
            request.copy() if isinstance(request, BackendInput)
            else BackendInput.from_dict(request)
        )
        binput.stop_conditions.max_tokens = 1  # prefill produces one token
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def extract_cb(token: int, pages: list, lease_id: str) -> None:
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result((token, pages, lease_id)))

        def emit(tokens: list[int], reason: FinishReason | None, logprobs=None) -> None:
            if reason in (FinishReason.ERROR, FinishReason.CANCELLED):
                try:
                    loop.call_soon_threadsafe(
                        lambda: fut.done()
                        or fut.set_exception(RuntimeError(f"prefill failed: {reason}")))
                except RuntimeError:
                    pass  # the caller's loop closed

        seed = binput.sampling_options.seed
        seq = Sequence(
            request_id=ctx.id,
            prompt=list(binput.token_ids),
            stop=binput,
            emit=emit,
            is_cancelled=lambda: ctx.is_stopped,
            extract_cb=extract_cb,
            extract_skip=max(int(skip_pages), 0),
            trace=current_trace(),
            submitted_at=time.time(),
            sample_seed=int(seed) if seed is not None else self._seed_rng.getrandbits(31),
            priority=binput.priority,
            deadline_unix=ctx.deadline or 0.0,
        )
        self._submit_q.put(seq)
        self._wake.set()
        self.start()
        return await fut

    def confirm_kv_lease(self, lease_id: str) -> None:
        """Delivery ack for a lease (thread-safe: queued for the loop,
        the page manager's single writer)."""
        self._lease_confirm_q.put(lease_id)
        self._wake.set()

    async def pin_prefix(self, token_ids: list[int]) -> tuple[int, str | None]:
        """How many full prompt pages this engine holds, pinned under a
        lease until admission re-references them (the suffix-only
        transfer's ``skip_blocks``; released at inject, the reaper the
        backstop). ``(0, None)`` when the loop is not running, sharing
        is off, or nothing is resident. Under tp > 1 a pin is rank 0's
        alone: only its page manager holds references, and its
        dispatches carry the page tables the other ranks attend
        through, so no rank takes a device step for it."""
        if not self._running or not self.kv.sharing:
            # A prefix_sharing=False engine never re-attaches at
            # admission, so a skip would discard the whole transfer.
            return (0, None)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pin_q.put((list(token_ids), loop, fut, current_trace()))
        self._wake.set()
        if not self._running and not fut.done():
            # stop() drained the queue before this put landed.
            fut.set_result((0, None))
        return await fut

    def kv_page_nbytes(self) -> int:
        """Host bytes one KV page occupies on the wire (K and V, all
        layers): the triage planner's cost unit. The whole page, every
        rank's heads, at any tp: the host tier, the G3 store and the
        wire hold whole pages (a rank's pools hold its Hkv/tp heads)."""
        m = self.cfg.model
        itemsize = 2 if self.cfg.kv_dtype == "bfloat16" else 4
        return 2 * m.num_layers * self.cfg.page_size * m.num_kv_heads * m.head_dim_ * itemsize

    # --------------------------------------------------- spot-reclaim plane
    async def reclaim_inflight(self) -> list[dict]:
        """Triage snapshot: every migratable in-flight sequence (ACTIVE,
        resident, not an extract leg) with its priority and shippable
        KV size."""
        return await self._reclaim_call("snapshot", None, default=[])

    async def reclaim_extract(self, request_id: str, ttl_s: float):
        """Live-migration extract: the sequence's complete pages to the
        host in one gather, pinned under a ``ttl_s`` lease; returns
        ``(block_hashes, pages, lease_id)``, or None when the sequence
        is gone or not migratable (the caller falls back to the
        journal). The partial tail page is never shipped."""
        return await self._reclaim_call("extract", (request_id, ttl_s), default=None)

    async def seed_prefix(self, hashes: list[int], pages: list) -> int:
        """Survivor side of a migration: inject the shipped blocks and
        park them as matchable prefix pages (refcount 0, LRU), as a
        finished sequence's are; returns the blocks seeded."""
        return await self._reclaim_call("seed", (hashes, pages), default=0)

    async def _reclaim_call(self, op: str, payload, default):
        if not self._running:
            return default
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._reclaim_q.put((op, payload, loop, fut))
        self._wake.set()
        if not self._running and not fut.done():
            fut.set_result(default)
        return await fut

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
        # CUDA graphs, both kinds, then by kind ("window", "mixed").
        g = self.graphs
        by_kind = {} if g is None else {
            kind: {"captured": g.captured[kind], "capture_seconds": g.capture_seconds[kind],
                   "replays": g.replays[kind]}
            for kind in g.KINDS
        }
        m["graphs"] = by_kind
        for name, total in (("graphs_captured", "captured"),
                            ("graph_capture_seconds", "capture_seconds"),
                            ("graph_replays", "replays")):
            m[name] = sum(k[total] for k in by_kind.values())
        # The JAX engine's names: programs built (here graphs captured)
        # and variants a warm boot ran.
        m["compiled_ragged_variants"] = len(self.graphs.graphs) if self.graphs else 0
        report = self.prewarm_report
        m["prewarmed_variants"] = report.variants + report.mixed_variants if report else 0
        m["prewarm"] = report.to_dict() if report else None
        if self.host_pool is not None:
            m["host_cache_resident"] = self.host_pool.resident
            m["host_cache_hits"] = self.host_pool.hits
            m["host_cache_stores"] = self.host_pool.stores
            m["offload_hits"] = self.kv.offload_hits
            m["offload_misses"] = self.kv.offload_misses
        if self.g3_store is not None:
            # G3: occupancy, demote / promote traffic, crash-recovery
            # adoption and the corruption-containment counters.
            g3 = self.g3_store
            m["kv_store_resident"] = g3.resident  # kv_store_pages: the page manager's gauges
            m["kv_store_adopted"] = g3.adopted
            m["kv_store_demotes"] = g3.stores
            m["kv_store_promotes"] = g3.hits
            m["kv_store_evictions"] = g3.evictions
            m["kv_store_quarantined"] = g3.quarantined
            m["kv_store_torn"] = g3.torn_pages
            m["kv_store_checksum_failures"] = g3.checksum_failures
            m["kv_store_errors"] = g3.store_errors
            m["kv_store_degraded"] = int(g3.degraded)
        # Per-dispatch profiling: host gap / in-flight percentiles and
        # first-use captures by kind (window, mixed, kv_move, offload).
        if self.profiler is not None:
            m["dispatch"] = self.profiler.summary()
        m["decode_window"] = self.cfg.decode_window
        m["tp"] = self.cfg.tp
        if self.comm is not None:  # this rank's page moves (tp > 1)
            m["tp_page_moves"] = {k: dict(v) for k, v in self.page_moves.items()}
        # This process's device-kernel launches by group and kernel
        # (ops/launches.py): a worker's stats show what it ran.
        m["kernel_launches"] = {g: dict(c) for g, c in launches.COUNTERS.items()}
        m["kv_prefix_hits"] = dict(self.kv.prefix_hits)
        for kind, n in self.kv.prefix_hits.items():
            m[f"kv_prefix_hits_{kind}"] = n
        m["kv_ledger_violations"] = self.kv_ledger_violations
        m["prefill_tokens_computed"] = self.sched.prefill_tokens
        # Handoff leases and the KV moves of disaggregation and reclaim.
        m["kv_leases_active"] = self.kv.active_leases
        m["kv_leases_granted"] = self.leases_granted
        m["kv_leases_confirmed"] = self.leases_confirmed
        m["kv_lease_reclaimed_pages"] = self.kv.lease_reclaimed_pages
        m["kv_extract_pages"] = self.kv_extract_pages
        m["kv_extract_seconds"] = self.kv_extract_s
        m["kv_inject_pages"] = self.kv_inject_pages
        m["kv_cow_copies"] = self.kv.cow_copies
        from ..disagg.transfer import wire_checksum_failures

        m["kv_wire_checksum_failures"] = wire_checksum_failures()
        m["build_info"] = dict(self._build_info)
        # Request anatomy and workload fingerprint: component totals over
        # finished requests, the worst-N exemplars (``llmctl slow``), the
        # live fingerprint's digest and its drift from the pinned
        # reference (0.0 without one).
        m["anatomy_totals"] = {k: round(v, 6) for k, v in self.anatomy_totals.items()}
        m["anatomy_requests"] = self.anatomy_requests
        m["anatomy_slow"] = self.anatomy_ring.snapshot()
        fp = self.fingerprint.snapshot()
        m["workload_fingerprint"] = fp.digest()
        m["workload_requests"] = fp.n
        drift = self.drift_watch.score()
        m["workload_drift_score"] = drift
        get_telemetry().workload_drift_score.set(drift)
        return m

    # ---------------------------------------------------- flight / profiling
    def _decode_span_attrs(self) -> dict:
        """Profiler attrs for the decode span: median in-flight and host
        gap of decode windows, and the window size."""
        return self.profiler.span_attrs("window", decode_window=self.cfg.decode_window)

    def _flight_snapshot(self) -> dict:
        """Slot, queue and page state for a flight dump, read from host
        state only (the watchdog thread may call it while the loop is
        wedged: a torn read beats no dump)."""
        try:
            slots = [
                {
                    "slot": i, "req": s.request_id, "state": s.state.value,
                    "generated": s.generated, "pages": len(s.page_ids),
                    "stalled": bool(s.stalled_since), "swapped": s.swap is not None,
                    "preemptions": s.preemptions,
                }
                for i, s in enumerate(self.sched.slots) if s is not None
            ]
            return {
                "slots": slots,
                "waiting": len(self.sched.waiting),
                "submitted_unqueued": self._submit_q.qsize(),
                "pages_active": self.kv.active_pages,
                "pages_total": self.kv.num_pages,
                "inflight_window": self._inflight is not None,
                "progress_mark": self._progress_mark,
                "kv_audit": self.kv_audit(),
            }
        except Exception:  # noqa: BLE001 - the snapshot is best effort
            log.exception("flight snapshot failed")
            return {}

    def _dump_flight(self, reason: str) -> None:
        """Dump the flight ring and a snapshot (watchdog stall, SIGUSR1
        through the process registry, ``dump_all``, or a loop crash)."""
        if self.flight is None:
            return
        path = self.cfg.flight_dump_path or default_dump_path()
        self.flight.dump(path, reason, snapshot=self._flight_snapshot())

    def _maybe_publish_gauges(self) -> None:
        """Mirror the engine gauges into the registry at most twice a
        second (the loop can spin far faster); host state only."""
        now = time.monotonic()
        if now - self._last_gauge_pub < 0.5:
            return
        self._last_gauge_pub = now
        tel = get_telemetry()
        tel.publish_engine_gauges(self.metrics())
        if self.host_pool is not None:
            tel.kv_host_pages.set(self.host_pool.resident)
        if self.g3_store is not None:
            # Occupancy, and the store's own counters by delta.
            g3 = self.g3_store
            tel.kv_store_pages.set(g3.resident)
            delta = g3.checksum_failures - self._pub_store_checksum_failures
            if delta:
                tel.kv_checksum_failures.labels("store").inc(delta)
                self._pub_store_checksum_failures += delta
            delta = g3.quarantined - self._pub_store_quarantined
            if delta:
                tel.kv_quarantined.inc(delta)
                self._pub_store_quarantined += delta
        for kind, total in self.kv.prefix_hits.items():
            delta = total - self._pub_prefix_hits[kind]
            if delta:
                tel.kv_prefix_hits.labels(kind).inc(delta)
                self._pub_prefix_hits[kind] = total

    def record_prewarm(self, report, manifest) -> None:
        """A warm boot's report (``aot.warmup.prewarm_engine``): its
        seconds and variants by kind on the registry, a ``prewarm``
        flight event, and (no graphs) its keys marked as used, so their
        first traffic dispatch is not counted as first use."""
        self.prewarm_report = report
        tel = get_telemetry()
        tel.prewarm_seconds.set(report.seconds)
        tel.prewarm_variants.labels("window").inc(report.variants)
        tel.prewarm_variants.labels("mixed").inc(report.mixed_variants)
        if self.profiler is not None:
            self.profiler.seed_variants("window", manifest.windows)
            self.profiler.seed_variants("mixed", manifest.mixed)
        if self.flight is not None:
            self.flight.record("prewarm", window=report.variants, mixed=report.mixed_variants)

    def _fresh(self, kind: str, key, captured_before: int | None) -> bool:
        """Whether this dispatch was ``key``'s first use: it captured the
        key's graph (a capture is progress for the watchdog), or, with no
        graphs, it is the key's first dispatch."""
        if captured_before is not None:
            fresh = self.graphs.captured[kind] > captured_before
            if fresh:
                self._progress_mark += 1
            return fresh
        return self.profiler.first_variant(kind, key) if self.profiler is not None else False

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
                # Conservation auditor: counter arithmetic over the page
                # ledger every cycle, busy or idle (a leaked ref or a
                # double release is caught within one cycle).
                if self.cfg.kv_ledger_check:
                    self._check_ledger()
                if self._inflight is not None:
                    # Steady state: launch the next window from the
                    # in-flight one's device carry, then consume the
                    # in-flight one while the next runs.
                    nxt = self._dispatch_chained(self._inflight) if self._can_chain() else None
                    prev, self._inflight = self._inflight, nxt
                    self._consume_ragged(prev)
                    self._maybe_publish_gauges()
                    self._progress_mark += 1  # consumed a window
                    if self._inflight is not None:
                        continue
                    # Chain broken (arrivals, prefill, a stop, a
                    # deadline, a dry pool): the full scheduling path
                    # follows.
                    if self.flight is not None:
                        self.flight.record("chain_break")
                # No window is in flight from here on. Lease confirms and
                # the reaper, prefix pins and the reclaim plane's calls
                # move pages (and extracts sync), so they run here; a
                # chain breaks when any is queued (``_can_chain``).
                self._service_leases()
                self._service_pins()
                self._service_reclaims()
                if not self.sched.has_work() and self._submit_q.empty():
                    # Idle: completed prefetches still inject, buffered
                    # evictions still reach the host tier, and the
                    # gauges decay to the idle state.
                    self._apply_prefetches()
                    self._flush_offloads()
                    self._maybe_publish_gauges()
                    if self.profiler is not None:
                        # Waiting for work is not host gap.
                        self.profiler.mark_idle()
                    if self._tp is not None:
                        self._tp.heartbeat()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                while True:
                    try:
                        self.sched.submit(self._submit_q.get_nowait())
                    except queue.Empty:
                        break
                self._poll_cancellations()
                # Reap dead work anywhere in the waiting queue before it
                # can waste a prefill; the full scan is throttled (the
                # loop can spin fast on a dry pool) and admission checks
                # the head in between.
                now_m = time.monotonic()
                if now_m - self._last_reap >= 0.02:
                    self._last_reap = now_m
                    self.sched.reap_waiting()
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
                self._maybe_publish_gauges()
                prefilling = [
                    s for s in self.sched.slots
                    if s is not None and s.state is SeqState.PREFILL
                ]
                # Rows attached to pages another row is still filling sit
                # out until those fills are dispatched (fill_ready also
                # claims orphans), and a shared partial tail is copied
                # before the row's first write into it: stream order then
                # makes the reads safe. Prompts whose KV a prefill worker
                # computed are injected (and start decoding) instead of
                # prefilled. Partitioned first, as the JAX loop does: a
                # fallback to local prefill joins the next dispatch.
                ready = [s for s in prefilling
                         if self.sched.fill_ready(s) and self._resolve_shared_tail(s)]
                batch = [s for s in ready if s.remote_kv is None]
                for seq in ready:
                    if seq.remote_kv is not None:
                        self._run_remote_inject(seq)
                pendings = self._dispatch_ragged(batch[: self.cfg.prefill_batch])
                if len(pendings) == 1 and pendings[0].solo and self.cfg.chained_decode:
                    self._inflight = pendings[0]  # consumed next iteration
                else:
                    # Mixed batches consume in the same iteration: the
                    # next chunks and drafts are planned from the tokens
                    # they just confirmed.
                    for p in pendings:
                        self._consume_ragged(p)
                if pendings:
                    self._progress_mark += 1
                else:
                    # Pool dry / everything stalled: yield briefly. No
                    # progress: the state the watchdog must see frozen.
                    if self.profiler is not None:
                        self.profiler.mark_idle()
                    if self._tp is not None:
                        self._tp.heartbeat()
                    self._wake.wait(timeout=0.001)
                    self._wake.clear()
            if self._inflight is not None:
                # Paused (stop / hold_admission): the window's tokens
                # belong to the host state the next loop builds from.
                prev, self._inflight = self._inflight, None
                self._consume_ragged(prev)
        except Exception:  # engine death must not hang clients
            log.exception("engine loop crashed; failing in-flight requests")
            self._dump_flight("crash")
            self._crashed = True
            self._running = False
            self._inflight = None
            self._drain_pin_q()
            self._drain_reclaim_q()
            pending = list(self.sched.slots) + list(self.sched.waiting)
            while not self._submit_q.empty():
                pending.append(self._submit_q.get_nowait())
            for seq in pending:
                if seq is not None:
                    seq.emit([], FinishReason.ERROR)
            raise

    def _poll_cancellations(self) -> None:
        """Finish bound rows that were cancelled or whose deadline passed
        (no window is in flight here, so the release races no write)."""
        now = time.time()
        for s in list(self.sched.slots):
            if s is None:
                continue
            if s.is_cancelled():
                self.sched.finish(s, FinishReason.CANCELLED)
            elif s.deadline_unix and now >= s.deadline_unix:
                get_telemetry().deadline_exceeded.labels("decode").inc()
                self.sched.finish(s, FinishReason.ERROR)

    def _on_admitted(self, seq: Sequence) -> None:
        """Close the request's queue wait (submission -> slot and pages
        bound), inject the admission's G2 pages (before any forward that
        can read them) and attribute the prefetched pages it attached."""
        now = time.time()
        seq.admitted_at = now
        # Anatomy: a first admission closes the queue wait, a re-admission
        # after preemption the requeue wait; the profiler's capture-seconds
        # total is marked for the first token's compile stall. The
        # fingerprint counts first admissions only (a continuation is the
        # same request).
        if seq.anat_preempted_at:
            seq.anat_preempt_s += max(now - seq.anat_preempted_at, 0.0)
            seq.anat_preempted_at = 0.0
        else:
            if seq.submitted_at:
                seq.anat_queue_s += max(now - seq.submitted_at, 0.0)
            self.fingerprint.observe_admit(
                len(seq.prompt), seq.cached_len, seq.priority, seq.submitted_at or now)
        if self.profiler is not None:
            seq.anat_compile_mark = self.profiler.compile_total_s()
        tel = get_telemetry()
        if seq.request_id in self._prefetch_inflight:
            tel.kv_prefetch_pages.labels("late").inc()
        served = self._prefetch_served.pop(seq.request_id, None)
        if served:
            hits = sum(1 for h in seq.prompt_hashes[: seq.hashed_pages] if h in served)
            if hits:
                self.prefetch_hits += hits
                tel.kv_prefetch_pages.labels("hit").inc(hits)
        if self.flight is not None:
            self.flight.record(
                "admit", req=seq.request_id, slot=seq.slot, prompt=len(seq.prompt),
                cached=seq.cached_len, priority=seq.priority,
            )
        if seq.submitted_at:
            tel.queue_wait.observe(max(now - seq.submitted_at, 0.0))
            tel.emit_stage("queue_wait", seq.submitted_at, now, seq.trace,
                           prompt_tokens=len(seq.prompt))
        self._apply_uploads(seq)

    # ------------------------------------------------------ request anatomy
    def _record_anatomy(self, seq: Sequence, reason, now: float, was_bound: bool) -> None:
        """The scheduler's finish tap: close the sequence's open anatomy
        segments, assemble its anatomy from the loop-stamped sums (host
        arithmetic only) and feed the component totals, the exemplar
        ring and the fingerprint. A prefill worker's extract sequence is
        an internal sub-request: its time shows in the client request's
        remote prefill and transfer spans."""
        if seq.extract_cb is not None:
            return
        if seq.anat_preempted_at:
            # Finished in preemption limbo (cancelled while requeued).
            seq.anat_preempt_s += max(now - seq.anat_preempted_at, 0.0)
            seq.anat_preempted_at = 0.0
        elif was_bound:
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
        resumed = seq.stop.resume_offset or 0
        generated = resumed + seq.generated
        ttft = None
        if seq.first_token_at and not seq.preemptions and seq.submitted_at:
            ttft = max(seq.first_token_at - seq.submitted_at, 0.0)
        itl = None
        if seq.first_token_at and seq.generated > 1:
            itl = max(now - seq.first_token_at, 0.0) / (seq.generated - 1)
        a = anatomy_from_timing(
            seq.request_id,
            queue_s=seq.anat_queue_s,
            prefill_s=seq.anat_prefill_s,
            decode_s=seq.anat_decode_s,
            compile_s=seq.anat_compile_s,
            swap_s=seq.anat_swap_s,
            preempt_s=seq.anat_preempt_s,
            gap_frac=(self.profiler.host_gap_fraction("window")
                      if self.profiler is not None else 0.0),
            edge_latency_s=max(now - seq.submitted_at, 0.0) if seq.submitted_at else 0.0,
            ttft_s=ttft,
            itl_s=itl,
            prompt_tokens=max(len(seq.prompt) - resumed, 0),
            generated_tokens=generated,
            priority=seq.priority,
            page_seconds=seq.anat_page_s,
        )
        self.anatomy_requests += 1
        tel = get_telemetry()
        for comp, v in a.components.items():
            if v > 0:
                self.anatomy_totals[comp] += v
                tel.request_seconds.labels(comp).inc(v)
        self.anatomy_ring.offer(a)
        self.fingerprint.observe_finish(
            generated,
            round(seq.spec_emitted_tokens / seq.spec_dispatches, 4)
            if seq.spec_dispatches else 0.0,
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
        now = time.time()
        t0 = victim.stalled_since or now
        freed, generated = len(victim.page_ids), victim.generated
        self.sched.preempt(victim)
        self.preempted += 1
        tel = get_telemetry()
        tel.preemptions.labels("kv_pressure").inc()
        tel.emit_stage(
            "preemption", t0, now, victim.trace, generated_tokens=generated,
            freed_pages=freed, priority=victim.priority, preemption=victim.preemptions,
        )
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
        if grace < 0 or self.host_pool is None or not self._stalled_past(grace):
            return
        n_stalled = sum(1 for s in self.sched.slots if s is not None and s.stalled_since)
        cands = [
            s for s in self.sched.slots
            if s is not None
            and s.state is SeqState.ACTIVE
            and s.swap is None
            and (n_stalled >= 2 or not s.stalled_since)
            and s.extract_cb is None
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
            self.kv.page_ref, self.kv.page_hash, victim.shared_tail_pid,
        )
        if not (off_pids or park_pids or drop_pids):
            return False
        record = SwapRecord(entries=entries, committed=not off_pids)
        if off_pids:
            k_b, v_b, ready, t_disp = self._gather_page_batch(off_pids)

            def committed(rec=record, prof=self.profiler):
                rec.committed = True  # copy thread, after the store
                if prof is not None:
                    prof.consume("offload", t_disp)

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
        # A stalled victim now waits in the host tier: its open stall
        # window rolls into the swap stall, and the swap window starts.
        if victim.stalled_since:
            victim.anat_swap_s += max(victim.swapped_since - victim.stalled_since, 0.0)
        victim.stalled = False
        victim.stalled_since = 0.0
        self.swapped_out += 1
        tel = get_telemetry()
        tel.kv_proactive_offloads.inc()
        tel.kv_page_moves.labels("offload").inc(len(off_pids))
        if self.flight is not None:
            self.flight.record(
                "swap_out", req=victim.request_id, slot=victim.slot,
                pages=len(off_pids) + len(park_pids) + len(drop_pids),
                kept=len(victim.page_ids),
            )
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
                self._inject_page_batch(inj, k_st, v_st, op="swap_in")
            seq.page_ids = new_ids
            seq.swap = None
            if seq.swapped_since:  # anatomy: the swap window closed
                seq.anat_swap_s += max(time.time() - seq.swapped_since, 0.0)
            seq.swapped_since = 0.0
            self.swapped_in += 1
            get_telemetry().kv_swap_ins.inc()
            if self.flight is not None:
                self.flight.record("swap_in", req=seq.request_id, slot=seq.slot,
                                   pages=len(inj), attached=len(attach))

    def _preempt_swapped(self, seq: Sequence) -> None:
        """Swap-in fallback: the host tier lost a swapped page."""
        self.sched.preempt(seq)
        self.preempted += 1
        get_telemetry().preemptions.labels("swap_miss").inc()
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
            or self.host_pool is None
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
            rest = hashes[start:]
            g2 = self.host_pool.match_chain(rest)
            if self.g3_store is not None and len(g2) < len(rest):
                # The copy stream's fetch falls through G2 -> G3 per page,
                # so a store-resident tail restores on the same path.
                g2 = g2 + self.g3_store.match_chain(rest[len(g2):])
            g2 = g2[:budget]
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
                get_telemetry().kv_prefetch_pages.labels("dropped").inc(len(pids))
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
                    [pid for pid, _, _ in inj], *self._stage([(k, v) for _, k, v in inj]),
                    op="prefetch",
                )
                self.prefetched_pages += len(inj)
                get_telemetry().kv_prefetch_pages.labels("restored").inc(len(inj))
                if self.flight is not None:
                    self.flight.record("prefetch", req=job["req"], pages=len(inj))
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
        self._prefetch_inflight.clear()  # dynlint: thread-ownership(loop thread joined before teardown flush)

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

    def _gather_page_batch(self, pids: list[int], kind: str = "offload",
                           page_major: bool = False):
        """One gather of ``pids`` into contiguous device batches
        ``[L, n, ps, Hkv*D]`` (``[n, L, ps, Hkv*D]`` when ``page_major``)
        on the compute stream, the event recorded after it (CUDA), which
        the copy stream waits on, and the profiler's dispatch stamp
        (consumed once the batch is on the host). ``kind``: ``offload``
        (host tier) or ``kv_move`` (an extract for the wire). Under
        tp > 1 the batches hold whole pages, every rank's heads in rank
        order (``pages_out``, ``engine/tp.py``), on the host (no event:
        already landed)."""
        prof = self.profiler
        t0 = prof.begin(kind) if prof is not None else 0.0
        if self._tp is not None:
            self._tp.send("pages_out", page_major, {"pids": np.asarray(pids, np.int64)})
        k_b, v_b = self._gather_pages(pids, page_major)
        ready = None
        if k_b.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        t_disp = prof.end(kind, t0) if prof is not None else 0.0
        if self.flight is not None:
            self.flight.record("dispatch", dispatch=kind, pages=len(pids))
        return k_b, v_b, ready, t_disp

    def _inject_page_batch(self, pids: list[int], k_host: torch.Tensor, v_host: torch.Tensor,
                           op: str):
        """Inject host batches ``[L, n, ps, Hkv*D]`` (whole pages) into
        device pages ``pids``: host -> device on the copy stream's side
        stream, then a scatter on the compute stream after it, ahead of
        every later forward; under tp > 1 each rank's head slice to that
        rank (``pages_in``, ``engine/tp.py``). Buffered evictions are
        gathered first, so a page being overwritten reached the host
        tier's gather before this lands. No sync follows a scatter, so
        the profiler sees its dispatch only. ``op`` labels the page-move
        counter (upload, prefetch, swap_in)."""
        self._flush_offloads()
        prof = self.profiler
        t0 = prof.begin("kv_move") if prof is not None else 0.0
        if self._tp is not None:
            self._tp.send("pages_in", None, {"pids": np.asarray(pids, np.int64)})
        self._scatter_pages(pids, k_host, v_host)
        if prof is not None:
            prof.end("kv_move", t0)
        if self.flight is not None:
            self.flight.record("dispatch", dispatch="kv_move", op=op, pages=len(pids))
        get_telemetry().kv_page_moves.labels(op).inc(len(pids))

    def _gather_pages(self, pids, page_major: bool = False) -> tuple:
        """``pids``' K and V on this rank's card, one contiguous batch
        each; under tp > 1 (every rank, rank 0 driving) every rank's
        head slice gathered to rank 0 as whole host pages (the heads'
        axis is the last, in rank order), None on the others."""
        (idx,) = self._upload(np.asarray(pids, np.int64))
        k_b = self.k_cache.index_select(1, idx)
        v_b = self.v_cache.index_select(1, idx)
        if page_major:
            k_b, v_b = k_b.transpose(0, 1).contiguous(), v_b.transpose(0, 1).contiguous()
        if self.comm is None:
            return k_b, v_b
        self._count_move("gather", len(pids))
        kv = self.comm.gather(torch.stack([k_b, v_b]), dim=-1)
        return (None, None) if kv is None else (kv[0], kv[1])

    def _scatter_pages(self, pids, k_host=None, v_host=None) -> None:
        """Write whole host pages ``[L, n, ps, Hkv*D]`` into ``pids``;
        under tp > 1 (every rank, rank 0 driving) rank 0's pages are
        scattered by head slice on the host and each rank uploads and
        writes its own (the others pass no pages)."""
        comm = self.comm
        if comm is None:
            k_dev, v_dev = self._moves().upload(k_host, v_host)
        else:
            self._count_move("scatter", len(pids))
            m = self.cfg.model
            shape = (2, m.num_layers, len(pids), self.cfg.page_size,
                     m.num_kv_heads // comm.world * m.head_dim_)
            parts = None
            if comm.rank == 0:
                parts = list(torch.stack([k_host, v_host]).chunk(comm.world, dim=-1))
            mine = comm.scatter(parts, shape, self.cfg.kv_torch_dtype)
            if comm.rank == 0:
                k_dev, v_dev = self._moves().upload(mine[0], mine[1])
            else:
                k_dev, v_dev = mine.to(self.device)
        (idx,) = self._upload(np.asarray(pids, np.int64))
        self.k_cache.index_copy_(1, idx, k_dev)
        self.v_cache.index_copy_(1, idx, v_dev)

    def _count_move(self, direction: str, pages: int) -> None:
        moves = self.page_moves[direction]
        moves["calls"] += 1
        moves["pages"] += pages

    def _flush_offloads(self) -> None:
        """Gather every eviction buffered since the last dispatch and
        hand the batch to the copy stream. Runs right before anything
        that could overwrite the evicted pages (forwards, injects) and on
        the idle path: the gather then reads the old content. After a
        crash under tp > 1 the batch is dropped: no collective is safe
        then."""
        if not self._pending_offloads:
            return
        moved, self._pending_offloads = self._pending_offloads, []  # dynlint: thread-ownership(loop thread joined before teardown flush)
        if self.copy_stream is None or (self._tp is not None and self._crashed):
            return
        k_b, v_b, ready, t_disp = self._gather_page_batch([pid for pid, _ in moved])
        on_stored = None
        if self.profiler is not None:
            prof = self.profiler
            on_stored = lambda: prof.consume("offload", t_disp)  # noqa: E731
        self.copy_stream.offload_batch([h for _, h in moved], k_b, v_b, on_stored=on_stored,
                                       ready=ready)
        get_telemetry().kv_page_moves.labels("offload").inc(len(moved))

    def _apply_uploads(self, seq: Sequence) -> None:
        """Inject an admission's G2 pages into their fresh device pages,
        in one batch, before any forward that reads them."""
        if not seq.pending_uploads:
            return
        ups = seq.pending_uploads
        pids = [pid for pid, _, _, _ in ups]
        self._inject_page_batch(pids, *self._stage([(k, v) for _, _, k, v in ups]),
                                op="upload")
        self.kv.mark_filled(pids)  # registered pending at admission
        seq.pending_uploads = []

    def _resolve_shared_tail(self, seq: Sequence) -> bool:
        """Copy-on-write before the row's first write into its shared
        partial tail (the prefill of the prompt's last token, or a
        remote inject), or into the last matched page of a page-aligned
        prompt matched in full, while another row holds it. Sole holder: the page just leaves the index.
        Shared: a fresh page takes a device-to-device copy of it in K
        and V on the compute stream, ahead of the dispatch that writes
        it, and replaces it in the row's table. False when the pool
        cannot supply the copy (the row waits; retried next iteration).
        True for a row with no shared tail."""
        pid = seq.shared_tail_pid
        if pid < 0:
            return True
        full = (seq.page_ids.index(pid) + 1) * self.cfg.page_size <= len(seq.prompt)
        if full and self.kv.page_ref(pid) <= 1:
            # A fully covered last page no other row holds: the rewrite
            # of its last slot reaches no live reader, and the block
            # stays registered.
            seq.shared_tail_pid = -1
            return True
        new_pid = self.kv.make_private(pid)
        if new_pid is None:
            return False
        if new_pid != pid:
            # An eviction the new page's allocation made reaches its
            # gather before the copy overwrites the page.
            self._flush_offloads()
            prof = self.profiler
            t0 = prof.begin("kv_move") if prof is not None else 0.0
            self._apply_tp_op(("copy_page", pid, new_pid))
            if prof is not None:
                prof.end("kv_move", t0)
            seq.page_ids[seq.page_ids.index(pid)] = new_pid
            self.kv.release_sequence([pid])
            tel = get_telemetry()
            tel.kv_page_moves.labels("cow").inc()
            tel.kv_cow_copies.inc()
            if self.flight is not None:
                self.flight.record("cow", req=seq.request_id, slot=seq.slot)
        seq.shared_tail_pid = -1
        return True

    # ------------------------------------------------------ KV handoffs
    def _moves(self) -> CopyStream:
        """The copy stream the handoffs' device <-> host legs use: the
        host tier's, or one made for them (no host pool, no offloads)."""
        if self.copy_stream is None:
            self.copy_stream = CopyStream(self.host_pool, device=self.device,
                                          store=self.g3_store)
        return self.copy_stream

    def _pages_to_host(self, pids: list[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``pids``' KV on the host, one ``(k, v)`` pair of contiguous
        ``[L, ps, Hkv*D]`` pages each: one gather on the compute stream
        (page-major, so no page is copied again for the wire), the
        device -> host copy on the copy stream into pinned memory, one
        sync."""
        t0 = time.perf_counter()
        k_b, v_b, ready, t_disp = self._gather_page_batch(pids, kind="kv_move", page_major=True)
        k_h, v_h = self._moves().to_host(k_b, v_b, ready)
        if self.profiler is not None:
            self.profiler.consume("kv_move", t_disp)
        if self.flight is not None:
            self.flight.record("consume", dispatch="kv_move", pages=len(pids))
        get_telemetry().kv_page_moves.labels("extract").inc(len(pids))
        self.kv_extract_pages += len(pids)
        self.kv_extract_s += time.perf_counter() - t0
        return [(k_h[j], v_h[j]) for j in range(len(pids))]

    def _open_lease(self, lease_id: str, seq: Sequence | None, pages: int, trace=None) -> None:
        """Open a lease's ``kv_lease`` span (closed at confirm or reap)
        and record its grant."""
        self.leases_granted += 1
        trace = seq.trace if seq is not None else trace
        if trace is not None:
            self._lease_traces[lease_id] = (trace, time.time())
        if self.flight is not None and seq is not None:
            self.flight.record("lease_grant", req=seq.request_id, pages=pages)

    def _close_lease_span(self, lease_id: str, outcome: str, pages: int | None = None) -> None:
        """One ``kv_lease`` span from grant to confirm or reap, in the
        request's trace (leases granted without one: no span)."""
        self.leases_confirmed += outcome == "confirmed"
        entry = self._lease_traces.pop(lease_id, None)
        if entry is None:
            return
        trace, granted_at = entry
        get_telemetry().emit_stage(
            "kv_lease", granted_at, time.time(), trace,
            lease_id=lease_id, outcome=outcome, pages=pages,
        )

    def _extract_prompt_pages(self, seq: Sequence) -> tuple[list, str]:
        """Every prompt page past ``extract_skip`` (the partial tail
        included) on the host for the wire, in one gather and one sync,
        pinned under a handoff lease granted while the sequence still
        holds its references."""
        ps = self.cfg.page_size
        n_pages = (len(seq.prompt) + ps - 1) // ps
        skip = min(seq.extract_skip, n_pages)
        pids = seq.page_ids[skip:n_pages]
        if not pids:
            return [], ""
        pages = self._pages_to_host(pids)
        lease_id = self.kv.grant_lease(pids, self.cfg.kv_lease_ttl_s)
        self._open_lease(lease_id, seq, len(pids))
        return pages, lease_id

    def _run_remote_inject(self, seq: Sequence) -> None:
        """Disaggregated admission: inject the remote prefill's pages
        (one batch) and go straight to decode. A suffix-only transfer
        ships pages from prompt page ``skip_pages``; the pin that kept
        the first ones resident is released here (admission holds them
        now). If those pages are no longer all resident (the pin was
        reaped under a long queue wait), the received suffix is useless:
        the sequence falls back to local prefill."""
        ps = self.cfg.page_size
        rk = seq.remote_kv
        if rk.pin_lease:
            if self.kv.confirm_lease(rk.pin_lease):
                self._close_lease_span(rk.pin_lease, "confirmed")
            rk.pin_lease = None
        n_pages = (len(seq.prompt) + ps - 1) // ps
        resident = seq.hashed_pages  # G1 matched + G2 restored at admission
        if rk.skip_pages and resident < rk.skip_pages:
            log.warning(
                "request %s: suffix-only KV transfer skipped %d pages but only %d are "
                "resident; prefilling locally", seq.request_id, rk.skip_pages, resident,
            )
            seq.remote_kv = None
            return
        start = max(resident, rk.skip_pages)
        end = min(n_pages, rk.skip_pages + len(rk.pages))
        if end > start:
            pages = [rk.pages[i - rk.skip_pages] for i in range(start, end)]
            self._inject_page_batch(seq.page_ids[start:end], *self._stage(pages), op="inject")
            self.kv.mark_filled(seq.page_ids[start:end])
            self.kv_inject_pages += end - start
        seq.remote_kv = None  # drop the host copy once its inject is queued
        seq.remote_prefilled = True
        # The decode worker computed none of this prompt's KV.
        self.sched.prefill_tokens -= len(seq.prompt) - seq.cached_len
        seq.prefill_sent = len(seq.prompt)
        self._finish_first_token(seq, rk.first_token)

    def _service_leases(self) -> None:
        """Queued delivery confirms, then the reaper: a decode worker
        that died between extract and inject returns the pinned pages
        within one lease period."""
        while True:
            try:
                lid = self._lease_confirm_q.get_nowait()
            except queue.Empty:
                break
            if self.kv.confirm_lease(lid):  # a confirm that raced the reaper: no-op
                self._close_lease_span(lid, "confirmed")
                if self.flight is not None:
                    self.flight.record("lease_confirm")
        if self.kv.active_leases:
            reclaimed = self.kv.reap_expired()
            if reclaimed:
                for lid, pages in self.kv.last_reaped:
                    self._close_lease_span(lid, "reaped", pages=pages)
                if self.flight is not None:
                    self.flight.record("lease_reap", pages=reclaimed)
                get_telemetry().kv_lease_reclaims.inc(reclaimed)
                log.warning(
                    "reaped %d KV pages from expired handoff leases (the receiver "
                    "never confirmed delivery)", reclaimed,
                )

    def _service_pins(self) -> None:
        """Loop side of :meth:`pin_prefix`: match the resident prefix
        (every registered page here is filled) and pin it."""
        while True:
            try:
                tokens, loop, fut, trace = self._pin_q.get_nowait()
            except queue.Empty:
                return
            hashes = compute_block_hashes_for_seq(tokens, self.cfg.page_size)
            pages = self.kv.match_resident_hashes(hashes, require_filled=True)
            lease = self.kv.grant_lease(pages, self.cfg.kv_lease_ttl_s) if pages else None
            if lease is not None:
                self._open_lease(lease, None, len(pages), trace=trace)
            result = (len(pages), lease)

            def resolve(f=fut, r=result, lease=lease):
                # On the caller's loop: a future already done (cancelled
                # request) can never hand the lease back, so release it.
                if f.done():
                    if lease is not None:
                        self.confirm_kv_lease(lease)
                else:
                    f.set_result(r)

            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:  # the caller's loop closed: release the pin
                if lease is not None and self.kv.confirm_lease(lease):
                    self._close_lease_span(lease, "confirmed")

    def _drain_pin_q(self) -> None:
        """Resolve every queued pin with the no-coverage answer:
        shutdown must never strand an awaiting caller."""
        while True:
            try:
                _tokens, loop, fut, _trace = self._pin_q.get_nowait()
            except queue.Empty:
                return
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(lambda f=fut: f.done() or f.set_result((0, None)))

    def _service_reclaims(self) -> None:
        """Loop side of the reclaim plane's calls."""
        while True:
            try:
                op, payload, loop, fut = self._reclaim_q.get_nowait()
            except queue.Empty:
                return
            try:
                if op == "snapshot":
                    result = self._reclaim_snapshot()
                elif op == "extract":
                    result = self._reclaim_extract(*payload)
                else:
                    result = self._seed_prefix(*payload)
            except Exception as err:
                log.exception("reclaim op %s failed", op)
                with contextlib.suppress(RuntimeError):
                    loop.call_soon_threadsafe(
                        lambda f=fut, e=err: f.done() or f.set_exception(e))
                continue

            def resolve(f=fut, r=result, op=op):
                # An extract whose caller gave up hands its lease back.
                if f.done():
                    if op == "extract" and r is not None:
                        self.confirm_kv_lease(r[2])
                else:
                    f.set_result(r)

            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:
                if op == "extract" and result is not None and self.kv.confirm_lease(result[2]):
                    self._close_lease_span(result[2], "confirmed")

    def _drain_reclaim_q(self) -> None:
        """Resolve every queued reclaim call with its no-op answer."""
        defaults = {"snapshot": [], "extract": None, "seed": 0}
        while True:
            try:
                op, _payload, loop, fut = self._reclaim_q.get_nowait()
            except queue.Empty:
                return
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(
                    lambda f=fut, r=defaults.get(op): f.done() or f.set_result(r))

    def _migratable(self, seq: Sequence | None) -> bool:
        return (
            seq is not None and seq.state is SeqState.ACTIVE and seq.swap is None
            and seq.extract_cb is None
        )

    def _full_pages(self, seq: Sequence) -> int:
        """Complete pages whose KV is written (positions up to pos - 1,
        as ``register_full_pages`` counts them)."""
        return min(max(0, (seq.pos - 1) // self.cfg.page_size), len(seq.page_ids))

    def _reclaim_snapshot(self) -> list[dict]:
        nb = self.kv_page_nbytes()  # the whole page: what a migration ships
        out = []
        for seq in self.sched.slots:
            if not self._migratable(seq):
                continue
            full = self._full_pages(seq)
            out.append({
                "request_id": seq.request_id,
                "priority": seq.priority,
                "full_pages": full,
                "kv_bytes": full * nb,
                "tokens_generated": max(0, len(seq.tokens) - len(seq.prompt)),
            })
        return out

    def _reclaim_extract(self, request_id: str, ttl_s: float):
        seq = next((s for s in self.sched.slots
                    if self._migratable(s) and s.request_id == request_id), None)
        if seq is None:
            return None
        full = self._full_pages(seq)
        if full <= 0:
            return None
        pids = seq.page_ids[:full]
        # The chained block hashes are the migration's identity: the
        # survivor registers the pages under them, and the journal
        # continuation (prompt + confirmed tokens) recomputes the same
        # chain at admission.
        hashes = compute_block_hashes_for_seq(seq.tokens, self.cfg.page_size)[:full]
        pages = self._pages_to_host(pids)
        lease_id = self.kv.grant_lease(pids, ttl_s)
        self._open_lease(lease_id, seq, full)
        return hashes, pages, lease_id

    def _seed_prefix(self, hashes: list[int], pages: list) -> int:
        if not self.kv.sharing:
            return 0
        seeded: list[int] = []
        seed_pages: list = []
        parent: int | None = None
        for i, h in enumerate(hashes[: len(pages)]):
            if self.kv.resident_page(h) is not None:
                parent = h  # block already here: extend the chain past it
                continue
            pid = self.kv.allocate_page()
            if pid is None:
                break  # pool dry: a shorter contiguous prefix still matches
            self.kv.register_full_page(pid, h, parent_hash=parent)
            seeded.append(pid)
            seed_pages.append(pages[i])
            parent = h
        if seeded:
            # Registered now, injected ahead of every later forward on
            # the compute stream, then parked: exactly a finished
            # sequence's pages. LRU pressure may evict them before the
            # continuation attaches, which costs a re-prefill only.
            self._inject_page_batch(seeded, *self._stage(seed_pages), op="inject")
            self.kv_inject_pages += len(seeded)
            self.kv.release_sequence(seeded)
        return len(seeded)

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
                    if self.flight is not None:
                        self.flight.record("stall_start", req=seq.request_id, slot=seq.slot)
                continue  # pool dry: the row sits this iteration out
            seq.stalled = len(seq.page_ids) * ps < min(wpos + K, cfg.max_model_len)
            if seq.stalled_since:
                # Anatomy: the page stall closed.
                seq.anat_swap_s += max(time.time() - seq.stalled_since, 0.0)
                if self.flight is not None:
                    self.flight.record("stall_end", req=seq.request_id, slot=seq.slot)
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
        offs, total = pack_layout(arrays)
        dev = torch.empty(total, dtype=torch.uint8, device=self.device)
        self._upload_into(dev, arrays, offs)
        return views(dev, arrays, offs)

    def _upload_into(self, dev: torch.Tensor, arrays, offs: list[int]) -> None:
        """Host arrays into the device byte buffer ``dev`` at ``offs``:
        through one pinned staging buffer on a card (kept until the
        event after its copy completes), directly on the CPU."""
        if self.device.type != "cuda":
            for t, a in zip(views(dev, arrays, offs), arrays):
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        host = torch.empty(dev.numel(), dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        for a, o in zip(arrays, offs):
            buf[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev.copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._staged.append((done, host))  # dynlint: thread-ownership(loop thread joined before teardown flush)

    def _poll_staged(self) -> None:
        """Drop the staging buffers whose uploads have completed."""
        while self._staged and self._staged[0][0].query():
            self._staged.popleft()

    def _fetch(self, ys: tuple) -> tuple[tuple, object]:
        """Queue host copies of a dispatch's outputs right behind it: on
        a card into pinned buffers, ``non_blocking``, with an event after
        them that consume waits on. On the CPU the outputs themselves,
        or copies where they are a graph's outputs, which its next
        replay overwrites."""
        if self.device.type != "cuda":
            return (tuple(y.clone() for y in ys) if self.graphs is not None else ys), None
        hosts = tuple(torch.empty(y.shape, dtype=y.dtype, pin_memory=True) for y in ys)
        for h, y in zip(hosts, ys):
            h.copy_(y, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return hosts, ready

    def _host(self, pending: _PendingRagged) -> list[np.ndarray]:
        """A dispatch's outputs on the host: its one sync. Under tp > 1
        they are folded into rank 0's digest (``engine/tp.py``)."""
        if pending.ready is not None:
            pending.ready.synchronize()  # dynlint: sync-point(ragged consume)
        out = [y.numpy() for y in pending.ys]
        if self._tp is not None:
            self._tp.digest.fold(out)
        return out

    # ------------------------------------------------- tensor parallelism
    def _apply_tp_op(self, op: tuple) -> None:
        """One device step outside a dispatch body, on this rank's shard;
        on rank 0 of tp > 1 also queued for the other ranks, which apply
        it before their next dispatch (``engine/tp.py``)."""
        kind = op[0]
        if kind == "copy_page":  # copy-on-write of a shared page, K and V
            _, src, dst = op
            self.k_cache[:, dst].copy_(self.k_cache[:, src])
            self.v_cache[:, dst].copy_(self.v_cache[:, src])
        elif kind == "start_counts":  # a row's penalty counts: its first token (+ a tail)
            _, slot, token, tail = op
            self._counts[slot] = 0
            self._counts[slot, token] += 1
            if tail is not None:
                (tail_d,) = self._upload(tail)
                self._counts[slot] += tail_d
        else:
            raise ValueError(f"unknown tp op {kind!r}")
        if self._tp is not None:
            self._tp.ops.append(op)

    def follow(self) -> list[dict]:
        """A follower rank (tp > 1, rank > 0): run rank 0's dispatches on
        this rank's shard until rank 0 stops; returns every rank's report."""
        if self.comm is None or self.comm.rank == 0:
            raise RuntimeError("follow() runs on a tp rank other than 0")
        return follow(self)

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
            if self.flight is not None:
                self.flight.record("spec_rewind", req=seq.request_id, pages=len(extra))

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
    def _window_host(self, key: WindowKey) -> dict[str, np.ndarray]:
        """A window's host arrays at ``key``'s shape, every row padding:
        position -1 (K/V writes go to ``drop_page``, nothing is emitted),
        the scratch penalty row ``max_decode_slots``, neutral sampler
        parameters. The order is the upload's and the graphs' layout."""
        cfg = self.cfg
        rows = key.rows
        seeds, temp, top_k, top_p, freq, pres, rep = self._sampler_arrays(rows)
        return {
            "tokens": np.zeros(rows, np.int64),
            "positions": np.full(rows, -1, np.int64),
            "max_pos": np.full(rows, -1, np.int64),
            "table": np.zeros((rows, key.pages), np.int32),
            "stop": np.full((rows, STOP_WIDTH), -1, np.int64),
            "eos_gate": np.zeros(rows, np.int64),
            "budget_gate": np.full(rows, cfg.decode_window, np.int64),
            "slot": np.full(rows, cfg.max_decode_slots, np.int64),
            "seeds": seeds, "temp": temp, "top_k": top_k, "top_p": top_p,
            "freq": freq, "pres": pres, "rep": rep,
        }

    def _window_out_spec(self, key: WindowKey) -> list[tuple[tuple, torch.dtype]]:
        """Shapes and types of :meth:`_window_body`'s outputs."""
        K, rows = self.cfg.decode_window, key.rows
        spec = [((K, rows), torch.int64)]
        if key.want_lp:
            spec += [((K, rows), torch.float32), ((K, rows, TOP_LOGPROBS), torch.int32),
                     ((K, rows, TOP_LOGPROBS), torch.float32)]
        return spec + [((rows,), torch.int64), ((rows,), torch.int64)]

    def _window_body(self, key: WindowKey, ins: dict) -> tuple:
        """``decode_window`` decode steps over the window's device
        inputs, each step's tokens fed back on the device: the windowed
        shape's tensor code, run eagerly or captured as a CUDA graph.
        Returns (sampled tokens [K, rows], logprobs (3) if the key
        wants them, final tokens [rows], final positions [rows])."""
        mcfg, K = self.cfg.model, self.cfg.decode_window
        tok_d, pos_d, max_d = ins["tokens"], ins["positions"], ins["max_pos"]
        stop_d, eos_d, budget_d, slot_d = ins["stop"], ins["eos_gate"], ins["budget_gate"], ins["slot"]
        counts = self._counts[slot_d] if key.full_sampler else None
        sampled, lps = [], []
        for t in range(K):
            logits, _, _ = forward(
                self.model, mcfg, tok_d[:, None], pos_d[:, None], ins["table"],
                self.k_cache, self.v_cache, attn_pages=key.pages,
                attn_impl=self.attn_impl, drop_page=self._drop_page, comm=self.comm,
            )
            logits = logits[:, 0]
            active = pos_d >= 0
            if key.full_sampler:
                shaped = apply_penalties(logits, counts, ins["freq"], ins["pres"], ins["rep"])
                nxt = sample_tokens_seeded(
                    shaped, ins["seeds"], pos_d, ins["temp"], ins["top_k"], ins["top_p"]
                ).long()
                counts.scatter_add_(1, nxt[:, None], active.to(torch.int32)[:, None])
            else:
                nxt = torch.argmax(logits, dim=-1)
            if key.want_lp:
                lps.append(token_logprobs(logits, nxt))
            tok_d = torch.where(active, nxt, tok_d)
            # A row leaves the window (position -1, writes dropped) at a
            # stop token past its min-tokens gate, at its max_tokens
            # budget, or at its page/model-length capacity.
            done = (stop_token_hit(nxt, stop_d) & (t >= eos_d)) | (t >= budget_d)
            pos_d = torch.where(active & ~done & (pos_d < max_d), pos_d + 1, -1)
            sampled.append(nxt)
        if key.full_sampler:
            # Padding rows all gather and write back the scratch row,
            # unchanged (they add nothing), so duplicates are harmless.
            self._counts[slot_d] = counts
        outs = (torch.stack(sampled),)
        if key.want_lp:
            outs += tuple(torch.stack(y) for y in zip(*lps))
        return outs + (tok_d, pos_d)

    def _build_windowed(self, part: list, full_sampler: bool, solo: bool) -> _PendingRagged:
        """Dispatch one pure-decode window over the rows (no host sync),
        padded to its key's rows and page bound."""
        cfg = self.cfg
        ps, K = cfg.page_size, cfg.decode_window
        want_lp = any(self._wants_logprobs(seq) is not None for seq, _, _ in part)
        max_pages = max((min(wpos + K, cap + 1) + ps - 1) // ps for _, wpos, cap in part)
        key = resolve_window_key(cfg, len(part), max_pages, full_sampler, want_lp)
        host = self._window_host(key)
        arrs = tuple(host[n] for n in ("seeds", "temp", "top_k", "top_p", "freq", "pres", "rep"))
        rows: list[_RaggedRow] = []
        capped = False
        for r, (seq, wpos, cap) in enumerate(part):
            capped = capped or cap < wpos + K
            host["tokens"][r] = seq.last_token()
            host["positions"][r] = wpos
            host["max_pos"][r] = cap
            n = min(len(seq.page_ids), key.pages)  # the window reads no further
            host["table"][r, :n] = seq.page_ids[:n]
            host["slot"][r] = seq.slot
            stops = self._stop_set(seq)
            host["stop"][r, : len(stops)] = stops
            host["eos_gate"][r], host["budget_gate"][r] = self._stop_gates(seq, seq.generated)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=min(K, cap - wpos + 1)))
        return self._launch_window(rows, key, len(part), solo, capped, host)

    def _launch_window(
        self, rows, key: WindowKey, nb, solo, capped, host: dict, carry=None
    ) -> _PendingRagged:
        """Run one window at ``key`` from the host arrays ``host`` (and,
        chained, the previous window's device ``carry`` of tokens and
        positions): through the key's CUDA graph when the engine has
        graphs (captured at the key's first dispatch), else eagerly.
        The outputs' host copies are queued right behind it. The
        profiler's stamps and the flight event are taken here, on the
        host, around the replay."""
        prof = self.profiler
        t0 = prof.begin("window") if prof is not None else 0.0
        captured = self.graphs.captured["window"] if self.graphs is not None else None
        arrays = list(host.values())
        if self.graphs is not None:
            g = self.graphs.get(key)
            self._upload_into(g.in_buf, arrays, g.offs)
            if carry is not None:
                g.inputs["tokens"].copy_(carry[0])
                g.inputs["positions"].copy_(carry[1])
            self.graphs.replay(g)
            outs = g.outputs
        else:
            if self._tp is not None:
                self._tp.send("window", key, host, chained=carry is not None)
            ins = dict(zip(host, self._upload(*arrays)))
            if carry is not None:
                ins["tokens"], ins["positions"] = carry
            outs = self._window_body(key, ins)
        ys, ready = self._fetch(outs[:-2])
        fresh = self._fresh("window", key, captured)
        dispatched_at = prof.end("window", t0, fresh) if prof is not None else 0.0
        if self.flight is not None:
            event = dict(dispatch="ragged", rows=nb, bucket=key.rows, windowed=True)
            if carry is not None:
                event["chained"] = True
            self.flight.record("dispatch", **event)
        self.steps += self.cfg.decode_window
        self.dispatches["windowed"] += 1
        get_telemetry().decode_batch_rows.observe(nb)
        return _PendingRagged(
            ys=ys, ready=ready, rows=rows, windowed=True, dispatched_at=dispatched_at,
            full_sampler=key.full_sampler, want_lp=key.want_lp, solo=solo, nb=nb,
            tokens_dev=outs[-2], positions_dev=outs[-1], host_in=host, capacity_capped=capped,
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
        if (
            not self._lease_confirm_q.empty() or not self._pin_q.empty()
            or not self._reclaim_q.empty() or self.kv.lease_due()
        ):
            return False  # the loop serves these between windows
        if self._spec is not None and any(
            e.seq.state is SeqState.ACTIVE and self._spec.wants_draft(e.seq) for e in p.rows
        ):
            # A verify span would cover these positions in one dispatch,
            # and drafts are planned from freshly consumed tokens.
            return False
        stepped = {id(e.seq) for e in p.rows}
        now = time.time()
        for s in self.sched.slots:
            if s is None:
                continue
            if s.state is SeqState.PREFILL or s.is_cancelled():
                return False
            if s.deadline_unix and now >= s.deadline_unix:
                return False  # break the chain so the deadline is enforced
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
        plan = []
        for e in pending.rows:
            seq = e.seq
            wpos = len(seq.tokens) - 1 + K  # host view + the in-flight window
            self.sched.ensure_pages_until(seq, wpos + K - 1)
            cap = min(cfg.max_model_len, len(seq.page_ids) * ps) - 1
            if cap < wpos:
                return None  # pool dry: consume and rebuild instead
            plan.append((e, wpos, cap))
        max_pages = max((min(wpos + K, cap + 1) + ps - 1) // ps for _, wpos, cap in plan)
        key = resolve_window_key(cfg, pending.nb, max_pages, pending.full_sampler,
                                 pending.want_lp)
        host = self._window_host(key)
        for name in ("stop", "slot", "seeds", "temp", "top_k", "top_p", "freq", "pres", "rep"):
            host[name][:] = pending.host_in[name]  # the same rows, the same rows bucket
        rows: list[_RaggedRow] = []
        capped = False
        for e, wpos, cap in plan:
            seq, r = e.seq, e.row
            capped = capped or cap < wpos + K
            host["max_pos"][r] = cap
            n = min(len(seq.page_ids), key.pages)
            host["table"][r, :n] = seq.page_ids[:n]
            host["eos_gate"][r], host["budget_gate"][r] = self._stop_gates(seq, seq.generated + K)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=min(K, cap - wpos + 1)))
        self._flush_offloads()
        nxt = self._launch_window(
            rows, key, pending.nb, True, capped, host,
            carry=(pending.tokens_dev, pending.positions_dev),
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
        if self.profiler is not None:
            # The wait in _host was this window's one sync.
            self.profiler.consume("window", pending.dispatched_at)
        sampled = host[0]
        if pending.want_lp:
            lps, top_ids, top_lps = host[1:4]
        tel = get_telemetry()
        finishes: list[Sequence] = []
        wasted = emitted = 0
        for e in pending.rows:
            seq, row = e.seq, e.row
            if seq.state is not SeqState.ACTIVE or seq.pending_finish is not None:
                wasted += e.n_valid  # the whole window past this row's stop
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
            wasted += e.n_valid - len(kept)
            emitted += len(kept)
            self.sched.register_full_pages(seq)
            n_top = self._wants_logprobs(seq)
            pack = None
            if n_top is not None and kept:
                n = len(kept)
                pack = self._lp_pack(n_top, lps[:n, row], top_ids[:n, row], top_lps[:n, row])
            if kept:
                self._note_emit(seq, len(kept), tel)
            seq.emit(kept, None, pack)
            if reason is not None:
                seq.pending_finish = reason
                finishes.append(seq)
        if self.flight is not None:
            self.flight.record("consume", dispatch="ragged", tokens=emitted, wasted=wasted)
        if wasted:
            self.wasted_steps += wasted
            tel.decode_wasted_steps.inc(wasted)
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

    def _mixed_host(self, key: MixedKey) -> dict[str, np.ndarray]:
        """A mixed dispatch's host arrays at ``key``'s shape, all padding:
        every flat token at position -1 (K/V writes go to ``drop_page``,
        outputs zeros) owned by the scratch row ``max_decode_slots``,
        every per-row entry neutral. The sampler's arrays come only with
        the full sampler, the drafts only with verify spans. The order
        is the upload's and the graphs' layout."""
        cfg = self.cfg
        B1, T_s = cfg.max_decode_slots + 1, cfg.spec_max_draft + 1
        host = {
            "tokens": np.zeros(key.tokens, np.int64),
            "positions": np.full(key.tokens, -1, np.int32),
            "row_of": np.full(key.tokens, B1 - 1, np.int32),
            "table": np.zeros((B1, key.pages or cfg.max_pages_per_seq), np.int32),
            # Each row's last fed position, then (verify spans) every
            # position of each span: the flat indices the head projects.
            "out_idx": np.zeros(B1 * (1 + T_s * key.with_spec), np.int64),
        }
        if key.with_spec:
            host["drafts"] = np.full((B1, T_s - 1), -1, np.int64)
            host["n_drafts"] = np.zeros(B1, np.int64)
        if key.full_sampler:
            host["pos0"] = np.full(B1, -1, np.int64)
            host["is_decode"] = np.zeros(B1, np.bool_)
            host["slot"] = np.full(B1, cfg.max_decode_slots, np.int64)
            if key.with_spec:
                host["spec_pos"] = np.full((B1, T_s), -1, np.int64)
            names = ("seeds", "temp", "top_k", "top_p", "freq", "pres", "rep")
            host.update(zip(names, self._sampler_arrays(B1)))
        return host

    def _mixed_out_spec(self, key: MixedKey) -> list[tuple[tuple, torch.dtype]]:
        """Shapes and types of :meth:`_mixed_body`'s outputs."""
        B1, T_s = self.cfg.max_decode_slots + 1, self.cfg.spec_max_draft + 1
        spec = [((B1,), torch.int64)]
        if key.with_spec:
            spec += [((B1, T_s), torch.int64), ((B1,), torch.int32)]
        if key.want_lp:
            for rows in ((B1,), (B1, T_s))[: 1 + key.with_spec]:
                spec += [(rows, torch.float32), ((*rows, TOP_LOGPROBS), torch.int32),
                         ((*rows, TOP_LOGPROBS), torch.float32)]
        return spec

    def _mixed_body(self, key: MixedKey, ins: dict) -> tuple:
        """One forward over the flat stream and every row's sample at its
        last fed position (a prompt's first token from the raw
        distribution, decode tokens through their penalty counts); a
        verify span is scored at every position, one vocab projection
        with the last positions, and accepted on the device: the mixed
        shape's tensor code, run eagerly or captured as a CUDA graph.
        Returns (tok0 [B1], with verify spans targets [B1, T_s] and
        n_emit [B1], with logprobs theirs)."""
        cfg = self.cfg
        B1, T_s = cfg.max_decode_slots + 1, cfg.spec_max_draft + 1
        logits_all, _, _ = forward_ragged(
            self.model, cfg.model, ins["tokens"], ins["positions"], ins["row_of"],
            ins["table"], self.k_cache, self.v_cache, ins["out_idx"], attn_pages=key.pages,
            attn_impl=self.attn_impl, q_tile=self._ragged_align(), drop_page=self._drop_page,
            comm=self.comm,
        )
        logits0 = logits_all[:B1]
        if key.full_sampler:
            slot_d, dec_d = ins["slot"], ins["is_decode"]
            counts = self._counts[slot_d]
            shaped = apply_penalties(logits0, counts, ins["freq"], ins["pres"], ins["rep"])
            tok0 = sample_tokens_seeded(
                torch.where(dec_d[:, None], shaped, logits0), ins["seeds"], ins["pos0"],
                ins["temp"], ins["top_k"], ins["top_p"],
            ).long()
            counts.scatter_add_(1, tok0[:, None], dec_d.to(torch.int32)[:, None])
        else:
            tok0 = torch.argmax(logits0, dim=-1)
        ys = (tok0,)
        if key.with_spec:
            spec_logits = logits_all[B1:].reshape(B1, T_s, -1)
            if key.full_sampler:
                # Penalty counts thread past rejections (a rejected
                # draft leaves no trace).
                targets, n_emit, counts = spec_verify_tokens(
                    spec_logits, ins["drafts"], ins["n_drafts"], ins["seeds"],
                    ins["spec_pos"], ins["temp"], ins["top_k"], ins["top_p"], counts,
                    ins["freq"], ins["pres"], ins["rep"],
                )
            else:
                targets = torch.argmax(spec_logits, dim=-1)
                n_emit = spec_accept_length(targets, ins["drafts"], ins["n_drafts"])
            ys += (targets.long(), n_emit)
        if key.full_sampler:
            # Padding rows all gather and write back the scratch row,
            # unchanged (they add nothing), so duplicates are harmless.
            self._counts[slot_d] = counts
        if key.want_lp:
            ys += token_logprobs(logits0, tok0)
            if key.with_spec:
                lp, tid, tlp = token_logprobs(
                    spec_logits.reshape(B1 * T_s, -1), targets.reshape(-1)
                )
                ys += (lp.reshape(B1, T_s), tid.reshape(B1, T_s, -1), tlp.reshape(B1, T_s, -1))
        return ys

    def _build_mixed(
        self, dec: list, spec: list, pf: list[Sequence], full_sampler: bool
    ) -> _PendingRagged:
        """Dispatch one flat stream carrying each prefill row's next
        chunk, each decode row's fed token and each speculative row's
        last token + drafts (no host sync), padded to its key's token
        bucket as the JAX engine pads (``aot.lattice.resolve_mixed_key``):
        with the kernel, every row's span aligned to ``ragged_q_tile``
        slots (padding at position -1, owned by the row), then the
        stream's tail owned by the scratch row ``max_decode_slots``."""
        cfg = self.cfg
        ps, align = cfg.page_size, self._ragged_align()
        # (kind, sequence, fed tokens, first position, drafts) per row.
        plan = []
        for seq in pf:
            start = seq.prefill_sent
            n = min(len(seq.prompt) - start, cfg.prefill_chunk)
            plan.append(("prefill", seq, seq.prompt[start : start + n], start, ()))
        for seq, wpos, _cap in dec:
            plan.append(("decode", seq, [seq.last_token()], wpos, ()))
        for seq, wpos, _cap, drafts in spec:
            # [last token] + drafts at consecutive positions.
            plan.append(("spec", seq, [seq.last_token()] + list(drafts), wpos, drafts))
        n_tokens = sum(-(-len(toks) // align) * align for _, _, toks, _, _ in plan)
        max_pages = max((p0 + len(toks) - 1) // ps + 1 for _, _, toks, p0, _ in plan)
        want_lp = any(self._wants_logprobs(seq) is not None for _, seq, _, _, _ in plan)
        key = resolve_mixed_key(cfg, self.attn_impl, n_tokens, max_pages, full_sampler,
                                want_lp, bool(spec))
        host = self._mixed_host(key)
        B1, T_s = cfg.max_decode_slots + 1, cfg.spec_max_draft + 1
        q_last = host["out_idx"][:B1]
        spec_idx = host["out_idx"][B1:].reshape(-1, T_s)
        cols = host["table"].shape[1]
        arrs = tuple(host[n] for n in ("seeds", "temp", "top_k", "top_p", "freq", "pres",
                                       "rep")) if full_sampler else ()
        rows: list[_RaggedRow] = []
        qs = 0  # the row's first flat slot
        for r, (kind, seq, toks, p0, drafts) in enumerate(plan):
            n = len(toks)
            host["tokens"][qs : qs + n] = toks
            host["positions"][qs : qs + n] = np.arange(p0, p0 + n)
            host["row_of"][qs : qs + -(-n // align) * align] = r
            m = min(len(seq.page_ids), cols)  # the row's pages reach no further
            host["table"][r, :m] = seq.page_ids[:m]
            q_last[r] = qs + n - 1
            if full_sampler:
                self._row_sampler_args(seq, r, arrs)
            if kind == "prefill":
                seq.prefill_sent = p0 + n
                if full_sampler:
                    # The first token's draw is keyed by the prompt's
                    # last position, as a decode step feeding that token
                    # would be.
                    host["pos0"][r] = p0 + n - 1
                rows.append(_RaggedRow(seq, "prefill", r,
                                       completing=seq.prefill_sent == len(seq.prompt)))
            elif kind == "decode":
                if full_sampler:
                    host["pos0"][r], host["is_decode"][r], host["slot"][r] = p0, True, seq.slot
                rows.append(_RaggedRow(seq, "decode", r, n_valid=1))
            else:
                g = len(drafts)
                spec_idx[r, :n] = qs + np.arange(n)
                host["drafts"][r, :g] = drafts
                host["n_drafts"][r] = g
                if full_sampler:
                    host["slot"][r] = seq.slot
                    host["spec_pos"][r, :n] = np.arange(p0, p0 + n)
                rows.append(_RaggedRow(seq, "spec", r, n_drafts=g))
            qs += -(-n // align) * align
        prof = self.profiler
        t0 = prof.begin("mixed") if prof is not None else 0.0
        captured = self.graphs.captured["mixed"] if self.graphs is not None else None
        ys, ready = self._fetch(self._launch_mixed(key, host))
        # The prompt pages these chunks completed are filled in dispatch
        # order: rows waiting on them may read from the next dispatch.
        for seq in pf:
            self.sched.mark_prefill_filled(seq)
        fresh = self._fresh("mixed", key, captured)
        dispatched_at = prof.end("mixed", t0, fresh) if prof is not None else 0.0
        if self.flight is not None:
            self.flight.record("dispatch", dispatch="ragged", rows=len(rows), tokens=n_tokens,
                               bucket=key.tokens, windowed=False)
        self.steps += 1
        self.dispatches["mixed"] += 1
        self.spec_dispatches += key.with_spec
        get_telemetry().decode_batch_rows.observe(len(dec) + len(spec))
        return _PendingRagged(
            ys=ys, ready=ready, rows=rows, windowed=False, dispatched_at=dispatched_at,
            full_sampler=full_sampler, want_lp=want_lp, solo=False, with_spec=key.with_spec,
        )

    def _launch_mixed(self, key: MixedKey, host: dict) -> tuple:
        """Run one mixed dispatch at ``key`` from the host arrays
        ``host``: through the key's CUDA graph when the engine has
        graphs (captured at the key's first dispatch), else eagerly.
        Returns its outputs on the device."""
        if self.graphs is not None:
            g = self.graphs.get(key)
            self._upload_into(g.in_buf, list(host.values()), g.offs)
            self.graphs.replay(g)
            return g.outputs
        if self._tp is not None:
            self._tp.send("mixed", key, host)
        return self._mixed_body(key, dict(zip(host, self._upload(*host.values()))))

    def _consume_mixed(self, pending: _PendingRagged) -> None:
        """Decode rows emit their one token, prompts completing their
        last chunk emit their first, speculative rows emit the accepted
        prefix and the correction the device computed (then rewind past
        the rejections), prompts mid-chunk emit nothing. The host's
        check_stop gates every token. Mixed batches are never chained
        over, so finishes release their pages at once."""
        host = self._host(pending)
        if self.profiler is not None:
            self.profiler.consume("mixed", pending.dispatched_at)
        if self.flight is not None:
            self.flight.record("consume", dispatch="ragged", rows=len(pending.rows))
        tel = get_telemetry()
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
                tel.decode_wasted_steps.inc()
                continue
            if e.kind == "decode":
                token = int(tok0[r])
                seq.tokens.append(token)
                seq.generated += 1
                reason = self.sched.check_stop(seq, token)
                self.sched.register_full_pages(seq)
                self._note_emit(seq, 1, tel)
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
            if n_emit - len(kept):  # past a host-found stop
                self.wasted_steps += n_emit - len(kept)
                tel.decode_wasted_steps.inc(n_emit - len(kept))
            seq.spec_dispatches += 1
            seq.spec_draft_tokens += g
            seq.spec_accepted_tokens += accepted
            seq.spec_emitted_tokens += len(kept)
            self.spec_row_dispatches += 1
            self.spec_draft_tokens += g
            self.spec_accepted_tokens += accepted
            self.spec_emitted_tokens += len(kept)
            tel.spec_draft_tokens.inc(g)
            tel.spec_accepted_tokens.inc(accepted)
            tel.spec_tokens_per_dispatch.observe(len(kept))
            if self.flight is not None:
                self.flight.record("spec_accept", req=seq.request_id, proposed=g,
                                   accepted=accepted, emitted=len(kept))
            self._spec.record(seq, proposed=g, accepted=accepted)
            self.sched.register_full_pages(seq)
            n_top = self._wants_logprobs(seq)
            pack = None
            if pending.want_lp and n_top is not None and kept:
                n = len(kept)
                pack = self._lp_pack(n_top, s_lps[r, :n], s_tids[r, :n], s_tlps[r, :n])
            if kept:
                self._note_emit(seq, len(kept), tel)
            seq.emit(kept, None, pack)
            if reason is not None:
                self.sched.finish(seq, reason)
            else:
                self._rewind_spec_pages(seq)

    @staticmethod
    def _note_emit(seq: Sequence, n: int, tel) -> None:
        """Time between tokens of ``n`` tokens emitted now (a window's
        share averaged over them)."""
        now = time.time()
        if seq.last_emit_at:
            tel.time_between_tokens.observe(max(now - seq.last_emit_at, 0.0) / n)
        seq.last_emit_at = now

    def _finish_first_token(self, seq: Sequence, token: int, lp_pack=None) -> None:
        """The prompt's first sampled token: close its prefill (histogram
        and span), start its penalty counts, promote the sequence to
        decode, and emit (with its logprobs)."""
        now = time.time()
        seq.first_token_at = seq.last_emit_at = now
        tel = get_telemetry()
        start = seq.admitted_at or seq.submitted_at or now
        prefill_s = max(now - start, 0.0)
        tel.prefill_compute.observe(prefill_s)
        # Anatomy: close this life's prefill, and book the first-use
        # capture seconds since admission as its compile stall.
        seq.anat_prefill_s += prefill_s
        compile_s = 0.0
        if self.profiler is not None:
            compile_s = max(self.profiler.compile_total_s() - seq.anat_compile_mark, 0.0)
            seq.anat_compile_s += min(compile_s, prefill_s)
        tel.emit_stage(
            "prefill", start, now, seq.trace, prompt_tokens=len(seq.prompt),
            cached_tokens=seq.cached_len, remote=seq.remote_prefilled or None,
            resumed_tokens=seq.stop.resume_offset or None,
            compile_s=round(compile_s, 6) if compile_s else None,
            **(self.profiler.span_attrs("mixed") if self.profiler is not None else {}),
        )
        if self.flight is not None:
            self.flight.record("first_token", req=seq.request_id, slot=seq.slot)
        seq.state = SeqState.ACTIVE
        tail = None
        resumed = seq.stop.resume_offset or 0
        if resumed and self._needs_sampler(seq):
            # A continuation with penalties: the re-prefilled tail of the
            # prompt is journaled completion, so the counts rebuild over
            # it and every later draw sees the uninterrupted run's
            # counts. (The splice token itself was drawn by the prefill
            # from the raw distribution, the JAX engine's caveat.)
            V = self.cfg.model.vocab_size
            tail = np.clip(np.asarray(seq.prompt[-resumed:], np.int64), 0, V - 1)
            tail = np.bincount(tail, minlength=V).astype(np.int32)
        self._apply_tp_op(("start_counts", seq.slot, token, tail))
        seq.tokens.append(token)
        seq.generated = 1
        self.sched.register_full_pages(seq)
        if seq.extract_cb is not None:
            pages, lease_id = self._extract_prompt_pages(seq)
            seq.extract_cb(token, pages, lease_id)
        reason = self.sched.check_stop(seq, token)
        seq.emit([token], None, lp_pack)
        if reason is not None:
            self.sched.finish(seq, reason)
