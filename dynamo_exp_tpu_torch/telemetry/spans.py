"""Span emission and the process's metric families: one hub a process.

Counterpart of ``dynamo_exp_tpu/telemetry/spans.py``. Every finished
span goes to the ``dynamo_stage_duration_seconds{stage}`` histogram and,
when ``configure(trace_file)`` set one, to a JSONL file through
``recorder.Recorder`` (one ``{"ts", "event"}`` line a span, rotated at
64 MiB keeping 4 older files; flushed at exit). ``DYN_TRACE_FILE=<path>``
makes each process record to ``<path>.pid<pid>``, which
``telemetry/timeline.py`` reads back with the path. The hub's registry (``telemetry/prom.py``, in place of
``prometheus_client``) holds the families the port feeds, with the JAX
package's names, labels and buckets:

- per-stage and engine latency histograms (queue wait, prefill, time
  between tokens) and the six ``dynamo_engine_*`` gauges;
- decode batch rows and wasted window steps; the KV families of the
  paths the port has (page moves, prefix hits, shared and host-tier
  pages, prefetch, proactive offload, swap-in) and preemptions;
- speculation (drafts, accepted drafts, tokens per verify row);
- per-dispatch device profiling (in-flight time, host gap, first-use
  capture seconds and their count, ``telemetry/dispatch.py``) and the
  warm boot's seconds and variants;
- the HTTP edge's overload and deadline families and the SLO families
  (violations, goodput, burn rate); ``dynamo_build_info``.

- the disaggregation plane (``disagg/transfer.py``): KV transfer time,
  bytes and outcomes, wire checksum failures (``path="wire"``), lease
  reclaims; the reclaim plane (``runtime/reclaim.py``): migrated pages
  and triage seconds; the link ledger (``telemetry/fleet.py``).

- the request anatomy's per-component seconds
  (``dynamo_request_seconds{component}``, ``telemetry/anatomy.py``) and
  the live workload's drift from a pinned reference
  (``dynamo_workload_drift_score``, ``telemetry/fingerprint.py``).

- the G3 store's pages, quarantines and ``path="store"`` checksums
  (``kv/persistent.py``), copy-on-write copies and the ledger auditor's
  violations.

- the planner's config-catalog swaps (``dynamo_config_swaps``, bumped by
  ``planner/planner.py``'s ``Planner._apply_config_swap``).

Gauge writes and span emission are thread-safe: the engine loop thread
emits with the ``TraceContext`` captured at submission.
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ..recorder import Recorder
from .context import TraceContext, attach, current_trace, detach, new_trace
from .prom import Counter, Gauge, Histogram, Registry

logger = logging.getLogger(__name__)

# Stage-duration buckets: a routing step is sub-millisecond while a
# long decode runs tens of seconds.
_STAGE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
_TBT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)
# KV transfer payloads: one page to a 3k-token prompt of a large model.
_BYTES_BUCKETS = (
    1 << 10, 16 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20,
    64 << 20, 256 << 20, 1 << 30,
)
# Per-dispatch timings: a decode window is ms-scale, a first-use capture
# seconds.
_DISPATCH_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Engine gauges: metrics()-dict key -> help.
_ENGINE_GAUGES = (
    ("hbm_page_occupancy", "Fraction of device KV pages in use"),
    ("offload_hit_rate", "G2 host-tier hit rate (hits / (hits+misses))"),
    ("num_requests_running", "Sequences actively decoding"),
    ("num_requests_waiting", "Sequences waiting for admission"),
    ("decode_batch_utilization", "ACTIVE decode slots / total slots"),
    ("request_stalled_slots",
     "ACTIVE slots page-limited by the KV pool (idle, or window-capped "
     "but still progressing)"),
)


@dataclass
class Span:
    """One finished stage of a request."""

    stage: str
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    start: float = 0.0  # unix seconds
    end: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(self.end - self.start, 0.0)

    def to_event(self) -> dict:
        return {
            "type": "span",
            "stage": self.stage,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start": self.start,
            "end": self.end,
            "attrs": self.attrs,
        }

    @classmethod
    def from_event(cls, d: dict) -> "Span":
        return cls(
            stage=d.get("stage", "?"),
            trace_id=d.get("trace_id", ""),
            span_id=d.get("span_id", ""),
            parent_span_id=d.get("parent_span_id", ""),
            start=float(d.get("start", 0.0)),
            end=float(d.get("end", 0.0)),
            attrs=d.get("attrs", {}) or {},
        )


class Telemetry:
    """Per-process span sink and metric registry."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        r = self.registry
        self._recorder: Recorder | None = None
        self._rec_lock = threading.Lock()
        self._atexit_registered = False
        # Instance identity stamped on every span.
        self.instance = f"{socket.gethostname()}:{os.getpid()}"
        self.stage_duration = Histogram(
            "dynamo_stage_duration_seconds",
            "Per-stage request latency (one series per pipeline stage)",
            ["stage"], buckets=_STAGE_BUCKETS, registry=r,
        )
        self.queue_wait = Histogram(
            "dynamo_engine_queue_wait_seconds",
            "Submission-to-admission wait in the engine scheduler",
            buckets=_STAGE_BUCKETS, registry=r,
        )
        self.prefill_compute = Histogram(
            "dynamo_engine_prefill_seconds",
            "Admission-to-first-token prefill latency",
            buckets=_STAGE_BUCKETS, registry=r,
        )
        self.time_between_tokens = Histogram(
            "dynamo_engine_time_between_tokens_seconds",
            "Decode inter-token latency (per token, window-averaged)",
            buckets=_TBT_BUCKETS, registry=r,
        )
        self.engine_gauges = {
            key: Gauge(f"dynamo_engine_{key}", help_, registry=r)
            for key, help_ in _ENGINE_GAUGES
        }
        # Decode occupancy: rows each window computed, window steps
        # spent past a row's stop, KV pages moved by batched gathers and
        # scatters.
        self.decode_batch_rows = Histogram(
            "dynamo_decode_batch_rows",
            "True (uncompacted-slot-free) rows per decode window dispatch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128), registry=r,
        )
        self.decode_wasted_steps = Counter(
            "dynamo_decode_wasted_steps_total",
            "Decode window steps computed for a row past its stop point",
            registry=r,
        )
        self.kv_page_moves = Counter(
            "dynamo_kv_page_moves_total",
            "KV pages moved by batched gather/scatter, by operation",
            ["op"], registry=r,  # inject | upload | prefetch | offload | cow | ...
        )
        self.kv_cow_copies = Counter(
            "dynamo_kv_cow_copies_total",
            "Shared KV pages duplicated copy-on-write before a "
            "divergent write",
            registry=r,
        )
        self.kv_shared_pages = Gauge(
            "dynamo_kv_shared_pages",
            "Device KV pages currently attached by more than one holder",
            registry=r,
        )
        self.kv_prefix_hits = Counter(
            "dynamo_kv_prefix_hits_total",
            "Prompt pages at admission by source: shared (G1 attach, "
            "refcounted), restore (G2 host-tier upload), persist (G3 "
            "persistent-store restore — the restart re-attachment "
            "path), miss (fresh prefill)",
            ["kind"], registry=r,  # shared | restore | persist | miss
        )
        self.kv_host_pages = Gauge(
            "dynamo_kv_host_pages",
            "G2 host-tier KV pages currently resident (HostKvPool "
            "occupancy — fleet views read host-tier pressure here)",
            registry=r,
        )
        # G3 persistent tier: occupancy and quarantines (its checksum
        # failures count under kv_checksum_failures{path="store"}).
        self.kv_store_pages = Gauge(
            "dynamo_kv_store_pages",
            "G3 persistent-store KV pages currently resident "
            "(PersistentKvStore occupancy)",
            registry=r,
        )
        self.kv_quarantined = Counter(
            "dynamo_kv_quarantined_total",
            "G3 store pages moved to quarantine after failing "
            "verification (the entry is barred from re-adoption; the "
            "block re-prefills from the journal, token-identically)",
            registry=r,
        )
        self.kv_prefetch_pages = Counter(
            "dynamo_kv_prefetch_pages_total",
            "G2→G1 prefetch outcomes: restored (pages injected ahead "
            "of admission), hit (restored pages the target admission "
            "attached), late (fetch still in flight when the target "
            "admitted), dropped (copy stream saturated)",
            ["outcome"], registry=r,
        )
        self.kv_proactive_offloads = Counter(
            "dynamo_kv_proactive_offloads_total",
            "Rows whose cold refcount-1 pages were proactively swapped "
            "to the host tier under KV pressure (preemption avoided)",
            registry=r,
        )
        self.kv_swap_ins = Counter(
            "dynamo_kv_swap_ins_total",
            "Proactively offloaded rows restored to full residency "
            "(token-identical resume from host-tier bytes)",
            registry=r,
        )
        self.deadline_exceeded = Counter(
            "dynamo_deadline_exceeded_total",
            "Requests abandoned because their end-to-end deadline expired",
            ["stage"], registry=r,  # engine_admission | decode | router
        )
        # The request plane's fault tolerance (runtime/push_router.py,
        # health.py, component.py, journal.py): retries and failovers,
        # circuit-breaker churn, the drain lifecycle, mid-stream
        # recoveries, duplicate tokens trimmed by the journal, and
        # reclaim notices (metadata-only reclaim).
        self.request_retries = Counter(
            "dynamo_request_retries_total",
            "Request-plane retries after connection/stream-start failures",
            ["reason"], registry=r,  # connect | stream_start
        )
        self.breaker_transitions = Counter(
            "dynamo_circuit_breaker_transitions_total",
            "Circuit-breaker state transitions across all tracked targets",
            ["state"], registry=r,  # open | half_open | closed
        )
        self.drain_events = Counter(
            "dynamo_drain_events_total",
            "Graceful-drain lifecycle events on served instances",
            ["event"], registry=r,  # started | completed
        )
        self.request_recoveries = Counter(
            "dynamo_request_recoveries_total",
            "Mid-stream failovers resumed on a different instance",
            ["reason"], registry=r,  # stream_drop | drain | reclaim
        )
        self.tokens_deduplicated = Counter(
            "dynamo_tokens_deduplicated_total",
            "Duplicate-index tokens dropped while splicing a resumed stream",
            registry=r,
        )
        self.reclaim_events = Counter(
            "dynamo_reclaim_events_total",
            "Spot-reclamation lifecycle events: notice (metadata "
            "flipped to reclaiming), migrated / failover (per-sequence "
            "triage outcomes), deadline_degraded (a planned migration "
            "fell back to journal failover at the grace deadline), "
            "completed (triage finished inside the grace window)",
            ["event"], registry=r,  # notice|migrated|failover|deadline_degraded|completed
        )
        self.reclaim_migrated_pages = Counter(
            "dynamo_reclaim_migrated_pages_total",
            "KV pages live-migrated to survivor instances during "
            "spot reclamation",
            registry=r,
        )
        self.reclaim_triage_seconds = Histogram(
            "dynamo_reclaim_triage_seconds",
            "Wall time of one reclaim triage pass (notice to last "
            "migration confirm) — must beat the grace window",
            buckets=_STAGE_BUCKETS, registry=r,
        )
        # Disaggregation: the KV page wire, its checksums, and the
        # handoff leases the loop's reaper reclaimed.
        self.kv_transfer_duration = Histogram(
            "dynamo_kv_transfer_duration_seconds",
            "Disagg KV page transfer wall time",
            ["direction"], buckets=_STAGE_BUCKETS, registry=r,  # send | recv
        )
        self.kv_transfer_bytes = Histogram(
            "dynamo_kv_transfer_bytes",
            "Disagg KV page transfer payload size",
            ["direction"], buckets=_BYTES_BUCKETS, registry=r,
        )
        self.kv_transfer_total = Counter(
            "dynamo_kv_transfers_total",
            "Disagg KV transfers by direction and outcome",
            ["direction", "outcome"], registry=r,
        )
        self.kv_checksum_failures = Counter(
            "dynamo_kv_checksum_failures_total",
            "KV pages that failed checksum verification on a restore "
            "path: store (G3 fetch) or wire (disagg inject / reclaim "
            "migration sink) — each one was quarantined or failed the "
            "transfer, never served",
            ["path"], registry=r,  # store | wire
        )
        self.kv_ledger_violations = Counter(
            "dynamo_kv_ledger_violations_total",
            "KV page-ledger conservation violations detected by the "
            "in-loop auditor (every page exactly one of free/parked/"
            "active/leased/shared, refcount totals conserved)",
            registry=r,
        )
        self.kv_lease_reclaims = Counter(
            "dynamo_kv_lease_reclaims_total",
            "KV pages reclaimed from expired disagg handoff leases",
            registry=r,
        )
        # The per-link transfer ledger (telemetry/fleet.py).
        self.kv_link_bytes = Counter(
            "dynamo_kv_link_bytes_total",
            "KV lease-transfer payload bytes per (src, dst) instance "
            "link, as observed by this process's transfer ledger",
            ["src", "dst"], registry=r,
        )
        self.kv_link_transfers = Counter(
            "dynamo_kv_link_transfers_total",
            "KV lease transfers observed per (src, dst) instance link",
            ["src", "dst"], registry=r,
        )
        self.kv_link_bandwidth = Gauge(
            "dynamo_kv_link_bandwidth_bytes_per_s",
            "Online per-link bandwidth estimate (EWMA over observed "
            "extract->ack lease-transfer durations) — the input surface "
            "for topology-aware decode-instance selection",
            ["src", "dst"], registry=r,
        )
        # Overload protection: edge sheds, the edge's in-flight count,
        # engine-side KV-pressure preemptions.
        self.requests_shed = Counter(
            "dynamo_requests_shed_total",
            "Requests refused by edge admission control, by priority "
            "class and HTTP status",
            ["priority", "code"], registry=r,  # low|normal|high x 429|503
        )
        self.admission_inflight = Gauge(
            "dynamo_admission_inflight",
            "Requests currently admitted (in flight) at the HTTP edge",
            registry=r,
        )
        self.preemptions = Counter(
            "dynamo_preemptions_total",
            "Engine sequences preempted and requeued as deterministic "
            "continuations, by cause",
            ["reason"], registry=r,  # kv_pressure | swap_miss
        )
        self.spec_draft_tokens = Counter(
            "dynamo_spec_draft_tokens_total",
            "Draft tokens proposed to the speculative verify pass",
            registry=r,
        )
        self.spec_accepted_tokens = Counter(
            "dynamo_spec_accepted_tokens_total",
            "Draft tokens accepted by the target-model verify pass",
            registry=r,
        )
        self.spec_tokens_per_dispatch = Histogram(
            "dynamo_spec_tokens_per_dispatch",
            "Tokens emitted per speculative verify dispatch "
            "(accepted prefix + correction token)",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16), registry=r,
        )
        # Per-dispatch profiling (telemetry/dispatch.py): in-flight time
        # (dispatch to the loop's existing sync), the host gap before a
        # dispatch, and first-use captures (the port's "compile").
        self.dispatch_seconds = Histogram(
            "dynamo_dispatch_seconds",
            "Device dispatch in-flight time (dispatch to the existing "
            "host sync), by dispatch kind",
            ["kind"], buckets=_DISPATCH_BUCKETS, registry=r,
        )
        self.host_gap_seconds = Histogram(
            "dynamo_host_gap_seconds",
            "Host gap between consuming a dispatch and issuing the "
            "kind's next one (~0 in the overlapped steady state)",
            ["kind"], buckets=_DISPATCH_BUCKETS, registry=r,
        )
        self.compile_seconds = Histogram(
            "dynamo_compile_seconds",
            "First-call duration of a fresh compiled variant "
            "(trace + compile + program load), by dispatch kind",
            ["kind"], buckets=_STAGE_BUCKETS, registry=r,
        )
        self.compile_cache_misses = Counter(
            "dynamo_compile_cache_misses_total",
            "Compiled-variant cache misses, by dispatch kind (steady "
            "state should stop incrementing — see the recompile guard; "
            "a warm boot starts flat at 0, docs/aot.md)",
            ["kind"], registry=r,
        )
        self.prewarm_seconds = Gauge(
            "dynamo_prewarm_seconds",
            "Wall time of the engine's warm-boot prewarm (0 = cold boot)",
            registry=r,
        )
        self.prewarm_variants = Counter(
            "dynamo_prewarm_variants_total",
            "Compiled variants loaded/built by warm-boot prewarm, by "
            "family",
            ["kind"], registry=r,  # window | mixed
        )
        # SLO attribution at the HTTP edge (telemetry/slo.py).
        self.slo_violations = Counter(
            "dynamo_slo_violations_total",
            "Completed requests that breached a latency SLO target",
            ["slo", "priority"], registry=r,
        )
        self.goodput_requests = Counter(
            "dynamo_goodput_requests_total",
            "Completed requests that met every configured SLO target",
            ["priority"], registry=r,
        )
        # The request anatomy's component totals and the live-vs-pinned
        # workload drift (telemetry/anatomy.py, fingerprint.py).
        self.request_seconds = Counter(
            "dynamo_request_seconds",
            "Request wall time decomposed by anatomy component "
            "(telemetry/anatomy.py COMPONENTS) — summed across "
            "finished requests",
            ["component"], registry=r,
        )
        self.slo_burn_rate = Gauge(
            "dynamo_slo_burn_rate",
            "Fraction of recent requests breaching each SLO axis, per "
            "burn window (fast=last 64, slow=last 1024 completed "
            "requests)",
            ["slo", "window"], registry=r,
        )
        self.workload_drift_score = Gauge(
            "dynamo_workload_drift_score",
            "Normalized [0,1] distance between the live workload "
            "fingerprint and the pinned reference (DYN_WORKLOAD_REF); "
            "0 when no reference is pinned",
            registry=r,
        )
        self.config_swaps = Counter(
            "dynamo_config_swaps",
            "Planner config-catalog swaps: drift past the alert "
            "threshold moved the fleet onto a different pre-validated "
            "tuned config (docs/tuning.md)",
            registry=r,
        )
        self.build_info = Gauge(
            "dynamo_build_info",
            "Constant-1 config-skew fingerprint: AOT lattice manifest "
            "hash, jax version, and serving feature flags — fleet "
            "scrapes compare label sets across instances",
            ["manifest_hash", "jax_version", "prefix_sharing", "spec"],
            registry=r,
        )

    # ------------------------------------------------------------ recorder
    def configure(self, trace_file: str | None) -> None:
        """Record spans to ``trace_file`` (None disables), rotated as
        ``Recorder``'s defaults say; an exit hook closes it."""
        with self._rec_lock:
            if self._recorder is not None:
                self._recorder.close()
                self._recorder = None
            if trace_file:
                self._recorder = Recorder(trace_file)
                if not self._atexit_registered:
                    self._atexit_registered = True
                    atexit.register(self._flush_at_exit)

    def configure_from_env(self) -> None:
        """Honour ``DYN_TRACE_FILE``: every process sharing it records to
        ``<path>.pid<pid>`` (two writers rotating one file would clobber
        each other's generations); ``timeline.load_spans(<path>)`` reads
        the siblings with the path."""
        path = os.environ.get("DYN_TRACE_FILE", "")
        if path:
            self.configure(f"{path}.pid{os.getpid()}")

    @property
    def trace_file(self) -> str | None:
        rec = self._recorder
        return rec.path if rec is not None else None

    def _flush_at_exit(self) -> None:
        with self._rec_lock:
            rec, self._recorder = self._recorder, None
            if rec is not None:
                with contextlib.suppress(Exception):
                    rec.close()

    # ------------------------------------------------------------ emission
    def emit(self, span: Span) -> None:
        """Record one finished span (thread-safe; never raises into the
        serving path), stamped with this process's instance."""
        span.attrs.setdefault("instance", self.instance)
        self.stage_duration.labels(span.stage).observe(span.duration_s)
        rec = self._recorder
        if rec is not None:
            try:
                with self._rec_lock:
                    rec.record(span.to_event(), ts=span.end)
            except Exception:  # noqa: BLE001 - tracing must not break serving
                logger.exception("span recording failed")

    def emit_stage(self, stage: str, start: float, end: float,
                   trace: TraceContext | None, **attrs: Any) -> None:
        """Explicit-time emission for the engine loop thread, which
        cannot hold a ``with span(...)`` open (None trace: no span)."""
        if trace is None:
            return
        child = trace.child()
        self.emit(Span(
            stage=stage, trace_id=child.trace_id, span_id=child.span_id,
            parent_span_id=trace.span_id, start=start, end=end,
            attrs={k: v for k, v in attrs.items() if v is not None},
        ))

    # -------------------------------------------------------------- gauges
    def set_build_info(self, manifest_hash: str = "", jax_version: str = "",
                       prefix_sharing: bool = False, spec: str = "off") -> None:
        """The constant-1 ``dynamo_build_info`` sample (replacing any
        previous label set). The port puts its torch version under the
        JAX package's ``jax_version`` label, so a fleet scrape compares
        one label set."""
        self.build_info.clear()
        self.build_info.labels(
            manifest_hash or "unknown", jax_version or "unknown",
            str(bool(prefix_sharing)).lower(), spec or "off",
        ).set(1)

    def publish_engine_gauges(self, metrics: dict) -> None:
        """Mirror an engine ``metrics()`` dict into the engine gauges
        (unknown keys ignored)."""
        for key, gauge in self.engine_gauges.items():
            if key in metrics:
                gauge.set(float(metrics[key]))
        if "kv_shared_pages" in metrics:
            self.kv_shared_pages.set(float(metrics["kv_shared_pages"]))

    def render(self) -> bytes:
        return self.registry.render()


class _ActiveSpan:
    """In-task span: a child of the current contextvar trace (or a fresh
    root), current inside the block, emitted on exit; ``set`` amends
    its attrs."""

    def __init__(self, hub: Telemetry, stage: str, attrs: dict):
        self._hub = hub
        self.stage = stage
        self.attrs = attrs
        self._token = None
        self._t0 = 0.0
        self._parent_id = ""
        self.context: TraceContext | None = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_ActiveSpan":
        parent = current_trace()
        if parent is None:  # no inbound trace: this span roots a new one
            self.context = new_trace()
        else:
            self.context = parent.child()
            self._parent_id = parent.span_id
        self._token = attach(self.context)
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            detach(self._token)
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self._hub.emit(Span(
            stage=self.stage, trace_id=self.context.trace_id,
            span_id=self.context.span_id, parent_span_id=self._parent_id,
            start=self._t0, end=time.time(),
            attrs={k: v for k, v in self.attrs.items() if v is not None},
        ))


# ---------------------------------------------------------------- process hub
_global: Telemetry | None = None
_global_lock = threading.Lock()


def get_telemetry() -> Telemetry:
    """The process-wide hub (made at first use; honours
    ``DYN_TRACE_FILE``)."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                hub = Telemetry()
                hub.configure_from_env()
                _global = hub
    return _global


def span(stage: str, **attrs: Any) -> _ActiveSpan:
    """``with span("preprocess", tokens=n):`` — a child of the current
    trace, or the root of a fresh one."""
    return _ActiveSpan(get_telemetry(), stage, dict(attrs))


@contextlib.contextmanager
def adopt(tc: TraceContext | None):
    """Make ``tc`` current for the block (no span is emitted)."""
    if tc is None:
        yield
        return
    token = attach(tc)
    try:
        yield
    finally:
        detach(token)
