"""The cluster simulator: modeled instances, real policy code.

Counterpart of ``dynamo_exp_tpu/sim/cluster.py``, built on the port's
own policy modules, so the same (seed, workload, config) triple gives
the JAX package's event log and report.

What is modeled and what is real:

- **Real, imported, unmodified**: edge admission
  (:class:`~dynamo_exp_tpu_torch.http.admission.AdmissionController`,
  the same watermark and priority math, the same instance),
  decode-instance selection (:class:`~dynamo_exp_tpu_torch.kv_router
  .scheduler.DefaultWorkerSelector` over :class:`ForwardPassMetrics`),
  the KV-pressure victim policy (:func:`~dynamo_exp_tpu_torch.engine
  .scheduler.select_preemption_victim`), footprint packing, reclaim
  triage and the planner's decision step
  (:func:`~dynamo_exp_tpu_torch.planner.policy.plan_step` /
  :func:`plan_step_slo`). A policy bug visible in simulation is a bug
  in the serving code, not in a reimplementation.
- **Modeled**: time. Instances hold work for service times drawn from a
  telemetry-fitted :class:`~.fit.ServiceTimeModel` instead of running a
  forward pass. KV occupancy is page-counted exactly (page size, pool
  size, per-sequence growth) but page *content* doesn't exist.

Modeling approximations (documented because calibration tolerance
depends on them): a decode round samples its per-token interval once
(occupancy at round start, not re-priced as neighbors come and go);
page allocation is greedy-reserving (a round grabs what it can up
front and schedules its stall at the exhaustion instant rather than
allocating page-by-page); preempted work re-enters as a full-context
continuation exactly like the engine's deterministic-resume path.

An instance is one engine (one card); ``chip_seconds`` keeps the JAX
field name and counts instance-seconds.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, field

from ..engine.scheduler import SeqState, select_preemption_victim
from ..engine.tiering import footprint_pages, select_packed_index
from ..http.admission import (
    AdmissionController,
    RequestShedError,
    ServiceOverloadedError,
)
from ..kv import PrefixIndex
from ..tokens import chain_hash
from ..kv_router.protocols import ForwardPassMetrics, OverlapScores
from ..kv_router.scheduler import (
    DefaultWorkerSelector,
    NoWorkersError,
    ProcessedEndpoints,
)
from ..parallel.multihost import TopologyCoordinate
from ..planner.planner import PlannerConfig
from ..planner.policy import (
    PlannerObservation,
    PlannerState,
    SloTargets,
    arm_decode_grace,
    plan_step,
    plan_step_slo,
)
from ..runtime.reclaim import (
    MIGRATE,
    SequenceSnapshot,
    SurvivorInfo,
    plan_triage,
)
from ..telemetry.slo import SloAttribution, SloConfig
from .core import EventLoop
from .fit import ServiceTimeModel
from .report import SimReport, percentile
from .workload import SimRequest


def _pages(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size) if tokens > 0 else 0


@dataclass
class SimConfig:
    """One simulated deployment. Instance-shape fields mirror
    EngineConfig; edge fields mirror the HTTP AdmissionController; the
    planner fields select and parameterize the shared decision step."""

    seed: int = 0
    # Per-instance engine shape.
    slots_per_instance: int = 8
    pages_per_instance: int = 256
    page_size: int = 16
    preempt_stall_grace_s: float = 0.5
    max_preemptions_per_seq: int = 2
    # Edge admission (one controller fronts the fleet).
    max_inflight: int = 64
    shed_watermark: int | None = None
    # Scale the admission bound with the live fleet (max_inflight /
    # shed_watermark are then per-instance budgets).
    admission_per_instance: bool = False
    # Routing.
    queue_weight: float = 1.0
    # Fleet-wide prefix sharing (docs/prefix_sharing.md): prefix_group
    # requests attach refcounted shared pages behind the same radix-
    # match logic the live engine runs; False models the private-copy
    # baseline (every request pays full pages for its prefix).
    prefix_sharing: bool = True
    # Predictive KV tiering (docs/engine_perf.md "Predictive KV
    # tiering"): footprint-packed admission (the same
    # select_packed_index rule the live scheduler runs), and a modeled
    # G2 host tier of this many pages per instance enabling proactive
    # offload — under KV pressure a cold row's private pages swap to
    # the host tier (restore billed at restore_s_per_page) instead of
    # the row being preempted. 0 host pages = reactive baseline.
    kv_packing: bool = True
    # Mirrors of EngineConfig.packing_scan_limit / packing_max_defers
    # (the autotuner tunes them through the shared knob registry,
    # tune/space.py): waiting-queue prefix scanned per packing pass,
    # and bypasses before a deferred sequence becomes a barrier.
    packing_scan_limit: int = 16
    packing_max_defers: int = 64
    host_pages_per_instance: int = 0
    proactive_offload: bool = True
    # Durable G3 KV (docs/fault_tolerance.md "Durable KV & corruption
    # containment"): a modeled per-host persistent page store fed by
    # parked-shared-block evictions (the live HostKvPool.on_demote ->
    # PersistentKvStore.store path), FIFO-bounded at this many pages.
    # A prefix_group admission whose radix match falls short extends
    # its warm-prefill credit with store-resident chain blocks, billed
    # at g3_restore_s_per_page each instead of their prefill compute.
    # 0 pages = no store (G2-only baseline).
    g3_pages_per_instance: int = 0
    g3_restore_s_per_page: float = 0.0005
    # Restart drill: at this sim time the busiest instance hard-
    # restarts (power cut — no reclaim grace): in-flight work journals
    # over to survivors, the host respawns after provision_s on the
    # SAME modeled disk, and its G3 store re-adopts (the live
    # boot_scan), so returning prefix groups re-attach warm.
    restart_at_s: float | None = None
    # Fleet.
    initial_instances: int = 1
    provision_s: float | None = None  # None -> service model's value
    # Spot reclamation (docs/fault_tolerance.md "Spot reclamation &
    # live migration"): the last ceil(initial * spot_fraction) initial
    # instances run on spot capacity and are reclaimed by a seeded
    # exponential schedule at reclaim_rate_per_min, each with
    # reclaim_grace_s of warning. In-flight sequences triage through
    # the REAL runtime.reclaim.plan_triage planner: live KV migration
    # (billed at migration_bw_bps over kv_bytes_per_page, sequential
    # out of the dying host) lands the prefix on the topology-nearest
    # survivor as admission cache credit; everything else rides the
    # journal (full re-prefill on the least-loaded survivor). A
    # reclaimed spot instance respawns after provision_s, and spot
    # chip-seconds bill at spot_cost_factor — billed_chip_seconds is
    # the "fraction of the cost" claim.
    spot_fraction: float = 0.0
    reclaim_rate_per_min: float = 0.0
    reclaim_grace_s: float = 5.0
    reclaim_margin_s: float = 0.25
    migration_bw_bps: float = 100e6
    kv_bytes_per_page: int = 2 << 20
    spot_cost_factor: float = 0.3
    # Planner: None (fixed fleet) | "reactive" | "slo".
    planner: str | None = None
    planner_cfg: PlannerConfig | None = None
    slo: SloTargets | None = None
    # Service times.
    service: ServiceTimeModel = field(default_factory=ServiceTimeModel)
    # Bookkeeping.
    record_events: bool = True
    max_events: int = 50_000_000


class _SimSeq:
    """One in-flight request. Carries exactly the policy surface
    :func:`select_preemption_victim` reads (state / pending_finish /
    extract_cb / preemptions / priority / submitted_at) plus the sim's
    own timing state — the real victim policy runs on these objects."""

    __slots__ = (
        "req", "state", "pending_finish", "extract_cb", "preemptions",
        "priority", "submitted_at", "instance", "epoch", "pages",
        "prompt_len", "remaining", "delivered", "round_budget",
        "gen_round", "itl", "decode_start", "first_token_at", "stalled",
        "stall_epoch", "cap_hit", "cached_tokens", "shared_hashes",
        "shared_page_count", "packing_defers", "swapped", "swap_pages",
        # Anatomy rollup marks (SimReport.anatomy): last admission,
        # preemption-limbo start (0 = not preempted-waiting), and when
        # this life's decode began (0 = still prefilling).
        "admitted_at", "preempted_at", "decode_began",
        # Spot reclamation: True while this life is a live-migrated
        # continuation whose cache credit is still unconsumed.
        "migrated",
        # Durable G3 KV: modeled store-fetch seconds owed for the
        # G3-restored share of cached_tokens (billed with the credit).
        "g3_restore_s",
    )

    def __init__(self, req: SimRequest, now: float):
        self.req = req
        self.state = SeqState.WAITING
        self.pending_finish = None
        self.extract_cb = None
        self.preemptions = 0
        self.priority = req.priority
        self.submitted_at = now
        self.instance: "_SimInstance | None" = None
        self.epoch = 0  # bumped on preemption; stale events no-op
        self.pages = 0
        self.prompt_len = req.prompt_len
        self.remaining = req.max_tokens
        self.delivered = 0
        self.round_budget = 0
        self.gen_round = 0
        self.itl = 0.0
        self.decode_start = 0.0
        self.first_token_at = 0.0
        self.stalled = False
        self.stall_epoch = 0  # bumped on each hard stall; stale grace no-ops
        self.cap_hit = False
        self.cached_tokens = 0
        # Prefix sharing: block hashes this sequence holds refs on, and
        # how many of its ``pages`` they back (the rest are private).
        self.shared_hashes: list[int] = []
        self.shared_page_count = 0
        # Predictive tiering: packed-admission bypass count, and the
        # proactive-offload swap state (private pages parked in the
        # modeled host tier awaiting swap-in).
        self.packing_defers = 0
        self.swapped = False
        self.swap_pages = 0
        self.admitted_at = 0.0
        self.preempted_at = 0.0
        self.decode_began = 0.0
        self.migrated = False
        self.g3_restore_s = 0.0


class _SimInstance:
    __slots__ = (
        "id", "cfg", "waiting", "bound", "stall_queue", "pages_free",
        "metrics", "draining", "prefix_index", "shared_refs", "parked",
        "born_at", "preemptions", "host_free", "swap_queue",
        "spot", "topo", "g3",
    )

    def __init__(self, iid: int, cfg: SimConfig, now: float):
        self.id = iid
        self.cfg = cfg
        self.waiting: deque[_SimSeq] = deque()
        self.bound: list[_SimSeq] = []  # PREFILL + ACTIVE (slot holders)
        self.stall_queue: list[_SimSeq] = []  # hard-stalled, FIFO
        self.pages_free = cfg.pages_per_instance
        self.draining = False
        self.born_at = now
        self.preemptions = 0  # per-instance share of report.preemptions
        # Predictive tiering: modeled G2 host-tier capacity and the
        # FIFO of proactively offloaded rows awaiting swap-in.
        self.host_free = cfg.host_pages_per_instance
        self.swap_queue: list[_SimSeq] = []
        # Spot reclamation: capacity class, and a deterministic modeled
        # topology coordinate (4 hosts per slice) so the triage
        # planner's topology-nearest selector has real distances to
        # fold in.
        self.spot = False
        self.topo = TopologyCoordinate(slice_id=iid // 4, host=iid % 4)
        # Prefix sharing (docs/prefix_sharing.md): the SAME radix index
        # the live page manager matches against, over synthetic per-
        # group block chains; refcounts per resident block, plus the
        # zero-ref parked set (counted free; evicted LRU-first as
        # allocations consume the pool — the live reclaimable LRU).
        self.prefix_index = PrefixIndex()
        self.shared_refs: dict[int, int] = {}
        self.parked: dict[int, None] = {}  # insertion order = LRU
        # Durable G3 KV: the modeled persistent store (insertion order
        # = FIFO eviction at g3_pages_per_instance). Dies with the host
        # on reclaim/retire; the restart drill hands it to the respawn
        # (same disk, live boot_scan re-adoption).
        self.g3: dict[int, None] = {}
        # One mutable metrics object per instance: the router reads it
        # in place (no per-arrival allocation at fleet scale).
        self.metrics = ForwardPassMetrics(
            request_total_slots=cfg.slots_per_instance,
            kv_total_blocks=cfg.pages_per_instance,
        )

    def refresh_metrics(self) -> ForwardPassMetrics:
        m = self.metrics
        m.request_active_slots = len(self.bound)
        m.num_requests_waiting = len(self.waiting)
        used = self.cfg.pages_per_instance - self.pages_free
        m.kv_active_blocks = used
        m.gpu_cache_usage_perc = used / self.cfg.pages_per_instance
        return m

    @property
    def idle(self) -> bool:
        return not self.bound and not self.waiting


class ClusterSim:
    """Deterministic replay of a workload through the real policies.

    One instance = one aggregated (prefill+decode) engine; the fleet
    starts at ``initial_instances`` and moves only by planner decisions.
    ``run()`` drains the workload and returns a :class:`SimReport`."""

    def __init__(self, cfg: SimConfig, workload):
        self.cfg = cfg
        self.loop = EventLoop()
        # Independent streams so adding a service-time draw never
        # perturbs routing tie-breaks (and vice versa).
        self.rng_service = random.Random(cfg.seed)
        self.selector = DefaultWorkerSelector(
            rng=random.Random(cfg.seed ^ 0x5EED), queue_weight=cfg.queue_weight
        )
        self.admission = AdmissionController(
            max_inflight=cfg.max_inflight, shed_watermark=cfg.shed_watermark
        )
        self._base_inflight = self.admission.max_inflight
        self._base_watermark = self.admission.shed_watermark
        self.instances: dict[int, _SimInstance] = {}
        self._provisioning = 0
        self._next_iid = 0
        self._workload = iter(workload)
        self._last_arrival = -1.0
        self._stream_done = False
        self._open = 0  # admitted, not yet finished
        self.report = SimReport()
        self._ttfts: list[float] = []
        self._itls: list[float] = []
        # Per-adjustment-interval planner sample window (KV only; the
        # latency window lives in the shared SLO attribution below).
        self._kv_samples: list[float] = []
        self._plan_state = PlannerState()
        self._pcfg = cfg.planner_cfg or PlannerConfig()
        self._slo = cfg.slo or SloTargets()
        # Shared SLO/goodput attribution (telemetry/slo.py): the very
        # class the live HTTP edge feeds and the live planner reads —
        # the sim's SimReport goodput/violation counts and its
        # plan_step_slo pressure window go through it verbatim, closing
        # the live<->sim calibration loop (docs/observability.md).
        self.slo_attr = SloAttribution(
            SloConfig(
                ttft_s=self._slo.ttft_p99_slo_s or None,
                itl_s=self._slo.itl_p99_slo_s or None,
            )
        )
        self._chip_seconds = 0.0
        self._chips_since = 0.0
        # Spot reclamation: its own rng stream (adding a reclaim draw
        # must never perturb routing or service times), billed cost
        # accounting, and the count of spot respawns in flight.
        self._rng_reclaim = random.Random(cfg.seed ^ 0x5B07)
        self._billed_chip_seconds = 0.0
        self._provisioning_spot = 0
        # Request-anatomy rollup (telemetry/anatomy.py component names;
        # SimReport.anatomy): sim-clock component totals across all
        # requests, accumulated at admission / prefill-done / preempt /
        # finish — the sim-side mirror of the engine's anatomy_totals
        # so fingerprint-replay calibration can compare shapes.
        self._anatomy = dict.fromkeys(
            ("queue_wait", "prefill_compute", "decode_compute",
             "preemption"),
            0.0,
        )
        # Prefix sharing: lazily built synthetic block-hash chain per
        # prefix group (chain_hash keeps it deterministic per group id,
        # independent of arrival order), plus resident-shared-page
        # accounting for the report.
        self._prefix_chains: dict[int, list[int]] = {}
        self._shared_resident = 0  # live + parked shared blocks, fleet-wide
        self.event_log: list[str] = []
        n_init = max(cfg.initial_instances, 1)
        n_spot = (
            max(min(round(n_init * cfg.spot_fraction), n_init), 1)
            if cfg.spot_fraction > 0
            else 0
        )
        for i in range(n_init):
            # The LAST n_spot initial instances are spot capacity.
            self._spawn_ready(spot=i >= n_init - n_spot)
        self._resize_admission()

    # ------------------------------------------------------------ logging
    def _log(self, fmt: str, *args) -> None:
        # %-lazy so a million-user run with record_events=False never
        # pays per-event string formatting.
        if self.cfg.record_events:
            msg = fmt % args if args else fmt
            self.event_log.append(f"{self.loop.now:.6f} {msg}")

    # ---------------------------------------------------- prefix sharing
    def _group_hashes(self, group: int, n: int) -> list[int]:
        """First ``n`` synthetic chained block hashes of a prefix group
        (the sim's stand-in for real token-block chains — same chain
        function, deterministic per group id)."""
        chain = self._prefix_chains.setdefault(group, [])
        while len(chain) < n:
            parent = chain[-1] if chain else None
            chain.append(chain_hash(parent, (group << 20) | len(chain)))
        return chain[:n]

    def _take_pages(self, inst: _SimInstance, n: int) -> None:
        """Consume pool pages, evicting parked (zero-ref, still-indexed)
        shared blocks LRU-first once free pages no longer cover them —
        the live manager's reclaimable-LRU eviction."""
        inst.pages_free -= n
        while inst.parked and len(inst.parked) > inst.pages_free:
            h = next(iter(inst.parked))
            del inst.parked[h]
            inst.prefix_index.remove(h)
            self._shared_resident -= 1
            # Durable G3 KV: the evicted cold block demotes to the
            # modeled persistent store (live HostKvPool.on_demote),
            # refreshed to the FIFO tail if already resident.
            if self.cfg.g3_pages_per_instance > 0:
                inst.g3.pop(h, None)
                inst.g3[h] = None
                while len(inst.g3) > self.cfg.g3_pages_per_instance:
                    inst.g3.pop(next(iter(inst.g3)))

    def _release_shared(self, inst: _SimInstance, seq: _SimSeq) -> None:
        """Drop the sequence's refs on its shared blocks; zero-ref
        blocks park (page counted free again, block still matchable
        until evicted)."""
        for h in seq.shared_hashes:
            left = inst.shared_refs.get(h, 0) - 1
            if left > 0:
                inst.shared_refs[h] = left
            else:
                inst.shared_refs.pop(h, None)
                inst.parked[h] = None
                inst.pages_free += 1
        seq.shared_hashes = []
        seq.shared_page_count = 0

    def _note_prefix_resident(self, inst: _SimInstance, seq: _SimSeq) -> None:
        """Baseline (prefix_sharing=False) bookkeeping: record the
        group's blocks for routing overlap and set the warm-prefill
        credit, with no page accounting (every request pays full
        pages)."""
        ps = self.cfg.page_size
        n_shared = min(seq.req.prefix_len, seq.prompt_len) // ps
        hashes = self._group_hashes(seq.req.prefix_group, n_shared)
        matched = inst.prefix_index.match_hashes(hashes)
        parent = hashes[len(matched) - 1] if matched else None
        for h in hashes[len(matched) :]:
            inst.prefix_index.insert(parent, h)
            parent = h
        seq.cached_tokens = min(len(matched) * ps, seq.prompt_len - 1)

    def _attach_prefix(self, inst: _SimInstance, seq: _SimSeq) -> bool:
        """Admission-time radix match + shared-page attach for a
        prefix_group request (mirrors KvPageManager.allocate_sequence:
        attach resident blocks refcounted, register the rest as this
        request's to fill, COW when a resident block extends the
        prompt's partial tail). Returns False when the pool can't cover
        the request right now."""
        cfg = self.cfg
        ps = cfg.page_size
        total = _pages(seq.prompt_len, ps)
        n_shared = min(seq.req.prefix_len, seq.prompt_len) // ps
        hashes = self._group_hashes(seq.req.prefix_group, n_shared + 1)
        matched = inst.prefix_index.match_hashes(hashes[:n_shared])
        new = hashes[len(matched) : n_shared]
        revive = [h for h in matched if h in inst.parked]
        cow = (
            seq.req.prefix_len >= seq.prompt_len
            and seq.prompt_len % ps != 0
            and len(matched) == n_shared
            and len(inst.prefix_index.match_hashes(hashes[: n_shared + 1]))
            == n_shared + 1
        )
        need = len(new) + len(revive) + (total - n_shared)
        if need > inst.pages_free:
            return False
        for h in revive:
            del inst.parked[h]
        self._take_pages(inst, need)
        parent = hashes[len(matched) - 1] if matched else None
        for h in new:
            inst.prefix_index.insert(parent, h)
            parent = h
            self._shared_resident += 1
            self.report.shared_pages_peak = max(
                self.report.shared_pages_peak, self._shared_resident
            )
        for h in matched + new:
            inst.shared_refs[h] = inst.shared_refs.get(h, 0) + 1
        seq.shared_hashes = matched + new
        seq.shared_page_count = n_shared
        seq.pages = total
        # Durable G3 KV: blocks past the radix match whose chain
        # continues in the modeled persistent store restore instead of
        # re-prefilling — credit extends over them, billed at
        # g3_restore_s_per_page each when the credit is consumed
        # (the live G3 fetch -> G2 promote on the admission path).
        g3_restored = 0
        if cfg.g3_pages_per_instance > 0:
            for h in new:
                if h not in inst.g3:
                    break
                g3_restored += 1
        seq.cached_tokens = min(
            (len(matched) + g3_restored) * ps, seq.prompt_len - 1
        )
        if g3_restored:
            seq.g3_restore_s = g3_restored * cfg.g3_restore_s_per_page
            self.report.g3_restored_pages += g3_restored
        if cow:
            self.report.cow_copies += 1
            seq.cached_tokens = seq.prompt_len - 1
        # Same accounting as KvPageManager.prefix_hits["shared"]: full-
        # block attaches plus the COW partial-tail attach (calibration
        # compares these counts exactly).
        self.report.shared_attached_pages += len(matched) + (1 if cow else 0)
        return True

    # ------------------------------------------------------------ fleet
    def _chips(self) -> int:
        return len(self.instances) + self._provisioning

    def _account_chips(self) -> None:
        now = self.loop.now
        dt = now - self._chips_since
        self._chip_seconds += self._chips() * dt
        # Billed cost: spot time (live spot instances + spot respawns
        # in flight) at spot_cost_factor, the rest at on-demand parity.
        n_spot = (
            sum(1 for i in self.instances.values() if i.spot)
            + self._provisioning_spot
        )
        self._billed_chip_seconds += (
            (self._chips() - n_spot) + n_spot * self.cfg.spot_cost_factor
        ) * dt
        self._chips_since = now

    def _spawn_ready(self, spot: bool = False) -> _SimInstance:
        self._account_chips()
        iid = self._next_iid
        self._next_iid += 1
        inst = _SimInstance(iid, self.cfg, self.loop.now)
        inst.spot = spot
        self.instances[iid] = inst
        self.report.max_instances = max(
            self.report.max_instances, len(self.instances)
        )
        self._resize_admission()
        self._log("instance %d ready", iid)
        return inst

    def _provision(self) -> None:
        self._account_chips()
        self._provisioning += 1
        delay = (
            self.cfg.provision_s
            if self.cfg.provision_s is not None
            else self.cfg.service.provision_s
        )
        self.loop.after(delay, self._on_instance_ready)
        self._log("instance provisioning")

    def _on_instance_ready(self) -> None:
        # Bill the provision window while the chip still counts as
        # provisioning — decrementing first would hand every scale-up a
        # free provision_s of chip time and bias the planner comparison.
        self._account_chips()
        self._provisioning -= 1
        self._spawn_ready()

    def _retire(self, inst: _SimInstance) -> None:
        self._account_chips()
        del self.instances[inst.id]
        self._resize_admission()
        self._log("instance %d retired", inst.id)

    def _resize_admission(self) -> None:
        if not self.cfg.admission_per_instance:
            return
        n = max(len(self.instances), 1)
        self.admission.resize(
            self._base_inflight * n, self._base_watermark * n
        )

    def _routable(self) -> list[_SimInstance]:
        return [i for i in self.instances.values() if not i.draining]

    # ----------------------------------------------------------- arrivals
    def _schedule_next_arrival(self) -> None:
        req = next(self._workload, None)
        if req is None:
            self._stream_done = True
            return
        if req.arrival_s < self._last_arrival:
            raise ValueError("workload arrivals must be non-decreasing")
        self._last_arrival = req.arrival_s
        self.loop.at(req.arrival_s, self._on_arrival, req)

    def _on_arrival(self, req: SimRequest) -> None:
        self._schedule_next_arrival()
        self.report.submitted += 1
        try:
            self.admission.acquire(req.priority)
        except ServiceOverloadedError:
            self.report.shed_503 += 1
            self._log("req %d shed 503", req.index)
            return
        except RequestShedError:
            self.report.shed_429 += 1
            self._log("req %d shed 429", req.index)
            return
        candidates = self._routable()
        endpoints = ProcessedEndpoints(
            metrics={i.id: i.refresh_metrics() for i in candidates}
        )
        overlaps = OverlapScores()
        if req.prefix_group >= 0:
            # Real per-instance index coverage — the router walks the
            # same radix trees admissions registered into, exactly like
            # the live KV router over worker prefix indexes.
            q = self._group_hashes(
                req.prefix_group,
                min(req.prefix_len, req.prompt_len) // self.cfg.page_size,
            )
            overlaps = OverlapScores(
                scores={
                    i.id: n
                    for i in candidates
                    if (n := i.prefix_index.coverage_blocks(q)) > 0
                }
            )
        try:
            wid, overlap_blocks = self.selector.select_worker(
                endpoints,
                overlaps,
                req.prompt_len,
                self.cfg.page_size,
            )
        except NoWorkersError:
            self.report.errors += 1
            self.admission.release()
            self._log("req %d error no-workers", req.index)
            return
        inst = self.instances[wid]
        seq = _SimSeq(req, self.loop.now)
        seq.instance = inst
        self._open += 1
        inst.waiting.append(seq)
        self._log("req %d -> inst %d (overlap %d)", req.index, wid, overlap_blocks)
        self._pump(inst)

    # ---------------------------------------------------------- admission
    def _pick_waiting(self, inst: _SimInstance) -> _SimSeq:
        """The next admission candidate: the head under plain first-fit
        or — with footprint packing on — the first waiting sequence
        whose lifetime forecast fits the free pool, through the SAME
        :func:`~dynamo_exp_tpu_torch.engine.tiering.select_packed_index` rule
        the live scheduler runs (priority and starvation guards
        included)."""
        if not self.cfg.kv_packing or len(inst.waiting) <= 1:
            return inst.waiting[0]
        ps = self.cfg.page_size
        cand = []
        entries = []
        for i, s in enumerate(inst.waiting):
            if i >= self.cfg.packing_scan_limit:
                break
            total = footprint_pages(s.prompt_len, s.remaining, ps)
            resident = 0
            if self.cfg.prefix_sharing and s.req.prefix_group >= 0:
                n_shared = min(s.req.prefix_len, s.prompt_len) // ps
                resident = len(
                    inst.prefix_index.match_hashes(
                        self._group_hashes(s.req.prefix_group, n_shared)
                    )
                )
            fits = max(total - resident, 0) <= inst.pages_free
            cand.append(s)
            entries.append((fits, s.priority, s.packing_defers))
        idx = select_packed_index(
            entries, max_defers=self.cfg.packing_max_defers
        )
        if idx is None or idx == 0:
            return inst.waiting[0]
        for s in cand[:idx]:
            s.packing_defers += 1
        return cand[idx]

    @staticmethod
    def _remove_waiting(inst: _SimInstance, seq: _SimSeq) -> None:
        for i, s in enumerate(inst.waiting):
            if s is seq:
                del inst.waiting[i]
                return

    def _pump(self, inst: _SimInstance) -> None:
        """Engine-side admission: bind waiting work to free slots while
        pages allow. Mirrors the live loop's `_kv_pressure` gate —
        nothing is admitted while any bound row is hard-stalled or
        swapped out, so newcomers can't steal pages preemption (or a
        pending swap-in) is waiting for."""
        cfg = self.cfg
        while (
            inst.waiting
            and not inst.stall_queue
            and not inst.swap_queue
            and len(inst.bound) < cfg.slots_per_instance
        ):
            seq = self._pick_waiting(inst)
            capacity_tokens = cfg.pages_per_instance * cfg.page_size
            if seq.prompt_len > capacity_tokens:
                # A prompt bigger than the whole pool can never be
                # allocated — reject (finish=error) instead of waiting
                # forever, exactly like Scheduler.admit_next.
                self._remove_waiting(inst, seq)
                self._finish(seq, "error")
                continue
            if cfg.prefix_sharing and seq.req.prefix_group >= 0:
                if not self._attach_prefix(inst, seq):
                    return  # pool exhausted; retry after a release
                self._remove_waiting(inst, seq)
            else:
                need = _pages(seq.prompt_len, cfg.page_size) - seq.pages
                if need > inst.pages_free:
                    return  # pool exhausted; retry after a release
                self._remove_waiting(inst, seq)
                self._take_pages(inst, max(need, 0))
                seq.pages += max(need, 0)
                if seq.req.prefix_group >= 0:
                    # Private-copy baseline: full pages, but overlap
                    # routing and warm-prefill credit stay (a routing-
                    # only index, never page-accounted or evicted) so
                    # the sharing A/B isolates page residency, not a
                    # routing-policy change.
                    self._note_prefix_resident(inst, seq)
            # Anatomy: close the queue-wait (first admission) or
            # preemption-limbo (re-admission) segment.
            if seq.preempted_at:
                self._anatomy["preemption"] += self.loop.now - seq.preempted_at
                seq.preempted_at = 0.0
            else:
                self._anatomy["queue_wait"] += self.loop.now - seq.submitted_at
            seq.admitted_at = self.loop.now
            seq.state = SeqState.PREFILL
            inst.bound.append(seq)
            prefill_tokens = seq.prompt_len
            # Cache credit applies on first admission (router overlap)
            # or when a live migration just parked this life's prefix on
            # this instance; the credit is consumed here exactly once.
            restore_s = 0.0
            if seq.cached_tokens and (seq.preemptions == 0 or seq.migrated):
                prefill_tokens = max(seq.prompt_len - seq.cached_tokens, 1)
                # G3-restored blocks skip prefill compute but pay the
                # modeled store-fetch time, serialized ahead of the
                # residual prefill (the live restore-before-compute
                # upload ordering).
                restore_s = seq.g3_restore_s
            seq.migrated = False
            seq.g3_restore_s = 0.0
            delay = restore_s + cfg.service.prefill_time(
                prefill_tokens, self.rng_service
            )
            self.loop.after(delay, self._on_prefill_done, seq, seq.epoch)

    # ------------------------------------------------------------- decode
    def _coverable(self, seq: _SimSeq) -> int:
        """Tokens this round's held pages can still produce. The final
        sampled token rides out without its KV written (engine
        semantics), hence the +1."""
        return seq.pages * self.cfg.page_size - seq.prompt_len + 1

    def _on_prefill_done(self, seq: _SimSeq, epoch: int) -> None:
        if seq.epoch != epoch or seq.state is not SeqState.PREFILL:
            return
        cfg = self.cfg
        inst = seq.instance
        seq.state = SeqState.ACTIVE
        # Anatomy: the prefill segment just closed; decode begins.
        self._anatomy["prefill_compute"] += self.loop.now - seq.admitted_at
        seq.decode_began = self.loop.now
        if not seq.first_token_at:
            seq.first_token_at = self.loop.now
            ttft = self.loop.now - seq.req.arrival_s
            self._ttfts.append(ttft)
            self.slo_attr.observe_ttft(ttft)
        rows = sum(1 for s in inst.bound if s.state is SeqState.ACTIVE)
        seq.itl = cfg.service.decode_itl(
            rows, cfg.slots_per_instance, self.rng_service
        )
        seq.decode_start = self.loop.now
        seq.gen_round = 0
        capacity_tokens = cfg.pages_per_instance * cfg.page_size
        max_by_cap = capacity_tokens - seq.prompt_len + 1
        seq.round_budget = min(seq.remaining, max(max_by_cap, 0))
        seq.cap_hit = seq.round_budget < seq.remaining
        self._reserve_and_schedule(seq)

    def _grab_round_pages(self, seq: _SimSeq) -> int:
        """Take as many of the round's still-needed pages as are free;
        returns the number grabbed."""
        cfg = self.cfg
        inst = seq.instance
        need_total = _pages(
            seq.prompt_len + max(seq.round_budget - 1, 0), cfg.page_size
        )
        grab = min(max(need_total - seq.pages, 0), inst.pages_free)
        self._take_pages(inst, grab)
        seq.pages += grab
        return grab

    def _schedule_round_progress(self, seq: _SimSeq) -> bool:
        """Schedule the round's completion (fully covered) or its next
        stall point; False when the held pages can't feed even the next
        token."""
        coverable = self._coverable(seq)
        left = seq.round_budget - seq.gen_round
        if coverable >= seq.round_budget:
            self.loop.after(
                left * seq.itl, self._on_decode_done, seq, seq.epoch
            )
        elif coverable > seq.gen_round:
            self.loop.after(
                (coverable - seq.gen_round) * seq.itl,
                self._on_stall,
                seq,
                seq.epoch,
                coverable,
            )
        else:
            return False
        return True

    def _reserve_and_schedule(self, seq: _SimSeq) -> None:
        self._grab_round_pages(seq)
        if not self._schedule_round_progress(seq):
            self._hard_stall(seq)

    def _on_stall(self, seq: _SimSeq, epoch: int, gen_now: int) -> None:
        if seq.epoch != epoch or seq.state is not SeqState.ACTIVE:
            return
        seq.gen_round = min(gen_now, seq.round_budget)
        self._reserve_and_schedule(seq)

    def _hard_stall(self, seq: _SimSeq) -> None:
        """The row cannot feed its next token: start the preemption
        grace clock (the engine's `stalled_since`). With proactive
        offload enabled (a modeled host tier), a cold row's private
        pages swap out immediately — the live engine's
        ``proactive_offload_grace_s=0`` default — so the grace clock
        usually never expires and preemption stays the fallback."""
        if seq.stalled:
            return
        seq.stalled = True
        # A resume (pages fed) then re-stall within the same epoch must
        # get a FULL grace window (the engine re-sets stalled_since), so
        # each stall gets its own generation and the previous stall's
        # still-pending timer no-ops instead of firing early.
        seq.stall_epoch += 1
        inst = seq.instance
        inst.stall_queue.append(seq)
        self._log("req %d hard-stalled on inst %d", seq.req.index, inst.id)
        if (
            self.cfg.proactive_offload
            and self.cfg.host_pages_per_instance > 0
            and self._proactive_swap(inst)
        ):
            self._feed_stalled(inst)
            if not seq.stalled:
                return  # swap freed enough; no grace clock needed
        grace = self.cfg.preempt_stall_grace_s
        if grace >= 0:
            self.loop.after(
                grace, self._on_grace, seq, seq.epoch, seq.stall_epoch
            )

    def _proactive_swap(self, inst: _SimInstance) -> bool:
        """Swap the coldest eligible row's private pages to the modeled
        host tier (the live ``_swap_out``): lowest priority, youngest,
        not itself stalled or already swapped. Returns True when pages
        were freed."""
        # Mirror of the live victim rule: stalled rows are exempt
        # unless several are starving (then swapping the coldest
        # stalled one feeds the rest).
        n_stalled = len(inst.stall_queue)
        cands = [
            s
            for s in inst.bound
            if s.state is SeqState.ACTIVE
            and not s.swapped
            and (n_stalled >= 2 or not s.stalled)
            and s.pending_finish is None
            and s.extract_cb is None
        ]
        for victim in sorted(
            cands, key=lambda s: (s.priority, -s.submitted_at)
        ):
            freed = victim.pages - victim.shared_page_count
            if freed <= 0 or freed > inst.host_free:
                continue
            # Progress so far this round (the live engine's host view
            # of the row at the swap point).
            gen = victim.gen_round
            if victim.itl > 0:
                gen = min(
                    max(
                        int((self.loop.now - victim.decode_start) / victim.itl),
                        victim.gen_round,
                    ),
                    victim.round_budget,
                )
            victim.gen_round = gen
            victim.epoch += 1  # cancel in-flight round timers
            if victim.stalled:
                victim.stalled = False
                inst.stall_queue.remove(victim)
            victim.swapped = True
            victim.swap_pages = freed
            victim.pages = victim.shared_page_count
            inst.pages_free += freed
            inst.host_free -= freed
            inst.swap_queue.append(victim)
            self.report.proactive_offloads += 1
            self._log(
                "req %d proactively offloaded on inst %d (%d pages)",
                victim.req.index, inst.id, freed,
            )
            return True
        return False

    def _on_swap_resumed(self, seq: _SimSeq, epoch: int) -> None:
        """Restore landed (host→device scatter billed): the row
        resumes its round exactly where it left off."""
        if seq.epoch != epoch or seq.state is not SeqState.ACTIVE:
            return
        seq.decode_start = self.loop.now - seq.gen_round * seq.itl
        if not self._schedule_round_progress(seq):
            self._hard_stall(seq)

    def _on_grace(self, seq: _SimSeq, epoch: int, stall_epoch: int) -> None:
        if (
            seq.epoch != epoch
            or seq.stall_epoch != stall_epoch
            or not seq.stalled
        ):
            return
        inst = seq.instance
        victim = select_preemption_victim(
            inst.bound, self.cfg.max_preemptions_per_seq
        )
        if victim is None:
            return  # nothing eligible; stalled row waits for a release
        self._preempt(victim)
        self._feed_stalled(inst)
        if seq.stalled:  # one eviction wasn't enough — keep the clock
            self.loop.after(
                self.cfg.preempt_stall_grace_s,
                self._on_grace,
                seq,
                seq.epoch,
                seq.stall_epoch,
            )

    def _preempt(self, victim: _SimSeq) -> None:
        """Evict via the real victim policy and requeue the victim as a
        deterministic continuation of itself (full context as prompt,
        budget reduced), exactly like Scheduler.preempt."""
        inst = victim.instance
        gen = victim.gen_round
        if not victim.stalled and not victim.swapped and victim.itl > 0:
            # decode_start is the round's *virtual* start (rebased on
            # stall-resume), so elapsed/itl = tokens actually produced.
            # A swapped victim's progress was frozen at swap-out.
            gen = min(
                max(
                    int((self.loop.now - victim.decode_start) / victim.itl),
                    victim.gen_round,
                ),
                victim.round_budget,
            )
        if victim.swapped:
            # Preempting a swapped row (swap-in starved too long, or
            # the victim policy chose it): its host-tier reservation
            # returns; the continuation re-prefills from scratch.
            victim.swapped = False
            inst.host_free += victim.swap_pages
            victim.swap_pages = 0
            if victim in inst.swap_queue:
                inst.swap_queue.remove(victim)
        victim.epoch += 1
        victim.delivered += gen
        victim.prompt_len += gen
        victim.remaining -= gen
        victim.preemptions += 1
        inst.pages_free += victim.pages - victim.shared_page_count
        self._release_shared(inst, victim)
        victim.pages = 0
        inst.bound.remove(victim)
        if victim.stalled:
            victim.stalled = False
            inst.stall_queue.remove(victim)
        # Anatomy: close this life's decode segment; limbo starts now.
        if victim.decode_began:
            self._anatomy["decode_compute"] += self.loop.now - victim.decode_began
            victim.decode_began = 0.0
        victim.preempted_at = self.loop.now
        victim.state = SeqState.WAITING
        inst.waiting.append(victim)  # back of the queue, like the engine
        inst.preemptions += 1
        self.report.preemptions += 1
        self._log(
            "req %d preempted on inst %d (%d tokens into the round)",
            victim.req.index, inst.id, gen,
        )

    def _feed_stalled(self, inst: _SimInstance) -> None:
        """Freed pages go to hard-stalled rows first (admission stays
        gated while any remain), then to pending swap-ins (oldest
        first), then to engine admission — the live loop's order."""
        for seq in list(inst.stall_queue):
            if self._grab_round_pages(seq) <= 0:
                continue
            if self._schedule_round_progress(seq):
                seq.stalled = False
                inst.stall_queue.remove(seq)
                # Rebase the round's virtual start so elapsed/itl keeps
                # equaling tokens actually produced — a preemption mid-
                # round must not count the stall dwell as generation.
                seq.decode_start = self.loop.now - seq.gen_round * seq.itl
            # else: partial grab, still starved — keep queue position
            # and the already-armed grace clock.
        for seq in list(inst.swap_queue):
            if seq.swap_pages > inst.pages_free:
                continue
            self._take_pages(inst, seq.swap_pages)
            seq.pages += seq.swap_pages
            inst.host_free += seq.swap_pages
            restore = seq.swap_pages * self.cfg.service.restore_s_per_page
            seq.swap_pages = 0
            seq.swapped = False
            inst.swap_queue.remove(seq)
            self.report.swap_ins += 1
            self._log("req %d swapped back in on inst %d", seq.req.index, inst.id)
            self.loop.after(restore, self._on_swap_resumed, seq, seq.epoch)
        self._pump(inst)

    def _on_decode_done(self, seq: _SimSeq, epoch: int) -> None:
        if seq.epoch != epoch or seq.state is not SeqState.ACTIVE:
            return
        seq.delivered += seq.round_budget
        seq.remaining -= seq.round_budget
        self._finish(seq, "length")

    # ------------------------------------------------------------- finish
    def _finish(self, seq: _SimSeq, reason: str) -> None:
        inst = seq.instance
        seq.epoch += 1
        seq.state = SeqState.FINISHED
        # Anatomy: close whichever segment this request died inside of.
        if seq.preempted_at:
            self._anatomy["preemption"] += self.loop.now - seq.preempted_at
            seq.preempted_at = 0.0
        elif seq.decode_began:
            self._anatomy["decode_compute"] += self.loop.now - seq.decode_began
            seq.decode_began = 0.0
        if inst is not None:
            inst.pages_free += seq.pages - seq.shared_page_count
            self._release_shared(inst, seq)
            seq.pages = 0
            if seq in inst.bound:
                inst.bound.remove(seq)
            if seq.stalled:
                seq.stalled = False
                inst.stall_queue.remove(seq)
            if seq.swapped:
                seq.swapped = False
                inst.host_free += seq.swap_pages
                seq.swap_pages = 0
                if seq in inst.swap_queue:
                    inst.swap_queue.remove(seq)
        self._open -= 1
        self.admission.release()
        if reason == "length":
            self.report.completed += 1
            self.report.completed_tokens += seq.delivered
            if seq.cap_hit:
                self.report.capacity_capped += 1
            itl = None
            if seq.delivered > 1 and seq.first_token_at:
                itl = (self.loop.now - seq.first_token_at) / (
                    seq.delivered - 1
                )
                self._itls.append(itl)
                self.slo_attr.observe_itl(itl)
            # Shared-path attribution: same call the live edge makes
            # per drained stream (shed/errored work is never fed here,
            # so it can't count as goodput — matching the edge).
            ttft = (
                seq.first_token_at - seq.req.arrival_s
                if seq.first_token_at
                else None
            )
            self.slo_attr.count(seq.priority, ttft_s=ttft, itl_s=itl)
        else:
            self.report.errors += 1
        self._log("req %d finished %s (%d tok)", seq.req.index, reason, seq.delivered)
        if inst is not None:
            self._feed_stalled(inst)
            if inst.draining and inst.idle and len(self.instances) > 1:
                self._retire(inst)

    # ---------------------------------------------------- spot reclamation
    def _start_reclaims(self) -> None:
        if self.cfg.spot_fraction > 0 and self.cfg.reclaim_rate_per_min > 0:
            self._schedule_next_reclaim()

    def _schedule_next_reclaim(self) -> None:
        rate = self.cfg.reclaim_rate_per_min / 60.0
        self.loop.after(
            self._rng_reclaim.expovariate(rate), self._on_reclaim_tick
        )

    def _on_reclaim_tick(self) -> None:
        spot_ids = sorted(
            iid
            for iid, inst in self.instances.items()
            if inst.spot and not inst.draining
        )
        # Reclaim only while a survivor exists: a platform can take the
        # whole fleet, but the study's question is survival, not
        # annihilation.
        if spot_ids and len(self._routable()) > 1:
            iid = spot_ids[self._rng_reclaim.randrange(len(spot_ids))]
            self._begin_reclaim(self.instances[iid])
        if self._fleet_busy():
            self._schedule_next_reclaim()

    def _gen_progress(self, seq: _SimSeq) -> int:
        """Tokens this round has produced by now — the same elapsed/itl
        banking rule as :meth:`_preempt`."""
        gen = seq.gen_round
        if (
            seq.state is SeqState.ACTIVE
            and not seq.stalled
            and not seq.swapped
            and seq.itl > 0
        ):
            gen = min(
                max(
                    int((self.loop.now - seq.decode_start) / seq.itl),
                    seq.gen_round,
                ),
                seq.round_budget,
            )
        return gen if seq.state is not SeqState.WAITING else 0

    def _detach(self, seq: _SimSeq) -> int:
        """Remove the sequence from its instance, banking decode
        progress into its continuation prompt (delivered tokens are
        final — the journal guarantees no loss, no duplication).
        Returns tokens banked."""
        inst = seq.instance
        gen = self._gen_progress(seq)
        if seq.swapped:
            seq.swapped = False
            inst.host_free += seq.swap_pages
            seq.swap_pages = 0
            if seq in inst.swap_queue:
                inst.swap_queue.remove(seq)
        seq.epoch += 1
        seq.delivered += gen
        seq.prompt_len += gen
        seq.remaining -= gen
        if seq in inst.bound:
            inst.pages_free += seq.pages - seq.shared_page_count
            self._release_shared(inst, seq)
            seq.pages = 0
            inst.bound.remove(seq)
        else:
            self._remove_waiting(inst, seq)
        if seq.stalled:
            seq.stalled = False
            inst.stall_queue.remove(seq)
        if seq.decode_began:
            self._anatomy["decode_compute"] += self.loop.now - seq.decode_began
            seq.decode_began = 0.0
        if not seq.preempted_at:
            seq.preempted_at = self.loop.now  # limbo until re-admission
        seq.state = SeqState.WAITING
        seq.instance = None
        seq.cached_tokens = 0
        seq.migrated = False
        seq.g3_restore_s = 0.0
        return gen

    def _least_loaded(self) -> "_SimInstance | None":
        ready = self._routable()
        if not ready:
            return None
        return min(ready, key=lambda i: (len(i.bound) + len(i.waiting), i.id))

    def _requeue_on(self, seq: _SimSeq, dest: _SimInstance) -> None:
        seq.instance = dest
        dest.waiting.append(seq)
        self._pump(dest)

    def _failover(self, seq: _SimSeq) -> None:
        """Journal failover: the continuation re-prefills its whole
        context on the least-loaded survivor (queue-depth routing, the
        recovery router's behavior)."""
        self._detach(seq)
        self.report.reclaim_failovers += 1
        dest = self._least_loaded()
        if dest is None:
            self._log("req %d reclaim failover found no survivor", seq.req.index)
            self._finish(seq, "error")
            return
        self._log(
            "req %d failover -> inst %d (%d tok banked)",
            seq.req.index, dest.id, seq.delivered,
        )
        self._requeue_on(seq, dest)

    def _begin_reclaim(self, inst: _SimInstance) -> None:
        """A reclaim notice landed: flip the instance out of routing
        (the live metadata republish) and run the REAL triage planner
        over its in-flight work."""
        if inst.draining:
            return
        inst.draining = True
        cfg = self.cfg
        grace = cfg.reclaim_grace_s
        self.report.reclaims += 1
        survivors = [
            SurvivorInfo(
                instance=f"sim-{i.id}", instance_id=i.id, topology=i.topo
            )
            for i in self.instances.values()
            if i is not inst and not i.draining
        ]
        snaps: list[SequenceSnapshot] = []
        by_rid: dict[str, _SimSeq] = {}
        ps = cfg.page_size
        for seq in list(inst.bound):
            gen = self._gen_progress(seq)
            # Live-engine bound: only complete pages of confirmed
            # tokens ship; swapped rows' KV is not device-resident.
            full = (
                max(0, (seq.prompt_len + gen - 1) // ps)
                if seq.state is SeqState.ACTIVE and not seq.swapped
                else 0
            )
            snap = SequenceSnapshot(
                request_id=str(seq.req.index),
                priority=seq.priority,
                full_pages=full,
                kv_bytes=full * cfg.kv_bytes_per_page,
                tokens_generated=seq.delivered + gen,
            )
            snaps.append(snap)
            by_rid[snap.request_id] = seq
        plan = plan_triage(
            snaps,
            survivors,
            grace,
            origin=f"sim-{inst.id}",
            origin_topo=inst.topo,
            margin_s=cfg.reclaim_margin_s,
            est_fn=lambda _s, _d, nb: nb / cfg.migration_bw_bps,
        )
        n_mig = sum(1 for d in plan if d.action == MIGRATE)
        self._log(
            "reclaim notice inst %d (grace %.2fs): %d migrate, %d failover",
            inst.id, grace, n_mig, len(plan) - n_mig,
        )
        for d in plan:
            seq = by_rid[d.seq.request_id]
            if d.action == MIGRATE:
                self._detach(seq)
                self.report.reclaim_migrated += 1
                self.report.reclaim_migrated_pages += d.seq.full_pages
                self._log(
                    "req %d migrate inst %d -> inst %d (%d pages, eta %.3fs)",
                    seq.req.index, inst.id, d.dest.instance_id,
                    d.seq.full_pages, d.eta_s,
                )
                self.loop.after(
                    d.eta_s,
                    self._on_migrate_landed,
                    seq,
                    d.dest.instance_id,
                    d.seq.full_pages,
                    seq.epoch,
                )
            else:
                self._failover(seq)
        for seq in list(inst.waiting):
            # Never started here: plain reroute, nothing to ship.
            self._failover(seq)
        self.loop.after(grace, self._on_reclaim_kill, inst.id)

    def _on_migrate_landed(
        self, seq: _SimSeq, dest_id: int, full_pages: int, epoch: int
    ) -> None:
        if seq.epoch != epoch or seq.state is not SeqState.WAITING:
            return
        dest = self.instances.get(dest_id)
        if dest is None or dest.draining:
            # The survivor itself died mid-transfer: the journal still
            # owns correctness — plain failover, cache credit lost.
            self.report.reclaim_migrated -= 1
            self.report.reclaim_migrated_pages -= full_pages
            self.report.reclaim_failovers += 1
            self._log(
                "req %d migration target inst %d gone; journal failover",
                seq.req.index, dest_id,
            )
            fallback = self._least_loaded()
            if fallback is None:
                self._finish(seq, "error")
                return
            self._requeue_on(seq, fallback)
            return
        # The shipped prefix parked in dest's cache: the continuation
        # admits with that many tokens of prefill credit.
        seq.migrated = True
        seq.cached_tokens = min(
            full_pages * self.cfg.page_size, seq.prompt_len - 1
        )
        self._log(
            "req %d migration landed on inst %d (%d tok cached)",
            seq.req.index, dest.id, seq.cached_tokens,
        )
        self._requeue_on(seq, dest)

    def _on_reclaim_kill(self, iid: int) -> None:
        inst = self.instances.get(iid)
        if inst is None:
            return
        # Triage displaced everything at the notice; anything that
        # landed since (it can't — the instance left routing) or was
        # missed degrades to failover rather than dying with the host.
        for seq in list(inst.bound) + list(inst.waiting):
            self._failover(seq)
        was_spot = inst.spot
        self._retire(inst)
        self._log("instance %d reclaimed", iid)
        if was_spot and self._fleet_busy():
            # The spot pool refills: same capacity class, fresh host.
            self._account_chips()
            self._provisioning += 1
            self._provisioning_spot += 1
            delay = (
                self.cfg.provision_s
                if self.cfg.provision_s is not None
                else self.cfg.service.provision_s
            )
            self.loop.after(delay, self._on_spot_ready)
            self._log("instance provisioning (spot respawn)")

    def _on_spot_ready(self) -> None:
        self._account_chips()
        self._provisioning -= 1
        self._provisioning_spot -= 1
        self._spawn_ready(spot=True)

    # ------------------------------------------------------ restart drill
    def _start_restart_drill(self) -> None:
        if self.cfg.restart_at_s is not None:
            self.loop.after(self.cfg.restart_at_s, self._on_restart)

    def _on_restart(self) -> None:
        """Hard restart drill: the busiest instance dies with NO grace
        (power cut, not a reclaim notice) — in-flight work journals
        over to survivors, the host respawns after provision_s on the
        SAME modeled disk, and its G3 store re-adopts (the live
        boot_scan), so returning prefix groups re-attach warm."""
        live = self._routable()
        if not live:
            return
        inst = max(live, key=lambda i: (len(i.bound) + len(i.waiting), i.id))
        self.report.restarts += 1
        self._log(
            "instance %d hard restart (%d g3 pages survive)",
            inst.id, len(inst.g3),
        )
        inst.draining = True  # out of routing before failovers reroute
        g3 = inst.g3
        for seq in list(inst.bound) + list(inst.waiting):
            self._failover(seq)
        if inst.id in self.instances:  # _finish may have retired it
            self._retire(inst)
        self._account_chips()
        self._provisioning += 1
        delay = (
            self.cfg.provision_s
            if self.cfg.provision_s is not None
            else self.cfg.service.provision_s
        )
        self.loop.after(delay, self._on_restart_ready, g3)

    def _on_restart_ready(self, g3: dict) -> None:
        self._account_chips()
        self._provisioning -= 1
        inst = self._spawn_ready()
        inst.g3 = g3
        self._log(
            "instance %d restarted, adopted %d g3 pages", inst.id, len(g3)
        )

    # ------------------------------------------------------------- planner
    def _start_planner(self) -> None:
        if self.cfg.planner is None:
            return
        self.loop.after(
            self._pcfg.metric_pulling_interval, self._on_metric_tick
        )
        self.loop.after(
            self._pcfg.adjustment_interval, self._on_adjust_tick
        )

    def _fleet_busy(self) -> bool:
        return not self._stream_done or self._open > 0

    def _on_metric_tick(self) -> None:
        """Mirror Planner.collect_metrics: one KV sample per instance
        per scrape, biased up by waiting work about to claim cache."""
        for inst in self.instances.values():
            m = inst.refresh_metrics()
            kv = m.gpu_cache_usage_perc
            if m.request_active_slots and m.num_requests_waiting > 0:
                kv += (
                    self._pcfg.waiting_request_kv_estimate
                    * m.num_requests_waiting
                )
            self._kv_samples.append(kv)
        if self._fleet_busy():
            self.loop.after(
                self._pcfg.metric_pulling_interval, self._on_metric_tick
            )

    def _on_adjust_tick(self) -> None:
        # Pressure inputs from the shared attribution window — the same
        # window_percentiles()/reset_window() round the live Planner
        # makes against the HTTP edge's attribution.
        ttft_p99, itl_p99 = self.slo_attr.window_percentiles()
        obs = PlannerObservation(
            num_prefill=0,
            num_decode=len(self.instances) + self._provisioning,
            prefill_queue=(),
            kv_load=tuple(self._kv_samples),
            ttft_p99_s=ttft_p99,
            itl_p99_s=itl_p99,
            now=self.loop.now,
        )
        if self.cfg.planner == "slo":
            decision, self._plan_state = plan_step_slo(
                obs, self._plan_state, self._pcfg, self._slo
            )
        else:
            decision, self._plan_state = plan_step(
                obs, self._plan_state, self._pcfg
            )
        for action in decision.actions:
            entry = action.as_log() | {"t": round(self.loop.now, 3)}
            self.report.planner_actions.append(entry)
            self._log("planner %s (signal %.3f)", action.op, action.signal)
            if action.op == "add":
                self._provision()
                if decision.arm_decode_grace:
                    # Provisioning always lands in sim, so every
                    # proposed add earns its grace period.
                    self._plan_state = arm_decode_grace(self._plan_state)
            else:
                ready = [
                    i for i in self.instances.values() if not i.draining
                ]
                if len(ready) > self._pcfg.min_endpoint:
                    inst = max(ready, key=lambda i: i.id)  # youngest
                    inst.draining = True
                    if inst.idle and len(self.instances) > 1:
                        self._retire(inst)
        self._kv_samples = []
        self.slo_attr.reset_window()
        if self._fleet_busy():
            self.loop.after(
                self._pcfg.adjustment_interval, self._on_adjust_tick
            )

    # ----------------------------------------------------------------- run
    def run(self) -> SimReport:
        t0 = time.perf_counter()  # dynlint: determinism(host-only wall-clock report field)
        self._chips_since = self.loop.now
        self._schedule_next_arrival()
        self._start_planner()
        self._start_reclaims()
        self._start_restart_drill()
        self.loop.run(max_events=self.cfg.max_events)
        self._account_chips()
        r = self.report
        if self._open > 0:
            # Requests stranded with no event left to free them (every
            # row stalled at its preemption bound): the live analogue is
            # a hang, which the engine's capacity fixes make unreachable
            # in practice — surface it as errors, never silently.
            self._log("%d requests starved at drain", self._open)
            r.errors += self._open
        r.duration_s = self.loop.now
        r.events = self.loop.processed
        r.accepted_per_dispatch = round(
            max(self.cfg.service.spec_tokens_per_dispatch, 1.0), 4
        )
        r.wall_clock_s = round(time.perf_counter() - t0, 3)  # dynlint: determinism(host-only wall-clock report field)
        r.chip_seconds = round(self._chip_seconds, 3)
        r.billed_chip_seconds = round(self._billed_chip_seconds, 3)
        if r.duration_s > 0:
            r.goodput_tok_s = round(r.completed_tokens / r.duration_s, 3)
        # SLO attribution totals (shared telemetry/slo.py code path —
        # the live edge's dynamo_goodput_requests_total /
        # dynamo_slo_violations_total equivalents).
        r.goodput_requests = self.slo_attr.goodput_total
        # Latency anatomy rollup (same component names as the live
        # telemetry/anatomy.py plane, restricted to what the sim models).
        r.anatomy = {k: round(v, 6) for k, v in self._anatomy.items()}
        r.slo_violations_ttft = self.slo_attr.violations["ttft"]
        r.slo_violations_itl = self.slo_attr.violations["itl"]
        r.ttft_p50_s = percentile(self._ttfts, 0.5)
        r.ttft_p99_s = percentile(self._ttfts, 0.99)
        r.itl_p50_s = percentile(self._itls, 0.5)
        r.itl_p99_s = percentile(self._itls, 0.99)
        # Fleet rollup through the SAME FleetView code path the live
        # FleetAggregator uses (docs/observability.md "Fleet plane"), so
        # fleet numbers are comparable live<->sim by construction. Keyed
        # sim-<id> in sorted order; rollup is deterministic (the view's
        # wall-clock scrape stamp never enters it).
        from ..telemetry.fleet import FleetView

        r.fleet = FleetView.from_snapshots(
            {
                f"sim-{iid}": {
                    **inst.refresh_metrics().to_dict(),
                    "preemptions": inst.preemptions,
                    "draining": inst.draining,
                }
                for iid, inst in self.instances.items()
            }
        ).rollup()
        return r
