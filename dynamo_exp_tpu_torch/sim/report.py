"""Simulation outcome report: the numbers policies are judged on.

Counterpart of ``dynamo_exp_tpu/sim/report.py`` with the same field
names, so the two packages' reports compare key for key. A chip-second
here (``chip_seconds``, ``billed_chip_seconds``) is one instance held for
one second: on the port, a card-second."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# The nearest-rank percentile of the shared SLO attribution
# (telemetry/slo.py), re-exported for the simulator.
from ..telemetry.slo import percentile  # noqa: F401


@dataclass
class SimReport:
    """Aggregate outcome of one simulated run.

    ``goodput_tok_s`` counts only tokens of *completed* requests over
    the active window — shed or errored work contributes nothing, so a
    policy that admits everything and thrashes scores worse than one
    that sheds cleanly. ``chip_seconds`` integrates fleet size over sim
    time: the planner comparison holds it (approximately) equal so the
    goodput delta is attributable to the policy, not to spend."""

    duration_s: float = 0.0
    submitted: int = 0
    completed: int = 0
    shed_429: int = 0
    shed_503: int = 0
    errors: int = 0
    preemptions: int = 0
    # Predictive KV tiering (docs/engine_perf.md "Predictive KV
    # tiering"): rows whose cold pages were proactively swapped to the
    # modeled host tier instead of being preempted, and the swap-ins
    # that restored them. Preemption is the fallback: a healthy tiered
    # run shows proactive_offloads > 0 with preemptions near zero.
    proactive_offloads: int = 0
    swap_ins: int = 0
    # Requests whose prompt+max_tokens exceeded one instance's whole KV
    # pool and finished `length` at the capacity cap (live-engine
    # semantics) — counted in `completed`, but with tokens undelivered,
    # so a nonzero value flags goodput that looks better than it is.
    capacity_capped: int = 0
    completed_tokens: int = 0
    goodput_tok_s: float = 0.0
    # SLO attribution (telemetry/slo.py SloAttribution — the same code
    # path the live edge exports as dynamo_goodput_requests_total /
    # dynamo_slo_violations_total): completed requests meeting every
    # configured target, and per-target breach counts.
    goodput_requests: int = 0
    slo_violations_ttft: int = 0
    slo_violations_itl: int = 0
    # Fleet-wide prefix sharing (docs/prefix_sharing.md): pages a
    # prefix_group admission attached instead of allocating (radix-match
    # hits on already-resident blocks), the high-water mark of resident
    # shared blocks across the fleet, and copy-on-write page copies
    # (a resident block extended a prompt's partial tail).
    shared_attached_pages: int = 0
    shared_pages_peak: int = 0
    cow_copies: int = 0
    # Tokens delivered per decode dispatch under the fitted speculative
    # decoding factor (1.0 = speculation off): `llmctl sim` runs fitted
    # from spec-tagged telemetry report it so spec-on fleet studies are
    # labeled with the speedup assumption they were run under.
    accepted_per_dispatch: float = 1.0
    ttft_p50_s: float | None = None
    ttft_p99_s: float | None = None
    itl_p50_s: float | None = None
    itl_p99_s: float | None = None
    # Spot reclamation (docs/fault_tolerance.md "Spot reclamation &
    # live migration"): reclaim notices served, sequences live-migrated
    # (KV prefix shipped, resumed with cache credit) vs journal
    # failovers (full re-prefill), pages shipped, and chip-seconds at
    # billed cost (spot time × spot_cost_factor) — goodput per
    # billed_chip_second is the spot-fleet economics headline.
    reclaims: int = 0
    reclaim_migrated: int = 0
    reclaim_failovers: int = 0
    reclaim_migrated_pages: int = 0
    # Durable G3 KV (docs/fault_tolerance.md "Durable KV & corruption
    # containment"): hard-restart drills served, and chain blocks
    # restored from the modeled persistent store as admission cache
    # credit (each billed g3_restore_s_per_page instead of its prefill
    # compute) — warm-restart TTFT recovery is the headline.
    restarts: int = 0
    g3_restored_pages: int = 0
    billed_chip_seconds: float = 0.0
    max_instances: int = 0
    chip_seconds: float = 0.0
    events: int = 0
    wall_clock_s: float = 0.0
    # Latency anatomy rollup (telemetry/anatomy.py component names,
    # restricted to what the event model resolves): total seconds the
    # fleet's requests spent in queue_wait / prefill_compute /
    # decode_compute / preemption limbo, for live<->sim anatomy diffs.
    anatomy: dict = field(default_factory=dict)
    planner_actions: list[dict] = field(default_factory=list)
    # Fleet rollup at drain time, built through the SAME
    # telemetry.fleet.FleetView path the live FleetAggregator uses
    # (docs/observability.md "Fleet plane") — per-instance occupancy /
    # queue depth / preemptions rolled up identically live and sim.
    fleet: dict = field(default_factory=dict)

    @property
    def shed(self) -> int:
        return self.shed_429 + self.shed_503

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def to_dict(self, include_host_time: bool = False) -> dict:
        """Serializable view. ``wall_clock_s`` is host wall time around
        the (simulated-clock) run — the one field that differs between
        two bit-identical runs — so comparison/serialization drops it
        by DEFAULT: seeded regression diffs (`make sim`, the
        determinism suites) compare clean without every caller
        remembering to pop it. Pass ``include_host_time=True`` for
        profiling output."""
        d = {k: v for k, v in self.__dict__.items()}
        if not include_host_time:
            d.pop("wall_clock_s", None)
        d["shed"] = self.shed
        d["shed_rate"] = round(self.shed_rate, 4)
        return d

    def to_json(
        self, indent: int | None = None, include_host_time: bool = False
    ) -> str:
        return json.dumps(
            self.to_dict(include_host_time=include_host_time),
            indent=indent,
            default=str,
        )
