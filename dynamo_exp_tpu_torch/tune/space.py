"""The declarative knob space.

Counterpart of ``dynamo_exp_tpu/tune/space.py``: the same knobs (names,
owners, kinds, grids, sim / live flags), so :func:`space_digest` and
:func:`config_hash` equal the JAX package's and a journal or an
artifact from either package names the same space. One registry maps
every *tunable* ``EngineConfig`` / ``PlannerConfig`` / ``SloTargets`` /
``SimConfig`` field to its type, bounds, candidate grid, and sim-vs-live
applicability. Everything downstream derives from it:

- the search (:mod:`.search`) walks the sim-applicable knobs' grids;
- the artifact (:mod:`.artifact`) resolves the live engine knobs and
  stamps their :func:`config_hash`;
- a registry-walk test (``tests/test_torch_tune.py``) asserts the
  registry and the port's config dataclasses cannot drift: every
  scalar field of an owning config (a bool / int / float default, or
  an optional scalar such as ``cuda_graphs: bool | None``) is either
  registered here or allowlisted in :data:`NON_TUNABLE`, and every
  registered knob's default sits on its own grid.

Registry order, hashes, and grids are bit-identical across processes
and hosts (the journal and the artifact both embed :func:`space_digest`).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class Knob:
    """One tunable field of an owning config dataclass.

    ``grid`` is the finite, ordered candidate set the search walks —
    it must contain the owning dataclass's default (the guard test
    asserts it). ``sim`` marks knobs the simulator can evaluate
    (directly, or through ``sim_field`` for engine knobs that map onto
    a SimConfig mirror); ``live`` marks knobs a live engine boot
    honors. A knob can be both."""

    name: str
    owner: str  # "engine" | "planner" | "slo" | "sim"
    kind: str  # "int" | "float" | "bool"
    grid: tuple
    sim: bool = True
    live: bool = True
    sim_field: str | None = None  # SimConfig mirror of an engine knob
    note: str = ""


KNOBS: tuple[Knob, ...] = (
    # ------------------------------------------------------------ engine
    Knob("max_decode_slots", "engine", "int", (4, 8, 16, 32),
         sim_field="slots_per_instance",
         note="decode batch envelope (B of the decode step)"),
    Knob("num_pages", "engine", "int", (128, 256, 512, 1024, 2048),
         sim_field="pages_per_instance",
         note="global KV page pool size"),
    Knob("page_size", "engine", "int", (8, 16, 32),
         sim_field="page_size",
         note="tokens per KV page (also the reuse-hash block)"),
    Knob("prefill_batch", "engine", "int", (4, 8, 16), sim=False,
         note="sequences sharing one prefill dispatch"),
    Knob("prefill_chunk", "engine", "int", (128, 256, 512, 1024),
         sim=False,
         note="prompt tokens fed per chunk (decode interleaves between)"),
    Knob("decode_window", "engine", "int", (4, 8, 16, 32), sim=False,
         note="decode steps per compiled dispatch (host syncs once)"),
    Knob("preempt_stall_grace_s", "engine", "float",
         (0.1, 0.25, 0.5, 1.0),
         sim_field="preempt_stall_grace_s",
         note="hard-stall grace before KV-pressure preemption"),
    Knob("max_preemptions_per_seq", "engine", "int", (0, 1, 2, 4),
         sim_field="max_preemptions_per_seq",
         note="victimization bound per sequence (live-lock guard)"),
    Knob("prefix_sharing", "engine", "bool", (False, True),
         sim_field="prefix_sharing",
         note="refcounted copy-on-write shared prefix pages"),
    Knob("kv_packing", "engine", "bool", (False, True),
         sim_field="kv_packing",
         note="footprint-packed admission vs first-fit"),
    Knob("packing_scan_limit", "engine", "int", (4, 8, 16, 32, 64),
         sim_field="packing_scan_limit",
         note="waiting-queue prefix scanned per packing pass"),
    Knob("packing_max_defers", "engine", "int", (16, 32, 64, 128),
         sim_field="packing_max_defers",
         note="bypasses before a deferred seq becomes a barrier"),
    Knob("host_cache_pages", "engine", "int", (0, 64, 256, 1024),
         sim_field="host_pages_per_instance",
         note="G2 host-RAM KV tier size (0 disables offload)"),
    Knob("kv_prefetch", "engine", "bool", (False, True), sim=False,
         note="G2->G1 prefetch of waiting prompts' host prefixes"),
    Knob("prefetch_depth", "engine", "int", (1, 2, 4, 8), sim=False,
         note="waiting sequences scanned per prefetch pass"),
    Knob("prefetch_reserve_pages", "engine", "int", (0, 2, 4, 8),
         sim=False,
         note="free-page headroom prefetch never consumes"),
    Knob("proactive_offload_grace_s", "engine", "float",
         (0.0, 0.1, 0.25), sim=False,
         note="stall grace before cold-tail swap-out (< preempt grace)"),
    Knob("ragged_q_tile", "engine", "int", (1, 4, 8, 16), sim=False,
         note="flat-stream row alignment of the ragged mixed kernel"),
    # ----------------------------------------------------------- planner
    Knob("adjustment_interval", "planner", "float", (5.0, 10.0, 20.0),
         live=True, note="seconds between planner adjustment rounds"),
    Knob("prefill_queue_scale_up_threshold", "planner", "float",
         (3.0, 5.0, 8.0), note="reactive prefill scale-up trigger"),
    Knob("prefill_queue_scale_down_threshold", "planner", "float",
         (0.1, 0.2, 0.5), note="reactive prefill scale-down trigger"),
    Knob("decode_kv_scale_up_threshold", "planner", "float",
         (0.7, 0.8, 0.9), note="reactive decode KV scale-up trigger"),
    Knob("decode_kv_scale_down_threshold", "planner", "float",
         (0.3, 0.5, 0.6), note="reactive decode KV scale-down trigger"),
    Knob("waiting_request_kv_estimate", "planner", "float",
         (0.01, 0.02, 0.05),
         note="KV fraction one waiting request is assumed to claim"),
    # --------------------------------------------------------------- slo
    Knob("decode_kv_target", "slo", "float", (0.6, 0.75, 0.85),
         note="per-worker KV load the SLO planner sizes the fleet to"),
    Knob("prefill_queue_target", "slo", "float", (1.0, 2.0, 4.0),
         note="per-worker prefill queue depth target"),
    Knob("forecast_horizon", "slo", "float", (1.0, 2.0, 3.0),
         note="look-ahead windows along the observed trend"),
    Knob("scale_down_headroom", "slo", "float", (0.4, 0.6),
         note="pressure below this fraction sheds one worker"),
    Knob("max_scale_step", "slo", "int", (1, 2, 4),
         note="most workers added/removed in one round"),
    # ------------------------------------------------------ sim/edge only
    Knob("max_inflight", "sim", "int", (16, 32, 64, 128), live=False,
         note="edge admission bound (AdmissionController)"),
    Knob("queue_weight", "sim", "float", (0.5, 1.0, 2.0), live=False,
         note="routing: queue-depth weight in worker selection"),
)

KNOB_BY_NAME: dict[str, Knob] = {k.name: k for k in KNOBS}

# Registry-walk allowlist: scalar fields of the owning configs that are
# deliberately NOT tunable. The guard test asserts registered +
# allowlisted covers every such field exactly: adding a config field
# without deciding its tunability breaks the build.
NON_TUNABLE: dict[str, frozenset] = {
    "engine": frozenset({
        # Parallelism/topology and workload contract, not perf knobs.
        "tp", "sp", "max_model_len", "default_max_tokens",
        # Correctness/debug toggles (A/B and equivalence runs only).
        "chained_decode", "profile_dispatches", "kv_ledger_check",
        # CUDA graphs on or off: an A/B of the same padded dispatches
        # (None = on a card), not a perf knob to search.
        "cuda_graphs",
        # Observability plane (flight ring, watchdog, leases).
        "flight_events", "watchdog_stall_s", "kv_lease_ttl_s",
        # Durable G3 tier capacity: sized to the local disk, a
        # provisioning decision like max_gpu_budget, not a perf knob.
        "kv_store_pages",
        # Speculation is tuned online by the adaptive controller
        # (spec/controller.py); static search would fight it.
        "spec_draft_len", "spec_min_draft", "spec_max_draft",
        "spec_adaptive", "spec_ngram", "spec_ngram_min",
        "spec_miss_limit", "spec_retry_tokens",
    }),
    "planner": frozenset({
        # Budget/topology constraints and loop mechanics.
        "metric_pulling_interval", "max_gpu_budget",
        "decode_engine_num_gpu", "prefill_engine_num_gpu",
        "min_endpoint", "no_operation",
    }),
    "slo": frozenset({
        # The SLO contract itself (targets are inputs, not knobs) and
        # measured hints.
        "ttft_p99_slo_s", "itl_p99_slo_s", "max_pressure",
        "provision_s",
    }),
    "sim": frozenset({
        # Engine mirrors (tuned through their engine knob), workload /
        # fleet / economics model parameters, and bookkeeping.
        "seed", "slots_per_instance", "pages_per_instance", "page_size",
        "preempt_stall_grace_s", "max_preemptions_per_seq",
        "admission_per_instance", "prefix_sharing", "kv_packing",
        "packing_scan_limit", "packing_max_defers",
        "host_pages_per_instance", "proactive_offload",
        "initial_instances", "spot_fraction", "reclaim_rate_per_min",
        "reclaim_grace_s", "reclaim_margin_s", "migration_bw_bps",
        "kv_bytes_per_page", "spot_cost_factor", "record_events",
        "max_events",
        # Durable-KV restart drill: store capacity / restore-cost model
        # parameters, not perf knobs.
        "g3_pages_per_instance", "g3_restore_s_per_page",
        # Optional scalars: the edge watermark (derived from
        # max_inflight when unset), the restart drill's time and the
        # provisioning delay (the service model's when unset) describe
        # the deployment and the study, not a knob.
        "shed_watermark", "restart_at_s", "provision_s",
    }),
}

def owner_classes() -> dict[str, type]:
    """The owning config dataclass per owner key (lazy: SimConfig pulls
    the whole policy import graph)."""
    from ..engine.config import EngineConfig
    from ..planner.planner import PlannerConfig
    from ..planner.policy import SloTargets
    from ..sim.cluster import SimConfig

    return {
        "engine": EngineConfig,
        "planner": PlannerConfig,
        "slo": SloTargets,
        "sim": SimConfig,
    }


def default_value(knob: Knob):
    """The owning dataclass's declared default for this knob."""
    cls = owner_classes()[knob.owner]
    for f in fields(cls):
        if f.name == knob.name:
            return f.default
    raise KeyError(f"{knob.owner} config has no field {knob.name!r}")


def defaults(owner: str | None = None) -> dict:
    """name -> dataclass default, for every knob (or one owner's)."""
    return {
        k.name: default_value(k)
        for k in KNOBS
        if owner is None or k.owner == owner
    }


def sim_knobs(planner: bool = False) -> tuple[Knob, ...]:
    """The knobs a simulator evaluation can observe: engine knobs with
    a SimConfig mirror plus sim-only edge knobs; planner/slo knobs only
    when the evaluation runs a planner."""
    out = []
    for k in KNOBS:
        if not k.sim:
            continue
        if k.owner in ("planner", "slo") and not planner:
            continue
        out.append(k)
    return tuple(out)


def live_knobs() -> tuple[Knob, ...]:
    return tuple(k for k in KNOBS if k.live)


def split_overrides(overrides: dict) -> dict[str, dict]:
    """Partition an overrides dict by owner (unknown names raise)."""
    out: dict[str, dict] = {"engine": {}, "planner": {}, "slo": {}, "sim": {}}
    for name in sorted(overrides):
        knob = KNOB_BY_NAME.get(name)
        if knob is None:
            raise KeyError(
                f"unknown knob {name!r}; registered: {sorted(KNOB_BY_NAME)}"
            )
        out[knob.owner][name] = overrides[name]
    return out


def sim_kwargs_from_overrides(overrides: dict) -> dict:
    """Map a knob-overrides dict onto SimConfig keyword arguments
    (engine knobs through their ``sim_field`` mirror; live-only knobs
    are dropped — the simulator cannot observe them)."""
    out: dict = {}
    for name in sorted(overrides):
        knob = KNOB_BY_NAME.get(name)
        if knob is None:
            raise KeyError(
                f"unknown knob {name!r}; registered: {sorted(KNOB_BY_NAME)}"
            )
        if not knob.sim:
            continue
        if knob.owner == "engine":
            if knob.sim_field:
                out[knob.sim_field] = overrides[name]
        elif knob.owner == "sim":
            out[name] = overrides[name]
    return out


def engine_kwargs_from_overrides(overrides: dict) -> dict:
    """The live-applicable engine-knob subset of an overrides dict,
    ready to splat into ``EngineConfig(...)``."""
    return {
        name: val
        for name, val in sorted(overrides.items())
        if (k := KNOB_BY_NAME.get(name)) is not None
        and k.owner == "engine"
        and k.live
    }


def resolved_engine_knobs(cfg) -> dict:
    """Every registered engine knob's resolved value on an
    ``EngineConfig`` instance (the dict :func:`config_hash` covers)."""
    return {k.name: getattr(cfg, k.name) for k in KNOBS if k.owner == "engine"}


def config_hash(knobs: dict) -> str:
    """Stable short hash of a resolved knob dict (the JAX package's,
    bit for bit): the pairing key ``llmctl bench compare`` uses so
    differently-knobbed runs never silently compare. Canonical JSON, so
    dict order cannot leak in."""
    blob = json.dumps(knobs, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def space_digest() -> str:
    """Identity of the registry itself (names, grids, applicability):
    embedded in trial journals and artifacts so a resumed or replayed
    run detects a space change instead of mixing incompatible trials."""
    blob = json.dumps(
        [
            {
                "name": k.name,
                "owner": k.owner,
                "kind": k.kind,
                "grid": list(k.grid),
                "sim": k.sim,
                "live": k.live,
                "sim_field": k.sim_field,
            }
            for k in KNOBS
        ],
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def render_knob_table() -> str:
    """The knob table as markdown (the JAX package's docs/tuning.md
    table, generated from the same registry)."""
    lines = [
        "| knob | owner | type | grid | sim | live | what it does |",
        "|---|---|---|---|---|---|---|",
    ]
    for k in KNOBS:
        grid = ", ".join(str(v) for v in k.grid)
        lines.append(
            f"| `{k.name}` | {k.owner} | {k.kind} | {grid} "
            f"| {'yes' if k.sim else '-'} | {'yes' if k.live else '-'} "
            f"| {k.note} |"
        )
    return "\n".join(lines)
