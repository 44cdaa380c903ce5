"""Sim-in-the-loop autotuner over the engine's knob surface
(``llmctl tune``; counterpart of ``dynamo_exp_tpu/tune/``).

Four stages, each its own module:

- :mod:`.space` — the declarative knob registry: every tunable
  ``EngineConfig`` / ``PlannerConfig`` / ``SloTargets`` / ``SimConfig``
  field with its grid and sim-vs-live applicability, guarded against
  config drift by a registry-walk test.
- :mod:`.search` — deterministic seeded coordinate descent with a
  successive-halving rung, evaluating candidates in the cluster
  simulator against a workload-fingerprint target, journaling every
  trial as resumable JSONL.
- :mod:`.validate` — top-K candidates re-run on a live ``TorchEngine``
  (on the card unless the caller asks for the CPU); sim-vs-live rank
  agreement (Kendall tau + top-1) gates the recommendation.
- :mod:`.artifact` — the emitted config artifact: knob overrides +
  provenance + target fingerprint + matching graph manifest, loadable
  straight into an engine boot or a planner config catalog.
"""

from .artifact import (
    ARTIFACT_VERSION,
    build_artifact,
    catalog_entry_from_artifact,
    engine_config_from_artifact,
    load_artifact,
    manifest_from_artifact,
    resolved_live_knobs,
    write_artifact,
)
from .search import (
    SearchSettings,
    TuneResult,
    TuneTarget,
    composite_objective,
    evaluate,
    load_journal,
    run_search,
    target_from_fingerprint,
    target_from_trace,
    top_candidates,
)
from .space import (
    KNOB_BY_NAME,
    KNOBS,
    config_hash,
    render_knob_table,
    space_digest,
)
from .validate import kendall_tau, validate_candidates

__all__ = [
    "ARTIFACT_VERSION",
    "KNOBS",
    "KNOB_BY_NAME",
    "SearchSettings",
    "TuneResult",
    "TuneTarget",
    "build_artifact",
    "catalog_entry_from_artifact",
    "composite_objective",
    "config_hash",
    "engine_config_from_artifact",
    "evaluate",
    "kendall_tau",
    "load_artifact",
    "load_journal",
    "manifest_from_artifact",
    "render_knob_table",
    "resolved_live_knobs",
    "run_search",
    "space_digest",
    "target_from_fingerprint",
    "target_from_trace",
    "top_candidates",
    "validate_candidates",
    "write_artifact",
]
