"""Dynamic worker scaling: the planner.

Counterpart of ``dynamo_exp_tpu/planner/``: the pure policies
(``policy.py``), the asyncio loop that feeds them metrics
(``planner.py``) and the connector that applies their actions to the SDK
supervisor (``connector.py``).
"""

from .connector import LocalConnector, PlannerConnector
from .planner import Planner, PlannerConfig, prefill_queue_name
from .policy import (
    CatalogEntry,
    Decision,
    PlannerObservation,
    PlannerState,
    ScaleAction,
    SloTargets,
    arm_decode_grace,
    maybe_swap_config,
    plan_step,
    plan_step_slo,
)

__all__ = [
    "Planner",
    "PlannerConfig",
    "PlannerConnector",
    "LocalConnector",
    "PlannerObservation",
    "PlannerState",
    "ScaleAction",
    "CatalogEntry",
    "Decision",
    "SloTargets",
    "arm_decode_grace",
    "maybe_swap_config",
    "plan_step",
    "plan_step_slo",
    "prefill_queue_name",
]
