"""Discrete-event cluster simulator (counterpart of ``dynamo_exp_tpu/sim/``).

Replays seeded workloads (the chaos harness's ``overload_burst``
scenarios, recorded trace files, or synthetic million-user arrival
processes) through the port's own policy code (edge admission
watermarks, KV-router selector scoring, KV-pressure victim selection,
planner decision steps) against modeled instances whose service times
are fitted from real telemetry (span JSONL, bench JSON). Deterministic
per seed: the same (seed, workload, config) triple produces a
bit-identical event log, the JAX package's.
"""

from .cluster import ClusterSim, SimConfig
from .core import EventLoop
from .fit import LatencyDist, ServiceTimeModel
from .report import SimReport
from .workload import (
    SimRequest,
    burst_workload,
    diurnal_workload,
    load_trace,
    ramp_workload,
    save_trace,
    synthetic_users,
)

__all__ = [
    "ClusterSim",
    "SimConfig",
    "SimReport",
    "EventLoop",
    "ServiceTimeModel",
    "LatencyDist",
    "SimRequest",
    "burst_workload",
    "diurnal_workload",
    "ramp_workload",
    "synthetic_users",
    "load_trace",
    "save_trace",
]
