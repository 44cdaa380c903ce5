"""Workload traces (counterpart of ``dynamo_exp_tpu/sim/``, trimmed to
``workload.py``'s request record and its JSONL trace files, which the
workload fingerprint reads and writes). The cluster simulator, its
generators and the fitter wait for ROADMAP Queue 1 entry 8."""

from .workload import SimRequest, load_trace, save_trace

__all__ = ["SimRequest", "load_trace", "save_trace"]
