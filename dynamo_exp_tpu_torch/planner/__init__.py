"""The planner (counterpart of ``dynamo_exp_tpu/planner/``), trimmed to
the prefill queue's name. The rest waits for a later slice (ROADMAP
Queue 1)."""

from .planner import prefill_queue_name

__all__ = ["prefill_queue_name"]
