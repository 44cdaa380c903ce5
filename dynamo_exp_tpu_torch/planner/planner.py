"""Trimmed counterpart of ``dynamo_exp_tpu/planner/planner.py``: only
the remote-prefill queue's name, which both packages' fleets must spell
alike. The SLO planner itself waits for a later slice (ROADMAP Queue 1).
"""


def prefill_queue_name(model_name: str) -> str:
    """Shared naming for the remote-prefill work queue, keyed by the
    served model's name."""
    return f"prefill-{model_name}"
