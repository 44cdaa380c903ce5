"""Workload fingerprint constants.

Trimmed counterpart of ``dynamo_exp_tpu/telemetry/fingerprint.py``: only
the drift threshold ``telemetry/fleet.py`` flags members by. The
fingerprint itself (``WorkloadFingerprint``, ``FingerprintBuilder``,
``drift_score`` and ``dynamo_workload_drift_score``) waits for a later
slice (ROADMAP Queue 1, telemetry).
"""

# One threshold, several consumers (the fleet view's DRIFT flag, the
# planner's config swap trigger): drift past it means "the pinned
# reference no longer describes live traffic, act".
DRIFT_ALERT_THRESHOLD = 0.25
