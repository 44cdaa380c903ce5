"""Instance health tracking for the request plane.

Counterpart of ``dynamo_exp_tpu/runtime/health.py``:

- :class:`CircuitBreaker`: one consecutive-failure breaker with the
  closed -> open -> half-open cycle.
- :class:`HealthTracker`: per-instance breakers plus discovery-fed
  liveness (snapshot timestamps, draining / reclaiming metadata), owned
  by every :class:`~.client.Client`; request outcomes feed it from
  :class:`~.push_router.PushRouter`, discovery snapshots from the
  client's watch.

State transitions land on ``dynamo_circuit_breaker_transitions_total``.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

from ..telemetry import get_telemetry
from .transports.base import InstanceInfo

logger = logging.getLogger(__name__)

# Metadata key a draining worker publishes to discovery; routers treat a
# truthy value as "no new work".
DRAINING_KEY = "draining"

# Metadata key a spot-reclaimed worker publishes (docs/fault_tolerance.md
# "Spot reclamation & live migration"): same routing consequence as
# draining — no new work within one watch event — but the window is a
# hard platform deadline, not a goodbye the worker controls, so the
# reclaim plane additionally triages in-flight sequences under it.
RECLAIMING_KEY = "reclaiming"


def is_draining(info: InstanceInfo) -> bool:
    return bool(info.metadata.get(DRAINING_KEY))


def is_reclaiming(info: InstanceInfo) -> bool:
    return bool(info.metadata.get(RECLAIMING_KEY))


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe.

    ``allow()`` answers "may I send work now?": always in CLOSED; never
    inside the OPEN cooldown; exactly one caller (the probe) per
    half-open window after the cooldown. ``record_success`` closes,
    ``record_failure`` (re)opens once ``failure_threshold`` consecutive
    failures accumulate — or immediately when the half-open probe fails.

    ``clock`` is injectable so tests can step time deterministically.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.name = name
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def _transition(self, state: BreakerState) -> None:
        if state is self.state:
            return
        self.state = state
        get_telemetry().breaker_transitions.labels(state.value).inc()
        logger.info("circuit breaker %s -> %s", self.name or "?", state.value)

    def allow(self) -> bool:
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            if self.clock() - self._opened_at < self.cooldown_s:
                return False
            self._transition(BreakerState.HALF_OPEN)
            self._probe_inflight = False
        # HALF_OPEN: admit a single probe until its outcome is recorded.
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def would_allow(self) -> bool:
        """``allow()`` without claiming the half-open probe slot."""
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            return self.clock() - self._opened_at >= self.cooldown_s
        return not self._probe_inflight

    def release(self) -> None:
        """Release a claimed probe slot **without recording an outcome**.

        Some dispatch paths end with neither success nor failure evidence
        about the instance — the request's own deadline expired, the
        caller was cancelled mid-await. Without this, the slot claimed by
        ``allow()`` leaks: the breaker sticks in HALF_OPEN with
        ``_probe_inflight`` set forever and the instance becomes
        permanently unroutable. Callers must pair every ``allow()`` with
        exactly one of record_success / record_failure / release."""
        self._probe_inflight = False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._probe_inflight = False
        self._transition(BreakerState.CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        self._probe_inflight = False
        if self.state is BreakerState.HALF_OPEN or (
            self.state is BreakerState.CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self._opened_at = self.clock()
            self._transition(BreakerState.OPEN)
        elif self.state is BreakerState.OPEN:
            # Failures while already open (racing in-flight requests)
            # restart the cooldown so a dead instance is not probed
            # while still provably failing.
            self._opened_at = self.clock()

    @property
    def is_open(self) -> bool:
        return self.state is BreakerState.OPEN


@dataclass
class _InstanceHealth:
    breaker: CircuitBreaker
    last_seen: float = 0.0
    failures_total: int = field(default=0)


class HealthTracker:
    """Per-instance health over request outcomes + discovery liveness.

    ``stale_after_s`` (optional) excludes instances whose discovery
    snapshot is older than the window — heartbeat staleness for fabrics
    whose watch stream has gone quiet. Disabled by default because the
    in-proc discovery only pushes on membership *change*.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        stale_after_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._instances: dict[int, _InstanceHealth] = {}

    def _entry(self, instance_id: int) -> _InstanceHealth:
        entry = self._instances.get(instance_id)
        if entry is None:
            entry = self._instances[instance_id] = _InstanceHealth(
                breaker=CircuitBreaker(
                    self.failure_threshold,
                    self.cooldown_s,
                    clock=self.clock,
                    name=f"instance-{instance_id}",
                ),
                last_seen=self.clock(),
            )
        return entry

    # ---------------------------------------------------------- outcomes
    def record_success(self, instance_id: int) -> None:
        self._entry(instance_id).breaker.record_success()

    def record_failure(self, instance_id: int) -> None:
        entry = self._entry(instance_id)
        entry.failures_total += 1
        entry.breaker.record_failure()

    def release(self, instance_id: int) -> None:
        """Outcome-free release of an :meth:`acquire` claim (deadline
        expiry, cancellation — paths that say nothing about the
        instance's health). See :meth:`CircuitBreaker.release`."""
        self._entry(instance_id).breaker.release()

    def breaker(self, instance_id: int) -> CircuitBreaker:
        return self._entry(instance_id).breaker

    # --------------------------------------------------------- discovery
    def observe_instances(self, infos: Iterable[InstanceInfo]) -> None:
        """Feed a discovery snapshot: stamps liveness and drops health
        state for instances that left (their ids are lease-derived and
        never reused, so the state is dead weight)."""
        now = self.clock()
        seen = set()
        for info in infos:
            seen.add(info.instance_id)
            self._entry(info.instance_id).last_seen = now
        for iid in list(self._instances):
            if iid not in seen:
                del self._instances[iid]

    # ----------------------------------------------------------- queries
    def is_available(self, info: InstanceInfo) -> bool:
        """Routable right now: not draining, not reclaiming, not
        breaker-blocked, not stale. Does NOT claim the half-open probe
        slot — selection does that via :meth:`acquire`."""
        if is_draining(info) or is_reclaiming(info):
            return False
        entry = self._instances.get(info.instance_id)
        if entry is None:
            return True
        if (
            self.stale_after_s is not None
            and entry.last_seen
            and self.clock() - entry.last_seen > self.stale_after_s
        ):
            return False
        return entry.breaker.would_allow()

    def acquire(self, instance_id: int) -> bool:
        """Claim the right to dispatch to the instance (consumes the
        half-open probe slot when the breaker is recovering)."""
        return self._entry(instance_id).breaker.allow()

    def filter_available(
        self, infos: Iterable[InstanceInfo]
    ) -> list[InstanceInfo]:
        return [i for i in infos if self.is_available(i)]

    def unavailable_ids(self, infos: Iterable[InstanceInfo]) -> set[int]:
        return {i.instance_id for i in infos if not self.is_available(i)}
