"""Deterministic discrete-event loop (counterpart of
``dynamo_exp_tpu/sim/core.py``, the same calendar).

A bare-bones calendar queue: callbacks scheduled at absolute sim times,
popped in (time, insertion-order) order. The insertion-order tie-break
is the determinism linchpin — simultaneous events (a burst arriving at
t=0, releases cascading at one instant) fire in exactly the order they
were scheduled, every run, so a seeded simulation's event log is
bit-identical across runs and platforms.

No wall clock anywhere: ``now`` only advances when an event fires.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable


class EventLoop:
    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable, tuple]] = []
        self._counter = 0
        self.now = 0.0
        self.processed = 0

    def at(self, when: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` at absolute sim time ``when`` (clamped
        to now: the past is not available)."""
        when = max(when, self.now)
        heapq.heappush(self._heap, (when, self._counter, fn, args))
        self._counter += 1

    def after(self, delay: float, fn: Callable, *args: Any) -> None:
        self.at(self.now + max(delay, 0.0), fn, *args)

    def __len__(self) -> int:
        return len(self._heap)

    def run(
        self,
        until: float | None = None,
        max_events: int | None = None,
    ) -> None:
        """Drain the calendar. ``until`` stops the clock at a horizon
        (events beyond it stay queued); ``max_events`` is a runaway
        guard for misbehaving models, not a sampling knob."""
        while self._heap:
            if max_events is not None and self.processed >= max_events:
                raise RuntimeError(
                    f"simulation exceeded {max_events} events — "
                    "runaway model (check stall/preempt cycles)"
                )
            when, _, fn, args = self._heap[0]
            if until is not None and when > until:
                break
            heapq.heappop(self._heap)
            self.now = when
            fn(*args)
            self.processed += 1
