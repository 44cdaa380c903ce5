"""Edge admission control: bounded in-flight work with priority-aware
load shedding.

Counterpart of ``dynamo_exp_tpu/http/admission.py``, the same rule. The
controller keeps one in-flight count per service (everything between
admission and the final frame) and two watermarks:

- ``shed_watermark``: above it admission is graduated by priority —
  ``low`` sheds first, ``normal`` at the midpoint, ``high`` rides to the
  cap. A shed request gets **429 + Retry-After**.
- ``max_inflight`` (the hard cap): at it nothing is admitted, ``high``
  included: **503 + Retry-After**.

Priorities arrive as the ``priority`` body or ``nvext`` field or the
``X-Request-Priority`` header (``protocols/common.py``).
"""


from __future__ import annotations

import threading

from ..protocols.common import (  # noqa: F401 - re-exported API
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    parse_priority,
    priority_name,
)
from ..telemetry import get_telemetry


class RequestShedError(Exception):
    """Admission refused for this priority class right now (HTTP 429)."""

    status = 429

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ServiceOverloadedError(RequestShedError):
    """The hard in-flight cap is reached — nothing is admitted (503)."""

    status = 503


def _resolve_watermark(max_inflight: int, shed_watermark: int | None) -> int:
    """Default high watermark: 3/4 of the cap (at least 1 so the
    graduated band exists); an explicit value is clamped to the cap."""
    if shed_watermark is not None:
        return min(shed_watermark, max_inflight)
    return max((max_inflight * 3) // 4, 1)


class AdmissionController:
    """Per-service in-flight bound with priority-graduated shedding.

    Thread-safe (the handlers run on one event loop, but scrapes and
    tests read the count); admission is one lock-guarded
    compare-and-increment."""

    def __init__(
        self,
        max_inflight: int = 64,
        shed_watermark: int | None = None,
        retry_after_s: float = 1.0,
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self.shed_watermark = _resolve_watermark(max_inflight, shed_watermark)
        self.retry_after_s = retry_after_s
        self._inflight = 0
        self._lock = threading.Lock()

    @property
    def inflight(self) -> int:
        return self._inflight

    def threshold(self, priority: int) -> int:
        """The in-flight level at which ``priority`` stops being
        admitted: ``low`` at the watermark, ``high`` at the hard cap,
        classes in between spaced linearly across the shed band."""
        band = self.max_inflight - self.shed_watermark
        frac = min(max(priority, 0), PRIORITY_HIGH) / PRIORITY_HIGH
        return self.shed_watermark + int(band * frac)

    def acquire(self, priority: int = PRIORITY_NORMAL) -> None:
        """Admit one request or raise the matching shed error.

        Every successful ``acquire`` must be paired with exactly one
        ``release`` (use :meth:`admit` for the context-manager form)."""
        tel = get_telemetry()
        with self._lock:
            if self._inflight >= self.max_inflight:
                tel.requests_shed.labels(priority_name(priority), "503").inc()
                raise ServiceOverloadedError(
                    f"service at capacity ({self._inflight} in flight, "
                    f"cap {self.max_inflight})",
                    self.retry_after_s,
                )
            if self._inflight >= self.threshold(priority):
                tel.requests_shed.labels(priority_name(priority), "429").inc()
                raise RequestShedError(
                    f"shedding {priority_name(priority)}-priority work "
                    f"({self._inflight} in flight, watermark "
                    f"{self.threshold(priority)})",
                    self.retry_after_s,
                )
            self._inflight += 1
            tel.admission_inflight.set(self._inflight)

    def release(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1
            get_telemetry().admission_inflight.set(self._inflight)

    def admit(self, priority: int = PRIORITY_NORMAL) -> "_Admission":
        """``with admission.admit(priority): ...`` — acquire on enter
        (raising the shed error before the body runs), release on exit."""
        return _Admission(self, priority)


class _Admission:
    def __init__(self, controller: AdmissionController, priority: int):
        self._controller = controller
        self._priority = priority

    def __enter__(self) -> "_Admission":
        self._controller.acquire(self._priority)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._controller.release()
