"""SLO / goodput attribution at the HTTP edge.

Counterpart of ``dynamo_exp_tpu/telemetry/slo.py``, the same code path:
one request either met its latency targets or it did not, and
:class:`SloAttribution` is the one place that answers it. The edge
measures each request's TTFT and ITL as its stream drains and feeds
them here (``dynamo_slo_violations_total{slo,priority}``,
``dynamo_goodput_requests_total{priority}``); each SLO axis keeps a
fast (last 64 requests) and a slow (last 1024) breach window, exported
as ``dynamo_slo_burn_rate{slo,window}``. ``percentile`` is the
nearest-rank percentile the dispatch profiler's summaries use too. The
planner (``planner/planner.py``, ``Planner(slo_source=...)``) reads the
same window for its SLO policy, and the cluster simulator
(``sim/cluster.py``) builds the same :class:`SloAttribution` for each
simulated run.
"""


from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass

# Admission priority classes (http/admission.py) -> counter label names.
PRIORITY_NAMES = {0: "low", 1: "normal", 2: "high"}

# Burn-rate window sizes, in completed requests. Request-count windows
# (not wall-clock) keep the math deterministic and meaningful at any
# throughput: 64 requests of signal at 1 rps or 1000 rps is the same
# statistical confidence.
BURN_WINDOWS = (("fast", 64), ("slow", 1024))


def percentile(samples: list[float], q: float) -> float | None:
    """Nearest-rank percentile: ``sorted[ceil(q*n) - 1]``. On a 2-sample
    window p99 is the MAX, not the min — these window percentiles feed
    the SLO planner's pressure terms, and flooring the rank would hide
    a breached tail exactly in low-throughput windows. None on no
    samples."""
    if not samples:
        return None
    s = sorted(samples)
    rank = min(max(math.ceil(q * len(s)), 1), len(s))
    return s[rank - 1]


@dataclass(frozen=True)
class SloConfig:
    """Per-request latency targets. ``None`` means the axis is not an
    SLO (it is still measured for the pressure window, never counted as
    a violation)."""

    ttft_s: float | None = None
    itl_s: float | None = None

    @property
    def active(self) -> bool:
        return self.ttft_s is not None or self.itl_s is not None


class SloAttribution:
    """Windowed TTFT/ITL attribution against :class:`SloConfig` targets.

    Thread-safe (the HTTP edge records from request tasks while the
    planner reads the window). Two surfaces:

    - ``observe_ttft`` / ``observe_itl`` feed the *pressure window*
      (``window_percentiles`` → ``reset_window`` per adjustment
      interval);
    - ``count`` attributes one *completed* request: each breached
      target increments its violation counter, a request breaching
      nothing counts as goodput. Shed/errored requests are never fed
      here — they have their own counters and contribute no goodput by
      construction.

    ``record`` composes both for call sites (the live edge) that learn
    TTFT and ITL at the same moment; the simulator calls the pieces at
    the instants its event loop learns them.
    """

    def __init__(
        self,
        cfg: SloConfig | None = None,
        telemetry=None,
        window: int = 4096,
    ):
        self.cfg = cfg or SloConfig()
        self._tel = telemetry
        self._lock = threading.Lock()
        self._window = window
        self.completed = 0
        self.violations: dict[str, int] = {"ttft": 0, "itl": 0}
        self.goodput_by_priority: dict[str, int] = {}
        # Bounded: a deployment with SLO flags but no planner pulling
        # (and resetting) the window must not leak two floats per
        # request forever — the window self-truncates to the most
        # recent ``window`` samples, which is also the right percentile
        # basis when nobody resets it.
        self._win_ttft: deque[float] = deque(maxlen=window)
        self._win_itl: deque[float] = deque(maxlen=window)
        # Burn-rate windows: per (slo axis, window name), a bounded
        # deque of 0/1 breach outcomes for requests where that axis was
        # measurable. Fed under the same lock as the attribution
        # counters.
        self._burn: dict[tuple[str, str], deque[int]] = {
            (slo, wname): deque(maxlen=size)
            for slo in ("ttft", "itl")
            for wname, size in BURN_WINDOWS
        }

    # ------------------------------------------------------ pressure window
    def observe_ttft(self, ttft_s: float) -> None:
        with self._lock:
            self._win_ttft.append(ttft_s)

    def observe_itl(self, itl_s: float) -> None:
        with self._lock:
            self._win_itl.append(itl_s)

    def window_percentiles(self) -> tuple[float | None, float | None]:
        """(p99 TTFT, p99 ITL) over the current window: the pressure
        inputs the JAX package's SLO planner reads."""
        with self._lock:
            return (
                percentile(list(self._win_ttft), 0.99),
                percentile(list(self._win_itl), 0.99),
            )

    def reset_window(self) -> None:
        """Clear the pressure window (one call per adjustment interval;
        mirrors the live planner's stale-sample discipline)."""
        with self._lock:
            self._win_ttft = deque(maxlen=self._window)
            self._win_itl = deque(maxlen=self._window)

    # -------------------------------------------------------- attribution
    @staticmethod
    def priority_name(priority) -> str:
        if isinstance(priority, str):
            return priority
        return PRIORITY_NAMES.get(priority, str(priority))

    def count(
        self,
        priority,
        ttft_s: float | None = None,
        itl_s: float | None = None,
    ) -> tuple[str, ...]:
        """Attribute one completed request; returns the breached SLOs
        (``()`` = goodput). A target left ``None`` in the config — or a
        latency the caller couldn't measure (e.g. ITL of a 1-token
        response) — never counts as a violation."""
        violated = []
        if (
            self.cfg.ttft_s is not None
            and ttft_s is not None
            and ttft_s > self.cfg.ttft_s
        ):
            violated.append("ttft")
        if (
            self.cfg.itl_s is not None
            and itl_s is not None
            and itl_s > self.cfg.itl_s
        ):
            violated.append("itl")
        name = self.priority_name(priority)
        rates: list[tuple[str, str, float]] = []
        with self._lock:
            self.completed += 1
            for v in violated:
                self.violations[v] += 1
            if not violated:
                self.goodput_by_priority[name] = (
                    self.goodput_by_priority.get(name, 0) + 1
                )
            # Feed every axis that was *measurable* on this request —
            # a met target is a 0, so the window denominator is real
            # traffic, not just breaches.
            for slo, measured in (("ttft", ttft_s), ("itl", itl_s)):
                target = getattr(self.cfg, f"{slo}_s")
                if target is None or measured is None:
                    continue
                for wname, _size in BURN_WINDOWS:
                    win = self._burn[(slo, wname)]
                    win.append(1 if slo in violated else 0)
                    rates.append((slo, wname, sum(win) / len(win)))
        if self._tel is not None:
            for v in violated:
                self._tel.slo_violations.labels(v, name).inc()
            if not violated:
                self._tel.goodput_requests.labels(name).inc()
            for slo, wname, rate in rates:
                self._tel.slo_burn_rate.labels(slo, wname).set(rate)
        return tuple(violated)

    def record(
        self,
        priority,
        ttft_s: float | None = None,
        itl_s: float | None = None,
    ) -> tuple[str, ...]:
        """Observe into the pressure window AND attribute, in one call
        (the live edge learns both at stream end)."""
        if ttft_s is not None:
            self.observe_ttft(ttft_s)
        if itl_s is not None:
            self.observe_itl(itl_s)
        return self.count(priority, ttft_s=ttft_s, itl_s=itl_s)

    # ------------------------------------------------------------- totals
    @property
    def goodput_total(self) -> int:
        with self._lock:
            return sum(self.goodput_by_priority.values())

    def burn_rates(self) -> dict[str, float]:
        """Current breach fraction per ``"<slo>/<window>"`` key, e.g.
        ``{"ttft/fast": 0.05, "ttft/slow": 0.01, ...}``. Only windows
        that have received at least one measurable request appear —
        the ``metrics()["slo_burn_rate"]`` mirror shape."""
        with self._lock:
            return {
                f"{slo}/{wname}": round(sum(win) / len(win), 4)
                for (slo, wname), win in self._burn.items()
                if win
            }
