"""Per-dispatch device profiling on the engine loop's own timestamps.

Counterpart of ``dynamo_exp_tpu/telemetry/dispatch.py``. In the
overlapped steady state a throughput problem is one of two things: the
card spent too long *in flight*, or the host left a *gap* between
consuming one dispatch and issuing the next. This profiler attributes
wall time to those two, per dispatch kind, plus first-use work, with
``time.monotonic()`` stamps taken where the loop already is:

- ``begin(kind)`` right before the dispatch records the **host gap**
  since the kind's previous consume and returns the stamp;
- ``end(kind, t0, fresh)`` right after the dispatch returns; a
  ``fresh`` dispatch is one that captured its key's CUDA graph
  (``engine/graphs.py``; on the CPU, which has no graphs, the first
  dispatch of a key), and its wall goes to
  ``dynamo_compile_seconds{kind}`` and
  ``dynamo_compile_cache_misses_total{kind}``;
- ``consume(kind, t_dispatch)`` right after the wait on the dispatch's
  event that the loop already makes records the **in-flight** time.

Nothing here syncs or touches the card, and nothing runs inside a
captured graph. The kinds are the JAX package's, with its ``ragged``
split into the port's two graph kinds: ``window`` (pure-decode windows)
and ``mixed`` (prefill chunks, decode rows beside them, verify spans);
``kv_move`` (injections of host pages) and ``offload`` (gathers written
back to the host tier, consumed on the copy thread) as in JAX.
"""


from __future__ import annotations

import time
from collections import deque

from .slo import percentile

# The engine's dispatch kinds: a closed set, the label space of the
# dispatch families and the keys of metrics()["dispatch"].
DISPATCH_KINDS = ("window", "mixed", "kv_move", "offload")

# Summary stat fields.
SUMMARY_FIELDS = (
    "count",
    "host_gap_p50_s",
    "host_gap_p99_s",
    "in_flight_p50_s",
    "in_flight_p99_s",
    "compile_misses",
    "compile_total_s",
)


class DispatchProfiler:
    """Host-side per-dispatch timing. All methods are cheap (two clock
    reads and a deque append at worst) and rely on the GIL for the
    cross-thread case (the offload consume arrives from the CopyStream
    thread; ``summary()`` may be called from any thread)."""

    def __init__(self, telemetry=None, reservoir: int = 1024):
        self._tel = telemetry
        self._gap = {k: deque(maxlen=reservoir) for k in DISPATCH_KINDS}
        self._flight = {k: deque(maxlen=reservoir) for k in DISPATCH_KINDS}
        self._count = dict.fromkeys(DISPATCH_KINDS, 0)
        self._compile_misses = dict.fromkeys(DISPATCH_KINDS, 0)
        self._compile_s = dict.fromkeys(DISPATCH_KINDS, 0.0)
        # kind -> (monotonic time, event seq) of the last consume (or
        # dispatch end, for never-synced kinds); cleared on idle so
        # gaps never span a genuinely-idle engine. The event seq gates
        # gap recording: if ANY other profiler event landed in between,
        # the engine was busy with other dispatch kinds and the elapsed
        # time is work inter-arrival, not host overhead — a prefill
        # arriving 5s into a decode-saturated steady state must not
        # read as a 5s prefill host gap.
        self._last_consume: dict[str, tuple[float, int]] = {}
        self._event_seq = 0
        # (family, key) variants already seen: freshness where no graph
        # is captured (the CPU, or cuda_graphs=False).
        self._seen_variants: set = set()

    # ------------------------------------------------------------ dispatch
    def begin(self, kind: str) -> float:
        """Immediately before the dispatch call; returns its timestamp
        (pass to :meth:`end` and stash for :meth:`consume`). The host
        gap since the kind's previous consume is recorded only when no
        other dispatch activity intervened — back-to-back work of the
        same kind, the case where the elapsed time really is host
        overhead."""
        now = time.monotonic()
        last = self._last_consume.get(kind)
        self._event_seq += 1
        if last is not None and last[1] == self._event_seq - 1:
            gap = max(now - last[0], 0.0)
            self._gap[kind].append(gap)
            if self._tel is not None:
                self._tel.host_gap_seconds.labels(kind).observe(gap)
        return now

    def end(self, kind: str, t0: float, fresh: bool = False) -> float:
        """Immediately after the dispatch call returns. ``fresh`` marks
        a first-use variant: the call's wall time is its capture (a
        capture runs inside the call; a replay only enqueues). Returns
        the dispatch-completion timestamp for :meth:`consume`."""
        now = time.monotonic()
        self._count[kind] += 1
        if fresh:
            dur = max(now - t0, 0.0)
            self._compile_misses[kind] += 1
            self._compile_s[kind] += dur
            if self._tel is not None:
                self._tel.compile_cache_misses.labels(kind).inc()
                self._tel.compile_seconds.labels(kind).observe(dur)
        # Never-synced kinds (scatter moves) get their gap reference
        # here; synced kinds overwrite it with the later consume.
        self._event_seq += 1
        self._last_consume[kind] = (now, self._event_seq)
        return now

    def first_variant(self, family: str, key) -> bool:
        """True exactly once per (family, key): first use of a key where
        no graph capture marks it."""
        k = (family, key)
        if k in self._seen_variants:
            return False
        self._seen_variants.add(k)
        return True

    def seed_variants(self, family: str, keys) -> None:
        """Warm boot: mark (family, key) variants as already run, so their
        first traffic dispatch is not charged as first use. (With graphs
        the capture count decides, and prewarm has captured them.)"""
        for key in keys:
            self._seen_variants.add((family, key))

    # ------------------------------------------------------------- consume
    def consume(self, kind: str, t_dispatch: float) -> None:
        """Immediately after the dispatch's existing host sync. Records
        in-flight time and arms the kind's host-gap reference."""
        now = time.monotonic()
        if t_dispatch > 0.0:
            flight = max(now - t_dispatch, 0.0)
            self._flight[kind].append(flight)
            if self._tel is not None:
                self._tel.dispatch_seconds.labels(kind).observe(flight)
        self._event_seq += 1
        self._last_consume[kind] = (now, self._event_seq)

    def mark_idle(self) -> None:
        """The loop is parking (no work, or everything stalled): drop
        the gap references so wait time never reads as host gap."""
        self._last_consume.clear()

    def compile_total_s(self) -> float:
        """First-use capture seconds over all kinds; the anatomy marks it
        at admission and books the growth at first token as the
        request's compile stall."""
        return sum(self._compile_s.values())

    def host_gap_fraction(self, kind: str) -> float:
        """Median host-gap share of one ``kind`` dispatch interval,
        gap / (gap + in-flight), in [0, 1]; 0.0 before a sample. The
        anatomy carves host_gap out of decode compute with it."""
        flight = self._p(self._flight[kind], 0.5)
        if flight is None:
            return 0.0
        gap = self._p(self._gap[kind], 0.5) or 0.0
        return gap / (gap + flight) if (gap + flight) > 0 else 0.0

    # ------------------------------------------------------------- summary
    @staticmethod
    def _p(samples, q) -> float | None:
        v = percentile(list(samples), q)
        return round(v, 6) if v is not None else None

    def summary(self) -> dict:
        """Per-kind stats over the recent reservoir window, the
        ``engine.metrics()["dispatch"]`` mirror. Every kind is always
        present (count 0, None percentiles before its first dispatch)."""
        out = {}
        for k in DISPATCH_KINDS:
            out[k] = {
                "count": self._count[k],
                "host_gap_p50_s": self._p(self._gap[k], 0.5),
                "host_gap_p99_s": self._p(self._gap[k], 0.99),
                "in_flight_p50_s": self._p(self._flight[k], 0.5),
                "in_flight_p99_s": self._p(self._flight[k], 0.99),
                "compile_misses": self._compile_misses[k],
                "compile_total_s": round(self._compile_s[k], 6),
            }
        return out

    def span_attrs(self, kind: str, **extra) -> dict:
        """Attrs for the decode and prefill spans: median in-flight and
        host-gap for the kind, or {} before the first sample."""
        flight = self._p(self._flight[kind], 0.5)
        if flight is None:
            return {}
        gap = self._p(self._gap[kind], 0.5)
        return {
            "dispatch_p50_s": flight,
            "host_gap_p50_s": gap if gap is not None else 0.0,
            **extra,
        }
