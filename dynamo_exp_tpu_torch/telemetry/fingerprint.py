"""Online workload fingerprint and drift.

Counterpart of ``dynamo_exp_tpu/telemetry/fingerprint.py``. A
:class:`WorkloadFingerprint` is a compact, order-independent summary of
a request population: ISL / OSL histograms over fixed geometric
buckets, the priority mix, the prefix-cache share, speculative
acceptance and arrival-rate statistics. It is built

- live (:class:`FingerprintBuilder`): the engine feeds it at admission
  and at finish, counter arithmetic on host values only;
- offline from a span file (:func:`fingerprint_from_spans`), a
  ``sim/workload.py`` trace (:func:`fingerprint_from_trace`) or a bench
  capture (:func:`fingerprint_from_bench`), through ``llmctl
  fingerprint``.

The **digest** is a sha256 over the canonical JSON of the
time-independent fields only (bucket counts, mixes, shares; never a
wall-clock rate). The bucket edges and the canonical JSON are the JAX
package's byte for byte, so both packages hash the same traffic alike.
:func:`replay_workload` turns a fingerprint back into ``sim/workload.py``
requests, and :func:`drift_score` compares two fingerprints into the
``dynamo_workload_drift_score`` gauge.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field

# Fixed geometric bucket edges (upper bounds, inclusive; the last
# bucket is open). Shared by live + offline builders so digests from
# either path are comparable.
ISL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
OSL_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
_N_PRIORITIES = 3  # low / normal / high (telemetry.slo.PRIORITY_NAMES)


def _bucket_index(v: int, edges: tuple) -> int:
    for i, edge in enumerate(edges):
        if v <= edge:
            return i
    return len(edges)


def _bucket_bounds(i: int, edges: tuple) -> tuple[int, int]:
    lo = 1 if i == 0 else edges[i - 1] + 1
    hi = edges[i] if i < len(edges) else edges[-1] * 2
    return lo, hi


@dataclass(frozen=True)
class WorkloadFingerprint:
    """Immutable snapshot; ``digest()`` is the stable identity."""

    n: int = 0
    # Bucket counts, len(edges)+1 each (last bucket open-ended).
    isl_hist: tuple = ()
    osl_hist: tuple = ()
    priority_mix: tuple = (0.0,) * _N_PRIORITIES  # fractions, 4dp
    prefix_share: float = 0.0  # cached tokens / prompt tokens, 4dp
    spec_accept: float = 0.0  # mean accepted tokens per spec dispatch, 4dp
    # Wall-clock-derived — carried for the sim bridge, EXCLUDED from
    # the digest (host jitter must not change the workload identity).
    arrival_rate_rps: float = 0.0
    arrival_cv: float = 0.0
    duration_s: float = 0.0

    def digest(self) -> str:
        stable = {
            "v": 1,
            "n": self.n,
            "isl": list(self.isl_hist),
            "osl": list(self.osl_hist),
            "priority_mix": list(self.priority_mix),
            "prefix_share": self.prefix_share,
            "spec_accept": self.spec_accept,
        }
        blob = json.dumps(stable, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_dict(self) -> dict:
        return {
            "digest": self.digest(),
            "n": self.n,
            "isl_hist": list(self.isl_hist),
            "osl_hist": list(self.osl_hist),
            "isl_buckets": list(ISL_BUCKETS),
            "osl_buckets": list(OSL_BUCKETS),
            "priority_mix": list(self.priority_mix),
            "prefix_share": self.prefix_share,
            "spec_accept": self.spec_accept,
            "arrival_rate_rps": self.arrival_rate_rps,
            "arrival_cv": self.arrival_cv,
            "duration_s": self.duration_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadFingerprint":
        return cls(
            n=int(d.get("n", 0)),
            isl_hist=tuple(d.get("isl_hist", ())),
            osl_hist=tuple(d.get("osl_hist", ())),
            priority_mix=tuple(d.get("priority_mix", (0.0,) * _N_PRIORITIES)),
            prefix_share=float(d.get("prefix_share", 0.0)),
            spec_accept=float(d.get("spec_accept", 0.0)),
            arrival_rate_rps=float(d.get("arrival_rate_rps", 0.0)),
            arrival_cv=float(d.get("arrival_cv", 0.0)),
            duration_s=float(d.get("duration_s", 0.0)),
        )


def load_fingerprint(path: str) -> WorkloadFingerprint:
    with open(path) as f:
        return WorkloadFingerprint.from_dict(json.load(f))


class FingerprintBuilder:
    """Streaming accumulator. Thread-safe: the engine loop feeds it,
    serving threads snapshot it (``metrics()["workload_fingerprint"]``).
    All state is counters/sums — order of observation cannot change the
    snapshot, which is what makes the digest layout-independent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._isl = [0] * (len(ISL_BUCKETS) + 1)
        self._osl = [0] * (len(OSL_BUCKETS) + 1)
        self._prio = [0] * _N_PRIORITIES
        self._prompt_tokens = 0
        self._cached_tokens = 0
        self._spec_sum = 0.0
        self._spec_n = 0
        self._first_t = 0.0
        self._last_t = 0.0
        # Welford over inter-arrival deltas (wall-clock; digest-exempt).
        self._ia_n = 0
        self._ia_mean = 0.0
        self._ia_m2 = 0.0

    def observe_admit(
        self,
        prompt_tokens: int,
        cached_tokens: int = 0,
        priority: int = 1,
        arrival_t: float = 0.0,
    ) -> None:
        with self._lock:
            self._n += 1
            self._isl[_bucket_index(max(int(prompt_tokens), 1), ISL_BUCKETS)] += 1
            if 0 <= priority < _N_PRIORITIES:
                self._prio[priority] += 1
            self._prompt_tokens += max(int(prompt_tokens), 0)
            self._cached_tokens += max(int(cached_tokens), 0)
            if arrival_t:
                if not self._first_t:
                    self._first_t = arrival_t
                elif arrival_t >= self._last_t:
                    delta = arrival_t - self._last_t
                    self._ia_n += 1
                    d = delta - self._ia_mean
                    self._ia_mean += d / self._ia_n
                    self._ia_m2 += d * (delta - self._ia_mean)
                self._last_t = max(self._last_t, arrival_t)

    def observe_finish(
        self, generated_tokens: int, spec_tokens_per_dispatch: float = 0.0
    ) -> None:
        with self._lock:
            self._osl[_bucket_index(max(int(generated_tokens), 1), OSL_BUCKETS)] += 1
            if spec_tokens_per_dispatch > 0:
                self._spec_sum += float(spec_tokens_per_dispatch)
                self._spec_n += 1

    def snapshot(self) -> WorkloadFingerprint:
        with self._lock:
            n = self._n
            prio_total = sum(self._prio) or 1
            duration = max(self._last_t - self._first_t, 0.0)
            rate = (n - 1) / duration if duration > 0 and n > 1 else 0.0
            cv = 0.0
            if self._ia_n > 1 and self._ia_mean > 0:
                var = self._ia_m2 / (self._ia_n - 1)
                cv = (var ** 0.5) / self._ia_mean
            return WorkloadFingerprint(
                n=n,
                isl_hist=tuple(self._isl),
                osl_hist=tuple(self._osl),
                priority_mix=tuple(
                    round(c / prio_total, 4) for c in self._prio
                ),
                prefix_share=round(
                    self._cached_tokens / self._prompt_tokens, 4
                ) if self._prompt_tokens else 0.0,
                spec_accept=round(
                    self._spec_sum / self._spec_n, 4
                ) if self._spec_n else 0.0,
                arrival_rate_rps=round(rate, 4),
                arrival_cv=round(cv, 4),
                duration_s=round(duration, 4),
            )


# ------------------------------------------------------------ offline paths
_PRIO_BY_NAME = {"low": 0, "normal": 1, "high": 2}


def fingerprint_from_spans(spans) -> WorkloadFingerprint:
    """Build from a recorder span file (``timeline.load_spans``): each
    trace's prefill span gives ISL/prefix, its decode span gives
    OSL/priority/spec, and the earliest span start is the arrival."""
    b = FingerprintBuilder()
    by_trace: dict[str, list] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    # Deterministic feed order (irrelevant to the digest, but keeps the
    # wall-clock fields reproducible for a given file).
    for trace_id in sorted(by_trace):
        group = by_trace[trace_id]
        arrival = min(s.start for s in group)
        prompt = cached = generated = 0
        priority = 1
        spec = 0.0
        saw_request = False
        for s in group:
            if s.stage == "prefill":
                saw_request = True
                prompt = max(prompt, int(s.attrs.get("prompt_tokens", 0) or 0))
                cached = max(cached, int(s.attrs.get("cached_tokens", 0) or 0))
            elif s.stage == "decode":
                saw_request = True
                generated += int(s.attrs.get("generated_tokens", 0) or 0)
                if s.attrs.get("priority") is not None:
                    priority = int(s.attrs["priority"])  # 0 = low is valid
                spec = float(s.attrs.get("spec_tokens_per_dispatch", 0.0) or 0.0)
            elif s.stage == "http_request":
                saw_request = True
        if not saw_request:
            continue
        b.observe_admit(prompt, cached, priority, arrival)
        if generated or any(s.stage == "decode" for s in group):
            b.observe_finish(generated, spec)
    return b.snapshot()


def fingerprint_from_trace(path: str) -> WorkloadFingerprint:
    """Build from a ``sim/workload.py`` JSONL trace."""
    from ..sim.workload import load_trace

    b = FingerprintBuilder()
    for req in load_trace(path):
        cached = min(req.prefix_len, req.prompt_len) if req.prefix_group >= 0 else 0
        b.observe_admit(req.prompt_len, cached, req.priority, req.arrival_s or 1e-9)
        b.observe_finish(req.max_tokens)
    return b.snapshot()


def fingerprint_from_bench(path: str) -> WorkloadFingerprint:
    """Coarse build from a bench capture: ``_isl<N>_`` / ``_osl<N>``
    markers in metric names, weighted by the line's request count."""
    import re

    from .bench_compare import load_bench_lines

    b = FingerprintBuilder()
    pat = re.compile(r"_isl(\d+)_osl(\d+)")
    for line in load_bench_lines(path):
        m = pat.search(str(line.get("metric", "")))
        if not m:
            continue
        isl, osl = int(m.group(1)), int(m.group(2))
        count = int(line.get("requests", 1) or 1)
        for _ in range(max(count, 1)):
            b.observe_admit(isl)
            b.observe_finish(osl)
    return b.snapshot()


# ---------------------------------------------------------------- sim bridge
def replay_workload(
    fp: WorkloadFingerprint,
    seed: int = 0,
    n: int | None = None,
    rate_rps: float | None = None,
):
    """Turn a fingerprint back into ``sim/workload.py`` requests: the
    fingerprint→sim seam. Lengths draw from the bucket histograms
    (uniform within a bucket), priorities from the measured mix,
    arrivals from an exponential process at the measured rate. Fully
    deterministic in ``seed``."""
    import random

    from ..sim.workload import SimRequest

    count = n if n is not None else max(fp.n, 1)
    rate = rate_rps if rate_rps is not None else (fp.arrival_rate_rps or 1.0)
    rate = max(rate, 1e-6)
    rng = random.Random(seed)

    def draw_len(hist: tuple, edges: tuple, fallback: int) -> int:
        total = sum(hist)
        if not total:
            return fallback
        pick = rng.randrange(total)
        for i, c in enumerate(hist):
            if pick < c:
                lo, hi = _bucket_bounds(i, edges)
                return rng.randint(lo, hi)
            pick -= c
        return fallback

    def draw_priority() -> int:
        if not sum(fp.priority_mix):
            return 1
        r = rng.random()
        acc = 0.0
        for p, frac in enumerate(fp.priority_mix):
            acc += frac
            if r < acc:
                return p
        return _N_PRIORITIES - 1

    out = []
    t = 0.0
    for i in range(count):
        t += rng.expovariate(rate)
        prompt_len = draw_len(fp.isl_hist, ISL_BUCKETS, 128)
        max_tokens = draw_len(fp.osl_hist, OSL_BUCKETS, 32)
        prefix_len = 0
        prefix_group = -1
        if fp.prefix_share > 0 and rng.random() < min(fp.prefix_share * 2, 1.0):
            # Approximate the measured shared-token share with a small
            # pool of prefix groups at share-proportional depth.
            prefix_group = rng.randrange(4)
            prefix_len = max(int(prompt_len * min(fp.prefix_share * 2, 0.9)), 0)
        out.append(
            SimRequest(
                index=i,
                arrival_s=round(t, 6),
                prompt_len=prompt_len,
                max_tokens=max_tokens,
                priority=draw_priority(),
                prefix_group=prefix_group,
                prefix_len=prefix_len,
            )
        )
    return out


# --------------------------------------------------------------------- drift
def _tv_distance(a: tuple, b: tuple) -> float:
    """Total-variation distance between two count histograms, in
    [0, 1]. Empty-vs-nonempty is maximal drift."""
    ta, tb = sum(a), sum(b)
    if not ta and not tb:
        return 0.0
    if not ta or not tb:
        return 1.0
    size = max(len(a), len(b))
    pa = [(a[i] if i < len(a) else 0) / ta for i in range(size)]
    pb = [(b[i] if i < len(b) else 0) / tb for i in range(size)]
    return 0.5 * sum(abs(x - y) for x, y in zip(pa, pb))


# One threshold, several consumers (the fleet view's DRIFT flag, the
# planner's config swap trigger): drift past it means "the pinned
# reference no longer describes live traffic, act".
DRIFT_ALERT_THRESHOLD = 0.25


def drift_score(live: WorkloadFingerprint, ref: WorkloadFingerprint) -> float:
    """Normalized [0, 1] distance between two fingerprints — the
    ``dynamo_workload_drift_score`` value. Equal-weight mean over the
    axes a tuner keys on: ISL shape, OSL shape, priority mix, prefix
    share, spec acceptance, and arrival-rate ratio (log-scaled, a 4x
    rate change saturates the axis)."""
    import math

    axes = [
        _tv_distance(live.isl_hist, ref.isl_hist),
        _tv_distance(live.osl_hist, ref.osl_hist),
        0.5 * sum(
            abs(x - y) for x, y in zip(live.priority_mix, ref.priority_mix)
        ),
        min(abs(live.prefix_share - ref.prefix_share), 1.0),
        min(abs(live.spec_accept - ref.spec_accept) / 4.0, 1.0),
    ]
    if live.arrival_rate_rps > 0 and ref.arrival_rate_rps > 0:
        axes.append(
            min(
                abs(math.log(live.arrival_rate_rps / ref.arrival_rate_rps))
                / math.log(4.0),
                1.0,
            )
        )
    return round(sum(axes) / len(axes), 4)


@dataclass
class WorkloadDriftWatch:
    """Live-vs-pinned drift: holds a reference fingerprint (e.g. loaded
    from ``DYN_WORKLOAD_REF``) and scores the live builder against it
    on demand. Score is 0.0 until both sides have data."""

    builder: FingerprintBuilder
    reference: WorkloadFingerprint | None = None
    min_n: int = 8  # don't score a handful of requests against a fleet
    _last: float = field(default=0.0, repr=False)

    def score(self) -> float:
        if self.reference is None:
            return 0.0
        live = self.builder.snapshot()
        if live.n < self.min_n:
            return self._last
        self._last = drift_score(live, self.reference)
        return self._last


def render_fingerprint(fp: WorkloadFingerprint) -> str:
    """Human-readable summary for ``llmctl fingerprint``."""

    def hist_line(hist: tuple, edges: tuple) -> str:
        total = sum(hist) or 1
        parts = []
        for i, c in enumerate(hist):
            if not c:
                continue
            lo, hi = _bucket_bounds(i, edges)
            label = f"<={edges[i]}" if i < len(edges) else f">{edges[-1]}"
            parts.append(f"{label}:{c / total:.0%}")
        return " ".join(parts) or "(empty)"

    mix = " ".join(
        f"{name}:{fp.priority_mix[p]:.0%}"
        for p, name in ((0, "low"), (1, "normal"), (2, "high"))
    )
    return "\n".join([
        f"workload fingerprint over {fp.n} request(s)  digest {fp.digest()[:16]}",
        f"  isl        {hist_line(fp.isl_hist, ISL_BUCKETS)}",
        f"  osl        {hist_line(fp.osl_hist, OSL_BUCKETS)}",
        f"  priority   {mix}",
        f"  prefix     {fp.prefix_share:.1%} of prompt tokens cache-hit",
        f"  spec       {fp.spec_accept:.2f} accepted tokens/dispatch",
        f"  arrivals   {fp.arrival_rate_rps:.2f} rps (cv {fp.arrival_cv:.2f}) "
        f"over {fp.duration_s:.1f}s",
    ])
