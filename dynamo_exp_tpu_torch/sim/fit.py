"""Service-time models fitted from real telemetry.

Counterpart of ``dynamo_exp_tpu/sim/fit.py``, the same fits. The port's
engine records what the span fit reads: ``prefill`` spans with
``prompt_tokens`` and ``cached_tokens``, ``decode`` spans with
``generated_tokens`` and the dispatch profiler's ``dispatch_p50_s``,
``host_gap_p50_s`` and ``decode_window`` (``engine/scheduler.py``,
``telemetry/dispatch.py``). Bench lines keep the JAX dispatch kinds
(``ragged``, then the older ``decode``) and also read the port's
``window`` kind, so a JAX bench file and a port one both fit.

The simulator's instances don't compute anything — they hold a request
for as long as the real engine would have. Those holds come from a
:class:`ServiceTimeModel`, fitted from whichever telemetry the repo has
actually produced:

- **span JSONL** (the telemetry recorder's ``{"ts", "event"}`` lines,
  ``DYN_TRACE_FILE`` / ``--trace-file``, or bare span objects):
  ``prefill`` spans carry ``prompt_tokens`` and a
  duration → per-prompt-token prefill time; ``decode`` spans carry
  ``generated_tokens`` → inter-token latency (ITL).
- **BENCH JSON** (``bench.py`` output, or ``BENCH_r*.json``
  wrappers with a ``parsed`` record): ``decode_throughput_*_c{N}``
  lines give aggregate tok/s at concurrency N → per-row ITL = N/tok_s;
  ``p50_ttft_s`` over the metric's ISL gives prefill per token. Lines
  without a concurrency-tagged throughput metric fall back to their
  per-kind ``dispatch`` percentiles (every bench line carries them):
  the ``ragged`` kind's (in-flight + host-gap) p50 over
  ``decode_window`` tokens — pre-ragged bench files carry the old
  ``decode`` kind, which is read as a fallback, so existing
  ``BENCH_r*.json`` records stay fittable. Decode spans carrying
  dispatch-profiler attrs contribute the same per-window samples
  directly.

Latencies are modeled lognormal (service times are multiplicative:
right-skewed, never negative) around the fitted median; draws come from
the simulation's seeded ``random.Random`` so runs stay deterministic.
When no telemetry is available, :meth:`ServiceTimeModel.default` gives
round numbers in the right ratios (prefill ~10x cheaper per token than
decode per-token, both ms-scale) — calibration tests use exact-count
invariants, not absolute latencies, so defaults are fine there.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable


@dataclass
class LatencyDist:
    """Lognormal latency around a median: ``median * exp(sigma * z)``.
    ``sigma=0`` degenerates to a constant — the calibration suites use
    that for exactly reproducible timings."""

    median_s: float
    sigma: float = 0.0

    def sample(self, rng) -> float:
        if self.sigma <= 0.0:
            return self.median_s
        return self.median_s * math.exp(self.sigma * rng.gauss(0.0, 1.0))

    @classmethod
    def fit(cls, samples: Iterable[float]) -> "LatencyDist":
        logs = [math.log(s) for s in samples if s > 0.0]
        if not logs:
            raise ValueError("no positive samples to fit")
        mu = sum(logs) / len(logs)
        var = sum((x - mu) ** 2 for x in logs) / len(logs)
        return cls(median_s=math.exp(mu), sigma=math.sqrt(var))


@dataclass
class ServiceTimeModel:
    """How long a modeled instance holds work.

    ``batch_congestion`` captures the occupancy cost the engine's
    row-compacted decode actually shows (docs/engine_perf.md): per-row
    ITL at full occupancy is ``(1 + batch_congestion)`` times the
    single-row ITL, interpolated linearly in between. Decode is
    memory-bound and row-compaction keeps cost ∝ occupancy, so the slope
    is mild — but it is what makes "more load on one instance" cost
    something, which routing and scaling policies need to see."""

    prefill_token_s: LatencyDist = field(
        default_factory=lambda: LatencyDist(0.002)
    )
    prefill_floor_s: float = 0.01  # dispatch floor for tiny prompts
    itl_s: LatencyDist = field(default_factory=lambda: LatencyDist(0.02))
    batch_congestion: float = 0.25
    # Worker add → serving (the planner's SloTargets.provision_s hint).
    # Fitted from ``bench.py --coldstart-sweep`` lines, which tag each
    # sample ``prewarmed: true|false`` (docs/aot.md): warm (prewarmed)
    # samples win when present — a fleet that warm-boots its instances
    # must plan with the warm landing delay, not the cold one.
    provision_s: float = 2.0
    # Predictive KV tiering (docs/engine_perf.md "Predictive KV
    # tiering"): host→device restore cost per page when a proactively
    # offloaded row swaps back in (one batched scatter per row; the
    # per-page slope is what a bigger context pays).
    restore_s_per_page: float = 0.0005
    # Speculative decoding (docs/speculative.md): tokens emitted per
    # decode dispatch per row (accepted draft prefix + correction).
    # ``itl_s`` is normalized to the per-*dispatch* interval — equal to
    # the per-token interval when speculation is off, and the span
    # fitter multiplies a spec-on span's per-token ITL back up by its
    # own measured factor (see ``_span_samples``) so the factor is
    # never baked into ``itl_s`` twice. ``decode_itl`` then divides by
    # this fitted factor once. 1.0 = speculation off. Learned from
    # spec-tagged bench lines (``tokens_per_dispatch``) or decode spans
    # (``spec_tokens_per_dispatch`` attr).
    spec_tokens_per_dispatch: float = 1.0

    def prefill_time(self, prompt_tokens: int, rng) -> float:
        return self.prefill_floor_s + prompt_tokens * self.prefill_token_s.sample(
            rng
        )

    def decode_itl(self, rows: int, slots: int, rng) -> float:
        """Per-token interval for one row when ``rows`` of ``slots``
        slots are occupied (sampled once per decode round per row)."""
        base = self.itl_s.sample(rng)
        if slots > 1:
            fill = (max(rows, 1) - 1) / max(slots - 1, 1)
            base = base * (1.0 + self.batch_congestion * fill)
        return base / max(self.spec_tokens_per_dispatch, 1.0)

    def planner_hints(self) -> dict:
        """Fitted per-worker service rates the SLO planner can budget
        with (tokens/s at median latency, congestion-free)."""
        spec = max(self.spec_tokens_per_dispatch, 1.0)
        return {
            "decode_tokens_per_s": spec / max(self.itl_s.median_s, 1e-9),
            "prefill_tokens_per_s": 1.0
            / max(self.prefill_token_s.median_s, 1e-9),
            "provision_s": self.provision_s,
        }

    # ------------------------------------------------------------ fitting
    @classmethod
    def default(cls) -> "ServiceTimeModel":
        return cls()

    @classmethod
    def from_spans(cls, paths: Iterable[str | Path]) -> "ServiceTimeModel":
        """Fit from telemetry recorder JSONL (span events)."""
        prefill_per_token, itl, tpd = _span_samples(paths)
        model = cls.default()
        if prefill_per_token:
            model.prefill_token_s = LatencyDist.fit(prefill_per_token)
        if itl:
            model.itl_s = LatencyDist.fit(itl)
        if tpd:
            model.spec_tokens_per_dispatch = _median(tpd)
        return model

    @classmethod
    def from_bench_json(
        cls, paths: Iterable[str | Path]
    ) -> "ServiceTimeModel":
        """Fit from ``bench.py`` JSON lines, or a
        ``BENCH_r*.json`` wrapper (a dict with a ``parsed`` record)."""
        prefill_per_token, itl, tpd, provision = _bench_samples(paths)
        model = cls.default()
        if itl:
            model.itl_s = LatencyDist.fit(itl)
        if prefill_per_token:
            model.prefill_token_s = LatencyDist.fit(prefill_per_token)
        if tpd:
            model.spec_tokens_per_dispatch = _median(tpd)
        _fit_provision(model, provision)
        return model

    @classmethod
    def from_telemetry(
        cls,
        span_paths: Iterable[str | Path] = (),
        bench_paths: Iterable[str | Path] = (),
    ) -> "ServiceTimeModel":
        """Spans win where both sources speak (they are per-request
        measurements; bench numbers are aggregates)."""
        bench_p, bench_i, bench_t, bench_prov = (
            _bench_samples(bench_paths) if bench_paths else ([], [], [], [])
        )
        span_p, span_i, span_t = (
            _span_samples(span_paths) if span_paths else ([], [], [])
        )
        model = cls.default()
        prefill = span_p or bench_p
        itl = span_i or bench_i
        tpd = span_t or bench_t
        if prefill:
            model.prefill_token_s = LatencyDist.fit(prefill)
        if itl:
            model.itl_s = LatencyDist.fit(itl)
        if tpd:
            model.spec_tokens_per_dispatch = _median(tpd)
        _fit_provision(model, bench_prov)
        return model


def _median(samples: list[float]) -> float:
    s = sorted(samples)
    return s[len(s) // 2]


def _fit_provision(
    model: ServiceTimeModel, samples: list[tuple[bool, float]]
) -> None:
    """Fold ``(prewarmed, provision_s)`` samples from coldstart bench
    lines into the model: warm-boot samples win over cold ones (a fleet
    that prewarms plans with the warm landing delay; the cold samples
    are its baseline, not its operating point)."""
    warm = [s for pre, s in samples if pre]
    cold = [s for pre, s in samples if not pre]
    chosen = warm or cold
    if chosen:
        model.provision_s = _median(chosen)


def _span_samples(
    paths: Iterable[str | Path],
) -> tuple[list[float], list[float], list[float]]:
    prefill_per_token: list[float] = []
    itl: list[float] = []
    tpd: list[float] = []
    for path in paths:
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            # The recorder writes {"ts": ..., "event": {span}}; a bare
            # span object (the JAX fit's only input) reads as it is.
            if isinstance(ev.get("event"), dict):
                ev = ev["event"]
            if ev.get("type") != "span":
                continue
            dur = float(ev.get("end", 0.0)) - float(ev.get("start", 0.0))
            attrs = ev.get("attrs") or {}
            if ev.get("stage") == "prefill" and dur > 0:
                toks = int(attrs.get("prompt_tokens") or 0) - int(
                    attrs.get("cached_tokens") or 0
                )
                if toks > 0:
                    prefill_per_token.append(dur / toks)
            elif ev.get("stage") == "decode" and dur > 0:
                # The span runs first-token -> finish and
                # generated_tokens counts the first token, so the
                # duration covers toks-1 inter-token intervals (same
                # convention as the sim's own ITL report).
                toks = int(attrs.get("generated_tokens") or 0)
                spec = attrs.get("spec_tokens_per_dispatch")
                spec_on = isinstance(spec, (int, float)) and spec > 0
                # Dispatch-profiler attrs (docs/observability.md): the
                # engine's median per-window (dispatch + host gap) time
                # over decode_window tokens is a direct per-token ITL
                # sample — unlike the wall duration it excludes queue
                # wait and stalls. It REPLACES the duration-derived
                # sample for spans that carry it (adding both would
                # blend two populations and let the repeated engine-wide
                # median swamp the fit).
                dp = attrs.get("dispatch_p50_s")
                win = attrs.get("decode_window")
                if (
                    isinstance(dp, (int, float))
                    and dp > 0
                    and isinstance(win, (int, float))
                    and win >= 1
                ):
                    gap = attrs.get("host_gap_p50_s") or 0.0
                    itl.append((float(dp) + float(gap)) / float(win))
                elif toks > 1:
                    # Normalize to the per-DISPATCH interval: a spec-on
                    # span's per-token ITL already embeds the multi-
                    # token speedup, and decode_itl() divides by the
                    # fitted factor — without the multiply here the
                    # speedup would be counted twice.
                    itl.append(
                        dur / (toks - 1) * (float(spec) if spec_on else 1.0)
                    )
                if spec_on:
                    tpd.append(float(spec))
    return prefill_per_token, itl, tpd


def _bench_samples(
    paths: Iterable[str | Path],
) -> tuple[
    list[float], list[float], list[float], list[tuple[bool, float]]
]:
    itl: list[float] = []
    prefill_per_token: list[float] = []
    tpd: list[float] = []
    provision: list[tuple[bool, float]] = []
    for path in paths:
        text = Path(path).read_text().strip()
        records: list[dict] = []
        try:
            doc = json.loads(text)
            if isinstance(doc, dict):
                parsed = doc.get("parsed")
                if isinstance(parsed, dict):
                    records.append(parsed)
                elif "metric" in doc:
                    records.append(doc)
            elif isinstance(doc, list):
                records.extend(d for d in doc if isinstance(d, dict))
        except json.JSONDecodeError:
            for line in text.splitlines():
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(d, dict):
                    records.append(d)
        for rec in records:
            metric = str(rec.get("metric", ""))
            value = rec.get("value")
            if not metric or not isinstance(value, (int, float)):
                continue
            if value <= 0:
                continue
            # Coldstart lines (bench.py --coldstart-sweep): every line
            # carries ``prewarmed: bool`` + ``provision_s`` so the fit
            # can tell a warm-boot landing delay from a cold one
            # (docs/aot.md). These lines have no throughput metric —
            # fall through so their dispatch percentiles still fit ITL.
            prov = rec.get("provision_s")
            if isinstance(prov, (int, float)) and prov > 0:
                provision.append((bool(rec.get("prewarmed")), float(prov)))
            m = re.search(r"_c(\d+)$", metric) or re.search(
                r"_a(\d+)of\d+$", metric
            )
            conc = int(m.group(1)) if m else None
            throughput_line = metric.startswith(
                ("decode_throughput", "decode_occupancy")
            ) and bool(conc)
            if throughput_line:
                itl.append(conc / float(value))
            else:
                # Per-kind dispatch percentiles (bench.py attaches them
                # to every line): (in-flight + host-gap) p50 over the
                # line's decode_window is a per-token ITL sample — the
                # fallback that fits service times from lines with no
                # concurrency-tagged throughput metric. The ragged
                # engine emits kind="ragged", the port's engine
                # kind="window"; pre-ragged BENCH_r*.json lines carry the
                # old "decode" kind and stay fittable.
                dispatch = rec.get("dispatch") or {}
                disp = (
                    dispatch.get("ragged")
                    or dispatch.get("window")
                    or dispatch.get("decode")
                    or {}
                )
                flight = disp.get("in_flight_p50_s")
                win = rec.get("decode_window")
                if (
                    isinstance(flight, (int, float))
                    and flight > 0
                    and isinstance(win, (int, float))
                    and win >= 1
                ):
                    gap = disp.get("host_gap_p50_s") or 0.0
                    itl.append((float(flight) + float(gap)) / float(win))
            ttft = rec.get("p50_ttft_s")
            isl_m = re.search(r"_isl(\d+)", metric)
            if (
                isinstance(ttft, (int, float))
                and ttft > 0
                and isl_m is not None
            ):
                prefill_per_token.append(float(ttft) / int(isl_m.group(1)))
            # Spec-sweep lines (``bench.py --spec-sweep``) carry the
            # measured tokens-per-dispatch; speculation-off lines carry
            # None, which is correctly skipped here.
            spec = rec.get("tokens_per_dispatch")
            if metric.startswith("spec_decode") and isinstance(
                spec, (int, float)
            ) and spec > 0:
                tpd.append(float(spec))
    return prefill_per_token, itl, tpd, provision
