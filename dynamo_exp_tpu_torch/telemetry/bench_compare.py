"""Bench regression comparator (``llmctl bench compare A.json B.json``).

Counterpart of ``dynamo_exp_tpu/telemetry/bench_compare.py``. Compares
two bench captures (raw ``bench.py`` JSONL, or the ``BENCH_r*.json``
wrappers ``{"n", "cmd", "rc", "tail", "parsed"}``) metric by metric and
flags regressions: a ``tok/s`` value falling more than the threshold,
or a latency field (``*ttft*``, ``*itl*``, ``*latency*`` ending ``_s``)
or an anatomy component growing more than it. A pair of lines tagged
with different platforms (a chip against a CPU run) or knob configs is
skipped, never flagged; captures with no comparable pair compare clean.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


def load_bench_lines(path: str) -> list[dict]:
    """Every bench metric line in ``path``. Accepts raw bench JSONL
    (one metric object per line) and the BENCH_r* wrapper shape (metric
    lines recovered from ``parsed`` + the stdout ``tail``). Unparseable
    lines are skipped — a crashed run yields [] rather than an error."""
    with open(path) as f:
        text = f.read()
    lines: list[dict] = []
    seen: set[str] = set()

    def add(obj) -> None:
        if isinstance(obj, dict) and obj.get("metric"):
            key = json.dumps(obj, sort_keys=True)
            if key not in seen:
                seen.add(key)
                lines.append(obj)

    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and ("tail" in doc or "parsed" in doc):
        add(doc.get("parsed"))
        for raw in str(doc.get("tail", "")).splitlines():
            raw = raw.strip()
            if raw.startswith("{"):
                try:
                    add(json.loads(raw))
                except ValueError:
                    continue
        return lines
    if isinstance(doc, dict):
        add(doc)
        return lines
    if isinstance(doc, list):
        for obj in doc:
            add(obj)
        return lines
    for raw in text.splitlines():
        raw = raw.strip()
        if raw.startswith("{"):
            try:
                add(json.loads(raw))
            except ValueError:
                continue
    return lines


_LATENCY_MARKERS = ("ttft", "itl", "latency")


def _latency_fields(line: dict) -> dict[str, float]:
    out = {}
    for key, val in line.items():
        if not isinstance(val, (int, float)):
            continue
        if any(m in key for m in _LATENCY_MARKERS) and key.endswith("_s"):
            out[key] = float(val)
    return out


@dataclass
class Finding:
    metric: str
    field: str
    old: float
    new: float
    change: float  # signed fraction (+ = grew)
    kind: str  # "regression" | "improvement" | "skipped"
    note: str = ""


@dataclass
class CompareReport:
    findings: list[Finding] = field(default_factory=list)
    compared: int = 0
    skipped: list[str] = field(default_factory=list)

    @property
    def regressions(self) -> list[Finding]:
        return [f for f in self.findings if f.kind == "regression"]

    @property
    def ok(self) -> bool:
        return not self.regressions


def compare_bench(
    old_lines: list[dict],
    new_lines: list[dict],
    threshold: float = 0.10,
) -> CompareReport:
    """Flag per-metric regressions beyond ``threshold`` (default 10%).

    Only metrics present in BOTH captures compare; a platform-tag
    mismatch (chip vs CPU-fallback line) skips the pair with a note.
    Lines carrying a ``config_hash`` (the tuner's knob stamp) pair by
    (metric, config_hash) — a run knobbed differently is a different
    experiment, skipped rather than flagged as a regression; untagged
    legacy lines keep pairing by metric alone. Throughput compares on
    ``value`` for ``tok/s`` lines (lower = worse); every
    ``*ttft*``/``*itl*`` latency field compares too (higher = worse)."""
    report = CompareReport()
    by_metric = {ln["metric"]: ln for ln in old_lines}
    by_config = {
        (ln["metric"], ln["config_hash"]): ln
        for ln in old_lines
        if ln.get("config_hash")
    }
    for new in new_lines:
        old = by_config.get((new["metric"], new.get("config_hash")))
        if old is None:
            old = by_metric.get(new["metric"])
        if old is None:
            continue
        h_old = old.get("config_hash")
        h_new = new.get("config_hash")
        if h_old and h_new and h_old != h_new:
            report.skipped.append(
                f"{new['metric']}: knob config {h_old} vs {h_new} — "
                f"differently-tuned runs, not comparable"
            )
            continue
        p_old = old.get("platform")
        p_new = new.get("platform")
        if p_old != p_new:
            report.skipped.append(
                f"{new['metric']}: platform {p_old or 'untagged'} vs "
                f"{p_new or 'untagged'} — not comparable"
            )
            continue
        report.compared += 1

        def judge(fld: str, a: float, b: float, higher_is_worse: bool,
                  metric: str = new["metric"]) -> None:
            if a <= 0:
                return
            change = (b - a) / a
            worse = change > threshold if higher_is_worse else (
                change < -threshold
            )
            better = change < -threshold if higher_is_worse else (
                change > threshold
            )
            kind = (
                "regression" if worse else "improvement" if better else None
            )
            if kind:
                report.findings.append(
                    Finding(metric, fld, a, b, round(change, 4), kind)
                )

        unit = str(old.get("unit") or "")
        if unit.endswith("tok/s") and isinstance(
            new.get("value"), (int, float)
        ) and isinstance(old.get("value"), (int, float)):
            judge(f"value({unit})", float(old["value"]), float(new["value"]),
                  higher_is_worse=False)
        # Spot-reclamation sweep fields (bench.py --reclaim-sweep):
        # billed chip-seconds are the spot-economics denominator
        # (growing spend at equal goodput is a regression), the
        # migrated fraction is the live-migration hit rate (falling
        # means more journal re-prefill), and goodput per billed
        # chip-second is the headline ratio the sweep exists for.
        for fld, worse_high in (
            ("billed_chip_seconds", True),
            ("migrated_fraction", False),
            ("goodput_per_billed_chip_s", False),
        ):
            a_v, b_v = old.get(fld), new.get(fld)
            if isinstance(a_v, (int, float)) and isinstance(
                b_v, (int, float)
            ):
                judge(fld, float(a_v), float(b_v),
                      higher_is_worse=worse_high)
        lat_old, lat_new = _latency_fields(old), _latency_fields(new)
        for fld in sorted(set(lat_old) & set(lat_new)):
            judge(fld, lat_old[fld], lat_new[fld], higher_is_worse=True)
        # Per-request anatomy components (bench.py _anatomy_stats, mean
        # seconds per finished request): attribute a latency regression
        # to the component that moved. Seconds spent — higher is worse.
        an_old = old.get("anatomy") or {}
        an_new = new.get("anatomy") or {}
        for fld in sorted(set(an_old) & set(an_new)):
            a_v, b_v = an_old[fld], an_new[fld]
            if isinstance(a_v, (int, float)) and isinstance(
                b_v, (int, float)
            ):
                judge(f"anatomy.{fld}", float(a_v), float(b_v),
                      higher_is_worse=True)
    return report


def render_compare(report: CompareReport, a: str, b: str) -> str:
    lines = [
        f"bench compare: {a} -> {b}  "
        f"({report.compared} comparable metric(s), "
        f"{len(report.skipped)} skipped)"
    ]
    for f in report.findings:
        arrow = "REGRESSION" if f.kind == "regression" else "improvement"
        lines.append(
            f"  {arrow}: {f.metric} {f.field} "
            f"{f.old:g} -> {f.new:g} ({f.change:+.1%})"
        )
    for note in report.skipped:
        lines.append(f"  skipped: {note}")
    if report.compared == 0:
        lines.append(
            "  no comparable metrics (failed runs or disjoint modes) — "
            "nothing to flag"
        )
    elif report.ok:
        lines.append("  no regressions beyond threshold")
    return "\n".join(lines)
