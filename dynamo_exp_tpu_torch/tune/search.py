"""Seeded sim-in-the-loop knob search.

Counterpart of ``dynamo_exp_tpu/tune/search.py``, the same search: for
one seed and budget the port writes the JAX package's journal, byte for
byte. Coordinate descent with a successive-halving rung over the
declarative knob space (:mod:`.space`): candidates are first scored on
one search seed (rung 0) and only challengers that beat the incumbent's
rung-0 score graduate to the full multi-seed evaluation (rung 1). Every
evaluation is one :class:`~dynamo_exp_tpu_torch.sim.cluster.ClusterSim`
run replaying the workload target: a workload fingerprint through
:func:`~dynamo_exp_tpu_torch.telemetry.fingerprint.replay_workload`, a
trace file, or a named synthetic workload.

Determinism contract: no wall clocks, every random draw comes from
``random.Random(seed)``, and the JSONL trial journal is byte-identical
across same-seed runs, which is what makes a run resumable: a truncated
journal replays as an evaluation cache and the search rewrites the
identical uninterrupted journal.

The composite objective scores goodput per chip-second (an instance's
card-second here), discounted by p99 TTFT/ITL SLO compliance, so a
config that buys throughput by blowing latency targets (or by holding an
overscaled fleet) loses to one that serves the same tokens inside the
SLO envelope for fewer card-seconds.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field

from ..planner.planner import PlannerConfig
from ..planner.policy import SloTargets
from ..sim.cluster import ClusterSim, SimConfig
from ..sim.fit import ServiceTimeModel
from ..telemetry.fingerprint import (
    WorkloadFingerprint,
    fingerprint_from_trace,
    replay_workload,
)
from . import space

JOURNAL_VERSION = 1


# ------------------------------------------------------------------ target
@dataclass(frozen=True)
class TuneTarget:
    """The workload the search optimizes for. ``fingerprint`` targets
    replay through the fingerprint's sim bridge; synthetic targets
    generate from the named ``sim/workload.py`` scenario."""

    kind: str  # "fingerprint" | "synthetic"
    fingerprint: WorkloadFingerprint | None = None
    name: str = ""  # synthetic scenario name
    requests: int = 64
    rate_rps: float | None = None
    duration_s: float = 60.0

    @property
    def digest(self) -> str:
        if self.fingerprint is not None:
            return self.fingerprint.digest()
        return f"synthetic:{self.name}"

    def workload(self, seed: int) -> list:
        if self.fingerprint is not None:
            return replay_workload(
                self.fingerprint,
                seed=seed,
                n=self.requests,
                rate_rps=self.rate_rps,
            )
        from ..sim import workload as wl

        if self.name == "burst":
            return wl.burst_workload(seed, n=self.requests)
        if self.name == "ramp":
            return wl.ramp_workload(
                seed,
                duration_s=self.duration_s,
                rps_start=self.rate_rps or 1.0,
                rps_end=(self.rate_rps or 1.0) * 4,
            )
        if self.name == "diurnal":
            return wl.diurnal_workload(
                seed,
                duration_s=self.duration_s,
                rps_base=self.rate_rps or 1.0,
                rps_peak=(self.rate_rps or 1.0) * 4,
            )
        if self.name == "users":
            return list(
                wl.synthetic_users(
                    seed, users=self.requests, duration_s=self.duration_s
                )
            )
        raise ValueError(f"unknown synthetic workload {self.name!r}")


def target_from_fingerprint(
    fp: WorkloadFingerprint,
    requests: int | None = None,
    rate_rps: float | None = None,
) -> TuneTarget:
    return TuneTarget(
        kind="fingerprint",
        fingerprint=fp,
        requests=requests or max(fp.n, 16),
        rate_rps=rate_rps,
    )


def target_from_trace(
    path: str, requests: int | None = None, rate_rps: float | None = None
) -> TuneTarget:
    """Trace files target through their fingerprint (same bridge, so a
    span capture and its fingerprint file tune identically)."""
    return target_from_fingerprint(
        fingerprint_from_trace(path), requests=requests, rate_rps=rate_rps
    )


# --------------------------------------------------------------- objective
def composite_objective(report) -> dict:
    """Score one sim run. ``goodput_per_chip_s`` is SLO-goodput tokens
    per chip-second (the spend-normalized throughput axis);
    ``score`` discounts it by the TTFT and ITL compliance fractions,
    so capacity bought by blowing p99 targets doesn't count."""
    completed = max(report.completed, 1)
    ttft_ok = 1.0 - min(report.slo_violations_ttft / completed, 1.0)
    itl_ok = 1.0 - min(report.slo_violations_itl / completed, 1.0)
    chip_s = max(report.chip_seconds, 1e-6)
    goodput_tokens = report.goodput_tok_s * report.duration_s
    goodput_per_chip_s = goodput_tokens / chip_s
    return {
        "score": round(goodput_per_chip_s * ttft_ok * itl_ok, 6),
        "goodput_tok_s": report.goodput_tok_s,
        "goodput_per_chip_s": round(goodput_per_chip_s, 4),
        "ttft_compliance": round(ttft_ok, 4),
        "itl_compliance": round(itl_ok, 4),
        "ttft_p99_s": report.ttft_p99_s,
        "itl_p99_s": report.itl_p99_s,
        "chip_seconds": report.chip_seconds,
        "completed": report.completed,
        "shed": report.shed,
        "preemptions": report.preemptions,
    }


# ------------------------------------------------------------------ search
@dataclass
class SearchSettings:
    """Everything one search run depends on, journaled for audit."""

    seed: int = 0
    budget: int = 64  # max sim evaluations (rung-0 + rung-1 both count)
    eval_seeds: int = 2  # seeds per full (rung-1) evaluation
    planner: bool = False  # run the SLO planner; include its knobs
    # Deployment envelope: SimConfig keyword overrides the search does
    # NOT tune (fleet size, service model riding separately).
    base_sim: dict = field(default_factory=dict)
    slo: SloTargets | None = None
    service: ServiceTimeModel | None = None

    def header(self, target: TuneTarget) -> dict:
        return {
            "kind": "header",
            "v": JOURNAL_VERSION,
            "space": space.space_digest(),
            "seed": self.seed,
            "budget": self.budget,
            "eval_seeds": self.eval_seeds,
            "planner": self.planner,
            "base_sim": {k: self.base_sim[k] for k in sorted(self.base_sim)},
            "target": target.digest,
            "requests": target.requests,
        }


@dataclass
class TuneResult:
    best_overrides: dict
    best_score: float
    default_score: float
    trials: int
    journal: list  # every journal line, header included
    target_digest: str
    seed: int

    @property
    def improvement(self) -> float:
        if self.default_score <= 0:
            return 0.0
        return round(self.best_score / self.default_score - 1.0, 4)


def evaluate(
    overrides: dict,
    target: TuneTarget,
    settings: SearchSettings,
    seed: int,
    workload: list | None = None,
) -> dict:
    """One sim run of one candidate on one seed -> objective dict.

    ``workload`` pins an explicit request list (the validation stage
    feeds both sim and live the same one); otherwise the target
    generates it from the seed."""
    split = space.split_overrides(overrides)
    kwargs = dict(settings.base_sim)
    kwargs.update(space.sim_kwargs_from_overrides(overrides))
    slo = settings.slo or SloTargets()
    if settings.planner:
        if split["slo"]:
            from dataclasses import replace

            slo = replace(slo, **split["slo"])
        kwargs.setdefault("planner", "slo")
        kwargs.setdefault("admission_per_instance", True)
        kwargs["planner_cfg"] = PlannerConfig(**split["planner"])
    cfg = SimConfig(
        seed=seed,
        record_events=False,
        service=settings.service or ServiceTimeModel.default(),
        slo=slo,
        **kwargs,
    )
    if workload is None:
        workload = target.workload(seed)
    report = ClusterSim(cfg, workload).run()
    return composite_objective(report)


def _eval_seed(base_seed: int, i: int) -> int:
    """The search's evaluation seeds: a fixed affine family so held-out
    tests can pick seeds provably outside it."""
    return base_seed * 1000 + i


def _canon(overrides: dict) -> str:
    return json.dumps(overrides, sort_keys=True, separators=(",", ":"))


def load_journal(path: str) -> list[dict]:
    """Parse a (possibly truncated) journal; a half-written trailing
    line is dropped, not an error — that is exactly the resume case."""
    out = []
    try:
        with open(path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    out.append(json.loads(raw))
                except ValueError:
                    break  # torn tail write; everything before it counts
    except FileNotFoundError:
        pass
    return out


def top_candidates(result: TuneResult, k: int) -> list[dict]:
    """The k best distinct configs the search fully evaluated (rung 1),
    best first — the validation stage's input. The default config is
    itself a rung-1 trial, so it competes for a slot like any other."""
    seen: set[str] = set()
    out: list[dict] = []
    trials = [
        ln
        for ln in result.journal
        if ln.get("kind") == "trial" and ln.get("rung") == 1
    ]
    for ln in sorted(trials, key=lambda t: -t["score"]):
        key = _canon(ln["overrides"])
        if key in seen:
            continue
        seen.add(key)
        out.append(dict(ln["overrides"]))
        if len(out) >= k:
            break
    return out


def run_search(
    target: TuneTarget,
    settings: SearchSettings,
    journal_path: str | None = None,
    resume: bool = False,
) -> TuneResult:
    """Coordinate descent over the sim-applicable knob grids.

    Pass structure: knob order is drawn once per pass from the seeded
    rng; each off-default grid value is scored at rung 0 (one seed) and
    promoted to the full rung only if it beats the incumbent's rung-0
    score. Passes repeat until a full pass yields no improvement or the
    trial budget is spent.

    ``resume`` replays an existing journal as an evaluation cache: the
    deterministic search path re-derives every decision, cache hits
    skip the sim run, and the rewritten journal is byte-identical to an
    uninterrupted run's.
    """
    knobs = space.sim_knobs(planner=settings.planner)
    rng = random.Random(settings.seed)
    header = settings.header(target)

    cache: dict[tuple[str, int], dict] = {}
    if resume and journal_path:
        prior = load_journal(journal_path)
        if prior and prior[0].get("kind") == "header":
            stale = {
                k: (prior[0].get(k), header[k])
                for k in ("space", "seed", "budget", "target")
                if prior[0].get(k) != header[k]
            }
            if stale:
                raise ValueError(
                    f"journal {journal_path} was written by a different "
                    f"run; mismatched fields: {stale}"
                )
            for line in prior[1:]:
                if line.get("kind") == "trial":
                    for s, comp in zip(line["seeds"], line["evals"]):
                        cache[(_canon(line["overrides"]), s)] = comp

    journal: list[dict] = [header]
    out = open(journal_path, "w") if journal_path else None

    def emit(line: dict) -> None:
        journal.append(line)
        if out is not None:
            out.write(json.dumps(line, sort_keys=True) + "\n")
            out.flush()

    if out is not None:
        out.write(json.dumps(header, sort_keys=True) + "\n")
        out.flush()

    trials = 0

    def run_eval(overrides: dict, seeds: list[int]) -> tuple[float, list]:
        evals = []
        for s in seeds:
            key = (_canon(overrides), s)
            if key not in cache:
                cache[key] = evaluate(overrides, target, settings, s)
            evals.append(cache[key])
        mean = round(sum(e["score"] for e in evals) / len(evals), 6)
        return mean, evals

    full_seeds = [
        _eval_seed(settings.seed, i) for i in range(settings.eval_seeds)
    ]
    rung0_seed = [full_seeds[0]]

    try:
        current: dict = {}
        best_score, evals = run_eval(current, full_seeds)
        best_r0 = evals[0]["score"]
        trials += 1
        emit({
            "kind": "trial", "i": trials, "overrides": current,
            "rung": 1, "seeds": full_seeds, "evals": evals,
            "score": best_score, "best": True,
        })
        default_score = best_score

        improved_any = True
        while improved_any and trials < settings.budget:
            improved_any = False
            order = list(knobs)
            rng.shuffle(order)
            for knob in order:
                if trials >= settings.budget:
                    break
                incumbent = current.get(knob.name, space.default_value(knob))
                for value in knob.grid:
                    if value == incumbent or trials >= settings.budget:
                        continue
                    cand = {
                        k: v for k, v in current.items() if k != knob.name
                    }
                    if value != space.default_value(knob):
                        cand[knob.name] = value
                    s0, evals0 = run_eval(cand, rung0_seed)
                    trials += 1
                    promoted = s0 > best_r0
                    emit({
                        "kind": "trial", "i": trials, "overrides": cand,
                        "rung": 0, "seeds": rung0_seed, "evals": evals0,
                        "score": s0, "best": False,
                        "promoted": promoted,
                    })
                    if not promoted or trials >= settings.budget:
                        continue
                    s_full, evals_full = run_eval(cand, full_seeds)
                    trials += 1
                    adopt = s_full > best_score
                    emit({
                        "kind": "trial", "i": trials, "overrides": cand,
                        "rung": 1, "seeds": full_seeds,
                        "evals": evals_full, "score": s_full,
                        "best": adopt,
                    })
                    if adopt:
                        current = cand
                        best_score = s_full
                        best_r0 = evals_full[0]["score"]
                        incumbent = current.get(
                            knob.name, space.default_value(knob)
                        )
                        improved_any = True

        emit({
            "kind": "result",
            "best_overrides": {k: current[k] for k in sorted(current)},
            "best_score": best_score,
            "default_score": default_score,
            "trials": trials,
            "target": target.digest,
        })
    finally:
        if out is not None:
            out.close()

    return TuneResult(
        best_overrides={k: current[k] for k in sorted(current)},
        best_score=best_score,
        default_score=default_score,
        trials=trials,
        journal=journal,
        target_digest=target.digest,
        seed=settings.seed,
    )
