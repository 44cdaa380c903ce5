"""Pure planner decision logic: ``plan_step`` and friends.

Counterpart of ``dynamo_exp_tpu/planner/policy.py``, decision for
decision: the live :class:`~dynamo_exp_tpu_torch.planner.planner.Planner`
loop drives these pure functions of an observation and a state (no
asyncio, no coordinator, no wall clock), so a scaling decision is
testable in microseconds. The card budget speaks GPUs
(``max_gpu_budget``, ``decode_engine_num_gpu``,
``prefill_engine_num_gpu``) where the JAX package speaks TPU chips.

Two policies:

- :func:`plan_step`, the reactive threshold loop: scale-down checks
  before scale-up, a decode grace period after an add, prefill scale-up
  gated on the queue trend staying above threshold, a hard card budget.
- :func:`plan_step_slo`, SLO-driven predictive scaling: forecasts
  per-worker KV load and queue depth along their observed linear trends
  and sizes the fleet to keep p99 TTFT / ITL under explicit targets. It
  can add (and remove) more than one worker a round, bounded by
  ``max_scale_step`` and the card budget.

A :class:`Decision` is a plan, not an effect: the caller applies each
:class:`ScaleAction` through its connector and folds what happened back
into state: when a proposed decode add lands, it applies
:func:`arm_decode_grace` (arming the grace period for a worker that
never spawned would pin an overscaled fleet for the whole window).
Budget accounting inside a step assumes the proposed actions succeed; a
connector failure wastes a round (the next observation re-derives the
fleet from discovery).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..telemetry.fingerprint import (
    DRIFT_ALERT_THRESHOLD,
    WorkloadFingerprint,
    drift_score,
)

# Number of adjustment intervals a new decode worker is protected from
# scale-down.
NEW_DECODE_WORKER_GRACE_PERIOD = 3
# Prefill scale-up looks this many intervals ahead along the queue's
# observed trend.
NEW_PREFILL_WORKER_QUEUE_BUFFER_PERIOD = 3


@dataclass(frozen=True)
class PlannerObservation:
    """One adjustment interval's worth of signals.

    ``prefill_queue`` / ``kv_load`` are the raw per-scrape samples (the
    live loop collects one per metric-pulling interval per worker); an
    empty tuple is NO signal, not zero load — a scrape outage must
    never read as idle. The SLO fields are optional percentile
    measurements over the interval's completions; ``None`` means not
    measured (the reactive policy ignores them entirely)."""

    num_prefill: int
    num_decode: int
    prefill_queue: tuple[float, ...] = ()
    kv_load: tuple[float, ...] = ()
    ttft_p99_s: float | None = None
    itl_p99_s: float | None = None
    now: float = 0.0
    # Workload-fingerprint plane: drift of live traffic vs the pinned
    # reference, and the live fingerprint itself. ``None`` means
    # the fingerprint plane isn't wired — the catalog swap stays off.
    drift_score: float | None = None
    fingerprint: WorkloadFingerprint | None = None


@dataclass(frozen=True)
class PlannerState:
    """Cross-interval memory. Today that is only the decode grace
    counter; keeping it a dataclass makes the fold explicit and lets
    the simulator snapshot/replay planner state."""

    decode_grace_remaining: int = 0
    # Name of the config-catalog entry currently in force ("" = the
    # deployment default). Folded by the catalog swap in
    # :func:`plan_step_slo`.
    active_config: str = ""


@dataclass(frozen=True)
class CatalogEntry:
    """One pre-validated tuned config the planner may swap to when
    live traffic drifts (the JAX package's ``llmctl tune`` emits these).
    ``overrides`` is a tuple of ``(knob, value)`` pairs — hashable, so
    the entry stays frozen; ``config_hash`` is the tune artifact's
    stable knob hash (the same one bench lines are stamped with)."""

    name: str
    fingerprint: WorkloadFingerprint
    overrides: tuple = ()
    config_hash: str = ""


@dataclass(frozen=True)
class ScaleAction:
    op: str  # "add" | "remove"
    component: str
    signal: float  # the metric value that triggered the action

    def as_log(self) -> dict:
        return {
            "op": self.op,
            "component": self.component,
            "signal": round(self.signal, 4),
        }


@dataclass(frozen=True)
class Decision:
    actions: tuple[ScaleAction, ...] = ()
    # Human-readable skipped/considered notes (grace period, drain
    # prediction, budget caps) for observability and test assertions.
    notes: tuple[str, ...] = ()
    # A decode scale-up is proposed: the caller must fold
    # :func:`arm_decode_grace` into its state IF (and only if) the add
    # actually lands — arming on a failed add would protect a worker
    # that never existed from scale-down for the whole grace period.
    arm_decode_grace: bool = False
    # Catalog swap proposed this round (``plan_step_slo`` only):
    # {"name", "config_hash", "drift_before", "drift_after",
    # "overrides"}. The caller records the flight/trace event and bumps
    # ``dynamo_config_swaps_total``; the new active entry is already
    # folded into the returned PlannerState.
    config_swap: dict | None = None


def arm_decode_grace(state: PlannerState) -> PlannerState:
    """Fold a *successful* decode scale-up into planner state: the new
    worker is protected from scale-down for the grace period. The value
    is post-decrement: the arming round itself already counts (the
    counter is set to the full period, then decremented on the way
    out)."""
    return PlannerState(
        decode_grace_remaining=max(
            state.decode_grace_remaining, NEW_DECODE_WORKER_GRACE_PERIOD - 1
        ),
        active_config=state.active_config,
    )


def maybe_swap_config(
    obs: PlannerObservation, state: PlannerState, cfg
) -> tuple[dict | None, str, list[str]]:
    """The catalog-swap decision: when live drift vs the pinned
    reference crosses :data:`DRIFT_ALERT_THRESHOLD` (the same number
    the fleet doctor flags DRIFT on), pick the catalog entry whose
    fingerprint is nearest the live one — and swap only if it is
    strictly nearer than the current drift (swapping to an equally
    wrong config would just churn). Pure: returns (swap-or-None,
    new-active-name, notes)."""
    catalog = tuple(getattr(cfg, "config_catalog", ()) or ())
    if (
        not catalog
        or obs.fingerprint is None
        or obs.drift_score is None
        or obs.drift_score < DRIFT_ALERT_THRESHOLD
    ):
        return None, state.active_config, []
    scored = sorted(
        (drift_score(obs.fingerprint, e.fingerprint), e.name, e)
        for e in catalog
    )
    best_d, _, best = scored[0]
    if best.name == state.active_config:
        return (
            None,
            state.active_config,
            [f"drift {obs.drift_score:.2f} but {best.name!r} already active"],
        )
    if best_d >= obs.drift_score:
        return (
            None,
            state.active_config,
            [
                f"drift {obs.drift_score:.2f}: no catalog entry nearer "
                f"(best {best.name!r} at {best_d:.2f})"
            ],
        )
    swap = {
        "name": best.name,
        "config_hash": best.config_hash,
        "drift_before": obs.drift_score,
        "drift_after": best_d,
        "overrides": dict(best.overrides),
    }
    return swap, best.name, []


def _mean(samples: tuple[float, ...]) -> float | None:
    return sum(samples) / len(samples) if samples else None


def _trend_forecast(samples: tuple[float, ...], horizon: float) -> float:
    """Last sample extrapolated ``horizon`` windows along the linear
    trend observed across the sample window (the same first-to-last
    slope the reactive prefill gate uses)."""
    if not samples:
        return 0.0
    trend = samples[-1] - samples[0] if len(samples) >= 2 else 0.0
    return samples[-1] + trend * horizon


def plan_step(
    obs: PlannerObservation, state: PlannerState, cfg
) -> tuple[Decision, PlannerState]:
    """The reactive threshold policy. ``cfg`` is a
    :class:`~dynamo_exp_tpu_torch.planner.planner.PlannerConfig` (duck-typed:
    only the threshold/budget fields are read)."""
    actions: list[ScaleAction] = []
    notes: list[str] = []
    grace = state.decode_grace_remaining
    curr_gpus = (
        obs.num_prefill * cfg.prefill_engine_num_gpu
        + obs.num_decode * cfg.decode_engine_num_gpu
    )
    avg_queue = _mean(obs.prefill_queue)
    avg_kv = _mean(obs.kv_load)

    # -- scale down first
    if (
        obs.num_prefill
        and avg_queue is not None
        and avg_queue < cfg.prefill_queue_scale_down_threshold
        and obs.num_prefill > cfg.min_endpoint
    ):
        actions.append(ScaleAction("remove", cfg.prefill_component, avg_queue))
        curr_gpus -= cfg.prefill_engine_num_gpu
    if (
        avg_kv is not None
        and avg_kv < cfg.decode_kv_scale_down_threshold
        and obs.num_decode > cfg.min_endpoint
    ):
        if grace > 0:
            notes.append(f"decode scale-down skipped (grace period {grace})")
        else:
            actions.append(
                ScaleAction("remove", cfg.decode_component, avg_kv)
            )
            curr_gpus -= cfg.decode_engine_num_gpu

    # -- scale up (prefill first: its queueing also inflates decode KV)
    if (
        obs.num_prefill
        and avg_queue is not None
        and avg_queue > cfg.prefill_queue_scale_up_threshold
        and curr_gpus + cfg.prefill_engine_num_gpu <= cfg.max_gpu_budget
    ):
        predicted = _trend_forecast(
            obs.prefill_queue, NEW_PREFILL_WORKER_QUEUE_BUFFER_PERIOD
        )
        if predicted > cfg.prefill_queue_scale_up_threshold:
            actions.append(
                ScaleAction("add", cfg.prefill_component, avg_queue)
            )
            curr_gpus += cfg.prefill_engine_num_gpu
        else:
            notes.append(
                f"prefill queue trend predicts drain ({predicted:.2f}); "
                "not scaling"
            )
    arm = False
    if (
        avg_kv is not None
        and avg_kv > cfg.decode_kv_scale_up_threshold
        and curr_gpus + cfg.decode_engine_num_gpu <= cfg.max_gpu_budget
    ):
        actions.append(ScaleAction("add", cfg.decode_component, avg_kv))
        curr_gpus += cfg.decode_engine_num_gpu
        arm = True

    if grace > 0:
        grace -= 1
    return (
        Decision(tuple(actions), tuple(notes), arm_decode_grace=arm),
        PlannerState(grace, active_config=state.active_config),
    )


# --------------------------------------------------------------------- SLO
@dataclass
class SloTargets:
    """SLO-driven predictive knobs, layered over a PlannerConfig.

    ``provision_s`` is a fitted-service hint from telemetry (the JAX
    package's simulator fits it: ``sim/fit.py``
    ``ServiceTimeModel.planner_hints``); zero means unknown and disables
    the corresponding estimate."""

    ttft_p99_slo_s: float = 2.0
    itl_p99_slo_s: float = 0.2
    # Windows of look-ahead along the observed trend (in adjustment
    # intervals): the whole point of "predictive" — scale for where the
    # signal is going, not where it is.
    forecast_horizon: float = 2.0
    # Per-worker KV load the fleet is sized to sit at. Well below the
    # reactive 0.9 threshold: past ~0.85 the engine starts stalling and
    # preempting, which is exactly what blows up p99 ITL.
    decode_kv_target: float = 0.75
    # Queue depth per prefill worker the fleet is sized to sit at.
    prefill_queue_target: float = 2.0
    # Most workers added or removed in one adjustment round.
    max_scale_step: int = 4
    # Desired/current below this fraction → remove one worker (deep
    # hysteresis so the fleet doesn't flap around the target).
    scale_down_headroom: float = 0.6
    # A single observed-pressure ratio is trusted at most this far (a
    # p99 blown 10x should not 10x the fleet in one round).
    max_pressure: float = 3.0
    # Measured worker add -> serving delay. A scale-up decided now only
    # lands this far in the future, so the forecast looks that much
    # further along the trend (in addition to ``forecast_horizon``).
    # 0 = unknown: no extension. A warm-booting fleet plans with its
    # measured warm landing delay: a shorter horizon scales on the burst
    # edge instead of buying standby capacity ahead of it.
    provision_s: float = 0.0


def plan_step_slo(
    obs: PlannerObservation,
    state: PlannerState,
    cfg,
    slo: SloTargets,
) -> tuple[Decision, PlannerState]:
    """SLO-driven predictive scaling.

    Sizing logic (decode / aggregated fleet):

    1. Forecast per-worker KV load ``forecast_horizon`` windows ahead
       along its linear trend. ``kv_pressure = forecast / kv_target``.
    2. Measure SLO attainment directly when available:
       ``ttft_pressure = ttft_p99 / ttft_slo`` and likewise for ITL —
       a breached target demands capacity even when KV looks fine
       (e.g. queue-bound TTFT), clamped to ``max_pressure``.
    3. ``desired = ceil(current * max(pressures))``, bounded by
       ``max_scale_step``, the card budget, and ``min_endpoint``.
    4. Scale down (one worker, grace-gated) only when every pressure
       forecast sits below ``scale_down_headroom``.

    The prefill fleet (disaggregated mode) is sized the same way from
    the queue-depth forecast against ``prefill_queue_target``.
    """
    actions: list[ScaleAction] = []
    notes: list[str] = []
    grace = state.decode_grace_remaining
    gpus = (
        obs.num_prefill * cfg.prefill_engine_num_gpu
        + obs.num_decode * cfg.decode_engine_num_gpu
    )

    # --------------------------------------------------- catalog swap
    swap, active, swap_notes = maybe_swap_config(obs, state, cfg)
    notes.extend(swap_notes)

    def clamp_pressure(x: float) -> float:
        return min(max(x, 0.0), slo.max_pressure)

    arm = False

    # Scale-ups decided now land provision_s later; look that much
    # further along the trend (in adjustment-interval windows).
    horizon = slo.forecast_horizon
    if slo.provision_s > 0:
        horizon += slo.provision_s / max(cfg.adjustment_interval, 1e-9)

    # ------------------------------------------------------------- decode
    kv_forecast = (
        _trend_forecast(obs.kv_load, horizon) if obs.kv_load else 0.0
    )
    pressures = []
    if obs.kv_load:
        pressures.append(clamp_pressure(kv_forecast / slo.decode_kv_target))
    if obs.ttft_p99_s is not None and slo.ttft_p99_slo_s > 0:
        pressures.append(
            clamp_pressure(obs.ttft_p99_s / slo.ttft_p99_slo_s)
        )
    if obs.itl_p99_s is not None and slo.itl_p99_slo_s > 0:
        pressures.append(clamp_pressure(obs.itl_p99_s / slo.itl_p99_slo_s))

    if pressures and obs.num_decode > 0:
        pressure = max(pressures)
        desired = max(
            math.ceil(obs.num_decode * pressure), cfg.min_endpoint
        )
        if desired > obs.num_decode:
            add = min(desired - obs.num_decode, slo.max_scale_step)
            # The card budget caps the expansion.
            afford = (cfg.max_gpu_budget - gpus) // max(
                cfg.decode_engine_num_gpu, 1
            )
            if add > afford:
                notes.append(
                    f"decode scale-up capped by budget ({add} -> {afford})"
                )
                add = afford
            signal = obs.kv_load[-1] if obs.kv_load else pressure
            for _ in range(max(add, 0)):
                actions.append(
                    ScaleAction("add", cfg.decode_component, signal)
                )
                gpus += cfg.decode_engine_num_gpu
            if add > 0:
                arm = True
        elif (
            pressure < slo.scale_down_headroom
            and obs.num_decode > cfg.min_endpoint
        ):
            if grace > 0:
                notes.append(
                    f"decode scale-down skipped (grace period {grace})"
                )
            else:
                actions.append(
                    ScaleAction(
                        "remove", cfg.decode_component, kv_forecast
                    )
                )
                gpus -= cfg.decode_engine_num_gpu

    # ------------------------------------------------------------ prefill
    if obs.num_prefill and obs.prefill_queue:
        q_forecast = max(_trend_forecast(obs.prefill_queue, horizon), 0.0)
        per_worker = q_forecast / obs.num_prefill
        p_pressure = clamp_pressure(per_worker / slo.prefill_queue_target)
        desired = max(
            math.ceil(obs.num_prefill * p_pressure), cfg.min_endpoint
        )
        if desired > obs.num_prefill:
            add = min(desired - obs.num_prefill, slo.max_scale_step)
            afford = (cfg.max_gpu_budget - gpus) // max(
                cfg.prefill_engine_num_gpu, 1
            )
            add = min(add, max(afford, 0))
            for _ in range(add):
                actions.append(
                    ScaleAction(
                        "add", cfg.prefill_component, obs.prefill_queue[-1]
                    )
                )
                gpus += cfg.prefill_engine_num_gpu
        elif (
            p_pressure < slo.scale_down_headroom
            and obs.num_prefill > cfg.min_endpoint
        ):
            actions.append(
                ScaleAction("remove", cfg.prefill_component, q_forecast)
            )
            gpus -= cfg.prefill_engine_num_gpu

    if grace > 0:
        grace -= 1
    return (
        Decision(
            tuple(actions),
            tuple(notes),
            arm_decode_grace=arm,
            config_swap=swap,
        ),
        PlannerState(grace, active_config=active),
    )
