"""The planner decision loop: pull metrics, scale the worker fleet.

Counterpart of ``dynamo_exp_tpu/planner/planner.py``: the same signals
(average KV-cache load of the decode workers, the prefill work queue's
depth), the same policies and safeguards:

- scale-down checks run before scale-up,
- a freshly added decode worker gets a grace period
  (``NEW_DECODE_WORKER_GRACE_PERIOD`` adjustment intervals) before any
  decode scale-down, so its KV cache can fill,
- prefill scale-up only when the queue's linear trend predicts it stays
  above threshold for ``NEW_PREFILL_WORKER_QUEUE_BUFFER_PERIOD``
  intervals (workers take time to start),
- a hard card budget caps the fleet, and a fleet that changed underneath
  an interval skips that round.

The decisions are :mod:`.policy`'s pure ``plan_step`` (and the SLO-driven
``plan_step_slo`` with ``PlannerConfig.slo``); this module is the asyncio
driver that feeds it metrics and applies its actions through a connector
(the SDK supervisor's control endpoint by default). Run it beside a
graph served by ``python -m dynamo_exp_tpu_torch.sdk.serve``:

    python -m dynamo_exp_tpu_torch.planner.planner \
        --coordinator HOST:PORT --namespace dynamo \
        --decode-component CudaWorker --prefill-component PrefillCudaWorker

Each action it takes is logged as ``planner action: {...}``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, replace
from typing import Callable

from .policy import (  # noqa: F401 - re-exported
    NEW_DECODE_WORKER_GRACE_PERIOD,
    NEW_PREFILL_WORKER_QUEUE_BUFFER_PERIOD,
    PlannerObservation,
    PlannerState,
    SloTargets,
    arm_decode_grace,
    plan_step,
    plan_step_slo,
)

logger = logging.getLogger(__name__)


@dataclass
class PlannerConfig:
    namespace: str = "dynamo"
    served_model_name: str = "model"
    decode_component: str = "CudaWorker"
    decode_endpoint: str = "generate"
    prefill_component: str = "PrefillCudaWorker"
    metric_pulling_interval: float = 1.0
    adjustment_interval: float = 10.0
    # Card budget and per-engine card costs (the JAX config's *_tpu
    # fields count chips).
    max_gpu_budget: int = 8
    decode_engine_num_gpu: int = 1
    prefill_engine_num_gpu: int = 1
    min_endpoint: int = 1
    prefill_queue_scale_up_threshold: float = 5.0
    prefill_queue_scale_down_threshold: float = 0.2
    decode_kv_scale_up_threshold: float = 0.9
    decode_kv_scale_down_threshold: float = 0.5
    # Estimated KV fraction one waiting request will claim once admitted.
    waiting_request_kv_estimate: float = 0.02
    no_operation: bool = False  # observe only
    # SLO-driven predictive mode: when set, decisions come from
    # plan_step_slo (forecast KV/queue trends, size the fleet to p99
    # TTFT/ITL targets) instead of the reactive threshold loop.
    slo: "SloTargets | None" = None
    # Pre-validated tuned configs (policy.CatalogEntry tuple): when the
    # live fingerprint drifts past DRIFT_ALERT_THRESHOLD, plan_step_slo
    # swaps to the nearest entry.
    config_catalog: tuple = ()


class Planner:
    def __init__(
        self,
        drt,
        config: PlannerConfig,
        connector=None,
        clock: Callable[[], float] = time.monotonic,
        slo_source=None,
    ):
        from ..kv_router.metrics_aggregator import KvMetricsAggregator
        from .connector import LocalConnector

        self.drt = drt
        self.cfg = config
        self.connector = connector or LocalConnector(config.namespace, drt)
        # Injected clock: the loop's interval pacing is testable.
        self._clock = clock
        self.metrics_aggregator = KvMetricsAggregator(
            drt.namespace(config.namespace).component(config.decode_component),
            interval_s=config.metric_pulling_interval,
        )
        self.prefill_queue = drt.work_queue(prefill_queue_name(config.served_model_name))
        self._decode_client = None
        self._prefill_client = None
        self._plan_state = PlannerState()
        # Per-interval samples.
        self.kv_load: list[float] = []
        self.prefill_queue_load: list[float] = []
        # Optional p99 measurements for the SLO policy, set by an
        # embedder before each adjustment round (cleared with the
        # interval: absent means no signal).
        self.ttft_p99_s: float | None = None
        self.itl_p99_s: float | None = None
        # Fingerprint-plane inputs for the catalog swap: live drift vs
        # the pinned reference, and the live fingerprint. Not reset each
        # round: the drift watch is a continuously maintained signal.
        self.drift_score: float | None = None
        self.live_fingerprint = None
        # SLO attribution source (telemetry.SloAttribution, usually the
        # HTTP edge's): each adjustment round pulls its p99 inputs from
        # the attribution window and resets it.
        self.slo_source = slo_source
        self.adjustments: list[dict] = []  # the decision log
        self._stop = asyncio.Event()

    @property
    def decode_worker_remaining_grace_period(self) -> int:
        return self._plan_state.decode_grace_remaining

    @decode_worker_remaining_grace_period.setter
    def decode_worker_remaining_grace_period(self, value: int) -> None:
        self._plan_state = replace(self._plan_state, decode_grace_remaining=value)

    # ------------------------------------------------------------- discovery
    async def get_workers_info(self) -> tuple[list[int], list[int]]:
        """(prefill instance ids, decode instance ids). No prefill fleet
        means aggregated mode."""
        cfg = self.cfg
        if self._prefill_client is None:
            try:
                ep = (self.drt.namespace(cfg.namespace).component(cfg.prefill_component)
                      .endpoint("pull"))
                self._prefill_client = await ep.client()
            except Exception:
                self._prefill_client = None
        p = self._prefill_client.instance_ids() if self._prefill_client is not None else []
        if self._decode_client is None:
            ep = (self.drt.namespace(cfg.namespace).component(cfg.decode_component)
                  .endpoint(cfg.decode_endpoint))
            self._decode_client = await ep.client()
        return p, self._decode_client.instance_ids()

    # --------------------------------------------------------------- metrics
    async def collect_metrics(self) -> None:
        cfg = self.cfg
        try:
            self.prefill_queue_load.append(float(await self.prefill_queue.size()))
        except Exception as e:
            logger.info("prefill queue size unavailable: %s", e)
        endpoints = await self.metrics_aggregator.scrape_once()
        for m in endpoints.metrics.values():
            kv_load = m.gpu_cache_usage_perc
            if m.request_active_slots and m.num_requests_waiting > 0:
                # Waiting requests will claim cache once admitted; bias
                # the signal up so the planner scales before they land.
                kv_load += cfg.waiting_request_kv_estimate * m.num_requests_waiting
            self.kv_load.append(kv_load)

    def _reset_interval(self) -> None:
        self.kv_load = []
        self.prefill_queue_load = []
        # p99s are per-interval measurements like the samples above: a
        # stale breach left in place would read as pressure every round.
        self.ttft_p99_s = None
        self.itl_p99_s = None

    # ----------------------------------------------------------- adjustments
    async def make_adjustments(self, p_endpoints: list[int], d_endpoints: list[int]) -> None:
        """Re-check the fleet, then apply the policy; skipped when the
        fleet changed underneath the interval."""
        new_p, new_d = await self.get_workers_info()
        if len(new_p) != len(p_endpoints) or len(new_d) != len(d_endpoints):
            logger.info("fleet changed mid-interval; skipping adjustments")
            return
        await self.make_adjustments_with_counts(p_endpoints, d_endpoints)

    def observe(self, p_endpoints: list[int], d_endpoints: list[int]) -> PlannerObservation:
        """The interval's samples as a pure observation. An interval with
        no samples is NO signal, not zero load: a scrape outage (likeliest
        when workers are saturated) must never read as idle."""
        return PlannerObservation(
            num_prefill=len(p_endpoints),
            num_decode=len(d_endpoints),
            prefill_queue=tuple(self.prefill_queue_load),
            kv_load=tuple(self.kv_load),
            ttft_p99_s=self.ttft_p99_s,
            itl_p99_s=self.itl_p99_s,
            now=self._clock(),
            drift_score=self.drift_score,
            fingerprint=self.live_fingerprint,
        )

    async def make_adjustments_with_counts(
        self, p_endpoints: list[int], d_endpoints: list[int]
    ) -> None:
        """One round without discovery: build the observation, take one
        :func:`plan_step` / :func:`plan_step_slo`, apply each proposed
        action through the connector."""
        cfg = self.cfg
        if self.slo_source is not None:
            self.ttft_p99_s, self.itl_p99_s = self.slo_source.window_percentiles()
            self.slo_source.reset_window()
        obs = self.observe(p_endpoints, d_endpoints)
        if cfg.slo is not None:
            decision, self._plan_state = plan_step_slo(obs, self._plan_state, cfg, cfg.slo)
        else:
            decision, self._plan_state = plan_step(obs, self._plan_state, cfg)
        for note in decision.notes:
            logger.info("%s", note)
        if decision.config_swap is not None:
            self._apply_config_swap(decision.config_swap)
        for action in decision.actions:
            apply = (self.connector.add_component if action.op == "add"
                     else self.connector.remove_component)
            if await apply(action.component):
                self._log_action(action.op, action.component, action.signal)
                if (decision.arm_decode_grace and action.op == "add"
                        and action.component == cfg.decode_component):
                    # Only a decode worker that actually spawned earns
                    # scale-down protection.
                    self._plan_state = arm_decode_grace(self._plan_state)

    def _apply_config_swap(self, swap: dict) -> None:
        """Record a catalog swap: an adjustment-log entry, a
        ``dynamo_config_swaps`` bump, and a ``config_swap`` span so the
        trace timeline shows when, and why, the fleet changed configs."""
        from ..telemetry import get_telemetry, span

        entry = {
            "op": "config_swap",
            "name": swap["name"],
            "config_hash": swap["config_hash"],
            "drift_before": swap["drift_before"],
            "drift_after": swap["drift_after"],
        }
        self.adjustments.append(entry)
        logger.info("planner action: %s", entry)
        get_telemetry().config_swaps.inc()
        with span("config_swap", name=swap["name"], config_hash=swap["config_hash"],
                  drift_before=swap["drift_before"], drift_after=swap["drift_after"]):
            pass

    def _log_action(self, op: str, component: str, signal: float) -> None:
        entry = {"op": op, "component": component, "signal": round(signal, 4)}
        self.adjustments.append(entry)
        logger.info("planner action: %s", entry)

    # ------------------------------------------------------------------ loop
    async def run(self) -> None:
        cfg = self.cfg
        p_endpoints, d_endpoints = await self.get_workers_info()
        self._reset_interval()
        last_adjustment = self._clock()
        while not self._stop.is_set():
            try:
                await self.collect_metrics()
                if self._clock() - last_adjustment >= cfg.adjustment_interval:
                    if not cfg.no_operation:
                        await self.make_adjustments(p_endpoints, d_endpoints)
                    p_endpoints, d_endpoints = await self.get_workers_info()
                    self._reset_interval()
                    last_adjustment = self._clock()
            except Exception:
                # A transient control-plane error must not kill the
                # scaling loop; retry next interval.
                logger.exception("planner round failed; will retry")
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=cfg.metric_pulling_interval)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()


def prefill_queue_name(model_name: str) -> str:
    """Shared naming for the remote-prefill work queue, keyed by the
    served model's name: both packages' fleets must spell it alike."""
    return f"prefill-{model_name}"


STR_FIELDS = ("namespace", "served_model_name", "decode_component", "decode_endpoint",
              "prefill_component")
FLOAT_FIELDS = ("metric_pulling_interval", "adjustment_interval",
                "prefill_queue_scale_up_threshold", "prefill_queue_scale_down_threshold",
                "decode_kv_scale_up_threshold", "decode_kv_scale_down_threshold")
INT_FIELDS = ("max_gpu_budget", "decode_engine_num_gpu", "prefill_engine_num_gpu",
              "min_endpoint")


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True)
    defaults = PlannerConfig()
    for fields, kind in ((STR_FIELDS, str), (FLOAT_FIELDS, float), (INT_FIELDS, int)):
        for f in fields:
            p.add_argument(f"--{f.replace('_', '-')}", type=kind, default=getattr(defaults, f))
    p.add_argument("--no-operation", action="store_true")
    return p


def config_from_args(args) -> PlannerConfig:
    return PlannerConfig(**{k: v for k, v in vars(args).items()
                            if k != "coordinator" and hasattr(PlannerConfig, k)})


def main(argv: list[str] | None = None) -> None:
    import signal

    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.logging import configure_logging

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    configure_logging()

    async def run():
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=args.coordinator))
        planner = Planner(drt, cfg)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, planner.stop)
        try:
            await planner.run()
        finally:
            planner.connector.close()
            await drt.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
