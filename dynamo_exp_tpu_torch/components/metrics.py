"""Standalone metrics exporter: worker load and KV hit rate -> Prometheus.

Counterpart of ``dynamo_exp_tpu/components/metrics.py``: scrape a
component's ``ForwardPassMetrics`` from the stats plane
(``KvMetricsAggregator``), count the routing decisions published on
``kv-hit-rate``, and serve both on ``/metrics`` for a Prometheus pull,
with the JAX exporter's series: the ``llm_kv_*`` gauges by
``worker_id`` and the ``llm_kv_hit_{events,isl_blocks,overlap_blocks}_total``
counters, then the process's telemetry registry. A lost event stream is
subscribed again; a departed worker's series are dropped. The registry
is ``telemetry/prom.py``'s and the server ``http/service.py``'s
``PlainServer`` (the JAX exporter uses prometheus_client and aiohttp).

    python -m dynamo_exp_tpu_torch.components.metrics \
        --coordinator HOST:PORT --component ns.comp [--port 9091]

SIGTERM stops it (exit 0).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging

from ..http.wire import PlainResponse, PlainServer, plain_json
from ..kv_router.metrics_aggregator import KvMetricsAggregator
from ..kv_router.protocols import KV_HIT_RATE_SUBJECT
from ..runtime.component import Component
from ..telemetry import CONTENT_TYPE_LATEST, Counter, Gauge, Registry, get_telemetry

logger = logging.getLogger(__name__)

_GAUGES = (
    ("request_active_slots", "Active request slots"),
    ("request_total_slots", "Total request slots"),
    ("kv_active_blocks", "Active KV blocks"),
    ("kv_total_blocks", "Total KV blocks"),
    ("num_requests_waiting", "Requests waiting for admission"),
    ("gpu_cache_usage_perc", "Device KV cache usage fraction"),
    ("gpu_prefix_cache_hit_rate", "Device prefix-cache hit rate"),
)


class MetricsService:
    """Scrapes one component and serves /metrics."""

    def __init__(self, component: Component, host: str = "0.0.0.0", port: int = 9091,
                 scrape_interval_s: float = 1.0):
        self.component = component
        self.host = host
        self.port = port
        self.registry = Registry()
        self.gauges = {name: Gauge(f"llm_kv_{name}", help_, ["worker_id"],
                                   registry=self.registry)
                       for name, help_ in _GAUGES}
        self.hit_events = Counter("llm_kv_hit_events_total",
                                  "KV-aware routing decisions observed", registry=self.registry)
        self.hit_isl_blocks = Counter("llm_kv_hit_isl_blocks_total",
                                      "Input blocks across routing decisions",
                                      registry=self.registry)
        self.hit_overlap_blocks = Counter("llm_kv_hit_overlap_blocks_total",
                                          "Matched (cache-hit) blocks across routing decisions",
                                          registry=self.registry)
        self.aggregator = KvMetricsAggregator(component, scrape_interval_s)
        self._tasks: list[asyncio.Task] = []
        self._server: PlainServer | None = None

    async def start(self) -> int:
        """Subscribe, scrape and serve; returns the bound port. Events
        published once this returns are counted."""
        await self.aggregator.start()
        plane = self.component.drt.event_plane
        stream = await plane.subscribe(KV_HIT_RATE_SUBJECT)

        async def pump_hits(stream):
            # A dead stream is never iterated again: each loss drops it
            # and subscribes anew until that succeeds.
            while True:
                try:
                    async for event in stream:
                        self.hit_events.inc()
                        self.hit_isl_blocks.inc(max(event.get("isl_blocks", 0), 0))
                        self.hit_overlap_blocks.inc(max(event.get("overlap_blocks", 0), 0))
                    return
                except asyncio.CancelledError:
                    return
                except Exception as exc:
                    logger.warning("hit-event stream lost (%s); retrying", exc)
                stream = None
                while stream is None:
                    await asyncio.sleep(1.0)
                    with contextlib.suppress(Exception):
                        stream = await plane.subscribe(KV_HIT_RATE_SUBJECT)

        async def pump_gauges():
            exported: set[str] = set()  # worker_ids with live series
            while True:
                await self.aggregator.updated.wait()
                self.aggregator.updated.clear()
                seen = set()
                for wid, m in self.aggregator.endpoints.metrics.items():
                    seen.add(str(wid))
                    for name, _ in _GAUGES:
                        self.gauges[name].labels(str(wid)).set(getattr(m, name))
                # A departed worker's series go, so dashboards show no ghosts.
                for wid in exported - seen:
                    for name, _ in _GAUGES:
                        self.gauges[name].remove(wid)
                exported = seen

        self._tasks = [asyncio.ensure_future(pump_hits(stream)),
                       asyncio.ensure_future(pump_gauges())]
        self._server = PlainServer(self._handle, self.host, self.port)
        self.port = await self._server.start()
        logger.info("metrics exporter on %s:%d", self.host, self.port)
        return self.port

    async def _handle(self, req) -> PlainResponse:
        if (req.method, req.path) != ("GET", "/metrics"):
            return plain_json({"error": "not found"}, 404)
        return PlainResponse(200, self.render(), CONTENT_TYPE_LATEST)

    def render(self) -> bytes:
        """The exporter's series, then the process-wide telemetry
        registry's (one scrape)."""
        return self.registry.render() + get_telemetry().render()

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._tasks = []
        await self.aggregator.stop()
        if self._server is not None:
            await self._server.stop()
            self._server = None


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.logging import configure_logging
    from ..runtime.runtime import run_until_signalled

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--component", required=True, help="namespace.component")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9091)
    p.add_argument("--scrape-interval", type=float, default=1.0)
    args = p.parse_args(argv)
    configure_logging()

    async def run():
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=args.coordinator))
        ns, _, comp = args.component.partition(".")
        svc = MetricsService(drt.namespace(ns).component(comp), args.host, args.port,
                             args.scrape_interval)
        try:
            port = await svc.start()
            print(f"metrics on http://{args.host}:{port}/metrics", flush=True)
            await asyncio.Event().wait()
        finally:
            await svc.stop()
            await drt.close()

    run_until_signalled(run())


if __name__ == "__main__":
    main()
