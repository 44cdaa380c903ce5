"""Periodic scrape of worker load metrics into a live snapshot.

Counterpart of ``dynamo_exp_tpu/kv_router/metrics_aggregator.py``: poll
the component's stats plane on an interval, parse ``ForwardPassMetrics``
per instance (draining instances left out), and expose the latest
``ProcessedEndpoints`` plus a change notification.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging

from ..runtime.component import Component
from .protocols import ForwardPassMetrics
from .scheduler import ProcessedEndpoints

logger = logging.getLogger(__name__)


class KvMetricsAggregator:
    def __init__(self, component: Component, interval_s: float = 0.1):
        self.component = component
        self.interval_s = interval_s
        self.endpoints = ProcessedEndpoints()
        self.updated = asyncio.Event()
        self._task: asyncio.Task | None = None

    async def scrape_once(self) -> ProcessedEndpoints:
        # Draining workers are excluded at the snapshot source: the
        # selector never sees them, so no selection path (embedded or
        # standalone router) can schedule onto a draining instance.
        stats = await self.component.scrape_stats(include_draining=False)
        metrics = {
            wid: ForwardPassMetrics.from_dict(d or {}) for wid, d in stats.items()
        }
        self.endpoints = ProcessedEndpoints(metrics=metrics)
        self.updated.set()
        return self.endpoints

    async def start(self) -> None:
        if self._task is not None:
            return

        async def loop():
            while True:
                try:
                    await self.scrape_once()
                except Exception:
                    logger.exception("metrics scrape failed")
                await asyncio.sleep(self.interval_s)

        self._task = asyncio.create_task(loop(), name="kv-metrics-aggregator")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
