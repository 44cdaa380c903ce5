"""Worker-side publishers: KV events and load metrics.

Counterpart of ``dynamo_exp_tpu/kv_router/publisher.py``:
``KvEventPublisher`` forwards the engine's page-manager events
(``engine/kv_manager.py`` ``KvEvent``) onto the event plane, attributed
to this worker; ``KvMetricsPublisher`` serves ``ForwardPassMetrics`` as
the endpoint's stats handler.

The engine emits events from its loop *thread*; the publisher hops them
onto the asyncio loop with ``run_coroutine_threadsafe``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from ..engine.kv_manager import KvEvent
from .protocols import (
    ForwardPassMetrics,
    KvCacheEventData,
    RouterEvent,
    kv_events_subject,
)

logger = logging.getLogger(__name__)


class KvEventPublisher:
    def __init__(
        self,
        event_plane,
        component_path: str,
        worker_id: int,
        loop: asyncio.AbstractEventLoop | None = None,
    ):
        self.event_plane = event_plane
        self.subject = kv_events_subject(component_path)
        self.worker_id = worker_id
        self.loop = loop
        self.published = 0

    async def publish(self, data: KvCacheEventData) -> None:
        event = RouterEvent(worker_id=self.worker_id, data=data)
        await self.event_plane.publish(self.subject, event.to_dict())
        self.published += 1

    def engine_callback(self) -> Callable[[KvEvent], None]:
        """Adapter for ``TorchEngine.kv.event_cb``, safe to call from the
        engine loop thread."""
        loop = self.loop or asyncio.get_event_loop()

        def cb(ev: KvEvent) -> None:
            data = KvCacheEventData(
                kind=ev.kind,
                block_hashes=list(ev.seq_hashes),
                parent_hash=ev.parent_hash,
            )
            try:
                asyncio.run_coroutine_threadsafe(self.publish(data), loop)
            except RuntimeError:  # loop closed during shutdown
                logger.debug("dropping kv event after loop close")

        return cb


class KvMetricsPublisher:
    """Holds the latest ForwardPassMetrics; use ``stats_handler`` when
    serving an endpoint so the metrics aggregator can scrape it."""

    def __init__(self):
        self.current = ForwardPassMetrics()

    def update(self, metrics: ForwardPassMetrics | dict) -> None:
        if isinstance(metrics, dict):
            metrics = ForwardPassMetrics.from_dict(metrics)
        self.current = metrics

    def stats_handler(self) -> dict:
        return self.current.to_dict()
