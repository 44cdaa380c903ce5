"""Mock worker: synthetic load metrics and KV events, no card.

Counterpart of ``dynamo_exp_tpu/components/mock_worker.py``: an echo
endpoint whose ``ForwardPassMetrics`` drift like a loaded worker's (a
seeded ``random.Random``: the same seed gives the JAX mock worker's
series) and a stream of synthetic ``stored`` KV events, for exercising
the metrics exporter and the KV router. It never touches the card.

    python -m dynamo_exp_tpu_torch.components.mock_worker \
        --coordinator HOST:PORT --component ns.comp
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import random

from ..kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEventData,
    RouterEvent,
    kv_events_subject,
)
from ..runtime.component import Component, annotated_stream


class MockWorker:
    """Serves an echo endpoint whose stats drift like a loaded worker's
    and publishes synthetic stored KV events."""

    def __init__(self, component: Component, endpoint: str = "generate", seed: int = 0):
        self.component = component
        self.endpoint_name = endpoint
        self.rng = random.Random(seed)
        self.metrics = ForwardPassMetrics(request_total_slots=16, kv_total_blocks=1024)
        self._served = None
        self._tasks: list[asyncio.Task] = []
        self._hashes = itertools.count(1)

    async def start(self) -> int:
        from ..engines.echo import EchoEngineCore

        engine = EchoEngineCore()

        async def handler(request: dict, context=None):
            async for frame in annotated_stream(engine, request, context):
                yield frame

        ep = self.component.endpoint(self.endpoint_name)
        self._served = await ep.serve_endpoint(
            handler, stats_handler=lambda: self.metrics.to_dict())
        self._tasks.append(asyncio.ensure_future(self._drift()))
        self._tasks.append(asyncio.ensure_future(self._publish_kv()))
        return self._served.instance_id

    async def _drift(self) -> None:
        while True:
            m = self.metrics
            m.request_active_slots = self.rng.randint(0, m.request_total_slots)
            m.kv_active_blocks = self.rng.randint(0, m.kv_total_blocks)
            m.num_requests_waiting = self.rng.randint(0, 4)
            m.gpu_cache_usage_perc = m.kv_active_blocks / m.kv_total_blocks
            m.gpu_prefix_cache_hit_rate = self.rng.random()
            await asyncio.sleep(0.1)

    async def _publish_kv(self) -> None:
        plane = self.component.drt.event_plane
        subject = kv_events_subject(self.component.path)
        wid = self._served.instance_id
        parent = None
        while True:
            h = next(self._hashes)
            event = RouterEvent(worker_id=wid, data=KvCacheEventData(
                kind="stored", block_hashes=[h], parent_hash=parent))
            await plane.publish(subject, event.to_dict())
            parent = h
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._tasks.clear()
        if self._served is not None:
            await self._served.close()
            self._served = None


def main() -> None:
    import argparse

    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.runtime import run_until_signalled

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--component", required=True, help="namespace.component")
    args = p.parse_args()

    async def run():
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=args.coordinator))
        ns, _, comp = args.component.partition(".")
        worker = MockWorker(drt.namespace(ns).component(comp))
        try:
            print(f"mock worker instance {await worker.start()}", flush=True)
            await asyncio.Event().wait()
        finally:
            await worker.stop()
            await drt.close()

    run_until_signalled(run())


if __name__ == "__main__":
    main()
