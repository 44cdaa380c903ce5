"""The KV-aware router: pick the worker with the best KV-overlap / load
trade-off, as an ``AsyncEngine``.

Counterpart of ``dynamo_exp_tpu/kv_router/router.py``: the event pump
feeding the indexer, the aggregator's metrics snapshot, the selector,
and a ``KVHitRateEvent`` per decision on ``kv-hit-rate``.
``KvPushRouter`` routes and then sends in one engine (``--router-mode
kv``); its failover re-runs the selector over the survivors, and it
checks the request's deadline at stage ``router`` before each
selection. ``build_routed_core`` composes the routed core for the
ingress's model watcher and for ``run.py``.
"""

from __future__ import annotations

import logging
from typing import Any

from ..runtime.component import Component
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from ..runtime.push_router import NoHealthyInstancesError, PushRouter, RouterMode
from ..telemetry import span as trace_span
from .indexer import KvIndexer
from .metrics_aggregator import KvMetricsAggregator
from .protocols import (
    KV_HIT_RATE_SUBJECT,
    KVHitRateEvent,
    RouterRequest,
    RouterResponse,
    kv_events_subject,
)
from .scheduler import (
    DefaultWorkerSelector,
    NoWorkersError,
    ProcessedEndpoints,
    WorkerSelector,
)

logger = logging.getLogger(__name__)


class KvRouter(AsyncEngine):
    """RouterRequest{token_ids} -> RouterResponse{worker_id, overlap}."""

    def __init__(
        self,
        component: Component,
        block_size: int,
        selector: WorkerSelector | None = None,
        scrape_interval_s: float = 0.1,
    ):
        self.component = component
        self.indexer = KvIndexer(block_size)
        self.aggregator = KvMetricsAggregator(component, scrape_interval_s)
        self.selector = selector or DefaultWorkerSelector()
        self.block_size = block_size
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        plane = self.component.drt.event_plane
        await self.indexer.start(plane, kv_events_subject(self.component.path))
        await self.aggregator.start()

    async def stop(self) -> None:
        self._started = False
        await self.indexer.stop()
        await self.aggregator.stop()

    async def schedule(
        self, token_ids: list[int], exclude: set[int] | frozenset[int] = frozenset()
    ) -> RouterResponse:
        """Pick a worker; ``exclude`` drops ids the caller knows are bad
        right now (failed this request, breaker-open, draining)."""
        await self.start()
        with trace_span("kv_route", isl_tokens=len(token_ids)) as sp:
            endpoints = self.aggregator.endpoints
            if not endpoints.metrics:
                endpoints = await self.aggregator.scrape_once()
            if exclude:
                endpoints = ProcessedEndpoints(
                    metrics={
                        w: m
                        for w, m in endpoints.metrics.items()
                        if w not in exclude
                    }
                )
            overlaps = self.indexer.find_matches_for_request(token_ids)
            worker_id, overlap = self.selector.select_worker(
                endpoints, overlaps, len(token_ids), self.block_size
            )
            sp.set(worker_id=worker_id, overlap_blocks=overlap)
        # Dead-worker hygiene: drop index entries for workers that left.
        for wid in list(overlaps.scores):
            if wid not in endpoints.metrics:
                self.indexer.remove_worker(wid)
        await self.component.drt.event_plane.publish(
            KV_HIT_RATE_SUBJECT,
            KVHitRateEvent(
                worker_id=worker_id,
                isl_blocks=len(token_ids) // self.block_size,
                overlap_blocks=overlap,
            ).to_dict(),
        )
        return RouterResponse(worker_id=worker_id, overlap_blocks=overlap)

    async def generate(
        self, request: dict, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        ctx = context or AsyncEngineContext()
        req = RouterRequest.from_dict(request)
        resp = await self.schedule(req.token_ids)

        async def _gen():
            yield resp.to_dict()

        return ResponseStream(_gen(), ctx)


class KvPushRouter(AsyncEngine):
    """Route KV-aware, then push to the chosen worker instance — the
    drop-in engine the ingress uses when router-mode=kv.

    Failover stays KV-aware: a connection/stream-start failure re-runs
    the selector over the remaining workers (failed + unhealthy +
    draining excluded) instead of falling back to random choice, so the
    retry still lands on the best surviving prefix overlap. Mid-stream
    failover (resumable streams) re-selects the same way — the
    continuation's token_ids include the journaled tokens, so the
    overlap estimate prices the re-prefill correctly."""

    def __init__(self, push_router: PushRouter, kv_router: KvRouter):
        self.push = push_router
        self.kv = kv_router
        # Install the KV-aware re-selector for mid-stream continuation
        # dispatch (PushRouter alone would refuse to move an
        # explicit-target request to a different instance).
        self.push.continuation_selector = self._reselect

    async def _reselect(
        self, token_ids: list[int], exclude: frozenset[int]
    ) -> int:
        try:
            resp = await self.kv.schedule(
                token_ids, exclude=set(exclude) | self.push.unavailable_ids()
            )
        except NoWorkersError as e:
            raise NoHealthyInstancesError(str(e)) from e
        return resp.worker_id

    async def generate(
        self, request: dict | Any, context: AsyncEngineContext | None = None
    ) -> ResponseStream[Any]:
        ctx = context or AsyncEngineContext()
        token_ids = (
            request.get("token_ids", []) if isinstance(request, dict) else []
        )
        failed: set[int] = set()
        attempt = 0
        while True:
            ctx.check_deadline("router")
            try:
                resp = await self.kv.schedule(
                    token_ids, exclude=failed | self.push.unavailable_ids()
                )
            except NoWorkersError as e:
                raise NoHealthyInstancesError(str(e)) from e
            routed = request
            if isinstance(request, dict):
                routed = dict(request)
                routed["estimated_prefix_hit_num_blocks"] = resp.overlap_blocks
            try:
                return await self.push.generate_direct(
                    routed, instance_id=resp.worker_id, context=ctx
                )
            except ConnectionError:
                # The push router already recorded the failure against
                # the instance; re-select among the survivors.
                failed.add(resp.worker_id)
                attempt += 1
                if attempt > self.push.retries:
                    raise
                await self.push.sleep_backoff(attempt, ctx)


async def build_routed_core(endpoint, mode: RouterMode, block_size: int):
    """The one place that composes a routed core engine for an endpoint.

    Returns (engine, kv_router_or_None) — callers must ``await
    kv_router.stop()`` when done (it owns an event subscription and a
    scrape task). Used by both the ingress model watcher and the run CLI
    so the two can't drift.
    """
    client = await endpoint.client()
    # Ingress may accept requests moments before the worker fleet's
    # discovery snapshot lands; absorb that race instead of 503ing.
    if mode is RouterMode.KV:
        kv_router = KvRouter(endpoint.component, block_size=block_size)
        await kv_router.start()
        return (
            KvPushRouter(
                PushRouter(client, RouterMode.DIRECT, ready_wait_s=30.0),
                kv_router,
            ),
            kv_router,
        )
    return PushRouter(client, mode, ready_wait_s=30.0), None


__all__ = ["KvRouter", "KvPushRouter", "RouterMode", "build_routed_core"]
