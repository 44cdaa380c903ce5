"""Distributed runtime and the Namespace -> Component -> Endpoint hierarchy.

Counterpart of ``dynamo_exp_tpu/runtime/component.py``: a
``DistributedRuntime`` owns the transports (in-process in static mode,
the coordinator and TCP planes with ``coordinator_endpoint`` set);
namespaces contain components; components expose named endpoints that
are served over the request plane and registered in discovery under a
lease, so a worker's death removes its instance. A served instance
watches the drain-intent and reclaim-notice KV prefixes. A reclaim
flips the instance's metadata (routers stop sending) and hands the grace
window to ``on_reclaim``: a served engine's worker attaches
``runtime/reclaim.py``'s ``ReclaimController`` there, which triages the
in-flight streams and migrates their KV live to a survivor; without it,
in-flight streams ride the journal's failover.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import AsyncIterator

from .client import Client
from .config import RuntimeConfig
from .engine import AsyncEngineContext
from .runtime import Runtime
from .transports.base import (
    Discovery,
    EndpointAddress,
    EventPlane,
    Handler,
    InstanceInfo,
    Lease,
    ObjectStore,
    RequestPlane,
    ServedEndpoint,
    StatsHandler,
    WorkQueue,
)
from .transports.inproc import InProcDiscovery, InProcRequestPlane

logger = logging.getLogger(__name__)

# KV prefix where drain intent is published (``{DRAIN_PREFIX}{instance_id}``);
# the serving process watches the prefix and starts its own graceful
# drain (the worker owns its lease, so the operator never forges
# registrations).
DRAIN_PREFIX = "v1/drain/"

# KV prefix where spot-reclamation notices land:
# ``{RECLAIM_PREFIX}{instance_id}`` with a JSON ``{"grace_s": N}``
# payload. Same watch discipline as drain; the value carries the
# platform's grace window for ``on_reclaim``.
RECLAIM_PREFIX = "v1/reclaim/"

# Default grace window when a reclaim notice carries none (SIGTERM,
# malformed payload): seconds-scale, matching typical spot preemption.
DEFAULT_RECLAIM_GRACE_S = 30.0

# Endpoints served under one lease, for composing unique instance ids.
# Per-lease (not process-global): a long-lived process serving many
# endpoints across many leases must never overflow one lease's id range
# into another's. The counter lives on the lease object so its state
# dies with the lease (no global table to leak across lease churn).
_ENDPOINTS_PER_LEASE = 10_000


def _next_endpoint_seq(lease) -> int:
    seq = getattr(lease, "_endpoint_seq", 0) + 1
    if seq >= _ENDPOINTS_PER_LEASE:
        raise RuntimeError(
            f"lease {lease.lease_id} exceeded {_ENDPOINTS_PER_LEASE} endpoints"
        )
    lease._endpoint_seq = seq
    return seq


class DistributedRuntime:
    """Runtime + cluster transports. In static mode (no coordinator
    configured) discovery and the request plane are in-process."""

    def __init__(
        self,
        runtime: Runtime | None = None,
        config: RuntimeConfig | None = None,
        discovery: Discovery | None = None,
        request_plane: RequestPlane | None = None,
        event_plane: "EventPlane | None" = None,
    ):
        self.config = config or RuntimeConfig()
        self.runtime = runtime or Runtime()
        if discovery is None or request_plane is None:
            if self.config.is_static:
                discovery = discovery or InProcDiscovery()
                request_plane = request_plane or InProcRequestPlane()
            else:
                from .transports.coordinator import CoordinatorDiscovery
                from .transports.tcp import TcpRequestPlane

                discovery = discovery or CoordinatorDiscovery(
                    self.config.coordinator_endpoint,
                    lease_ttl_s=self.config.lease_ttl_s,
                )
                request_plane = request_plane or TcpRequestPlane(
                    bind_host=self.config.response_host,
                    bind_port=self.config.response_port,
                )
        self.discovery = discovery
        self.request_plane = request_plane
        # The discovery backend is the factory for its sibling planes, so
        # events/queues/blobs automatically ride the same fabric.
        self.event_plane = event_plane or self.discovery.event_plane()
        self._namespaces: dict[str, Namespace] = {}
        self._primary_lease: Lease | None = None
        self._bg_tasks: list = []

    def spawn_background(self, coro, name: str):
        """Run a long-lived coroutine tied to this runtime's lifetime
        (heartbeats, re-publishers). Cancelled on close()."""
        import asyncio

        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._bg_tasks.append(task)
        task.add_done_callback(
            lambda t: self._bg_tasks.remove(t) if t in self._bg_tasks else None
        )
        return task

    @classmethod
    def detached(cls) -> "DistributedRuntime":
        """Static single-process runtime (no discovery services)."""
        return cls(config=RuntimeConfig())

    async def primary_lease(self) -> Lease:
        if self._primary_lease is None or not self._primary_lease.is_valid():
            self._primary_lease = await self.discovery.create_lease(
                self.config.lease_ttl_s
            )
        return self._primary_lease

    def namespace(self, name: str) -> "Namespace":
        if name not in self._namespaces:
            self._namespaces[name] = Namespace(self, name)
        return self._namespaces[name]

    def work_queue(self, name: str) -> "WorkQueue":
        """A named FIFO work queue (JetStream work-queue equivalent)."""
        return self.discovery.work_queue(name)

    @property
    def object_store(self) -> "ObjectStore":
        """Bucketed blob store (NATS object-store equivalent, holds MDCs)."""
        return self.discovery.object_store()

    def shutdown(self) -> None:
        self.runtime.shutdown()

    async def close(self) -> None:
        import asyncio

        for task in list(self._bg_tasks):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                # Swallow only the bg task's own cancellation; if close()
                # itself was cancelled (run.py bounds it with wait_for),
                # that must propagate or the shutdown cap is defeated.
                if not task.cancelled():
                    raise
            except Exception:  # noqa: BLE001 - a failing bg task must
                pass  # not block runtime teardown
        self._bg_tasks.clear()
        if self._primary_lease is not None and self._primary_lease.is_valid():
            await self._primary_lease.revoke()
        await self.request_plane.close()
        await self.event_plane.close()
        await self.discovery.close()
        await self.runtime.close()


class Namespace:
    def __init__(self, drt: DistributedRuntime, name: str):
        _validate_segment(name)
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)


class Component:
    """A discoverable unit of work (e.g. "worker", "router", "prefill")."""

    def __init__(self, namespace: Namespace, name: str):
        _validate_segment(name)
        self.namespace = namespace
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.namespace.drt

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/components/{self.name}"

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    async def scrape_stats(self, include_draining: bool = True) -> dict[int, dict]:
        """Collect live stats from every instance of this component.

        ``include_draining=False`` drops instances that advertised drain
        in their discovery metadata — selection planes (the KV router's
        metrics aggregator) must not schedule onto them.
        """
        from .health import is_draining

        out: dict[int, dict] = {}
        for info in await self.drt.discovery.list_instances(self.path):
            if not include_draining and is_draining(info):
                continue
            try:
                out[info.instance_id] = await self.drt.request_plane.scrape_stats(info)
            except ConnectionError:
                continue
        return out


class Endpoint:
    def __init__(self, component: Component, name: str):
        _validate_segment(name)
        self.component = component
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.component.drt

    @property
    def address(self) -> EndpointAddress:
        return EndpointAddress(
            self.component.namespace.name, self.component.name, self.name
        )

    @property
    def path(self) -> str:
        return self.address.path

    async def serve_endpoint(
        self,
        handler: Handler,
        stats_handler: StatsHandler | None = None,
        lease: Lease | None = None,
        metadata: dict | None = None,
    ) -> "ServedInstance":
        """Register + serve this endpoint; returns the live instance handle."""
        drt = self.drt
        if lease is None:
            lease = await drt.primary_lease()
        # Instance ids must be unique ACROSS processes (the registry and
        # direct routing key on them), so derive them from the lease id —
        # globally unique per coordinator — plus a per-process counter
        # for the several endpoints one process serves under one primary
        # lease. A bare per-process counter would make every worker
        # process claim instance 1 and clobber its peers in discovery.
        info = InstanceInfo(
            address=self.address,
            instance_id=lease.lease_id * _ENDPOINTS_PER_LEASE
            + _next_endpoint_seq(lease),
            metadata=metadata or {},
        )
        served = await drt.request_plane.serve(info, handler, stats_handler)
        await drt.discovery.register_instance(info, lease)
        logger.info("serving endpoint %s as instance %d", self.path, info.instance_id)
        instance = ServedInstance(self, info, served, lease)
        instance._start_drain_watch()
        instance._start_reclaim_watch()
        return instance

    async def client(
        self,
        static_instances: list[InstanceInfo] | None = None,
        health=None,
    ) -> Client:
        """A client that tracks this endpoint's live instances. ``health``
        overrides the default HealthTracker (custom breaker thresholds,
        injectable clock under test)."""
        if static_instances is not None:
            return Client.new_static(
                self.drt.request_plane, static_instances, health=health
            )
        return await Client.new_dynamic(
            self.drt.runtime,
            self.drt.discovery,
            self.drt.request_plane,
            self.path,
            health=health,
        )


class ServedInstance:
    def __init__(
        self,
        endpoint: Endpoint,
        info: InstanceInfo,
        served: ServedEndpoint,
        lease: Lease,
    ):
        self.endpoint = endpoint
        self.info = info
        self._served = served
        self.lease = lease
        self._drain_task = None
        self._reclaim_task = None
        # Reclaim hook: ``async def on_reclaim(grace_s: float)``,
        # invoked once after the ``reclaiming`` metadata republish,
        # inside the grace window. None = metadata-only reclaim (routers
        # stop sending; in-flight streams ride the journal failover).
        self.on_reclaim = None
        # The running triage of the first notice: a later notice (the
        # platform's SIGTERM after an operator's ``llmctl reclaim``)
        # waits for it instead of returning while it runs.
        self._reclaim_run: asyncio.Future | None = None

    @property
    def instance_id(self) -> int:
        return self.info.instance_id

    @property
    def is_draining(self) -> bool:
        from .health import is_draining

        return is_draining(self.info)

    @property
    def is_reclaiming(self) -> bool:
        from .health import is_reclaiming

        return is_reclaiming(self.info)

    def _start_drain_watch(self) -> None:
        """Watch the drain-intent KV prefix, so an operator can trigger
        a graceful drain without owning this worker's lease."""
        drt = self.endpoint.drt

        async def _watch() -> None:
            key = f"{DRAIN_PREFIX}{self.info.instance_id}"
            try:
                async for snapshot in drt.discovery.kv_watch_prefix(DRAIN_PREFIX):
                    if key in snapshot:
                        await self.drain()
                        # Consume the intent: the key has done its job,
                        # and leaving it would grow the drain prefix
                        # forever (and re-ship stale keys to every
                        # instance's watcher on each KV change).
                        with contextlib.suppress(Exception):
                            await drt.discovery.kv_delete(key)
                        return
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a broken control-plane watch
                # must not kill serving; drain stays operator-reachable
                # via ServedInstance.drain() in-process.
                logger.debug(
                    "drain watch for instance %d ended",
                    self.info.instance_id,
                    exc_info=True,
                )

        self._drain_task = drt.spawn_background(
            _watch(), name=f"drain-watch-{self.info.instance_id}"
        )

    def _start_reclaim_watch(self) -> None:
        """Watch the reclaim-notice KV prefix, so a platform agent can
        trigger reclaim without owning this worker's lease. The value
        carries the grace window as JSON."""
        import json

        drt = self.endpoint.drt

        async def _watch() -> None:
            key = f"{RECLAIM_PREFIX}{self.info.instance_id}"
            try:
                async for snapshot in drt.discovery.kv_watch_prefix(
                    RECLAIM_PREFIX
                ):
                    if key not in snapshot:
                        continue
                    grace_s = DEFAULT_RECLAIM_GRACE_S
                    with contextlib.suppress(Exception):
                        raw = snapshot[key]
                        if isinstance(raw, (bytes, bytearray)):
                            raw = raw.decode()
                        grace_s = float(json.loads(raw).get("grace_s", grace_s))
                    await self.reclaim(grace_s)
                    # Consume the notice (same hygiene as the drain key).
                    with contextlib.suppress(Exception):
                        await drt.discovery.kv_delete(key)
                    return
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a broken control-plane watch
                # must not kill serving; reclaim stays reachable via
                # ServedInstance.reclaim() in-process (SIGTERM path).
                logger.debug(
                    "reclaim watch for instance %d ended",
                    self.info.instance_id,
                    exc_info=True,
                )

        self._reclaim_task = drt.spawn_background(
            _watch(), name=f"reclaim-watch-{self.info.instance_id}"
        )

    async def reclaim(self, grace_s: float = DEFAULT_RECLAIM_GRACE_S) -> None:
        """Spot-reclamation notice: republish this instance with
        ``reclaiming`` (and ``draining``, so every legacy gate holds) in
        its discovery metadata — routers and the KV aggregator stop
        sending work within one watch event — then hand the grace
        window to :attr:`on_reclaim` for in-flight triage. A notice
        while reclaiming returns once the first notice's republish and
        triage have run (shielded: cancelling a waiter, or the watch
        task that started it, never cuts the triage)."""
        if self._reclaim_run is None:
            if self.info.metadata.get("reclaiming"):
                return
            self._reclaim_run = asyncio.ensure_future(self._reclaim(grace_s))
        await asyncio.shield(self._reclaim_run)

    async def _reclaim(self, grace_s: float) -> None:
        from ..telemetry import get_telemetry

        self.info.metadata = {
            **self.info.metadata,
            "reclaiming": True,
            "reclaim_grace_s": grace_s,
            "draining": True,
        }
        await self.endpoint.drt.discovery.register_instance(self.info, self.lease)
        get_telemetry().reclaim_events.labels("notice").inc()
        logger.warning(
            "instance %d reclaiming (endpoint %s, grace %.1fs)",
            self.info.instance_id,
            self.endpoint.path,
            grace_s,
        )
        if self.on_reclaim is not None:
            await self.on_reclaim(grace_s)

    async def drain(self) -> None:
        """Signal drain: republish this instance with ``draining`` set in
        its discovery metadata. Routers stop sending new work on their
        next snapshot; in-flight requests keep streaming. Call
        :meth:`close` afterwards to wait them out and deregister."""
        if self.info.metadata.get("draining"):
            return
        from ..telemetry import get_telemetry

        self.info.metadata = {**self.info.metadata, "draining": True}
        await self.endpoint.drt.discovery.register_instance(self.info, self.lease)
        get_telemetry().drain_events.labels("started").inc()
        logger.info(
            "instance %d draining (endpoint %s)",
            self.info.instance_id,
            self.endpoint.path,
        )

    async def close(self, revoke_lease: bool | None = None) -> None:
        """Stop serving: drop from discovery first, then drain inflight
        requests (graceful-shutdown order).

        By default the lease is revoked only if it is dedicated to this
        instance; a process-shared primary lease (which other endpoints
        ride on) is left alone and just this instance is deregistered.
        """
        drt = self.endpoint.drt
        if self._drain_task is not None:
            self._drain_task.cancel()
            self._drain_task = None
        if self._reclaim_task is not None:
            self._reclaim_task.cancel()
            self._reclaim_task = None
        if revoke_lease is None:
            revoke_lease = self.lease is not drt._primary_lease
        if revoke_lease and self.lease.is_valid():
            await self.lease.revoke()
        else:
            await drt.discovery.deregister_instance(self.info.instance_id)
        await self._served.close()
        if self.is_draining:
            from ..telemetry import get_telemetry

            get_telemetry().drain_events.labels("completed").inc()


def _validate_segment(name: str) -> None:
    if not name or any(c in name for c in "./ \t\n"):
        raise ValueError(f"invalid name segment: {name!r}")


async def annotated_stream(
    engine,
    request: dict,
    context: AsyncEngineContext | None = None,
) -> AsyncIterator[dict]:
    """Adapt an AsyncEngine of dicts into an Annotated-frame handler stream."""
    from .annotated import Annotated

    ctx = context or AsyncEngineContext()
    try:
        stream = await engine.generate(request, ctx)
        async for item in stream:
            yield Annotated.from_data(item).to_dict()
    except Exception as e:  # error frames travel in-band
        yield Annotated.from_error(str(e)).to_dict()
