"""In-process transport: discovery and the request plane without a network.

Counterpart of ``dynamo_exp_tpu/runtime/transports/inproc.py``: static
mode, where the whole component / endpoint / router stack runs inside
one process. Also the in-process event plane, work queue and object
store that static discovery hands out.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import weakref
from typing import AsyncIterator

from ..engine import AsyncEngineContext
from .base import (
    Discovery,
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

_instance_ids = itertools.count(1)


def next_instance_id() -> int:
    return next(_instance_ids)


class InProcLease(Lease):
    def __init__(self, discovery: "InProcDiscovery", lease_id: int):
        self._discovery = discovery
        self._id = lease_id
        self._valid = True

    @property
    def lease_id(self) -> int:
        return self._id

    def is_valid(self) -> bool:
        return self._valid

    async def revoke(self) -> None:
        if self._valid:
            self._valid = False
            await self._discovery._revoke_lease(self._id)


class InProcDiscovery(Discovery):
    """Registry + KV store living in process memory, with watches."""

    def __init__(self):
        self._instances: dict[int, InstanceInfo] = {}
        self._kv: dict[str, bytes] = {}
        self._lease_keys: dict[int, set[str]] = {}
        self._lease_instances: dict[int, set[int]] = {}
        self._change = asyncio.Condition()
        self._version = 0

    async def _bump(self) -> None:
        async with self._change:
            self._version += 1
            self._change.notify_all()

    async def create_lease(self, ttl_s: float | None = None) -> Lease:
        lease = InProcLease(self, next_instance_id())
        self._lease_keys.setdefault(lease.lease_id, set())
        return lease

    async def register_instance(
        self, info: InstanceInfo, lease: Lease | None = None
    ) -> Lease:
        if lease is None:
            lease = await self.create_lease()
        self._instances[info.instance_id] = info
        self._lease_instances.setdefault(lease.lease_id, set()).add(info.instance_id)
        await self._bump()
        return lease

    async def deregister_instance(self, instance_id: int) -> None:
        self._instances.pop(instance_id, None)
        for insts in self._lease_instances.values():
            insts.discard(instance_id)
        await self._bump()

    async def _revoke_lease(self, lease_id: int) -> None:
        for inst in self._lease_instances.pop(lease_id, set()):
            self._instances.pop(inst, None)
        for key in self._lease_keys.pop(lease_id, set()):
            self._kv.pop(key, None)
        await self._bump()

    async def list_instances(self, prefix: str) -> list[InstanceInfo]:
        return [
            i for i in self._instances.values() if i.address.path.startswith(prefix)
        ]

    async def watch_instances(self, prefix: str) -> AsyncIterator[list[InstanceInfo]]:
        last = -1
        while True:
            async with self._change:
                if self._version == last:
                    await self._change.wait()
                last = self._version
            yield await self.list_instances(prefix)

    async def kv_put(self, key: str, value: bytes, lease: Lease | None = None) -> None:
        self._kv[key] = value
        if lease is not None:
            self._lease_keys.setdefault(lease.lease_id, set()).add(key)
        await self._bump()

    async def kv_create(
        self, key: str, value: bytes, lease: Lease | None = None
    ) -> bool:
        if key in self._kv:
            return False
        await self.kv_put(key, value, lease)
        return True

    async def kv_get(self, key: str) -> bytes | None:
        return self._kv.get(key)

    async def kv_get_prefix(self, prefix: str) -> dict[str, bytes]:
        return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    async def kv_delete(self, key: str) -> None:
        self._kv.pop(key, None)
        await self._bump()

    async def kv_watch_prefix(self, prefix: str) -> AsyncIterator[dict[str, bytes]]:
        last = -1
        while True:
            async with self._change:
                if self._version == last:
                    await self._change.wait()
                last = self._version
            yield await self.kv_get_prefix(prefix)


class _InProcServed(ServedEndpoint):
    def __init__(self, plane: "InProcRequestPlane", instance_id: int):
        self._plane = plane
        self._instance_id = instance_id

    async def close(self) -> None:
        entry = self._plane._handlers.pop(self._instance_id, None)
        if entry is not None:
            # Graceful drain: wait for inflight requests to finish.
            _, _, inflight = entry
            while inflight[0] > 0:
                await asyncio.sleep(0.005)


class InProcRequestPlane(RequestPlane):
    def __init__(self):
        self._handlers: dict[int, tuple[Handler, StatsHandler | None, list[int]]] = {}

    async def serve(
        self,
        info: InstanceInfo,
        handler: Handler,
        stats_handler: StatsHandler | None = None,
    ) -> ServedEndpoint:
        self._handlers[info.instance_id] = (handler, stats_handler, [0])
        return _InProcServed(self, info.instance_id)

    async def request_stream(
        self,
        instance: InstanceInfo,
        request: dict,
        context: AsyncEngineContext,
    ) -> AsyncIterator[dict]:
        entry = self._handlers.get(instance.instance_id)
        if entry is None:
            raise ConnectionError(
                f"no served endpoint for instance {instance.instance_id}"
            )
        handler, _, inflight = entry
        if context.deadline_expired:
            # Parity with the TCP plane: an expired request is refused
            # in-band before the handler runs.
            from ...telemetry import get_telemetry

            get_telemetry().deadline_exceeded.labels("request_plane").inc()

            async def _expired() -> AsyncIterator[dict]:
                yield {
                    "event": "error",
                    "comment": [f"deadline exceeded for request {context.id}"],
                }

            return _expired()

        # Count the request as inflight from dispatch (not first iteration),
        # so graceful drain can't miss a just-dispatched request.
        inflight[0] += 1
        done = [False]

        def _finish() -> None:
            if not done[0]:
                done[0] = True
                inflight[0] -= 1

        async def _gen() -> AsyncIterator[dict]:
            try:
                agen = handler(request, context)
                async for frame in agen:
                    if context.is_killed:
                        with contextlib.suppress(Exception):
                            await agen.aclose()
                        break
                    yield frame
            finally:
                _finish()

        gen = _gen()
        # Fallback: if the caller drops the stream without ever iterating,
        # the generator's finally never runs; decrement on GC instead.
        weakref.finalize(gen, _finish)
        return gen

    async def scrape_stats(self, instance: InstanceInfo) -> dict:
        entry = self._handlers.get(instance.instance_id)
        if entry is None:
            raise ConnectionError(f"instance {instance.instance_id} gone")
        _, stats_handler, inflight = entry
        stats = {"inflight": inflight[0]}
        if stats_handler is not None:
            stats.update(stats_handler())
        return stats


class InProcEventPlane(EventPlane):
    """Subject-based fan-out pub/sub inside one process. Subjects support
    a trailing ``*`` wildcard on subscribe (``ns.comp.*``)."""

    def __init__(self):
        self._subs: dict[str, list[asyncio.Queue]] = {}

    async def publish(self, subject: str, payload: dict) -> None:
        for pattern, queues in list(self._subs.items()):
            if pattern == subject or (
                pattern.endswith("*") and subject.startswith(pattern[:-1])
            ):
                for q in queues:
                    q.put_nowait(payload)

    async def subscribe(self, subject: str) -> AsyncIterator[dict]:
        # Register the queue before returning so events published between
        # subscribe() and the consumer's first await are not lost.
        q: asyncio.Queue = asyncio.Queue()
        self._subs.setdefault(subject, []).append(q)

        async def _gen() -> AsyncIterator[dict]:
            try:
                while True:
                    yield await q.get()
            finally:
                with contextlib.suppress(ValueError):
                    self._subs.get(subject, []).remove(q)

        return _gen()


class InProcWorkQueue(WorkQueue):
    """FIFO queue in process memory (static-mode prefill queue)."""

    def __init__(self):
        self._q: asyncio.Queue[bytes] = asyncio.Queue()

    async def push(self, payload: bytes) -> None:
        self._q.put_nowait(payload)

    async def pull(self, timeout_s: float | None = None) -> bytes | None:
        try:
            if timeout_s is None:
                return await self._q.get()
            return await asyncio.wait_for(self._q.get(), timeout_s)
        except asyncio.TimeoutError:
            return None

    async def size(self) -> int:
        return self._q.qsize()


class InProcObjectStore(ObjectStore):
    def __init__(self):
        self._buckets: dict[str, dict[str, bytes]] = {}

    async def put(self, bucket: str, key: str, data: bytes) -> None:
        self._buckets.setdefault(bucket, {})[key] = data

    async def get(self, bucket: str, key: str) -> bytes | None:
        return self._buckets.get(bucket, {}).get(key)

    async def delete(self, bucket: str, key: str) -> None:
        self._buckets.get(bucket, {}).pop(key, None)

    async def list(self, bucket: str) -> list[str]:
        return sorted(self._buckets.get(bucket, {}))
