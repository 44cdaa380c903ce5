"""Deterministic fault injection for the distributed fabric (counterpart
of ``dynamo_exp_tpu/runtime/transports/chaos.py``).

Wraps any :class:`RequestPlane` / :class:`Discovery` / :class:`WorkQueue`
with a seeded, scripted fault schedule so failure scenarios — worker
crash at stream start or mid-stream, network partition, discovery watch
flaps, work-queue outages, injected latency — are reproducible
bit-for-bit across runs, and equal to the JAX package's planes' for the
same seed and script (``tests/test_torch_chaos.py``).
:class:`StorageChaos` is the seeded fault source of the G3 persistent
KV tier (``kv/persistent.py``).

Two fault sources compose:

- **scripted faults** (:meth:`ChaosSchedule.add` and its shorthands):
  consumed in insertion order whenever a matching op fires, each a fixed
  number of times. Deterministic by construction.
- **partitions** (:meth:`ChaosSchedule.partition` / :meth:`heal`): a set
  of instance ids that are unreachable until healed — the "machine
  dropped off the network" primitive.

The only randomness is delay jitter, drawn from ``random.Random(seed)``,
so a given (seed, script, workload) triple always injects the same
faults at the same points. Every injected fault is appended to
:attr:`ChaosSchedule.injected` for assertions and cross-run comparison.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
from dataclasses import dataclass
from typing import AsyncIterator

from ..engine import AsyncEngineContext
from .base import (
    Discovery,
    Handler,
    InstanceInfo,
    Lease,
    RequestPlane,
    ServedEndpoint,
    StatsHandler,
    WorkQueue,
)


@dataclass
class Fault:
    """One scripted fault.

    ``op`` selects the interception point: ``request`` / ``stats`` on the
    request plane, ``watch`` / ``list`` on discovery, ``push`` / ``pull``
    / ``size`` on a work queue.

    ``kind``: ``error`` raises :class:`ConnectionError` (for ``request``,
    :attr:`after_frames` refines *when*: ``None`` fails the dispatch
    itself, ``N >= 0`` starts the stream and kills it after N frames —
    the worker-crash-mid-stream shape; :attr:`after_tokens` is the same
    cut expressed in **tokens**: the stream dies once N tokens have been
    delivered, counting ``len(frame.data.token_ids)`` per frame — the
    kill-at-token-K primitive resumable-stream tests script); ``delay``
    sleeps ``delay_s`` (plus seeded jitter) and then proceeds normally.

    ``times``: how many matching calls consume this fault (-1 = every
    matching call until the schedule is cleared).
    """

    op: str
    kind: str = "error"
    instance_id: int | None = None
    after_frames: int | None = None
    after_tokens: int | None = None
    delay_s: float = 0.0
    times: int = 1
    message: str = "chaos: injected fault"


class ChaosSchedule:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: list[Fault] = []
        self.partitioned: set[int] = set()
        # Log of every fault that actually fired, for determinism checks.
        self.injected: list[str] = []

    # ------------------------------------------------------------ script
    def add(self, fault: Fault) -> "ChaosSchedule":
        self.faults.append(fault)
        return self

    def fail_requests(
        self,
        instance_id: int | None = None,
        times: int = 1,
        after_frames: int | None = None,
    ) -> "ChaosSchedule":
        return self.add(
            Fault(
                "request",
                instance_id=instance_id,
                times=times,
                after_frames=after_frames,
                message="chaos: request failed"
                if after_frames is None
                else "chaos: stream dropped",
            )
        )

    def crash_at_token(
        self, k: int, instance_id: int | None = None, times: int = 1
    ) -> "ChaosSchedule":
        """Kill the response stream once exactly ``k`` tokens have been
        delivered (frames without ``token_ids`` pass through untouched) —
        the decode-worker-dies-mid-generation shape the resumable-stream
        suite replays at several k."""
        return self.add(
            Fault(
                "request",
                instance_id=instance_id,
                times=times,
                after_tokens=k,
                message=f"chaos: decode worker crashed at token {k}",
            )
        )

    def drain_timeout(
        self, instance_id: int | None = None, after_tokens: int = 0, times: int = 1
    ) -> "ChaosSchedule":
        """A graceful drain whose grace period expires mid-stream: the
        instance cuts the connection after ``after_tokens`` tokens
        instead of finishing the request. Distinguished from a crash by
        its message, so recovery telemetry labels it ``drain``."""
        return self.add(
            Fault(
                "request",
                instance_id=instance_id,
                times=times,
                after_tokens=after_tokens,
                message="chaos: drain grace period exceeded mid-stream",
            )
        )

    def reclaim_at(
        self,
        after_tokens: int,
        instance_id: int | None = None,
        grace_s: float = 1.0,
        times: int = 1,
    ) -> "ChaosSchedule":
        """A spot reclamation landing mid-stream: the platform takes the
        instance back after ``after_tokens`` tokens, cutting the
        connection with a reclaim-tagged message (``grace_s`` rides the
        message for the log) so recovery telemetry labels the failover
        ``reclaim`` and the journal continuation resumes on a survivor
        (docs/fault_tolerance.md "Spot reclamation & live migration")."""
        return self.add(
            Fault(
                "request",
                instance_id=instance_id,
                times=times,
                after_tokens=after_tokens,
                message=(
                    f"chaos: instance reclaimed mid-stream "
                    f"(grace {grace_s:g}s)"
                ),
            )
        )

    def fail_watch(self, times: int = 1) -> "ChaosSchedule":
        return self.add(Fault("watch", times=times, message="chaos: watch broke"))

    def fail_queue(self, op: str, times: int = 1) -> "ChaosSchedule":
        assert op in ("push", "pull", "size")
        return self.add(Fault(op, times=times, message=f"chaos: queue {op} down"))

    def delay_requests(
        self, delay_s: float, instance_id: int | None = None, times: int = 1
    ) -> "ChaosSchedule":
        return self.add(
            Fault(
                "request",
                kind="delay",
                instance_id=instance_id,
                delay_s=delay_s,
                times=times,
            )
        )

    def partition(self, *instance_ids: int) -> "ChaosSchedule":
        self.partitioned.update(instance_ids)
        return self

    def heal(self, *instance_ids: int) -> "ChaosSchedule":
        if instance_ids:
            self.partitioned.difference_update(instance_ids)
        else:
            self.partitioned.clear()
        return self

    def clear(self) -> "ChaosSchedule":
        self.faults.clear()
        self.partitioned.clear()
        return self

    # ----------------------------------------------------------- consume
    def take(self, op: str, instance_id: int | None = None) -> Fault | None:
        for f in self.faults:
            if f.op != op or f.times == 0:
                continue
            if (
                f.instance_id is not None
                and instance_id is not None
                and f.instance_id != instance_id
            ):
                continue
            if f.times > 0:
                f.times -= 1
            self.injected.append(f"{op}:{instance_id}:{f.kind}")
            return f
        return None

    async def apply_delay(self, fault: Fault) -> None:
        jitter = self.rng.random() * fault.delay_s * 0.1
        await asyncio.sleep(fault.delay_s + jitter)


class StorageChaos:
    """Seeded storage-fault schedule for the G3 persistent KV tier
    (the JAX package's docs/fault_tolerance.md, "Durable KV & corruption
    containment").

    Same consume-in-order contract as :class:`ChaosSchedule`, over the
    store's two interception points — ``store_write`` (demotion /
    shutdown drain) and ``store_read`` (promotion / re-attach fetch) —
    with storage-flavoured kinds:

    - ``enospc``: the write raises ``OSError(ENOSPC)`` → the store
      counts it and flips :attr:`~dynamo_exp_tpu_torch.kv.persistent.PersistentKvStore.degraded`
      (engine falls back to G2-only, never a stall).
    - ``torn``: the page file lands as a truncated prefix of the real
      bytes — the power-cut-mid-write shape ``boot_scan`` and the fetch
      checksum must both reject.
    - ``bitflip``: one payload byte of the *read* is flipped at a
      position drawn from the seeded rng — fetch must checksum-fail,
      quarantine, and miss; never serve the garbage.
    - ``delay``: the read sleeps ``delay_s`` first — a slow SSD must
      slow restores, never wedge the engine loop.

    The fifth family member — store-dir missing — needs no schedule: it
    is exercised by constructing the store over an uncreatable path.
    Every fired fault lands in :attr:`injected` for assertions.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: list[Fault] = []
        self.injected: list[str] = []

    # ------------------------------------------------------------ script
    def add(self, fault: Fault) -> "StorageChaos":
        assert fault.op in ("store_write", "store_read")
        self.faults.append(fault)
        return self

    def enospc(self, times: int = 1) -> "StorageChaos":
        return self.add(
            Fault(
                "store_write",
                kind="enospc",
                times=times,
                message="chaos: no space left on device",
            )
        )

    def torn_write(self, times: int = 1) -> "StorageChaos":
        return self.add(
            Fault(
                "store_write",
                kind="torn",
                times=times,
                message="chaos: torn page write",
            )
        )

    def bitflip_read(self, times: int = 1) -> "StorageChaos":
        return self.add(
            Fault(
                "store_read",
                kind="bitflip",
                times=times,
                message="chaos: bit flipped in stored page",
            )
        )

    def delay_read(self, delay_s: float, times: int = 1) -> "StorageChaos":
        return self.add(
            Fault(
                "store_read",
                kind="delay",
                delay_s=delay_s,
                times=times,
                message="chaos: slow store read",
            )
        )

    def clear(self) -> "StorageChaos":
        self.faults.clear()
        return self

    # ----------------------------------------------------------- consume
    def take(self, op: str) -> Fault | None:
        for f in self.faults:
            if f.op != op or f.times == 0:
                continue
            if f.times > 0:
                f.times -= 1
            self.injected.append(f"{op}:{f.kind}")
            return f
        return None


@dataclass
class BurstRequest:
    """One request of a seeded overload burst (see :func:`overload_burst`)."""

    index: int
    priority: str  # "low" | "normal" | "high"
    prompt: list[int]
    max_tokens: int
    delay_s: float  # submission offset within the burst
    seed: int  # sampling seed (pinned, so replays are token-identical)


def overload_burst(
    seed: int,
    n: int = 12,
    priorities: tuple[str, ...] = ("low", "normal", "high"),
    isl_range: tuple[int, int] = (4, 12),
    osl_range: tuple[int, int] = (6, 16),
    vocab_range: tuple[int, int] = (3, 200),
    spread_s: float = 0.0,
) -> list[BurstRequest]:
    """A deterministic N-request burst with mixed priorities — the
    overload-protection scenario (``tests/test_overload.py``, ``make
    chaos``): fired against a deliberately tiny KV pool, it must drive
    edge shedding (429/503) and engine KV-pressure preemption without
    ever hanging a request.

    Everything — prompts, lengths, priorities, per-request sampling
    seeds, submission jitter — derives from ``random.Random(seed)``, so
    a given seed always produces the same burst and cross-run
    determinism assertions hold bit-for-bit.
    """
    rng = random.Random(seed)
    burst = []
    for i in range(n):
        isl = rng.randint(*isl_range)
        burst.append(
            BurstRequest(
                index=i,
                priority=priorities[rng.randrange(len(priorities))],
                prompt=[rng.randint(*vocab_range) for _ in range(isl)],
                max_tokens=rng.randint(*osl_range),
                delay_s=rng.random() * spread_s,
                seed=rng.getrandbits(31),
            )
        )
    return burst


class ChaosRequestPlane(RequestPlane):
    """RequestPlane decorator injecting scheduled faults client-side."""

    def __init__(self, inner: RequestPlane, schedule: ChaosSchedule):
        self.inner = inner
        self.schedule = schedule

    async def serve(
        self,
        info: InstanceInfo,
        handler: Handler,
        stats_handler: StatsHandler | None = None,
    ) -> ServedEndpoint:
        return await self.inner.serve(info, handler, stats_handler)

    async def request_stream(
        self,
        instance: InstanceInfo,
        request: dict,
        context: AsyncEngineContext,
    ) -> AsyncIterator[dict]:
        iid = instance.instance_id
        if iid in self.schedule.partitioned:
            self.schedule.injected.append(f"request:{iid}:partition")
            raise ConnectionError(f"chaos: instance {iid} partitioned")
        fault = self.schedule.take("request", iid)
        if fault is not None:
            if fault.kind == "delay":
                await self.schedule.apply_delay(fault)
            elif fault.after_tokens is not None:
                inner = await self.inner.request_stream(
                    instance, request, context
                )
                return _drop_after_tokens(
                    inner, fault.after_tokens, fault.message
                )
            elif fault.after_frames is None:
                raise ConnectionError(fault.message)
            else:
                inner = await self.inner.request_stream(
                    instance, request, context
                )
                return _drop_after(inner, fault.after_frames, fault.message)
        return await self.inner.request_stream(instance, request, context)

    async def scrape_stats(self, instance: InstanceInfo) -> dict:
        iid = instance.instance_id
        if iid in self.schedule.partitioned:
            raise ConnectionError(f"chaos: instance {iid} partitioned")
        fault = self.schedule.take("stats", iid)
        if fault is not None and fault.kind == "error":
            raise ConnectionError(fault.message)
        return await self.inner.scrape_stats(instance)

    async def close(self) -> None:
        await self.inner.close()


async def _drop_after(
    frames: AsyncIterator[dict], n: int, message: str
) -> AsyncIterator[dict]:
    """Yield ``n`` frames, then die like a crashed worker connection."""
    produced = 0
    async for frame in frames:
        if produced >= n:
            closer = getattr(frames, "aclose", None)
            if closer is not None:
                with contextlib.suppress(Exception):
                    await closer()
            raise ConnectionError(message)
        yield frame
        produced += 1
    if produced < n:
        return  # stream ended before the scheduled crash point
    raise ConnectionError(message)


async def _drop_after_tokens(
    frames: AsyncIterator[dict], k: int, message: str
) -> AsyncIterator[dict]:
    """Yield frames until ``k`` tokens have been delivered, then die like
    a crashed worker connection — immediately after the frame that
    reaches the count (so a trailing finish/usage frame is lost with the
    connection, exactly like a real crash). ``k=0`` kills before the
    first token-bearing frame. Token counting inspects the engine-frame
    shape (``data.token_ids``). A stream that ends before K tokens never
    reaches its scheduled crash point (mirrors ``_drop_after``)."""
    delivered = 0
    async for frame in frames:
        data = frame.get("data") if isinstance(frame, dict) else None
        n_toks = (
            len(data.get("token_ids") or []) if isinstance(data, dict) else 0
        )
        crash_before = n_toks > 0 and delivered >= k  # only when k == 0
        if not crash_before:
            yield frame
            delivered += n_toks
        if crash_before or delivered >= k:
            closer = getattr(frames, "aclose", None)
            if closer is not None:
                with contextlib.suppress(Exception):
                    await closer()
            raise ConnectionError(message)


class ChaosDiscovery(Discovery):
    """Discovery decorator: watch flaps and list outages on schedule.

    Registration/KV ops pass straight through — the scenarios under test
    are consumer-side (clients and routers), not publisher-side.
    """

    def __init__(self, inner: Discovery, schedule: ChaosSchedule):
        self.inner = inner
        self.schedule = schedule

    async def register_instance(
        self, info: InstanceInfo, lease: Lease | None = None
    ) -> Lease:
        return await self.inner.register_instance(info, lease)

    async def create_lease(self, ttl_s: float | None = None) -> Lease:
        return await self.inner.create_lease(ttl_s)

    async def deregister_instance(self, instance_id: int) -> None:
        await self.inner.deregister_instance(instance_id)

    async def list_instances(self, prefix: str) -> list[InstanceInfo]:
        fault = self.schedule.take("list")
        if fault is not None and fault.kind == "error":
            raise ConnectionError(fault.message)
        return await self.inner.list_instances(prefix)

    async def watch_instances(
        self, prefix: str
    ) -> AsyncIterator[list[InstanceInfo]]:
        # The flap fires *after* a snapshot is delivered: the consumer saw
        # data, then the stream broke — the shape Client._watch must
        # survive by re-subscribing.
        async for snapshot in self.inner.watch_instances(prefix):
            yield snapshot
            fault = self.schedule.take("watch")
            if fault is not None and fault.kind == "error":
                raise ConnectionError(fault.message)

    async def kv_put(self, key: str, value: bytes, lease: Lease | None = None) -> None:
        await self.inner.kv_put(key, value, lease)

    async def kv_create(
        self, key: str, value: bytes, lease: Lease | None = None
    ) -> bool:
        return await self.inner.kv_create(key, value, lease)

    async def kv_get(self, key: str) -> bytes | None:
        return await self.inner.kv_get(key)

    async def kv_get_prefix(self, prefix: str) -> dict[str, bytes]:
        return await self.inner.kv_get_prefix(prefix)

    async def kv_delete(self, key: str) -> None:
        await self.inner.kv_delete(key)

    async def kv_watch_prefix(self, prefix: str) -> AsyncIterator[dict[str, bytes]]:
        async for snapshot in self.inner.kv_watch_prefix(prefix):
            yield snapshot

    # Sibling planes ride the inner fabric; queues get the chaos wrapper
    # so disagg scenarios can take the prefill queue down.
    def _new_event_plane(self):
        return self.inner.event_plane()

    def _new_work_queue(self, name: str) -> "ChaosWorkQueue":
        return ChaosWorkQueue(self.inner.work_queue(name), self.schedule)

    def _new_object_store(self):
        return self.inner.object_store()

    async def close(self) -> None:
        await self.inner.close()


class ChaosWorkQueue(WorkQueue):
    """WorkQueue decorator: outages on push/pull/size."""

    def __init__(self, inner: WorkQueue, schedule: ChaosSchedule):
        self.inner = inner
        self.schedule = schedule

    async def push(self, payload: bytes) -> None:
        fault = self.schedule.take("push")
        if fault is not None:
            if fault.kind == "delay":
                await self.schedule.apply_delay(fault)
            else:
                raise ConnectionError(fault.message)
        await self.inner.push(payload)

    async def pull(self, timeout_s: float | None = None) -> bytes | None:
        fault = self.schedule.take("pull")
        if fault is not None and fault.kind == "error":
            raise ConnectionError(fault.message)
        return await self.inner.pull(timeout_s)

    async def size(self) -> int:
        fault = self.schedule.take("size")
        if fault is not None and fault.kind == "error":
            raise ConnectionError(fault.message)
        return await self.inner.size()
