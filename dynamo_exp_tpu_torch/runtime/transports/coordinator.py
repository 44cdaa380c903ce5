"""Self-hosted control plane: one coordinator server for discovery,
leases, watches, pub/sub, work queues and the object store.

Counterpart of ``dynamo_exp_tpu/runtime/transports/coordinator.py``, on
the same wire (``codec.py``, the same ops and header fields), so a
worker or ingress of either package talks to a coordinator of either:

- **leases** with TTL + keepalive; expiry removes everything registered
  under the lease (instances and KV keys): elastic membership;
- **instance registry** with prefix watches (full-snapshot push);
- **KV store** with prefix watches (model entries, drain intents);
- **pub/sub subjects** with trailing-``*`` wildcards (KV events);
- **FIFO work queues** with blocking pull;
- **object store** buckets (model deployment cards).

Clients hold one persistent connection; requests are correlated by id
and watch pushes arrive unsolicited on the same socket. Losing the
connection stops keepalives, so the server expires the client's leases
within one TTL.

    python -m dynamo_exp_tpu_torch.runtime.transports.coordinator --host H --port P

prints ``coordinator ready on H:P`` once it listens.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import itertools
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator

from ...telemetry import current_trace_id
from .base import (
    Discovery,
    EventPlane,
    InstanceInfo,
    Lease,
    ObjectStore,
    WorkQueue,
)
from .codec import MsgType, TwoPartMessage, read_message, write_message

logger = logging.getLogger(__name__)

_b64 = base64.b64encode
_unb64 = base64.b64decode


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------


@dataclass
class _LeaseState:
    lease_id: int
    ttl_s: float
    expires_at: float
    instance_ids: set[int] = field(default_factory=set)
    keys: set[str] = field(default_factory=set)


@dataclass
class _Watch:
    conn: "_Conn"
    watch_id: int  # client-chosen, unique only per connection
    prefix: str
    kind: str  # "instances" | "kv" | "events"

    @property
    def key(self) -> tuple[int, int]:
        # Server-side identity: watch ids from different client connections
        # collide, so the registry keys on (connection, watch_id).
        return (self.conn.conn_id, self.watch_id)


_conn_ids = itertools.count(1)


class _Conn:
    def __init__(self, writer: asyncio.StreamWriter):
        self.conn_id = next(_conn_ids)
        self.writer = writer
        self.lock = asyncio.Lock()
        self.watch_keys: set[tuple[int, int]] = set()

    async def send(self, header: dict, payload: bytes = b"") -> None:
        async with self.lock:
            await write_message(
                self.writer, TwoPartMessage(MsgType.DATA, header, payload)
            )


class _FifoQueue:
    """Work queue supporting put-front, so an item popped for a client that
    died before delivery can be returned to the head instead of lost."""

    def __init__(self):
        self._items: deque[bytes] = deque()
        self._ready = asyncio.Condition()

    def qsize(self) -> int:
        return len(self._items)

    async def put(self, item: bytes, front: bool = False) -> None:
        async with self._ready:
            if front:
                self._items.appendleft(item)
            else:
                self._items.append(item)
            self._ready.notify()

    async def get(self, timeout_s: float) -> bytes | None:
        async def _pop() -> bytes:
            async with self._ready:
                while not self._items:
                    await self._ready.wait()
                return self._items.popleft()

        try:
            return await asyncio.wait_for(_pop(), timeout_s)
        except asyncio.TimeoutError:
            return None


class CoordinatorServer:
    """The control-plane server. Run standalone via
    ``python -m dynamo_exp_tpu_torch.runtime.transports.coordinator``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._ids = itertools.count(1)
        self._leases: dict[int, _LeaseState] = {}
        self._instances: dict[int, InstanceInfo] = {}
        self._kv: dict[str, bytes] = {}
        self._watches: dict[tuple[int, int], _Watch] = {}
        self._queues: dict[str, _FifoQueue] = {}
        self._buckets: dict[str, dict[str, bytes]] = {}
        self._sweeper: asyncio.Task | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._sweeper = asyncio.ensure_future(self._sweep_leases())
        logger.info("coordinator listening on %s:%d", self.host, self.port)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self) -> None:
        if self._sweeper:
            self._sweeper.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._sweeper
        if self._server:
            self._server.close()
            # Python 3.12's wait_closed blocks until every connection
            # handler returns — shutdown must not depend on clients
            # hanging up first, so drop live connections ourselves.
            for w in list(self._writers):
                with contextlib.suppress(Exception):
                    w.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------ lease sweep
    async def _sweep_leases(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            expired = [ls for ls in self._leases.values() if ls.expires_at <= now]
            for ls in expired:
                logger.info("lease %d expired", ls.lease_id)
                await self._revoke_lease(ls.lease_id)

    async def _revoke_lease(self, lease_id: int) -> None:
        ls = self._leases.pop(lease_id, None)
        if ls is None:
            return
        touched_instances = False
        touched_keys: set[str] = set()
        for iid in ls.instance_ids:
            if self._instances.pop(iid, None) is not None:
                touched_instances = True
        for key in ls.keys:
            if self._kv.pop(key, None) is not None:
                touched_keys.add(key)
        if touched_instances:
            await self._notify_instance_watches()
        for key in touched_keys:
            await self._notify_kv_watches(key)

    # --------------------------------------------------------------- watches
    async def _notify_instance_watches(self) -> None:
        for w in list(self._watches.values()):
            if w.kind != "instances":
                continue
            snapshot = [
                i.to_dict()
                for i in self._instances.values()
                if i.address.path.startswith(w.prefix)
            ]
            await self._push(w, {"instances": snapshot})

    async def _notify_kv_watches(self, changed_key: str) -> None:
        for w in list(self._watches.values()):
            if w.kind != "kv" or not changed_key.startswith(w.prefix):
                continue
            snapshot = {
                k: _b64(v).decode()
                for k, v in self._kv.items()
                if k.startswith(w.prefix)
            }
            await self._push(w, {"entries": snapshot})

    async def _push(self, w: _Watch, body: dict) -> None:
        try:
            await w.conn.send({"push": w.watch_id, **body})
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            self._watches.pop(w.key, None)

    # ------------------------------------------------------------ connection
    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _Conn(writer)
        self._writers.add(writer)
        try:
            while True:
                try:
                    msg = await read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                asyncio.ensure_future(self._dispatch(conn, msg))
        finally:
            self._writers.discard(writer)
            for key in list(conn.watch_keys):
                self._watches.pop(key, None)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _dispatch(self, conn: _Conn, msg: TwoPartMessage) -> None:
        op = msg.header.get("op", "")
        rid = msg.header.get("rid")
        try:
            body, payload = await self._handle_op(conn, op, msg.header, msg.payload)
        except Exception as e:  # noqa: BLE001 - all op errors go in-band
            logger.exception("coordinator op %s failed", op)
            body, payload = {"error": f"{type(e).__name__}: {e}"}, b""
        if rid is None:
            return
        try:
            await conn.send({"rid": rid, **body}, payload)
        except (ConnectionError, OSError):
            # Client died between request and response. A popped queue item
            # would otherwise be lost — return it to the head of its queue.
            if op == "queue_pull" and body.get("found"):
                await self._queues[msg.header["queue"]].put(payload, front=True)

    async def _handle_op(
        self, conn: _Conn, op: str, h: dict, payload: bytes
    ) -> tuple[dict, bytes]:
        if op == "lease_create":
            lease_id = next(self._ids)
            ttl = float(h.get("ttl_s") or 10.0)
            self._leases[lease_id] = _LeaseState(
                lease_id, ttl, time.monotonic() + ttl
            )
            return {"lease_id": lease_id}, b""
        if op == "lease_keepalive":
            ls = self._leases.get(h["lease_id"])
            if ls is None:
                return {"error": "lease expired"}, b""
            ls.expires_at = time.monotonic() + ls.ttl_s
            return {"ok": True}, b""
        if op == "lease_revoke":
            await self._revoke_lease(h["lease_id"])
            return {"ok": True}, b""
        if op == "register":
            info = InstanceInfo.from_dict(h["instance"])
            ls = self._leases.get(h.get("lease_id", 0))
            if ls is None:
                return {"error": "lease expired"}, b""
            self._instances[info.instance_id] = info
            ls.instance_ids.add(info.instance_id)
            await self._notify_instance_watches()
            return {"ok": True}, b""
        if op == "deregister":
            self._instances.pop(h["instance_id"], None)
            for ls in self._leases.values():
                ls.instance_ids.discard(h["instance_id"])
            await self._notify_instance_watches()
            return {"ok": True}, b""
        if op == "list":
            snapshot = [
                i.to_dict()
                for i in self._instances.values()
                if i.address.path.startswith(h.get("prefix", ""))
            ]
            return {"instances": snapshot}, b""
        if op == "watch":
            w = _Watch(conn, h["watch_id"], h.get("prefix", ""), h["kind"])
            self._watches[w.key] = w
            conn.watch_keys.add(w.key)
            if w.kind == "instances":
                await self._notify_instance_watches()
            elif w.kind == "kv":
                await self._notify_kv_watches(w.prefix)
            return {"ok": True}, b""
        if op == "unwatch":
            key = (conn.conn_id, h["watch_id"])
            self._watches.pop(key, None)
            conn.watch_keys.discard(key)
            return {"ok": True}, b""
        if op == "kv_put" or op == "kv_create":
            key = h["key"]
            if op == "kv_create" and key in self._kv:
                return {"created": False}, b""
            self._kv[key] = payload
            if h.get("lease_id"):
                ls = self._leases.get(h["lease_id"])
                if ls is None:
                    self._kv.pop(key, None)
                    return {"error": "lease expired"}, b""
                ls.keys.add(key)
            await self._notify_kv_watches(key)
            return {"created": True}, b""
        if op == "kv_get":
            val = self._kv.get(h["key"])
            return {"found": val is not None}, val or b""
        if op == "kv_get_prefix":
            entries = {
                k: _b64(v).decode()
                for k, v in self._kv.items()
                if k.startswith(h.get("prefix", ""))
            }
            return {"entries": entries}, b""
        if op == "kv_delete":
            self._kv.pop(h["key"], None)
            await self._notify_kv_watches(h["key"])
            return {"ok": True}, b""
        if op == "publish":
            subject = h["subject"]
            for w in list(self._watches.values()):
                if w.kind != "events":
                    continue
                if w.prefix == subject or (
                    w.prefix.endswith("*") and subject.startswith(w.prefix[:-1])
                ):
                    await self._push(w, {"subject": subject, "event": h["event"]})
            return {"ok": True}, b""
        if op == "queue_push":
            await self._queues.setdefault(h["queue"], _FifoQueue()).put(payload)
            return {"ok": True}, b""
        if op == "queue_pull":
            q = self._queues.setdefault(h["queue"], _FifoQueue())
            timeout = h.get("timeout_s")
            # Cap server-side blocking so a dead client can't pin a task
            # forever; the client loops on timeouts.
            item = await q.get(min(timeout or 5.0, 5.0))
            if item is None:
                return {"found": False}, b""
            return {"found": True}, item
        if op == "queue_size":
            q = self._queues.get(h["queue"])
            return {"size": q.qsize() if q else 0}, b""
        if op == "obj_put":
            self._buckets.setdefault(h["bucket"], {})[h["key"]] = payload
            return {"ok": True}, b""
        if op == "obj_get":
            val = self._buckets.get(h["bucket"], {}).get(h["key"])
            return {"found": val is not None}, val or b""
        if op == "obj_delete":
            self._buckets.get(h["bucket"], {}).pop(h["key"], None)
            return {"ok": True}, b""
        if op == "obj_list":
            return {"keys": sorted(self._buckets.get(h["bucket"], {}))}, b""
        raise ValueError(f"unknown op {op!r}")


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------


class CoordinatorClient:
    """One persistent connection to the coordinator, shared by all planes
    in a process. Request/response correlated by id; watch pushes fan out
    to per-watch queues."""

    def __init__(self, endpoint: str):
        host, _, port = endpoint.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._wlock = asyncio.Lock()
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._watch_queues: dict[int, asyncio.Queue] = {}
        self._reader_task: asyncio.Task | None = None
        self._keepalive_tasks: dict[int, asyncio.Task] = {}
        self._closed = False

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await read_message(self._reader)
                h = msg.header
                if "rid" in h:
                    fut = self._pending.pop(h["rid"], None)
                    if fut is not None and not fut.done():
                        fut.set_result((h, msg.payload))
                elif "push" in h:
                    q = self._watch_queues.get(h["push"])
                    if q is not None:
                        q.put_nowait(h)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            err = ConnectionError("coordinator connection lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            # Watch consumers block on queue.get(); without a sentinel
            # they would hang forever on a dead connection instead of
            # seeing an error they can retry on.
            for q in self._watch_queues.values():
                q.put_nowait(_CONN_LOST)
            self._watch_queues.clear()

    @property
    def is_alive(self) -> bool:
        return (
            self._writer is not None
            and self._reader_task is not None
            and not self._reader_task.done()
            and not self._closed
        )

    async def call(
        self, op: str, header: dict | None = None, payload: bytes = b""
    ) -> tuple[dict, bytes]:
        # Fail fast on a dead connection: if the reader task is gone its
        # cleanup already ran, so a future registered now would never be
        # resolved — even when the socket still accepts writes (peer sent
        # FIN only) — and the caller would hang forever.
        if not self.is_alive:
            raise ConnectionError("coordinator connection lost")
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        head = {"op": op, "rid": rid, **(header or {})}
        # Control-plane ops performed on behalf of a traced request carry
        # its trace_id so coordinator-side slow-op logs correlate.
        tid = current_trace_id()
        if tid is not None:
            head.setdefault("trace_id", tid)
        msg = TwoPartMessage(MsgType.DATA, head, payload)

        # Shielded, with the lock INSIDE the shield: this connection is
        # shared by every plane in the process. A caller cancelled
        # mid-write would leave a partial frame on the socket and desync
        # the stream for everyone — the write must complete atomically,
        # and the lock must stay held until it does (a shield around the
        # bare write would release the lock to the next writer while
        # bytes are still going out).
        async def _locked_write() -> None:
            async with self._wlock:
                await write_message(self._writer, msg)

        try:
            await asyncio.shield(_locked_write())
            t0 = time.monotonic()
            h, pl = await fut
        finally:
            # A caller cancelled any time after registering rid (even
            # while awaiting the shielded write — the write itself
            # completes, but the CancelledError surfaces here first)
            # would otherwise leave its entry in _pending forever: the
            # reply arrives, resolves a future nobody awaits, and the
            # dict grows per abandoned call. The read loop pops on
            # normal resolution, so this is a no-op on the happy path.
            self._pending.pop(rid, None)
        if (dt := time.monotonic() - t0) > 1.0:
            logger.warning("slow coordinator op %s: %.2fs", op, dt)
        if "error" in h:
            raise CoordinatorError(h["error"])
        return h, pl

    def open_watch(self, kind: str, prefix: str) -> tuple[int, asyncio.Queue]:
        wid = next(self._ids)
        q: asyncio.Queue = asyncio.Queue()
        self._watch_queues[wid] = q
        return wid, q

    async def start_watch(self, wid: int, kind: str, prefix: str) -> None:
        await self.call("watch", {"watch_id": wid, "kind": kind, "prefix": prefix})

    async def stop_watch(self, wid: int) -> None:
        self._watch_queues.pop(wid, None)
        with contextlib.suppress(ConnectionError, CoordinatorError):
            await self.call("unwatch", {"watch_id": wid})

    def spawn_keepalive(self, lease_id: int, ttl_s: float) -> None:
        async def _beat() -> None:
            interval = max(ttl_s / 3.0, 0.1)
            try:
                while True:
                    await asyncio.sleep(interval)
                    await self.call("lease_keepalive", {"lease_id": lease_id})
            except (ConnectionError, CoordinatorError, asyncio.CancelledError):
                pass

        self._keepalive_tasks[lease_id] = asyncio.ensure_future(_beat())

    def stop_keepalive(self, lease_id: int) -> None:
        task = self._keepalive_tasks.pop(lease_id, None)
        if task is not None:
            task.cancel()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for task in self._keepalive_tasks.values():
            task.cancel()
        if self._reader_task is not None:
            self._reader_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._reader_task
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()


class CoordinatorError(RuntimeError):
    pass


# Sentinel pushed into watch queues when the connection dies.
_CONN_LOST = {"__conn_lost__": True}


# --------------------------------------------------------------------------
# Plane adapters
# --------------------------------------------------------------------------


class CoordinatorLease(Lease):
    def __init__(self, client: CoordinatorClient, lease_id: int):
        self._client = client
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
            self._client.stop_keepalive(self._id)
            with contextlib.suppress(ConnectionError, CoordinatorError):
                await self._client.call("lease_revoke", {"lease_id": self._id})


class CoordinatorDiscovery(Discovery):
    """Discovery over the coordinator (etcd-equivalent semantics)."""

    def __init__(self, endpoint: str, lease_ttl_s: float = 10.0):
        self.endpoint = endpoint
        self.client = CoordinatorClient(endpoint)
        self.lease_ttl_s = lease_ttl_s
        self._connected = False
        self._connect_lock: asyncio.Lock | None = None

    async def _ensure(self) -> CoordinatorClient:
        # Lock so concurrent first uses don't both connect (the loser would
        # orphan the winner's socket and read loop). Created lazily because
        # __init__ may run outside any event loop.
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            if self._connected and not self.client.is_alive:
                # Connection died (coordinator restart): retrying callers
                # get a fresh socket instead of the dead client forever.
                # Leases/watches on the old connection are gone — callers
                # re-establish what they need (watch loops re-watch).
                await self.client.close()
                self.client = CoordinatorClient(self.endpoint)
                self._connected = False
            if not self._connected:
                await self.client.connect()
                self._connected = True
        return self.client

    # Sibling planes ride the same coordinator connection.
    def _new_event_plane(self) -> "CoordinatorEventPlane":
        return CoordinatorEventPlane(self)

    def _new_work_queue(self, name: str) -> "CoordinatorWorkQueue":
        return CoordinatorWorkQueue(self, name)

    def _new_object_store(self) -> "CoordinatorObjectStore":
        return CoordinatorObjectStore(self)

    async def create_lease(self, ttl_s: float | None = None) -> Lease:
        c = await self._ensure()
        ttl = ttl_s or self.lease_ttl_s
        h, _ = await c.call("lease_create", {"ttl_s": ttl})
        c.spawn_keepalive(h["lease_id"], ttl)
        return CoordinatorLease(c, h["lease_id"])

    async def register_instance(
        self, info: InstanceInfo, lease: Lease | None = None
    ) -> Lease:
        c = await self._ensure()
        if lease is None:
            lease = await self.create_lease()
        await c.call(
            "register", {"instance": info.to_dict(), "lease_id": lease.lease_id}
        )
        return lease

    async def deregister_instance(self, instance_id: int) -> None:
        c = await self._ensure()
        await c.call("deregister", {"instance_id": instance_id})

    async def list_instances(self, prefix: str) -> list[InstanceInfo]:
        c = await self._ensure()
        h, _ = await c.call("list", {"prefix": prefix})
        return [InstanceInfo.from_dict(d) for d in h["instances"]]

    async def watch_instances(self, prefix: str) -> AsyncIterator[list[InstanceInfo]]:
        c = await self._ensure()
        wid, q = c.open_watch("instances", prefix)
        await c.start_watch(wid, "instances", prefix)
        try:
            while True:
                h = await q.get()
                if h.get("__conn_lost__"):
                    raise ConnectionError("coordinator connection lost")
                yield [InstanceInfo.from_dict(d) for d in h["instances"]]
        finally:
            await c.stop_watch(wid)

    async def kv_put(self, key: str, value: bytes, lease: Lease | None = None) -> None:
        c = await self._ensure()
        await c.call(
            "kv_put",
            {"key": key, "lease_id": lease.lease_id if lease else 0},
            value,
        )

    async def kv_create(
        self, key: str, value: bytes, lease: Lease | None = None
    ) -> bool:
        c = await self._ensure()
        h, _ = await c.call(
            "kv_create",
            {"key": key, "lease_id": lease.lease_id if lease else 0},
            value,
        )
        return bool(h.get("created"))

    async def kv_get(self, key: str) -> bytes | None:
        c = await self._ensure()
        h, pl = await c.call("kv_get", {"key": key})
        return pl if h.get("found") else None

    async def kv_get_prefix(self, prefix: str) -> dict[str, bytes]:
        c = await self._ensure()
        h, _ = await c.call("kv_get_prefix", {"prefix": prefix})
        return {k: _unb64(v) for k, v in h["entries"].items()}

    async def kv_delete(self, key: str) -> None:
        c = await self._ensure()
        await c.call("kv_delete", {"key": key})

    async def kv_watch_prefix(self, prefix: str) -> AsyncIterator[dict[str, bytes]]:
        c = await self._ensure()
        wid, q = c.open_watch("kv", prefix)
        await c.start_watch(wid, "kv", prefix)
        try:
            while True:
                h = await q.get()
                if h.get("__conn_lost__"):
                    raise ConnectionError("coordinator connection lost")
                yield {k: _unb64(v) for k, v in h["entries"].items()}
        finally:
            await c.stop_watch(wid)

    async def close(self) -> None:
        await self.client.close()


class CoordinatorEventPlane(EventPlane):
    """Pub/sub over the coordinator (NATS-subject equivalent)."""

    def __init__(self, discovery: CoordinatorDiscovery):
        self._discovery = discovery

    async def publish(self, subject: str, payload: dict) -> None:
        c = await self._discovery._ensure()
        await c.call("publish", {"subject": subject, "event": payload})

    async def subscribe(self, subject: str) -> AsyncIterator[dict]:
        # Register with the server *before* returning (the server acks the
        # watch op), so no event published after subscribe() is missed —
        # the same invariant as the in-proc plane, which KvIndexer.start
        # depends on.
        c = await self._discovery._ensure()
        wid, q = c.open_watch("events", subject)
        await c.start_watch(wid, "events", subject)

        async def _gen() -> AsyncIterator[dict]:
            try:
                while True:
                    h = await q.get()
                    if h.get("__conn_lost__"):
                        raise ConnectionError("coordinator connection lost")
                    yield h["event"]
            finally:
                await c.stop_watch(wid)

        return _gen()


class CoordinatorWorkQueue(WorkQueue):
    def __init__(self, discovery: CoordinatorDiscovery, name: str):
        self._discovery = discovery
        self.name = name

    async def push(self, payload: bytes) -> None:
        c = await self._discovery._ensure()
        await c.call("queue_push", {"queue": self.name}, payload)

    async def pull(self, timeout_s: float | None = None) -> bytes | None:
        c = await self._discovery._ensure()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return None
            h, pl = await c.call(
                "queue_pull", {"queue": self.name, "timeout_s": remaining}
            )
            if h.get("found"):
                return pl

    async def size(self) -> int:
        c = await self._discovery._ensure()
        h, _ = await c.call("queue_size", {"queue": self.name})
        return int(h["size"])


class CoordinatorObjectStore(ObjectStore):
    def __init__(self, discovery: CoordinatorDiscovery):
        self._discovery = discovery

    async def put(self, bucket: str, key: str, data: bytes) -> None:
        c = await self._discovery._ensure()
        await c.call("obj_put", {"bucket": bucket, "key": key}, data)

    async def get(self, bucket: str, key: str) -> bytes | None:
        c = await self._discovery._ensure()
        h, pl = await c.call("obj_get", {"bucket": bucket, "key": key})
        return pl if h.get("found") else None

    async def delete(self, bucket: str, key: str) -> None:
        c = await self._discovery._ensure()
        await c.call("obj_delete", {"bucket": bucket, "key": key})

    async def list(self, bucket: str) -> list[str]:
        c = await self._discovery._ensure()
        h, _ = await c.call("obj_list", {"bucket": bucket})
        return list(h["keys"])


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="the port's coordinator server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6510)
    args = parser.parse_args()

    from ..runtime import run_until_signalled

    async def _run() -> None:
        server = CoordinatorServer(args.host, args.port)
        await server.start()
        print(f"coordinator ready on {server.address}", flush=True)
        try:
            await asyncio.Event().wait()  # serving since start()
        finally:
            await server.close()

    # SIGTERM (a pod's stop) closes every connection and exits 0.
    run_until_signalled(_run())


if __name__ == "__main__":
    main()
