"""Transport interfaces: discovery (control plane) and request plane.

Counterpart of ``dynamo_exp_tpu/runtime/transports/base.py``: the
distributed fabric split into planes behind small interfaces, so the
whole stack runs either in one process (static mode, most tests) or over
the self-hosted coordinator and TCP planes. The dict shapes
(``InstanceInfo.to_dict``) are the JAX package's, field for field, so a
worker of one package registers where an ingress of the other finds it.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

from ..engine import AsyncEngineContext

# A served endpoint handler: request dict -> stream of Annotated dicts.
Handler = Callable[[dict, AsyncEngineContext], AsyncIterator[dict]]
# A stats handler: () -> metrics dict (merged into the instance's stats).
StatsHandler = Callable[[], dict]


@dataclass(frozen=True)
class EndpointAddress:
    """Hierarchical endpoint id: ``{namespace}/components/{component}/{name}``."""

    namespace: str
    component: str
    name: str

    @property
    def subject(self) -> str:
        return f"{self.namespace}.{self.component}.{self.name}"

    @property
    def path(self) -> str:
        return f"{self.namespace}/components/{self.component}/endpoints/{self.name}"

    @classmethod
    def from_url(cls, url: str) -> "EndpointAddress":
        """Parse ``dyn://ns.component.endpoint``."""
        parts = url.removeprefix("dyn://").split(".")
        if len(parts) != 3:
            raise ValueError(f"expected dyn://ns.component.endpoint, got {url!r}")
        return cls(*parts)


@dataclass
class InstanceInfo:
    """One live instance of an endpoint, as published to discovery."""

    address: EndpointAddress
    instance_id: int
    transport: str = "inproc"  # "inproc" | "tcp"
    transport_address: str = ""  # host:port for tcp
    metadata: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "namespace": self.address.namespace,
            "component": self.address.component,
            "name": self.address.name,
            "instance_id": self.instance_id,
            "transport": self.transport,
            "transport_address": self.transport_address,
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "InstanceInfo":
        return cls(
            address=EndpointAddress(d["namespace"], d["component"], d["name"]),
            instance_id=d["instance_id"],
            transport=d.get("transport", "inproc"),
            transport_address=d.get("transport_address", ""),
            metadata=d.get("metadata", {}),
        )


class Lease(abc.ABC):
    """A liveness lease; revoking (or process death) removes registrations."""

    @property
    @abc.abstractmethod
    def lease_id(self) -> int: ...

    @abc.abstractmethod
    async def revoke(self) -> None: ...

    @abc.abstractmethod
    def is_valid(self) -> bool: ...


class Discovery(abc.ABC):
    """Control plane: endpoint registry with leases and watches, and a
    small KV store with watches (model entries, drain intents)."""

    @abc.abstractmethod
    async def register_instance(self, info: InstanceInfo, lease: Lease | None = None) -> Lease: ...

    @abc.abstractmethod
    async def create_lease(self, ttl_s: float | None = None) -> Lease: ...

    @abc.abstractmethod
    async def deregister_instance(self, instance_id: int) -> None:
        """Remove one instance without touching its lease."""

    @abc.abstractmethod
    async def list_instances(self, prefix: str) -> list[InstanceInfo]: ...

    @abc.abstractmethod
    def watch_instances(self, prefix: str) -> "AsyncIterator[list[InstanceInfo]]":
        """Yields the full live-instance snapshot on every membership
        change (the first yield is the current snapshot)."""

    # --- generic KV with watch ---
    @abc.abstractmethod
    async def kv_put(self, key: str, value: bytes, lease: Lease | None = None) -> None: ...

    @abc.abstractmethod
    async def kv_create(self, key: str, value: bytes, lease: Lease | None = None) -> bool:
        """Create-if-absent; returns False if the key already exists."""

    @abc.abstractmethod
    async def kv_get(self, key: str) -> bytes | None: ...

    @abc.abstractmethod
    async def kv_get_prefix(self, prefix: str) -> dict[str, bytes]: ...

    @abc.abstractmethod
    async def kv_delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def kv_watch_prefix(self, prefix: str) -> "AsyncIterator[dict[str, bytes]]":
        """Yields the full prefix snapshot on every change (the first
        yield is the current snapshot)."""

    # --- sibling-plane factories ---
    # The discovery backend knows which fabric the process is on, so it
    # makes the other control-plane services (events, queues, objects).
    # Defaults are in-process; the coordinator's ride its connection.
    def _new_event_plane(self) -> "EventPlane":
        from .inproc import InProcEventPlane

        return InProcEventPlane()

    def _new_work_queue(self, name: str) -> "WorkQueue":
        from .inproc import InProcWorkQueue

        return InProcWorkQueue()

    def _new_object_store(self) -> "ObjectStore":
        from .inproc import InProcObjectStore

        return InProcObjectStore()

    def event_plane(self) -> "EventPlane":
        plane = getattr(self, "_event_plane", None)
        if plane is None:
            plane = self._event_plane = self._new_event_plane()
        return plane

    def work_queue(self, name: str) -> "WorkQueue":
        queues = getattr(self, "_work_queues", None)
        if queues is None:
            queues = self._work_queues = {}
        if name not in queues:
            queues[name] = self._new_work_queue(name)
        return queues[name]

    def object_store(self) -> "ObjectStore":
        store = getattr(self, "_object_store", None)
        if store is None:
            store = self._object_store = self._new_object_store()
        return store

    async def close(self) -> None:
        return None


class ServedEndpoint(abc.ABC):
    """Handle for a serving endpoint; close() drains gracefully."""

    @abc.abstractmethod
    async def close(self) -> None: ...


class RequestPlane(abc.ABC):
    """Request push + streaming response plane."""

    @abc.abstractmethod
    async def serve(
        self, info: InstanceInfo, handler: Handler, stats_handler: StatsHandler | None = None
    ) -> ServedEndpoint: ...

    @abc.abstractmethod
    async def request_stream(
        self, instance: InstanceInfo, request: dict, context: AsyncEngineContext
    ) -> AsyncIterator[dict]:
        """Send one request to one instance; returns the Annotated-frame
        stream. Stopping or killing ``context`` propagates upstream."""

    @abc.abstractmethod
    async def scrape_stats(self, instance: InstanceInfo) -> dict:
        """Fetch the instance's live stats (load metrics)."""

    async def close(self) -> None:
        return None


class EventPlane(abc.ABC):
    """Fire-and-forget pub/sub by subject (KV events on
    ``{component}.kv_events``, routing decisions on ``kv-hit-rate``)."""

    @abc.abstractmethod
    async def publish(self, subject: str, payload: dict) -> None: ...

    @abc.abstractmethod
    async def subscribe(self, subject: str) -> "AsyncIterator[dict]":
        """A stream of payloads published to ``subject``. The
        subscription is registered before this returns: no event
        published afterwards can be missed."""

    async def close(self) -> None:
        return None


class WorkQueue(abc.ABC):
    """FIFO work queue (the disaggregated prefill queue)."""

    @abc.abstractmethod
    async def push(self, payload: bytes) -> None: ...

    @abc.abstractmethod
    async def pull(self, timeout_s: float | None = None) -> bytes | None:
        """Pop the oldest item; blocks up to ``timeout_s`` (None =
        forever), returns None on timeout."""

    @abc.abstractmethod
    async def size(self) -> int: ...


class ObjectStore(abc.ABC):
    """Bucketed blob store (holds model deployment cards)."""

    @abc.abstractmethod
    async def put(self, bucket: str, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    async def get(self, bucket: str, key: str) -> bytes | None: ...

    @abc.abstractmethod
    async def delete(self, bucket: str, key: str) -> None: ...

    @abc.abstractmethod
    async def list(self, bucket: str) -> list[str]: ...
