"""Planner -> supervisor scale actions.

Counterpart of ``dynamo_exp_tpu/planner/connector.py``: the SDK
supervisor (``sdk/serve.py``) serves a ``{namespace}.supervisor.control``
endpoint on the coordinator, and the LocalConnector is a client of it.
The supervisor owns its watcher table and the card allocator, so a scale
action is one round trip, and the answer (did it happen, what the fleet
looks like now) comes back in-band.
"""

from __future__ import annotations

import abc
import logging

logger = logging.getLogger(__name__)


class PlannerConnector(abc.ABC):
    @abc.abstractmethod
    async def add_component(self, component_name: str) -> bool: ...

    @abc.abstractmethod
    async def remove_component(self, component_name: str) -> bool: ...


class LocalConnector(PlannerConnector):
    """Scale actions against the local SDK supervisor's control endpoint."""

    def __init__(self, namespace: str, drt):
        self.namespace = namespace
        self.drt = drt
        self._client = None

    async def _control(self, op: str, service: str) -> dict:
        if self._client is None:
            ep = self.drt.namespace(self.namespace).component("supervisor").endpoint("control")
            self._client = await ep.client()
            await self._client.wait_for_instances(1, timeout=10.0)
        instances = self._client.instances
        if not instances:
            logger.warning("no supervisor control instance discovered")
            return {"ok": False, "counts": {}}
        stream = await self._client.generate_to(instances[0], {"op": op, "service": service})
        async for ann in stream:
            if ann.data is not None:
                return ann.data
        return {"ok": False, "counts": {}}

    async def add_component(self, component_name: str) -> bool:
        reply = await self._control("add", component_name)
        return bool(reply.get("ok"))

    async def remove_component(self, component_name: str) -> bool:
        reply = await self._control("remove", component_name)
        return bool(reply.get("ok"))

    async def list_components(self) -> dict[str, int]:
        reply = await self._control("list", "")
        return dict(reply.get("counts") or {})

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
