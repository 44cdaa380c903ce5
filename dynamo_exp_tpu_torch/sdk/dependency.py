"""``depends()``: graph edges that resolve to live clients at runtime.

Counterpart of ``dynamo_exp_tpu/sdk/dependency.py``: a class attribute
``dep = depends(Other)`` both declares the edge (so the serve CLI
launches ``Other``) and, inside a running service, behaves as a client
of ``Other``'s endpoint over the port's ``runtime/push_router.py``.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator

logger = logging.getLogger(__name__)


class DependencyClient:
    """Callable proxy for one remote endpoint of a dependency."""

    def __init__(self, push_router, endpoint_path: str, ready_timeout_s: float = 30.0):
        self._router = push_router
        self.endpoint_path = endpoint_path
        self.ready_timeout_s = ready_timeout_s

    async def generate(self, request: dict) -> AsyncIterator[Any]:
        """Send one request; returns the response stream (data frames).
        Waits for one live instance first: graph services boot
        concurrently, so a dependency may come up after its dependents."""
        if not self._router.client.instances:
            await self._router.client.wait_for_instances(1, self.ready_timeout_s)
        return await self._router.generate(request)

    async def round_robin(self, request: dict) -> AsyncIterator[Any]:
        return await self.generate(request)

    async def wait_ready(self, n: int = 1, timeout_s: float | None = None) -> None:
        """Block until ``n`` live instances exist."""
        if len(self._router.client.instance_ids()) >= n:
            return
        await self._router.client.wait_for_instances(
            n, timeout_s if timeout_s is not None else self.ready_timeout_s
        )

    async def direct(self, request: dict, instance_id: int) -> AsyncIterator[Any]:
        return await self._router.generate_direct(request, instance_id)

    def instance_ids(self) -> list[int]:
        return self._router.client.instance_ids()


class depends:  # noqa: N801 - the SDK's lowercase API
    """Declare a dependency on another @service class.

    As a class attribute it is inert metadata; ``resolve()`` (called by
    the serving layer) binds it to a live client. Reading it from an
    instance before resolution raises, which catches un-served usage.
    """

    def __init__(self, target: type, endpoint: str = "generate"):
        self.target = target
        self.endpoint_name = endpoint
        self._client: DependencyClient | None = None

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self._client is None:
            raise RuntimeError(
                f"dependency on {self.target.__name__} not resolved — are you "
                "running outside `python -m dynamo_exp_tpu_torch.sdk.serve`?"
            )
        return self._client

    async def resolve(self, drt) -> DependencyClient:
        """Bind to the dependency's endpoint via the request plane."""
        from ..runtime.push_router import PushRouter, RouterMode
        from .service import get_spec

        spec = get_spec(self.target)
        ep = (
            drt.namespace(spec.namespace)
            .component(spec.component_name)
            .endpoint(self.endpoint_name)
        )
        client = await ep.client()
        self._client = DependencyClient(PushRouter(client, RouterMode.ROUND_ROBIN), ep.path)
        return self._client
