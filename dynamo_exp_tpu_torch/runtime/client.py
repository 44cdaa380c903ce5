"""Endpoint client: tracks live instances and issues streaming requests.

Counterpart of ``dynamo_exp_tpu/runtime/client.py``: a dynamic client
watches discovery for membership changes (lease expiry drops an
instance at once); a static client uses a fixed instance list. Routing
policies live in :mod:`.push_router`.

Every client owns a :class:`~.health.HealthTracker`: discovery snapshots
stamp liveness into it here, request outcomes are recorded by the
router. The watch loop survives stream errors: it logs, re-subscribes
with capped exponential backoff and re-lists instances on resume.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import AsyncIterator

from .annotated import Annotated
from .engine import AsyncEngineContext
from .health import HealthTracker
from .runtime import Runtime
from .transports.base import Discovery, InstanceInfo, RequestPlane

logger = logging.getLogger(__name__)

# Watch-resubscribe backoff bounds (seconds).
_WATCH_BACKOFF_INITIAL_S = 0.05
_WATCH_BACKOFF_MAX_S = 2.0


class Client:
    def __init__(
        self, request_plane: RequestPlane, health: HealthTracker | None = None
    ):
        self.request_plane = request_plane
        self.health = health or HealthTracker()
        self._instances: list[InstanceInfo] = []
        self._changed = asyncio.Event()
        self._watch_task: asyncio.Task | None = None

    # --- construction -------------------------------------------------
    @classmethod
    def new_static(
        cls,
        request_plane: RequestPlane,
        instances: list[InstanceInfo],
        health: HealthTracker | None = None,
    ) -> "Client":
        c = cls(request_plane, health=health)
        c._apply_snapshot(list(instances))
        return c

    @classmethod
    async def new_dynamic(
        cls,
        runtime: Runtime,
        discovery: Discovery,
        request_plane: RequestPlane,
        endpoint_path: str,
        health: HealthTracker | None = None,
    ) -> "Client":
        c = cls(request_plane, health=health)

        async def _watch() -> None:
            backoff = _WATCH_BACKOFF_INITIAL_S
            while True:
                try:
                    async for snapshot in discovery.watch_instances(endpoint_path):
                        backoff = _WATCH_BACKOFF_INITIAL_S
                        c._apply_snapshot(snapshot)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - watch must survive
                    logger.warning(
                        "discovery watch for %s failed (%s: %s); "
                        "re-subscribing in %.2fs",
                        endpoint_path, type(e).__name__, e, backoff,
                    )
                else:
                    # The stream ended without error (control plane closed
                    # it); treat like a flap and re-subscribe.
                    logger.warning(
                        "discovery watch for %s ended; re-subscribing in %.2fs",
                        endpoint_path, backoff,
                    )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, _WATCH_BACKOFF_MAX_S)
                # Re-list on resume: membership changes during the gap
                # produced no watch push, so the snapshot must be pulled.
                with contextlib.suppress(Exception):
                    c._apply_snapshot(
                        await discovery.list_instances(endpoint_path)
                    )

        c._apply_snapshot(await discovery.list_instances(endpoint_path))
        c._watch_task = runtime.spawn(_watch())
        return c

    # --- membership ---------------------------------------------------
    def _apply_snapshot(self, snapshot: list[InstanceInfo]) -> None:
        self._instances = snapshot
        self.health.observe_instances(snapshot)
        self._changed.set()

    @property
    def instances(self) -> list[InstanceInfo]:
        return self._instances

    def instance_ids(self) -> list[int]:
        return [i.instance_id for i in self._instances]

    async def wait_for_instances(self, n: int = 1, timeout: float | None = None) -> None:
        async def _wait() -> None:
            while len(self._instances) < n:
                self._changed.clear()
                await self._changed.wait()

        await asyncio.wait_for(_wait(), timeout)

    def instance(self, instance_id: int) -> InstanceInfo:
        for i in self._instances:
            if i.instance_id == instance_id:
                return i
        raise KeyError(f"instance {instance_id} is not live")

    # --- requests -----------------------------------------------------
    async def generate_to(
        self,
        instance: InstanceInfo,
        request: dict,
        context: AsyncEngineContext | None = None,
    ) -> AsyncIterator[Annotated]:
        """Issue a request to one instance; yields Annotated frames.

        Error frames raise ``EngineError`` so callers see remote failures
        as exceptions unless they iterate the raw stream themselves.
        """
        ctx = context or AsyncEngineContext()
        frames = await self.request_plane.request_stream(instance, request, ctx)

        async def _gen() -> AsyncIterator[Annotated]:
            async for frame in frames:
                ann = Annotated.from_dict(frame)
                if ann.is_error():
                    raise EngineError(ann.error_message() or "remote engine error")
                yield ann

        return _gen()

    async def open_stream(
        self,
        instance: InstanceInfo,
        request: dict,
        context: AsyncEngineContext | None = None,
    ) -> tuple[Annotated | None, AsyncIterator[Annotated]]:
        """Dispatch and eagerly pull the stream's first frame, so
        stream-start failures surface to the caller's retry loop as
        exceptions *here* rather than mid-iteration.

        Returns ``(first, rest)``; ``first`` is None for a clean empty
        stream. An in-band error in the first frame is *returned* (not
        raised): it means the stream started — an application failure,
        outside the failover contract. The push router uses this for
        both the initial dispatch and resumable-stream continuation
        re-dispatches."""
        frames = await self.generate_to(instance, request, context)
        try:
            first: Annotated | None = await anext(aiter(frames))
        except StopAsyncIteration:
            first = None
        except EngineError as e:
            # generate_to raises for error frames; fold the first-frame
            # case back into a frame so retry loops' ConnectionError
            # filters stay precise.
            first = Annotated.from_error(str(e))
        return first, frames

    def close(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()


class EngineError(RuntimeError):
    """A remote engine reported an error frame in its response stream."""
