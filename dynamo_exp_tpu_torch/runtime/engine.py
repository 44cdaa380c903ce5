"""The streaming-engine abstraction.

Counterpart of ``dynamo_exp_tpu/runtime/engine.py`` without telemetry:
an ``AsyncEngine`` takes one request and returns a stream of responses
attached to a context that supports cooperative stop ("finish current
tokens, then stop") and kill ("drop everything now").
"""

from __future__ import annotations

import asyncio
import uuid
from typing import AsyncIterator, Generic, Protocol, TypeVar, runtime_checkable

Req = TypeVar("Req", contravariant=True)
Resp = TypeVar("Resp", covariant=True)


class AsyncEngineContext:
    """Per-request control handle carried alongside the response stream."""

    def __init__(self, request_id: str | None = None):
        self.id = request_id or uuid.uuid4().hex
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()

    def stop_generating(self) -> None:
        """Ask the generator to stop gracefully after the current step."""
        self._stopped.set()

    def kill(self) -> None:
        """Hard-stop: abandon the stream immediately."""
        self._stopped.set()
        self._killed.set()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()


class ResponseStream(Generic[Resp]):
    """An async response stream bound to its engine context."""

    def __init__(self, stream: AsyncIterator[Resp], context: AsyncEngineContext):
        self._stream = stream
        self.context = context

    def __aiter__(self) -> AsyncIterator[Resp]:
        return self._gen()

    async def _gen(self) -> AsyncIterator[Resp]:
        async for item in self._stream:
            if self.context.is_killed:
                break
            yield item

    async def aclose(self) -> None:
        closer = getattr(self._stream, "aclose", None)
        if closer is not None:
            await closer()


@runtime_checkable
class AsyncEngine(Protocol[Req, Resp]):
    """generate(request) -> context-carrying stream of responses."""

    async def generate(
        self, request: Req, context: AsyncEngineContext | None = None
    ) -> ResponseStream[Resp]: ...

