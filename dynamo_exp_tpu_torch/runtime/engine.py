"""The streaming-engine abstraction.

Counterpart of ``dynamo_exp_tpu/runtime/engine.py``: an ``AsyncEngine``
takes one request and returns a stream of responses attached to a
context that supports cooperative stop ("finish current tokens, then
stop"), kill ("drop everything now") and an end-to-end deadline.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, AsyncIterator, Generic, Protocol, TypeVar, runtime_checkable

Req = TypeVar("Req", contravariant=True)
Resp = TypeVar("Resp", covariant=True)


class DeadlineExceededError(TimeoutError):
    """The request's end-to-end deadline expired before it completed."""


class AsyncEngineContext:
    """Per-request control handle carried alongside the response stream,
    with an optional end-to-end **deadline** (unix seconds): the engine
    reaps a waiting request whose deadline passed and finishes a bound
    one at it."""

    def __init__(self, request_id: str | None = None, deadline: float | None = None):
        self.id = request_id or uuid.uuid4().hex
        self.deadline = deadline
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()

    # --- deadline -----------------------------------------------------
    def start_timeout(self, timeout_s: float | None) -> None:
        """Arm the deadline ``timeout_s`` seconds from now (None = no-op)."""
        if timeout_s is not None:
            self.deadline = time.time() + timeout_s

    def time_remaining(self) -> float | None:
        """Seconds until the deadline (may be negative); None if unset."""
        if self.deadline is None:
            return None
        return self.deadline - time.time()

    @property
    def deadline_expired(self) -> bool:
        return self.deadline is not None and time.time() >= self.deadline

    def check_deadline(self, stage: str = "router") -> None:
        """Raise :class:`DeadlineExceededError` if the deadline passed,
        counting the abandoning stage on
        ``dynamo_deadline_exceeded_total{stage}``."""
        if self.deadline_expired:
            from ..telemetry import get_telemetry

            get_telemetry().deadline_exceeded.labels(stage).inc()
            raise DeadlineExceededError(
                f"request {self.id} deadline exceeded at stage {stage!r}"
            )

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



class LambdaEngine(AsyncEngine[Any, Any]):
    """Wrap an async-generator function as an AsyncEngine (glue and tests)."""

    def __init__(self, fn):
        self._fn = fn

    async def generate(
        self, request: Any, context: AsyncEngineContext | None = None
    ) -> ResponseStream[Any]:
        ctx = context or AsyncEngineContext()
        return ResponseStream(self._fn(request, ctx), ctx)
