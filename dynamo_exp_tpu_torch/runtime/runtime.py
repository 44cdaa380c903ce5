"""Async runtime core: cancellation tokens and the Runtime wrapper.

Counterpart of ``dynamo_exp_tpu/runtime/runtime.py``, without the
blocking-work thread pool and ``run_until_cancelled`` (no caller in the
port): a process-wide runtime that owns a root cancellation token, runs
background tasks and shuts down cleanly on signal or cancel.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import signal
import uuid
import weakref
from typing import Any, Awaitable, Callable, Coroutine


class CancellationToken:
    """Hierarchical cancellation: cancelling a parent cancels all children.

    Children are held by weakref so short-lived per-request tokens don't
    accumulate on a long-lived parent.
    """

    def __init__(self, parent: "CancellationToken | None" = None):
        self._event = asyncio.Event()
        self._children: weakref.WeakSet[CancellationToken] = weakref.WeakSet()
        self._parent = parent
        if parent is not None:
            parent._children.add(self)
            if parent.is_cancelled():
                self._event.set()

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        for child in list(self._children):
            child.cancel()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    async def cancelled(self) -> None:
        """Wait until this token is cancelled."""
        await self._event.wait()

    def child_token(self) -> "CancellationToken":
        return CancellationToken(parent=self)


class Runtime:
    """Owns the event loop's lifecycle primitives for one worker process."""

    def __init__(self):
        self.worker_id = uuid.uuid4().hex
        self._root = CancellationToken()
        self._tasks: set[asyncio.Task] = set()

    @property
    def primary_token(self) -> CancellationToken:
        return self._root

    def shutdown(self) -> None:
        self._root.cancel()

    def is_shutdown(self) -> bool:
        return self._root.is_cancelled()

    def spawn(self, coro: Coroutine) -> asyncio.Task:
        """Track a background task; exceptions are surfaced, not swallowed."""
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._on_task_done)
        return task

    def _on_task_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if not task.cancelled():
            exc = task.exception()
            if exc is not None and not isinstance(exc, asyncio.CancelledError):
                logging.getLogger(__name__).error(
                    "background task failed: %r", exc, exc_info=exc
                )

    async def close(self) -> None:
        self.shutdown()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)


class Worker:
    """``main()`` harness: build a Runtime, run the user's async fn, handle
    SIGINT/SIGTERM, and block until cancellation completes."""

    def __init__(self, runtime: Runtime | None = None):
        self.runtime = runtime or Runtime()

    def execute(self, main: Callable[[Runtime], Awaitable[Any]]) -> Any:
        async def _run() -> Any:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, RuntimeError):
                    loop.add_signal_handler(sig, self.runtime.shutdown)
            try:
                return await main(self.runtime)
            finally:
                await self.runtime.close()

        return asyncio.run(_run())


def run_until_signalled(coro) -> None:
    """Run ``coro`` as the main task of a new event loop; SIGINT and
    SIGTERM cancel it, and a cancelled run returns normally, so that a
    service CLI stopped by its supervisor exits 0 after its ``finally``
    blocks ran."""
    loop = asyncio.new_event_loop()
    task = loop.create_task(coro)
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError, ValueError):
            loop.add_signal_handler(sig, task.cancel)
    try:
        loop.run_until_complete(task)
    except asyncio.CancelledError:
        pass
    finally:
        loop.close()
