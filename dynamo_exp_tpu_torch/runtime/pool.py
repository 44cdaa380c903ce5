"""Returnable object pool with RAII-style return-on-release.

The basis of the KV block pool: items checked out of the pool return to it
when released (or garbage-collected), and waiters are woken in order.

Counterpart of ``dynamo_exp_tpu/runtime/pool.py``.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class PoolItem(Generic[T]):
    """A checked-out pool item; ``release()`` (or ``with``, or garbage
    collection of a dropped item) returns it to the pool."""

    def __init__(self, value: T, pool: "Pool[T]"):
        self._value = value
        self._pool: Pool[T] | None = pool

    @property
    def value(self) -> T:
        if self._pool is None:
            raise RuntimeError("pool item used after release")
        return self._value

    def release(self) -> None:
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool._return(self._value)

    def __enter__(self) -> T:
        return self.value

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self) -> None:
        # RAII backstop: a dropped item (e.g. on an exception path) must
        # not permanently shrink pool capacity.
        self.release()


class Pool(Generic[T]):
    """Fixed-capacity async pool. ``acquire`` waits until an item is free."""

    def __init__(self, items: list[T], on_return: Callable[[T], None] | None = None):
        self._free: collections.deque[T] = collections.deque(items)
        self._capacity = len(items)
        self._on_return = on_return
        self._waiters: collections.deque[asyncio.Future] = collections.deque()

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def available(self) -> int:
        return len(self._free)

    def try_acquire(self) -> PoolItem[T] | None:
        if self._free:
            return PoolItem(self._free.popleft(), self)
        return None

    async def acquire(self) -> PoolItem[T]:
        item = self.try_acquire()
        if item is not None:
            return item
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            value = await fut
        except asyncio.CancelledError:
            # If the value was already handed to us, re-offer it so the
            # item isn't leaked (asyncio.Queue-style cancellation safety).
            # on_return already ran for this value; don't run it again.
            if fut.done() and not fut.cancelled():
                self._offer(fut.result())
            else:
                with contextlib.suppress(ValueError):
                    self._waiters.remove(fut)
            raise
        return PoolItem(value, self)

    def _return(self, value: T) -> None:
        if self._on_return is not None:
            self._on_return(value)
        self._offer(value)

    def _offer(self, value: T) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(value)
                return
        self._free.append(value)
