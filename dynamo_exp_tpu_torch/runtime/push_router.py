"""PushRouter: policy-based dispatch over a Client's live instances.

Counterpart of ``dynamo_exp_tpu/runtime/push_router.py``: random /
round-robin / direct(instance) / static routing, presented as an
AsyncEngine so routers compose with pipelines. KV-aware routing
(:mod:`..kv_router.router`) plugs in through ``RouterMode.DIRECT``.

Fault tolerance: selection skips draining and breaker-blocked
instances (the client's :class:`~.health.HealthTracker`); a
**connection / stream-start** failure (the transport refused, or the
stream died before its first frame) is retried with exponential backoff
and jitter against a *different* instance, up to ``retries`` times and
never past the request's deadline (``check_deadline("router")``: 504
``deadline_exceeded`` at the edge, ``dynamo_deadline_exceeded_total{stage="router"}``).

**Resumable streams**: once the first frame has arrived, a break is not
retried (that would duplicate tokens) but resumed. Journalable requests
(engine-level dicts carrying ``token_ids``) get a
:class:`~.journal.ReplayJournal`, and a mid-stream break dispatches a
**continuation request** to another healthy instance, up to
``max_recoveries`` times and never past the deadline, after which
:class:`RecoveryExhaustedError` surfaces (HTTP 502). In-band error
frames (``EngineError``) are application errors and are neither
retried nor resumed.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import random
from typing import Any, AsyncIterator, Awaitable, Callable

from ..telemetry import get_telemetry, span as trace_span
from .client import Client
from .engine import (
    AsyncEngine,
    AsyncEngineContext,
    DeadlineExceededError,
    ResponseStream,
)
from .journal import ReplayJournal
from .transports.base import InstanceInfo


class RouterMode(enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round-robin"
    DIRECT = "direct"
    STATIC = "static"
    KV = "kv"


class NoInstancesError(ConnectionError):
    pass


class NoHealthyInstancesError(NoInstancesError):
    """Instances exist, but every one is draining, breaker-open, or
    already tried this request — the 503 + Retry-After case."""


class RecoveryExhaustedError(ConnectionError):
    """A resumable stream broke more than ``max_recoveries`` times (or
    past its deadline); the HTTP layer maps this to 502."""


class PushRouter(AsyncEngine[dict, Any]):
    """Routes each request to one live instance of a remote endpoint."""

    def __init__(
        self,
        client: Client,
        mode: RouterMode = RouterMode.RANDOM,
        ready_wait_s: float = 0.0,
        retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        rng: random.Random | None = None,
        max_recoveries: int = 2,
        continuation_selector: (
            Callable[[list[int], frozenset[int]], Awaitable[int]] | None
        ) = None,
    ):
        self.client = client
        self.mode = mode
        # >0: a request arriving before any instance is discovered waits
        # this long for one instead of failing (ingress/graph startup
        # races); 0 keeps the strict fail-fast default.
        self.ready_wait_s = ready_wait_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # Injectable rng keeps backoff jitter (and journal seed pinning)
        # deterministic under test.
        self.rng = rng or random.Random()
        # Mid-stream failover budget per request; 0 disables journaling.
        self.max_recoveries = max_recoveries
        # KV-aware wrappers install a re-selector so a continuation still
        # lands on the best surviving prefix overlap (KvPushRouter).
        self.continuation_selector = continuation_selector
        self._rr = itertools.count()

    @property
    def health(self):
        return self.client.health

    def unavailable_ids(self) -> set[int]:
        """Live instance ids currently excluded from selection."""
        return self.health.unavailable_ids(self.client.instances)

    def _pick(
        self, request: dict, exclude: frozenset[int] | set[int] = frozenset()
    ) -> InstanceInfo:
        instances = self.client.instances
        if not instances:
            raise NoInstancesError("no live instances for endpoint")
        # An explicit target always wins, regardless of mode — KV-aware
        # callers (KvPushRouter) do their own health-filtered selection.
        if "_worker_instance_id" in request:
            try:
                return self.client.instance(int(request["_worker_instance_id"]))
            except KeyError as e:
                # Stale target (lease expired) is a routing error, so callers
                # can retry/503 with one except clause.
                raise NoInstancesError(str(e)) from e
        pool = [
            i
            for i in self.health.filter_available(instances)
            if i.instance_id not in exclude
        ]
        if not pool:
            raise NoHealthyInstancesError(
                f"no healthy instances for endpoint "
                f"({len(instances)} live, all draining/unhealthy/tried)"
            )
        if self.mode is RouterMode.RANDOM:
            return self.rng.choice(pool)
        if self.mode is RouterMode.ROUND_ROBIN:
            return pool[next(self._rr) % len(pool)]
        if self.mode in (RouterMode.DIRECT, RouterMode.KV):
            # The explicit-target branch above handles present ids.
            raise ValueError("direct routing requires _worker_instance_id")
        # STATIC: single fixed instance
        return pool[0]

    async def sleep_backoff(
        self, attempt: int, ctx: AsyncEngineContext
    ) -> None:
        """Exponential backoff with 50% jitter, capped by the deadline.
        Public: KV-aware wrappers reuse this policy for their own
        re-selecting retry loops."""
        delay = min(
            self.backoff_base_s * (2 ** (attempt - 1)), self.backoff_max_s
        )
        delay *= 0.5 + self.rng.random() / 2
        remaining = ctx.time_remaining()
        if remaining is not None:
            delay = min(delay, max(remaining, 0.0))
        if delay > 0:
            await asyncio.sleep(delay)

    async def _dispatch(
        self,
        request: dict,
        ctx: AsyncEngineContext,
        tried: set[int],
        pick: Callable[[], Awaitable[InstanceInfo] | InstanceInfo],
        retry_ok: bool,
    ):
        """One health-guarded dispatch loop: pick → acquire → open the
        stream, retrying stream-start failures against other instances.
        Every ``health.acquire`` is paired with exactly one of
        record_success / record_failure / release — a CancelledError (or
        any non-transport error) escaping between acquire and outcome
        must not strand the half-open probe slot."""
        attempt = 0
        while True:
            ctx.check_deadline("router")
            instance = pick()
            if asyncio.iscoroutine(instance):
                instance = await instance
            self.health.acquire(instance.instance_id)
            try:
                first, frames = await self.client.open_stream(
                    instance, request, ctx
                )
            except ConnectionError as e:
                # Stream-start failure: the instance never produced a
                # frame, so failing over cannot duplicate output.
                self.health.record_failure(instance.instance_id)
                tried.add(instance.instance_id)
                attempt += 1
                if not retry_ok or attempt > self.retries:
                    raise
                get_telemetry().request_retries.labels(
                    "connect" if _is_connect_error(e) else "stream_start"
                ).inc()
                await self.sleep_backoff(attempt, ctx)
                continue
            except BaseException:
                # No transport outcome (cancellation, bugs, deadline
                # races): free the probe slot without judging health.
                self.health.release(instance.instance_id)
                raise
            if (
                first is not None
                and first.is_error()
                and ctx.deadline_expired
            ):
                # The deadline expired in transit and the remote plane
                # refused in-band. That is neither an instance failure
                # nor an application error — surface it as the deadline
                # it is (HTTP maps this to 504, not 500). The probe slot
                # is released outcome-free: the expiry says nothing
                # about this instance's health.
                self.health.release(instance.instance_id)
                raise DeadlineExceededError(
                    first.error_message()
                    or f"request {ctx.id} deadline exceeded at request plane"
                )
            self.health.record_success(instance.instance_id)
            return instance, first, frames

    async def generate(
        self, request: dict, context: AsyncEngineContext | None = None
    ) -> ResponseStream[Any]:
        ctx = context or AsyncEngineContext()
        if not self.client.instances and self.ready_wait_s > 0:
            try:
                await self.client.wait_for_instances(1, self.ready_wait_s)
            except TimeoutError:
                pass  # fall through to the strict error below
        explicit_target = "_worker_instance_id" in request
        clean = {k: v for k, v in request.items() if k != "_worker_instance_id"}
        # Journal for mid-stream failover — engine-level requests only.
        # With an explicit target, recovery needs a re-selector (the
        # KV-aware wrapper's), otherwise the target is contractual.
        journal = None
        if self.max_recoveries > 0 and (
            not explicit_target or self.continuation_selector is not None
        ):
            journal = ReplayJournal.for_request(clean, self.rng)
        if journal is not None:
            clean = journal.request  # the seed-pinned copy
        tried: set[int] = set()
        instance, first, frames = await self._dispatch(
            clean,
            ctx,
            tried,
            pick=lambda: self._pick(request, exclude=tried),
            retry_ok=not explicit_target,
        )

        async def _emit(data) -> AsyncIterator[Any]:
            if journal is None:
                yield data
            else:
                out = journal.record(data)
                if out is not None:
                    yield out

        # Instances whose stream broke mid-flight for THIS request: a
        # continuation never lands on any of them again (cumulative
        # across recoveries, not just the most recent death).
        broken: set[int] = set()

        async def _data() -> AsyncIterator[Any]:
            nonlocal instance, first, frames
            while True:
                try:
                    if first is not None:
                        if first.is_error():
                            from .client import EngineError

                            raise EngineError(
                                first.error_message() or "remote error"
                            )
                        if first.data is not None:
                            async for out in _emit(first.data):
                                yield out
                        first = None
                    async for ann in frames:
                        if ann.data is not None:
                            async for out in _emit(ann.data):
                                yield out
                    return
                except ConnectionError as e:
                    if journal is None or journal.finished:
                        raise
                    done = journal.synthetic_finish()
                    if done is not None:
                        # The stream died between its last token and the
                        # finish frame; the budget is spent — close the
                        # stream locally instead of re-prefilling to
                        # generate nothing.
                        yield done
                        return
                    broken.add(instance.instance_id)
                    instance, first, frames = await self._recover(
                        journal, instance, e, ctx, broken
                    )

        return ResponseStream(_data(), ctx)

    async def _recover(
        self,
        journal: ReplayJournal,
        dead: InstanceInfo,
        err: ConnectionError,
        ctx: AsyncEngineContext,
        broken: set[int],
    ):
        """Mid-stream break: record the failure, then re-dispatch the
        journal's continuation request to a different healthy instance —
        never one whose stream already broke for this request
        (``broken`` accumulates across recoveries). Bounded by
        ``max_recoveries`` and the request's deadline."""
        self.health.record_failure(dead.instance_id)
        if journal.recoveries >= self.max_recoveries:
            raise RecoveryExhaustedError(
                f"stream for request {ctx.id} broke "
                f"{journal.recoveries + 1} times "
                f"(max_recoveries={self.max_recoveries}): {err}"
            ) from err
        if ctx.deadline_expired:
            # No recovery after the deadline: the client has given up.
            raise DeadlineExceededError(
                f"request {ctx.id} deadline exceeded during mid-stream "
                f"recovery (stream broke: {err})"
            ) from err
        journal.recoveries += 1
        # Cause attribution: a spot-reclaimed worker's break counts as
        # "reclaim" (it also says "drain"-adjacent things, so test
        # reclaim first); a drain-grace expiry as "drain"; anything else
        # as a plain stream drop.
        msg = str(err).lower()
        if "reclaim" in msg:
            reason = "reclaim"
        elif "drain" in msg:
            reason = "drain"
        else:
            reason = "stream_drop"
        get_telemetry().request_recoveries.labels(reason).inc()
        cont = journal.continuation_request()
        tried = set(broken)
        # The recovery span marks the re-prefill hop in the request's
        # trace.
        with trace_span(
            "recovery",
            request_id=ctx.id,
            reason=reason,
            recovery=journal.recoveries,
            journaled_tokens=len(journal.tokens),
            dead_instance=dead.instance_id,
        ) as sp:
            instance, first, frames = await self._dispatch(
                cont,
                ctx,
                tried,
                pick=lambda: self._pick_continuation(cont, tried),
                retry_ok=True,
            )
            sp.set(instance_id=instance.instance_id)
        journal.begin_continuation()
        return instance, first, frames

    def _pick_continuation(self, cont: dict, tried: set[int]):
        """Continuation placement: the KV-aware re-selector when
        installed (it sees prompt+journal, so the overlap estimate
        includes the re-prefill), plain health-filtered policy pick
        otherwise. Never the instance(s) that already failed this
        request."""
        if self.continuation_selector is None:
            return self._pick(cont, exclude=tried)

        async def _select() -> InstanceInfo:
            wid = await self.continuation_selector(
                cont.get("token_ids", []), frozenset(tried)
            )
            try:
                return self.client.instance(int(wid))
            except KeyError as e:
                raise NoInstancesError(str(e)) from e

        return _select()

    async def generate_direct(
        self,
        request: dict,
        instance_id: int,
        context: AsyncEngineContext | None = None,
    ) -> ResponseStream[Any]:
        return await self.generate(
            {**request, "_worker_instance_id": instance_id}, context
        )


def _is_connect_error(e: Exception) -> bool:
    """Connect-phase errors mention the transport; stream drops happen
    after dispatch. Best-effort label for the retry counter."""
    return "connect" in str(e).lower() or "no served endpoint" in str(e).lower()
