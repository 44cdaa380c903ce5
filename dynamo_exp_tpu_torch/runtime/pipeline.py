"""Composable pipeline graph: frontends, operators, backends, segments.

Counterpart of ``dynamo_exp_tpu/runtime/pipeline.py``. A service is a
directed graph of nodes, each defining behaviour on the forward
(request) path and the backward (response) path:

- ``ServiceFrontend``: graph entry, an ``AsyncEngine`` to callers.
- ``ServiceBackend``: graph exit, wrapping an engine.
- ``PipelineOperator``: a bidirectional node around an ``Operator``,
  transforming the request on the way down and the stream on the way up.
- ``PipelineNode``: an edge operator, one direction only.
- ``SegmentSink`` / ``SegmentSource``: network cut points. A segment
  ends at a SegmentSink (forwarding over an attached transport engine,
  e.g. a PushRouter client) and resumes remotely at a SegmentSource
  (served as an endpoint handler feeding its local graph).

The backward path rides the forward call's completion: each interposing
node awaits a per-request future ("slot") that the node below resolves
with the response stream, so every node still gets to wrap the stream on
its way up. ``Operator`` / ``build_pipeline`` are the linear chain the
OpenAI ingress runs.
"""

from __future__ import annotations

import abc
import asyncio
from typing import Any, AsyncIterator, Callable

from .engine import AsyncEngine, AsyncEngineContext, ResponseStream


class Context:
    """Per-request context propagated down the graph: the current
    (possibly transformed) payload plus shared id/controller/registry —
    the reference's ``Context<T>`` (``context.rs``: current, controller,
    registry, stages)."""

    def __init__(
        self,
        current: Any = None,
        request_id: str | None = None,
        controller: AsyncEngineContext | None = None,
    ):
        self.current = current
        self.engine_context = controller or AsyncEngineContext(request_id)
        self.values: dict[str, Any] = {}
        self.stages: list[str] = []
        # Stack of futures; each node awaiting a downstream response
        # pushes one, the node that produces a stream resolves the top.
        self._slots: list[asyncio.Future] = []

    @property
    def id(self) -> str:
        return self.engine_context.id

    @property
    def controller(self) -> AsyncEngineContext:
        return self.engine_context

    def map(self, fn: Callable[[Any], Any]) -> "Context":
        """Transform the payload in place, keeping id/registry/slots
        shared (the reference's ``Context::map``)."""
        self.current = fn(self.current)
        return self

    def insert(self, key: str, value: Any) -> None:
        self.values[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.values.get(key, default)

    # ------------------------------------------------------ slot plumbing
    def push_slot(self) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._slots.append(fut)
        return fut

    def resolve(self, stream: ResponseStream) -> None:
        """Deliver a response stream to the nearest waiting node above."""
        self._slots.pop().set_result(stream)

    def fail(self, exc: BaseException) -> None:
        """Fail the nearest waiting node above. With no waiter left the
        error has nowhere to flow — re-raise so it surfaces instead of
        vanishing."""
        if not self._slots:
            raise exc
        self._slots.pop().set_exception(exc)


class Sink(abc.ABC):
    """Forward-path receiver (``nodes.rs`` ``Sink<T>::on_data``)."""

    @abc.abstractmethod
    async def on_data(self, ctx: Context) -> None: ...


class Source:
    """Forward-path emitter with one downstream edge
    (``nodes.rs`` ``Source<T>::{on_next, link}``)."""

    def __init__(self) -> None:
        self._edge: Sink | None = None

    def link(self, sink: "Sink") -> "Sink":
        """Connect this node's forward edge; returns ``sink`` so graphs
        chain: ``front.link(op).link(backend)``."""
        if self._edge is not None:
            raise RuntimeError(f"{type(self).__name__} edge already linked")
        self._edge = sink
        return sink

    async def on_next(self, ctx: Context) -> None:
        """Forward to the edge. Invariant: ``on_data`` resolves or fails
        the top slot exactly once and never raises — each node guards
        its own synchronous work; this catch is the safety net that
        turns an escaped node bug into a failed request, not a caller
        hung forever on a leaked slot."""
        if self._edge is None:
            ctx.fail(RuntimeError(f"{type(self).__name__} has no edge"))
            return
        try:
            await self._edge.on_data(ctx)
        except BaseException as e:  # escaped on_data bug (see invariant)
            ctx.fail(e)


class _FrontendBase(Source):
    """Shared Source-with-entry behavior of ServiceFrontend and
    SegmentSource (the reference's ``Frontend<In, Out>`` inner)."""

    async def generate(
        self, request: Any, context: AsyncEngineContext | None = None
    ) -> ResponseStream:
        ctx = (
            request
            if isinstance(request, Context)
            else Context(request, controller=context)
        )
        if context is not None and ctx.engine_context is not context:
            ctx.engine_context = context
        ctx.stages.append(type(self).__name__)
        fut = ctx.push_slot()
        await self.on_next(ctx)
        return await fut


class ServiceFrontend(_FrontendBase, AsyncEngine):
    """Graph entry point: an AsyncEngine whose generate() walks the
    linked segment and returns the stream the backend sent back up."""


class SegmentSource(_FrontendBase, AsyncEngine):
    """Remote-side entry of a cut graph: serve this as the endpoint
    handler (``endpoint_handler``) and link the local continuation."""

    def endpoint_handler(self):
        """Adapter for ``Endpoint.serve_endpoint``: an async-generator
        handler that feeds the local graph segment."""

        async def handler(request, context=None):
            stream = await self.generate(request, context)
            async for item in stream:
                yield item

        return handler


class ServiceBackend(Sink):
    """Terminal node wrapping the engine (``sinks.rs`` ServiceBackend)."""

    def __init__(self, engine: AsyncEngine):
        self._engine = engine

    async def on_data(self, ctx: Context) -> None:
        ctx.stages.append(type(self).__name__)
        try:
            stream = await self._engine.generate(
                ctx.current, ctx.engine_context
            )
        except BaseException as e:  # propagate to the waiting node
            ctx.fail(e)
            return
        ctx.resolve(stream)


class SegmentSink(ServiceBackend):
    """Forward-path network egress: ends a local segment by forwarding
    over an attached transport engine (PushRouter client, direct client,
    in-process bridge). Attach may happen after graph construction —
    the reference's ``OnceLock<ServiceEngine>`` (``sinks.rs``)."""

    def __init__(self, engine: AsyncEngine | None = None):
        super().__init__(engine)

    def attach(self, engine: AsyncEngine) -> None:
        if self._engine is not None:
            raise RuntimeError("SegmentSink transport already attached")
        self._engine = engine

    async def on_data(self, ctx: Context) -> None:
        if self._engine is None:
            ctx.fail(RuntimeError("SegmentSink has no transport attached"))
            return
        await super().on_data(ctx)


class Operator(abc.ABC):
    """A bidirectional transform stage: sees the request AND the
    downstream engine, so information can flow from the forward path to
    the backward path (``nodes.rs`` ``Operator`` trait)."""

    @abc.abstractmethod
    async def generate(
        self,
        request: Any,
        next_engine: AsyncEngine,
        context: AsyncEngineContext,
    ) -> ResponseStream: ...


class _DownstreamEngine(AsyncEngine):
    """The engine facade a PipelineOperator hands its Operator: generate
    pushes the (transformed) request further down the node graph and
    returns the stream the lower nodes resolve."""

    def __init__(self, node: "PipelineOperator", ctx: Context):
        self._node = node
        self._ctx = ctx

    async def generate(
        self, request: Any, context: AsyncEngineContext | None = None
    ) -> ResponseStream:
        ctx = self._ctx
        ctx.current = request
        fut = ctx.push_slot()
        await self._node.on_next(ctx)
        return await fut


class PipelineOperator(Source, Sink):
    """Node adapter for an ``Operator``: a Sink on the upstream forward
    edge, a Source on the downstream forward edge, and the response
    passes back through the operator's wrapping on the way up."""

    def __init__(self, op: Operator):
        Source.__init__(self)
        self._op = op

    async def on_data(self, ctx: Context) -> None:
        ctx.stages.append(type(self._op).__name__)
        try:
            stream = await self._op.generate(
                ctx.current, _DownstreamEngine(self, ctx), ctx.engine_context
            )
        except BaseException as e:
            ctx.fail(e)
            return
        ctx.resolve(stream)


class PipelineNode(Source, Sink):
    """Edge operator: transforms ONE direction only (``nodes.rs``
    ``PipelineNode``). ``forward`` maps the request payload; ``backward``
    maps each response item. A forward node has no visibility into the
    backward path (and vice versa) — use PipelineOperator for that."""

    def __init__(self, forward=None, backward=None):
        Source.__init__(self)
        self._forward = forward
        self._backward = backward

    async def on_data(self, ctx: Context) -> None:
        if self._forward is not None:
            try:
                ctx.map(self._forward)
            except BaseException as e:  # fail OUR waiter, don't unwind
                ctx.fail(e)
                return
        if self._backward is None:
            await self.on_next(ctx)
            return
        fut = ctx.push_slot()
        await self.on_next(ctx)
        try:
            stream = await fut
        except BaseException as e:
            ctx.fail(e)
            return

        fmap = self._backward

        async def _wrapped() -> AsyncIterator[Any]:
            async for item in stream:
                yield fmap(item)

        ctx.resolve(ResponseStream(_wrapped(), stream.context))


# --------------------------------------------------------------------------
# Operator-chain sugar: the common linear case, kept API-stable.
# --------------------------------------------------------------------------

class _OperatorEngine(AsyncEngine):
    def __init__(self, op: Operator, next_engine: AsyncEngine):
        self._op = op
        self._next = next_engine

    async def generate(
        self, request: Any, context: AsyncEngineContext | None = None
    ) -> ResponseStream:
        ctx = context or AsyncEngineContext()
        return await self._op.generate(request, self._next, ctx)


def build_pipeline(operators: list[Operator], sink: AsyncEngine) -> AsyncEngine:
    """Chain operators (first = outermost) in front of ``sink``."""
    engine = sink
    for op in reversed(operators):
        engine = _OperatorEngine(op, engine)
    return engine


def build_segment(
    nodes: list[Operator | Sink], sink: AsyncEngine | None = None
) -> ServiceFrontend:
    """Build a linked graph segment: ServiceFrontend → nodes → terminal.

    ``nodes`` may mix Operators (wrapped in PipelineOperator) and
    ready-made graph nodes (PipelineNode, SegmentSink). If the last node
    is not already a Sink terminal, ``sink`` must be an AsyncEngine and
    is wrapped in a ServiceBackend.
    """
    front = ServiceFrontend()
    cur: Source = front
    for n in nodes:
        node = PipelineOperator(n) if isinstance(n, Operator) else n
        cur.link(node)
        if isinstance(node, Source):
            cur = node
        else:  # terminal (ServiceBackend / SegmentSink)
            if n is not nodes[-1]:
                raise ValueError("terminal node must be last")
            return front
    if sink is None:
        raise ValueError("segment needs a terminal: pass sink= or end nodes with one")
    cur.link(ServiceBackend(sink))
    return front


class MapOperator(Operator):
    """Stateless operator from two plain functions (request map, item map)."""

    def __init__(self, map_request=None, map_response_item=None):
        self._map_req = map_request
        self._map_item = map_response_item

    async def generate(
        self,
        request: Any,
        next_engine: AsyncEngine,
        context: AsyncEngineContext,
    ) -> ResponseStream:
        if self._map_req is not None:
            request = self._map_req(request)
        stream = await next_engine.generate(request, context)

        async def _gen() -> AsyncIterator[Any]:
            async for item in stream:
                yield self._map_item(item) if self._map_item else item

        return ResponseStream(_gen(), context)
