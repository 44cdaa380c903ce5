"""Trace context: one (trace_id, span_id) pair flowing with each request.

Counterpart of ``dynamo_exp_tpu/telemetry/context.py``, unchanged in
behaviour: a contextvar carries the current trace coordinates, so every
task of one request shares them; the engine loop thread, which does
not share the contextvar, gets the ``TraceContext`` captured at
submission. ``to_wire`` / ``from_wire`` give the dict the TCP request
plane carries in a request's header (``runtime/transports/tcp.py``), so
a worker's spans join the ingress's trace.
"""


from __future__ import annotations

import contextvars
import uuid
from dataclasses import dataclass


@dataclass(frozen=True)
class TraceContext:
    """Coordinates of the *current* span: children parent onto span_id."""

    trace_id: str
    span_id: str

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_id())

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "parent_span_id": self.span_id}

    @staticmethod
    def from_wire(d: dict | None) -> "TraceContext | None":
        if not d or not d.get("trace_id"):
            return None
        return TraceContext(d["trace_id"], d.get("parent_span_id", ""))


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "dynamo_trace_context", default=None
)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace() -> TraceContext | None:
    """The active trace context, or None outside any traced request."""
    return _current.get()


def current_trace_id() -> str | None:
    tc = _current.get()
    return tc.trace_id if tc is not None else None


def current_span_id() -> str | None:
    tc = _current.get()
    return tc.span_id if tc is not None else None


def new_trace(trace_id: str | None = None) -> TraceContext:
    """A fresh root context (``span_id`` is the root span's id)."""
    return TraceContext(trace_id or uuid.uuid4().hex, _new_id())


def attach(tc: TraceContext | None) -> contextvars.Token:
    """Make ``tc`` current; pass the returned token to :func:`detach`."""
    return _current.set(tc)


def detach(token: contextvars.Token) -> None:
    _current.reset(token)


def wire_headers() -> dict:
    """The current context as a wire dict, or {} when untraced — for
    merging into transport headers."""
    tc = _current.get()
    return tc.to_wire() if tc is not None else {}
