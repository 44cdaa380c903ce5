"""Operator chains: the linear pipeline the OpenAI ingress runs.

Counterpart of the ``Operator`` / ``build_pipeline`` part of
``dynamo_exp_tpu/runtime/pipeline.py``: an ``Operator`` sees the request
and the engine below it, so it can transform the request on the way
down and wrap the response stream on the way up; ``build_pipeline``
chains operators in front of a sink engine. The node graph and network
segments of the JAX package wait for a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import abc
from typing import Any

from .engine import AsyncEngine, AsyncEngineContext, ResponseStream


class Operator(abc.ABC):
    """A bidirectional transform stage."""

    @abc.abstractmethod
    async def generate(
        self,
        request: Any,
        next_engine: AsyncEngine,
        context: AsyncEngineContext,
    ) -> ResponseStream: ...


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
