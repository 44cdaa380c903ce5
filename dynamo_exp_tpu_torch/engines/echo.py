"""Echo test engines: the serving pipeline without a model.

Counterpart of ``dynamo_exp_tpu/engines/echo.py``: the core variant
echoes prompt token ids back one per step (exercising detokenization
and stop handling); the full variant echoes the last user message as
text (exercising the OpenAI chunk path).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from ..protocols.common import BackendInput, FinishReason, LLMEngineOutput
from ..protocols.delta import ChatDeltaGenerator, CompletionDeltaGenerator
from ..protocols.openai import ChatCompletionRequest, CompletionRequest
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream


class EchoEngineCore(AsyncEngine):
    """Token-level echo: streams the prompt's token ids back, one per step."""

    def __init__(self, token_delay_ms: float = 0.0):
        self.token_delay_ms = token_delay_ms

    async def generate(
        self, request: dict, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        ctx = context or AsyncEngineContext()
        binput = BackendInput.from_dict(request)

        async def _gen() -> AsyncIterator[dict]:
            limit = binput.stop_conditions.max_tokens or len(binput.token_ids)
            for i, tid in enumerate(binput.token_ids):
                if ctx.is_stopped or i >= limit:
                    break
                if self.token_delay_ms:
                    await asyncio.sleep(self.token_delay_ms / 1000.0)
                yield LLMEngineOutput(token_ids=[tid]).to_dict()
            yield LLMEngineOutput(
                finish_reason=FinishReason.LENGTH,
                prompt_tokens=len(binput.token_ids),
                completion_tokens=min(limit, len(binput.token_ids)),
            ).to_dict()

        return ResponseStream(_gen(), ctx)


class EchoEngineFull(AsyncEngine):
    """OpenAI-level echo: streams the last user message back as text."""

    def __init__(self, token_delay_ms: float = 0.0, chunk_chars: int = 4):
        self.token_delay_ms = token_delay_ms
        self.chunk_chars = chunk_chars

    async def generate(
        self, request: dict, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        ctx = context or AsyncEngineContext()
        if "messages" in request:
            req = ChatCompletionRequest.from_dict(request)
            text = next(
                (m.text_content() for m in reversed(req.messages) if m.role == "user"),
                "",
            )
            gen = ChatDeltaGenerator(req.model, ctx.id)
        else:
            req = CompletionRequest.from_dict(request)
            text = req.prompt if isinstance(req.prompt, str) else ""
            gen = CompletionDeltaGenerator(req.model, ctx.id)

        async def _gen() -> AsyncIterator[dict]:
            for i in range(0, len(text), self.chunk_chars):
                if ctx.is_stopped:
                    break
                if self.token_delay_ms:
                    await asyncio.sleep(self.token_delay_ms / 1000.0)
                yield gen.text_chunk(text[i : i + self.chunk_chars]).to_dict()
            yield gen.finish_chunk(FinishReason.EOS).to_dict()

        return ResponseStream(_gen(), ctx)
