"""OpenAIPreprocessor: OpenAI requests -> engine BackendInput, and engine
outputs -> OpenAI stream chunks.

Counterpart of ``dynamo_exp_tpu/preprocessor/preprocessor.py`` without
telemetry spans: apply model-card defaults, render the chat template,
tokenize, extract stop conditions / sampling options / annotations; as
a pipeline Operator it also turns the backend's text stream into
OpenAI deltas. Requests the port cannot serve yet are refused with a
400 naming their ROADMAP item, never served without what they asked
for: logprobs (Queue 1 item 3) and non-text content parts (Queue 1
item 9(h)).
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from ..model_card import ModelDeploymentCard
from ..protocols.common import (
    BackendInput,
    FinishReason,
    LLMEngineOutput,
    parse_priority,
)
from ..protocols.delta import ChatDeltaGenerator, CompletionDeltaGenerator
from ..protocols.openai import ChatCompletionRequest, CompletionRequest
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from ..runtime.pipeline import Operator
from ..tokenizer import Tokenizer
from .prompt import PromptFormatter


class InvalidRequestError(ValueError):
    """Request parameters outside supported bounds (HTTP 400)."""


class PromptTooLongError(ValueError):
    """Prompt exceeds the model's context window (HTTP layer maps to 400)."""


def _wants_logprobs(request) -> bool:
    if isinstance(request, ChatCompletionRequest):
        return bool(request.logprobs) or request.top_logprobs is not None
    return request.logprobs is not None


class OpenAIPreprocessor(Operator):
    """Tokenizing/templating front half of the serving pipeline."""

    def __init__(self, mdc: ModelDeploymentCard, tokenizer: Tokenizer | None = None):
        self.mdc = mdc
        self.tokenizer = tokenizer or Tokenizer.from_pretrained(
            mdc.tokenizer_path or mdc.model_path
        )
        self.formatter = PromptFormatter(mdc)

    # --- request path -------------------------------------------------
    def preprocess_chat(self, request: ChatCompletionRequest) -> BackendInput:
        for m in request.messages:
            if isinstance(m.content, list):
                for part in m.content:
                    if part.get("type", "text") != "text":
                        raise InvalidRequestError(
                            f"content part of type {part.get('type')!r}: the port "
                            "serves text only (multimodal input is ROADMAP Queue 1 "
                            "item 9(h))"
                        )
        prompt = self.formatter.render(
            [m.to_dict() for m in request.messages], tools=request.tools
        )
        return self._build_input(prompt, request, add_special_tokens=False)

    def preprocess_completion(self, request: CompletionRequest) -> BackendInput:
        prompt = request.prompt
        if isinstance(prompt, list) and len(prompt) == 1:
            prompt = prompt[0]
        if isinstance(prompt, str):
            return self._build_input(prompt, request, add_special_tokens=True)
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            return self._finish_input(list(prompt), request)
        raise ValueError(
            "multi-prompt batches must be expanded into per-prompt requests "
            "before preprocessing (the HTTP layer does this automatically)"
        )

    def _build_input(self, prompt: str, request, add_special_tokens: bool) -> BackendInput:
        ids = self.tokenizer.encode(prompt, add_special_tokens=add_special_tokens).ids
        return self._finish_input(ids, request)

    def _finish_input(self, token_ids: list[int], request) -> BackendInput:
        if len(token_ids) >= self.mdc.context_length:
            raise PromptTooLongError(
                f"prompt is {len(token_ids)} tokens but the model's context "
                f"length is {self.mdc.context_length}"
            )
        if _wants_logprobs(request):
            raise InvalidRequestError(
                "logprobs are not served by the port yet (ROADMAP Queue 1 item 3)"
            )
        stop = request.extract_stop_conditions()
        if not stop.stop_token_ids:
            stop.stop_token_ids = list(
                self.mdc.eos_token_ids or self.tokenizer.eos_token_ids
            )
        # Default generation budget: fill the remaining context.
        stop.apply_defaults(self.mdc.context_length - len(token_ids))
        try:
            priority = parse_priority(request.request_priority())
        except ValueError as e:
            raise InvalidRequestError(str(e)) from None
        return BackendInput(
            token_ids=token_ids,
            stop_conditions=stop,
            sampling_options=request.extract_sampling_options(),
            annotations=request.annotations(),
            priority=priority,
        )

    # --- pipeline operator --------------------------------------------
    async def generate(
        self,
        request: Any,
        next_engine: AsyncEngine,
        context: AsyncEngineContext,
    ) -> ResponseStream:
        """Operator form: OpenAI request in, OpenAI chunks out."""
        if isinstance(request, dict):
            request = (
                ChatCompletionRequest.from_dict(request)
                if "messages" in request
                else CompletionRequest.from_dict(request)
            )
        is_chat = isinstance(request, ChatCompletionRequest)
        backend_input = (
            self.preprocess_chat(request) if is_chat else self.preprocess_completion(request)
        )
        want_usage = bool(request.stream_options and request.stream_options.include_usage)
        stream = await next_engine.generate(backend_input.to_dict(), context)
        gen = (
            ChatDeltaGenerator(request.model, context.id)
            if is_chat
            else CompletionDeltaGenerator(request.model, context.id)
        )
        prompt_tokens = len(backend_input.token_ids)

        async def _chunks() -> AsyncIterator[Any]:
            completion_tokens = 0
            finish: FinishReason | None = None
            async for item in stream:
                out = LLMEngineOutput.from_dict(item) if isinstance(item, dict) else item
                completion_tokens += len(out.token_ids)
                if out.text:
                    chunk = gen.text_chunk(out.text)
                    chunk.seq_index = completion_tokens
                    yield chunk
                if out.finish_reason is not None:
                    finish = FinishReason(out.finish_reason)
            yield gen.finish_chunk(finish or FinishReason.EOS)
            if want_usage:
                yield gen.usage_chunk(prompt_tokens, completion_tokens)

        return ResponseStream(_chunks(), context)
