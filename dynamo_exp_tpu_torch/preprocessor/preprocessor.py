"""OpenAIPreprocessor: OpenAI requests -> engine BackendInput, and engine
outputs -> OpenAI stream chunks.

Counterpart of ``dynamo_exp_tpu/preprocessor/preprocessor.py`` without
telemetry spans: apply model-card defaults, render the chat template,
tokenize, extract stop conditions / sampling options / annotations; as
a pipeline Operator it also turns the backend's text stream into
OpenAI deltas, with the chat ``logprobs.content`` entries or the legacy
completions entries (``top_logprobs`` keyed by decoded text). Requests
the port cannot serve yet are refused with a 400 naming their ROADMAP
item, never served without what they asked for: non-text content
parts (Queue 1 item 9(h)).
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from ..model_card import ModelDeploymentCard
from ..ops.sampling import TOP_LOGPROBS
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
        sampling = request.extract_sampling_options()
        if sampling.logprobs is not None and sampling.logprobs > TOP_LOGPROBS:
            # The device computes a static top-N per step: refuse rather
            # than silently truncate the client's ask.
            raise InvalidRequestError(
                f"top_logprobs={sampling.logprobs} exceeds the "
                f"supported maximum of {TOP_LOGPROBS}"
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
            sampling_options=sampling,
            annotations=request.annotations(),
            priority=priority,
        )

    def _top_map(self, tops: dict | None) -> dict[str, float]:
        """A legacy completions top_logprobs entry, keyed by decoded text.
        Distinct ids can decode to the same string (partial-UTF-8 byte
        tokens all render U+FFFD): keep the best logprob per string."""
        out: dict[str, float] = {}
        for tid, lp in (tops or {}).items():
            text = self.tokenizer.decode([tid])
            if text not in out or lp > out[text]:
                out[text] = lp
        return out

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
        want_logprobs = backend_input.sampling_options.logprobs is not None

        def _token_entry(tid: int, lp: float, tops: dict | None) -> dict:
            text = self.tokenizer.decode([tid])
            entry: dict = {"token": text, "logprob": lp, "bytes": list(text.encode("utf-8"))}
            if is_chat:
                entry["top_logprobs"] = [
                    {
                        "token": (t := self.tokenizer.decode([a])),
                        "logprob": alp,
                        "bytes": list(t.encode("utf-8")),
                    }
                    for a, alp in (tops or {}).items()
                ]
            return entry

        def _shape(raw: list) -> dict | None:
            """(token id, logprob, tops) tuples -> the OpenAI logprobs object."""
            if not raw:
                return None
            entries = [_token_entry(tid, lp, tp) for tid, lp, tp in raw]
            if is_chat:
                return {"content": entries}
            has_tops = any(tp for _, _, tp in raw)  # legacy completions shape
            return {
                "tokens": [e["token"] for e in entries],
                "token_logprobs": [e["logprob"] for e in entries],
                "top_logprobs": [self._top_map(tp) for _, _, tp in raw] if has_tops else None,
            }

        async def _chunks() -> AsyncIterator[Any]:
            completion_tokens = 0
            finish: FinishReason | None = None
            # Logprob entries wait for text: a frame's text may be held
            # back (partial UTF-8, a possible stop-string prefix) while
            # its tokens already have logprobs; they ride the next chunk.
            pending: list = []
            async for item in stream:
                out = LLMEngineOutput.from_dict(item) if isinstance(item, dict) else item
                completion_tokens += len(out.token_ids)
                if want_logprobs and out.logprobs:
                    tops = out.top_logprobs or [None] * len(out.logprobs)
                    pending += list(zip(out.token_ids, out.logprobs, tops))
                if out.text:
                    chunk = gen.text_chunk(out.text, _shape(pending))
                    chunk.seq_index = completion_tokens
                    yield chunk
                    pending = []
                if out.finish_reason is not None:
                    finish = FinishReason(out.finish_reason)
            if pending:  # logprobs whose text never flushed (e.g. a stop)
                yield gen.text_chunk("", _shape(pending))
            yield gen.finish_chunk(finish or FinishReason.EOS)
            if want_usage:
                yield gen.usage_chunk(prompt_tokens, completion_tokens)

        return ResponseStream(_chunks(), context)
