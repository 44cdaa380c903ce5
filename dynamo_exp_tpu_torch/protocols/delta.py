"""Delta generators: backend step outputs -> OpenAI stream chunks.

Counterpart of ``dynamo_exp_tpu/protocols/delta.py``: text chunks
carry the OpenAI logprobs object the preprocessor shaped for them.
"""

from __future__ import annotations

from .common import FinishReason
from .openai import (
    ChatChoiceDelta,
    ChatCompletionChunk,
    ChatStreamChoice,
    CompletionChoice,
    CompletionChunk,
    Usage,
    new_request_id,
    now_unix,
)


def _usage(prompt_tokens: int, completion_tokens: int) -> Usage:
    return Usage(
        prompt_tokens=prompt_tokens,
        completion_tokens=completion_tokens,
        total_tokens=prompt_tokens + completion_tokens,
    )


class ChatDeltaGenerator:
    """Stateful converter for one chat request's response stream."""

    def __init__(self, model: str, request_id: str | None = None, index: int = 0):
        self.model = model
        self.id = request_id or new_request_id("chatcmpl")
        self.created = now_unix()
        self.index = index
        self._sent_role = False

    def _chunk(self, choices, usage=None) -> ChatCompletionChunk:
        return ChatCompletionChunk(
            id=self.id, created=self.created, model=self.model,
            choices=choices, usage=usage,
        )

    def text_chunk(self, text: str, logprobs=None) -> ChatCompletionChunk:
        delta = ChatChoiceDelta(content=text)
        if not self._sent_role:
            delta.role = "assistant"
            self._sent_role = True
        return self._chunk(
            [ChatStreamChoice(index=self.index, delta=delta, logprobs=logprobs)]
        )

    def finish_chunk(self, reason: FinishReason) -> ChatCompletionChunk:
        return self._chunk(
            [
                ChatStreamChoice(
                    index=self.index,
                    delta=ChatChoiceDelta(),
                    finish_reason=reason.to_openai(),
                )
            ]
        )

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> ChatCompletionChunk:
        return self._chunk([], _usage(prompt_tokens, completion_tokens))


class CompletionDeltaGenerator:
    """Stateful converter for one text-completion request's stream."""

    def __init__(self, model: str, request_id: str | None = None, index: int = 0):
        self.model = model
        self.id = request_id or new_request_id("cmpl")
        self.created = now_unix()
        self.index = index

    def _chunk(self, choices, usage=None) -> CompletionChunk:
        return CompletionChunk(
            id=self.id, created=self.created, model=self.model,
            choices=choices, usage=usage,
        )

    def text_chunk(self, text: str, logprobs=None) -> CompletionChunk:
        return self._chunk(
            [CompletionChoice(index=self.index, text=text, logprobs=logprobs)]
        )

    def finish_chunk(self, reason: FinishReason) -> CompletionChunk:
        return self._chunk(
            [CompletionChoice(index=self.index, text="", finish_reason=reason.to_openai())]
        )

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> CompletionChunk:
        return self._chunk([], _usage(prompt_tokens, completion_tokens))
