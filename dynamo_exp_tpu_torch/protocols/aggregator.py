"""Stream -> full-response aggregation for ``stream=false`` requests.

Counterpart of ``dynamo_exp_tpu/protocols/aggregator.py``: the service
always streams internally and folds unary responses from the chunk
stream. Without logprobs (ROADMAP Queue 1 item 3) there are none to
merge.
"""

from __future__ import annotations

from typing import AsyncIterator

from .openai import (
    ChatChoice,
    ChatCompletionChunk,
    ChatCompletionResponse,
    ChatMessage,
    CompletionChoice,
    CompletionChunk,
    CompletionResponse,
    Usage,
)


async def aggregate_chat_stream(
    chunks: AsyncIterator[ChatCompletionChunk],
) -> ChatCompletionResponse:
    pieces: dict[int, list[str]] = {}
    finish: dict[int, str | None] = {}
    roles: dict[int, str] = {}
    usage: Usage | None = None
    meta: ChatCompletionChunk | None = None
    async for chunk in chunks:
        meta = meta or chunk
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            idx = choice.index
            if choice.delta.role:
                roles[idx] = choice.delta.role
            if choice.delta.content:
                pieces.setdefault(idx, []).append(choice.delta.content)
            if choice.finish_reason is not None:
                finish[idx] = choice.finish_reason
    if meta is None:
        raise ValueError("empty response stream")
    indices = sorted(set(pieces) | set(finish) | set(roles)) or [0]
    choices = [
        ChatChoice(
            index=i,
            message=ChatMessage(
                role=roles.get(i, "assistant"), content="".join(pieces.get(i, []))
            ),
            finish_reason=finish.get(i),
        )
        for i in indices
    ]
    return ChatCompletionResponse(
        id=meta.id, created=meta.created, model=meta.model, choices=choices, usage=usage
    )


async def aggregate_completion_stream(
    chunks: AsyncIterator[CompletionChunk],
) -> CompletionResponse:
    pieces: dict[int, list[str]] = {}
    finish: dict[int, str | None] = {}
    usage: Usage | None = None
    meta: CompletionChunk | None = None
    async for chunk in chunks:
        meta = meta or chunk
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            if choice.text:
                pieces.setdefault(choice.index, []).append(choice.text)
            if choice.finish_reason is not None:
                finish[choice.index] = choice.finish_reason
    if meta is None:
        raise ValueError("empty response stream")
    indices = sorted(set(pieces) | set(finish)) or [0]
    choices = [
        CompletionChoice(index=i, text="".join(pieces.get(i, [])), finish_reason=finish.get(i))
        for i in indices
    ]
    return CompletionResponse(
        id=meta.id, created=meta.created, model=meta.model, choices=choices, usage=usage
    )
