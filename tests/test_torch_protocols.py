"""The port's OpenAI protocol types (dataclasses) against the JAX
package's pydantic models, on the CPU.

- The same request bodies are accepted or rejected (``ValueError`` in
  both: pydantic's ``ValidationError`` is one), and what is accepted
  dumps to the same dict.
- Delta generators, the unary aggregators and SSE frames give the same
  dicts and text, apart from ``id`` and ``created``.
"""

import asyncio

import pytest

from dynamo_exp_tpu.protocols import aggregator as jagg
from dynamo_exp_tpu.protocols import delta as jdelta
from dynamo_exp_tpu.protocols import openai as jopenai
from dynamo_exp_tpu.protocols import sse as jsse
from dynamo_exp_tpu.protocols.common import FinishReason as JFinishReason
from dynamo_exp_tpu.runtime.annotated import Annotated as JAnnotated
from dynamo_exp_tpu_torch.protocols import aggregator, delta, openai, sse
from dynamo_exp_tpu_torch.protocols.common import FinishReason
from dynamo_exp_tpu_torch.runtime.annotated import Annotated

MSG = [{"role": "user", "content": "hi"}]
CHAT_EDITS = [
    {},
    {"stream": True, "stream_options": {"include_usage": True}},
    {"max_tokens": 5.0, "temperature": "0.5", "top_k": "7", "seed": -1},
    {"max_tokens": True, "stream": "yes", "n": 2},
    {"stop": "END", "nvext": {"ignore_eos": "true", "annotations": ["a"]}},
    {"stop": ["a", "b"], "priority": "high", "tool_choice": {"x": 1}},
    {"messages": [{"role": "user", "content": [{"type": "text", "text": "x"}]}]},
    {"messages": [{"role": "tool", "content": None, "tool_call_id": "t", "extra": 1}]},
    {"tools": [{"type": "function"}], "user": "u", "custom_field": [1]},
    {"priority": 1.0, "max_completion_tokens": "1_000", "min_tokens": 0},
    # rejected
    {"max_tokens": 5.5},
    {"max_tokens": "0x5"},
    {"max_tokens": float("inf")},
    {"stream": 2},
    {"stop": 5},
    {"stop": ["a", 1]},
    {"n": None},
    {"model": 5},
    {"messages": "hi"},
    {"messages": [{"content": "no role"}]},
    {"messages": [{"role": "user", "content": 7}]},
    {"nvext": 5},
    {"nvext": {"annotations": "x"}},
    {"temperature": "hot"},
    {"top_k": 1e20},
    {"stream_options": {"include_usage": "maybe"}},
]
COMPLETION_EDITS = [
    {},
    {"prompt": [1, 2, 3]},
    {"prompt": [[1, 2], [3]]},
    {"prompt": ["a", "b"]},
    {"prompt": []},
    {"prompt": [True, 2.0]},
    {"prompt": ["1", 2]},
    {"echo": "1", "logprobs": True, "max_tokens": " 5 "},
    # rejected
    {"prompt": 5},
    {"prompt": [1, "a"]},
    {"prompt": ["a", [1]]},
    {"prompt": [[1, "x"]]},
    {"prompt": {"text": "x"}},
    {"seed": "abc"},
    {"echo": "sometimes"},
]


def _both(jcls, tcls, body):
    try:
        want = jcls.model_validate(body).model_dump(exclude_none=True)
    except ValueError:
        want = ValueError
    try:
        got = tcls.from_dict(body).to_dict()
    except ValueError:
        got = ValueError
    return got, want


@pytest.mark.parametrize("edit", CHAT_EDITS, ids=range(len(CHAT_EDITS)))
def test_chat_request_bodies_same_verdict(edit):
    body = {"model": "m", "messages": MSG, **edit}
    got, want = _both(jopenai.ChatCompletionRequest, openai.ChatCompletionRequest, body)
    assert got == want


@pytest.mark.parametrize("edit", COMPLETION_EDITS, ids=range(len(COMPLETION_EDITS)))
def test_completion_request_bodies_same_verdict(edit):
    body = {"model": "m", "prompt": "hello", **edit}
    got, want = _both(jopenai.CompletionRequest, openai.CompletionRequest, body)
    assert got == want


def test_missing_fields_and_non_objects_rejected():
    for body in ({"messages": MSG}, {"model": "m"}, [1], "x", None):
        for jcls, tcls in (
            (jopenai.ChatCompletionRequest, openai.ChatCompletionRequest),
            (jopenai.CompletionRequest, openai.CompletionRequest),
        ):
            assert _both(jcls, tcls, body) == (ValueError, ValueError)


def test_extracted_conditions_and_options_equal():
    body = {
        "model": "m", "messages": MSG, "max_completion_tokens": 9, "stop": "x",
        "temperature": 0.7, "top_p": 0.9, "seed": 3, "repetition_penalty": 1.1,
        "min_tokens": 2, "nvext": {"ignore_eos": True},
    }
    j = jopenai.ChatCompletionRequest.model_validate(body)
    t = openai.ChatCompletionRequest.from_dict(body)
    assert t.extract_stop_conditions().__dict__ == j.extract_stop_conditions().model_dump()
    assert t.extract_sampling_options().__dict__ == j.extract_sampling_options().model_dump()
    assert t.messages[0].text_content() == j.messages[0].text_content()


def _strip(d):
    return {k: v for k, v in d.items() if k not in ("id", "created")}


def _chunk_sequences():
    """The same generator calls on both packages' delta generators."""
    out = []
    for mod, fr in ((jdelta, JFinishReason), (delta, FinishReason)):
        dump = (lambda c: c.model_dump(exclude_none=True)) if mod is jdelta else (
            lambda c: c.to_dict())
        chat = mod.ChatDeltaGenerator("m", "rid")
        cmpl = mod.CompletionDeltaGenerator("m", "rid", index=1)
        out.append(
            [
                dump(chat.text_chunk("he")),
                dump(chat.text_chunk("llo")), dump(chat.finish_chunk(fr.LENGTH)),
                dump(chat.usage_chunk(3, 2)),
                dump(cmpl.text_chunk("a b")), dump(cmpl.finish_chunk(fr.EOS)),
                dump(cmpl.usage_chunk(1, 1)),
            ]
        )
    return out


def test_delta_chunks_equal():
    jchunks, tchunks = _chunk_sequences()
    assert [_strip(c) for c in tchunks] == [_strip(c) for c in jchunks]
    first = openai.ChatCompletionChunk.from_dict(tchunks[0])
    assert first.to_dict() == tchunks[0]


def test_aggregated_responses_equal():
    async def agg(fn, chunks):
        async def gen():
            for c in chunks:
                yield c

        return await fn(gen())

    jchunks, tchunks = _chunk_sequences()
    for j_cls, t_cls, j_fn, t_fn, sl in (
        (jopenai.ChatCompletionChunk, openai.ChatCompletionChunk,
         jagg.aggregate_chat_stream, aggregator.aggregate_chat_stream, slice(0, 4)),
        (jopenai.CompletionChunk, openai.CompletionChunk,
         jagg.aggregate_completion_stream, aggregator.aggregate_completion_stream,
         slice(4, 7)),
    ):
        want = asyncio.run(agg(j_fn, [j_cls.model_validate(c) for c in jchunks[sl]]))
        got = asyncio.run(agg(t_fn, [t_cls.from_dict(c) for c in tchunks[sl]]))
        assert got.to_dict() == want.model_dump(exclude_none=True)


def test_sse_frames_equal_and_decode():
    frames = [
        ({"a": 1, "b": "x\ny"}, None, None, []),
        ("plain text", "evt", "7", ["c1", "c2"]),
        (None, "error", None, ["boom"]),
    ]
    wire = ""
    for data, event, fid, comment in frames:
        got = sse.encode_frame(Annotated(data=data, id=fid, event=event, comment=comment))
        want = jsse.encode_frame(JAnnotated(data=data, id=fid, event=event, comment=comment))
        assert got == want
        wire += got
    assert sse.encode_done() == jsse.encode_done()
    wire += sse.encode_done()
    tdec, jdec = sse.SseDecoder(), jsse.SseDecoder()
    got = [f for i in range(0, len(wire), 5) for f in tdec.feed(wire[i : i + 5])]
    want = [f for i in range(0, len(wire), 5) for f in jdec.feed(wire[i : i + 5])]
    assert [(f.data, f.event, f.id, f.comment) for f in got] == [
        (f.data, f.event, f.id, f.comment) for f in want
    ]
    assert got[-1].data == sse.DONE_SENTINEL
