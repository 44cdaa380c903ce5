"""The port's preprocessor and detokenizing backend against the JAX
package's, on the CPU, on the fixture model directory.

- ``OpenAIPreprocessor``: the same rendered prompt text, token ids,
  stop conditions and sampling options (chat template, string and
  token-id completions), and the same ``PromptTooLongError``; logprob
  requests carry the same ``logprobs`` option as the JAX package's, and
  ``top_logprobs`` above 5 gets its 400 message; requests the port
  cannot serve yet (image parts) are refused.
- ``Backend`` over the echo core engine: the same text, token ids,
  finish reasons and usage with the stop-string jail, ``max_tokens``,
  EOS, ``min_tokens`` and ``ignore_eos``.
"""

import asyncio

import pytest

from dynamo_exp_tpu.backend import Backend as JBackend
from dynamo_exp_tpu.backend import StopSequenceJail as JJail
from dynamo_exp_tpu.engines.echo import EchoEngineCore as JEchoCore
from dynamo_exp_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_exp_tpu.preprocessor import preprocessor as jpre
from dynamo_exp_tpu.protocols import openai as jopenai
from dynamo_exp_tpu.tokenizer import Tokenizer as JTokenizer
from dynamo_exp_tpu_torch.backend import Backend, StopSequenceJail
from dynamo_exp_tpu_torch.engines.echo import EchoEngineCore
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.preprocessor import preprocessor as tpre
from dynamo_exp_tpu_torch.protocols import openai
from dynamo_exp_tpu_torch.tokenizer import Tokenizer

CHAT = [
    {"model": "tiny", "messages": [{"role": "user", "content": "hello world"}],
     "max_tokens": 5, "stop": ["END"]},
    {"model": "tiny", "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [{"type": "text", "text": "café "},
                                     {"type": "text", "text": "日本語"}]},
        {"role": "assistant", "content": "ok"},
        {"role": "user", "content": "STOP stop"}],
     "temperature": 0.8, "seed": 4, "nvext": {"ignore_eos": True}},
]
COMPLETION = [
    {"model": "tiny", "prompt": "the quick brown fox", "max_tokens": 3},
    {"model": "tiny", "prompt": [5, 6, 7, 8], "min_tokens": 2, "priority": "low"},
    {"model": "tiny", "prompt": ["only one"], "frequency_penalty": 0.5},
]


@pytest.fixture
def pre_pair(tiny_model_dir):
    jcard = JCard.from_local_path(tiny_model_dir, display_name="tiny")
    tcard = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    assert tcard.chat_template == jcard.chat_template
    assert tcard.eos_token_ids == jcard.eos_token_ids
    assert tcard.context_length == jcard.context_length
    return jpre.OpenAIPreprocessor(jcard), tpre.OpenAIPreprocessor(tcard)


def _same_input(got, want):
    assert got.token_ids == want.token_ids
    assert got.stop_conditions.__dict__ == want.stop_conditions.model_dump()
    assert got.sampling_options.__dict__ == want.sampling_options.model_dump()
    assert got.annotations == want.annotations and got.priority == want.priority


@pytest.mark.parametrize("body", CHAT, ids=range(len(CHAT)))
def test_chat_prompt_text_and_ids_equal(pre_pair, body):
    jp, tp = pre_pair
    jreq = jopenai.ChatCompletionRequest.model_validate(body)
    treq = openai.ChatCompletionRequest.from_dict(body)
    jtext = jp.formatter.render([m.model_dump(exclude_none=True) for m in jreq.messages])
    assert tp.formatter.render([m.to_dict() for m in treq.messages]) == jtext
    _same_input(tp.preprocess_chat(treq), jp.preprocess_chat(jreq))


@pytest.mark.parametrize("body", COMPLETION, ids=range(len(COMPLETION)))
def test_completion_ids_equal(pre_pair, body):
    jp, tp = pre_pair
    _same_input(
        tp.preprocess_completion(openai.CompletionRequest.from_dict(body)),
        jp.preprocess_completion(jopenai.CompletionRequest.model_validate(body)),
    )


def test_prompt_too_long_raises_in_both(pre_pair):
    jp, tp = pre_pair
    jp.mdc.context_length = tp.mdc.context_length = 4
    body = {"model": "tiny", "prompt": "this prompt is longer than four tokens"}
    with pytest.raises(jpre.PromptTooLongError):
        jp.preprocess_completion(jopenai.CompletionRequest.model_validate(body))
    with pytest.raises(tpre.PromptTooLongError):
        tp.preprocess_completion(openai.CompletionRequest.from_dict(body))


def test_fallback_prompt_without_template(pre_pair):
    jp, tp = pre_pair
    msgs = [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"}]
    assert tp.formatter._fallback(msgs) == jp.formatter._fallback(msgs)


def _preprocess(pre, body, jax_side=False):
    if "messages" in body:
        if jax_side:
            return pre.preprocess_chat(jopenai.ChatCompletionRequest.model_validate(body))
        return pre.preprocess_chat(openai.ChatCompletionRequest.from_dict(body))
    if jax_side:
        return pre.preprocess_completion(jopenai.CompletionRequest.model_validate(body))
    return pre.preprocess_completion(openai.CompletionRequest.from_dict(body))


@pytest.mark.parametrize(
    "body,match",
    [
        ({"model": "tiny", "prompt": "x", "logprobs": 6}, "top_logprobs=6 exceeds"),
        ({"model": "tiny", "messages": [{"role": "user", "content": "x"}],
          "logprobs": True, "top_logprobs": 6}, "top_logprobs=6 exceeds"),
        ({"model": "tiny", "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "data:,"}}]}]}, "item 9\\(h\\)"),
    ],
)
def test_unserved_requests_refused(pre_pair, body, match):
    """Image parts are not served yet; ``top_logprobs`` above the static
    5 gets the JAX package's 400 (the same message from both)."""
    jp, tp = pre_pair
    with pytest.raises(tpre.InvalidRequestError, match=match) as err:
        _preprocess(tp, body)
    if "image_url" not in str(body):
        with pytest.raises(jpre.InvalidRequestError) as jerr:
            _preprocess(jp, body, jax_side=True)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize(
    "body",
    [
        {"model": "tiny", "prompt": "x", "logprobs": 2},
        {"model": "tiny", "messages": [{"role": "user", "content": "x"}], "logprobs": True},
    ],
    ids=["completion", "chat"],
)
def test_logprob_requests_accepted(pre_pair, body):
    """The two logprob requests the port refused before it served them
    now pass preprocessing with the JAX package's ``logprobs`` option
    (2 for the legacy field, 0 for chat's ``logprobs: true``)."""
    jp, tp = pre_pair
    got = _preprocess(tp, body).sampling_options.logprobs
    assert got == _preprocess(jp, body, jax_side=True).sampling_options.logprobs
    assert got == (2 if "prompt" in body else 0)


@pytest.mark.parametrize(
    "stops,text",
    [(["STOP"], "abc STO"), (["STOP", "xyz"], "abc STOP here"), (["ab"], "a a ab")],
)
def test_stop_jail_equal(stops, text):
    j, t = JJail(stops), StopSequenceJail(stops)
    for i in range(len(text)):
        assert t.feed(text[i]) == j.feed(text[i])
    assert t.flush() == j.flush()


# (text to echo, stop conditions): the jail, max_tokens, EOS (id 1 is
# "</s>" in the fixture), min_tokens past EOS, ignore_eos.
BACKEND_CASES = [
    ("hello world STOP stop hidden", {"max_tokens": 100, "stop": ["STOP"]}),
    ("hello world STO", {"max_tokens": 100, "stop": ["STOP"]}),
    ("the quick brown fox jumps", {"max_tokens": 3}),
    ("hello</s>world", {"max_tokens": 50, "stop_token_ids": [1]}),
    ("a</s>bc</s>d", {"max_tokens": 50, "stop_token_ids": [1], "min_tokens": 3}),
    ("hello</s>world", {"max_tokens": 50, "stop_token_ids": [1], "ignore_eos": True}),
    ("café 日本語 ☃", {"max_tokens": 100, "stop": ["日本"]}),
]


@pytest.mark.parametrize("text,stop", BACKEND_CASES, ids=range(len(BACKEND_CASES)))
def test_backend_over_echo_equal(tiny_model_dir, text, stop):
    jtok = JTokenizer.from_pretrained(tiny_model_dir)
    tok = Tokenizer.from_pretrained(tiny_model_dir)
    ids = tok.encode(text, add_special_tokens=False).ids
    assert ids == jtok.encode(text, add_special_tokens=False).ids
    request = {"token_ids": ids, "stop_conditions": stop}

    async def run(backend):
        stream = await backend.generate(dict(request))
        return [item async for item in stream]

    got = asyncio.run(run(Backend(EchoEngineCore(), tok)))
    want = asyncio.run(run(JBackend(JEchoCore(), jtok)))
    assert got == want
    assert got[-1]["finish_reason"] in ("stop", "length", "eos")
