"""The port's OpenAI HTTP service, on the CPU, through a standard-library
client (``dynamo_exp_tpu_torch.http.client``, asyncio streams).

- With the echo engines: routes, keep-alive, ``Expect: 100-continue``,
  400 / 404 / 405, the prompt-batch fan-out, SSE framing, and a client
  disconnect killing the request's context.
- A disconnect mid-stream frees the ``TorchEngine`` slot and pages.
- End to end against the JAX package: its aiohttp ``HttpService`` +
  ``build_pipeline_engine`` + ``TPUEngine`` and the port's service +
  ``TorchEngine(device="cpu")`` on the fixture directory, with the same
  converted float32 weights (TINY widths, the fixture's vocabulary),
  give identical content text, finish reasons and usage for the same
  chat and completion requests: streaming and unary; greedy, seeded and
  penalized; a stop string; a token-id prompt; a prompt batch. Exact
  identity across frameworks holds at float32 only.
"""

import asyncio
import http.client
import json
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.http import build_pipeline_engine as j_build_pipeline_engine
from dynamo_exp_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engines.echo import EchoEngineCore, EchoEngineFull
from dynamo_exp_tpu_torch.http import HttpService, build_pipeline_engine, client
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.models import ModelConfig, params_from_jax
from dynamo_exp_tpu_torch.protocols.sse import DONE_SENTINEL

ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=256,
    prefill_chunk=16, decode_window=4, kv_dtype="float32",
)


def _run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


async def _serve(*models):
    """A started service on a free port with (name, engine) models."""
    svc = HttpService(host="127.0.0.1", port=0)
    for name, engine in models:
        svc.manager.add_chat_model(name, engine)
        svc.manager.add_completion_model(name, engine)
    port = await svc.start()
    return svc, f"http://127.0.0.1:{port}"


def _content(frames) -> tuple[dict, dict, dict | None]:
    """(text by choice index, finish reason by index, usage) of SSE frames."""
    text, finish, usage = {}, {}, None
    for f in frames:
        if f.data == DONE_SENTINEL:
            continue
        usage = f.data.get("usage") or usage
        for c in f.data["choices"]:
            piece = c.get("text") if "text" in c else (c.get("delta") or {}).get("content")
            text[c["index"]] = text.get(c["index"], "") + (piece or "")
            if c.get("finish_reason"):
                finish[c["index"]] = c["finish_reason"]
    return text, finish, usage


def _unary_content(body: dict) -> tuple[dict, dict, dict | None]:
    text = {
        c["index"]: c["message"]["content"] if "message" in c else c["text"]
        for c in body["choices"]
    }
    return text, {c["index"]: c["finish_reason"] for c in body["choices"]}, body.get("usage")


# ------------------------------------------------------------ echo engines
@pytest.mark.asyncio
async def test_routes_models_health_and_errors():
    svc, base = await _serve(("m1", EchoEngineFull()))
    try:
        r = await client.request(base + "/v1/models")
        assert r.status == 200 and [m["id"] for m in r.json()["data"]] == ["m1"]
        for path in ("/health", "/live"):
            r = await client.request(base + path)
            assert r.json() == {"status": "healthy", "models": ["m1"]}
        assert (await client.request(base + "/nope")).status == 404
        assert (await client.request(base + "/v1/completions")).status == 405
        chat = base + "/v1/chat/completions"
        r = await client.request(chat, "POST", {"model": "zz", "messages": []})
        assert r.status == 404 and r.json()["error"]["type"] == "model_not_found"
        r = await client.request(chat, "POST", {"model": "m1", "messages": "hi"})
        assert r.status == 400 and r.json()["error"]["code"] == 400
        r = await client.request(chat, "POST", {"model": "m1", "messages": [], "n": None})
        assert r.status == 400
    finally:
        await svc.stop()


@pytest.mark.asyncio
async def test_bad_json_keep_alive_and_expect_continue():
    svc, base = await _serve(("echo", EchoEngineFull()))
    port = svc.port

    def two_on_one_connection():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", "/v1/completions", body=b"{not json",
                         headers={"Content-Type": "application/json"})
            r1 = conn.getresponse()
            bad = (r1.status, json.loads(r1.read())["error"]["message"])
            body = json.dumps({"model": "echo", "prompt": "hello there"})
            conn.request("POST", "/v1/completions", body=body)
            r2 = conn.getresponse()
            return bad, r2.status, json.loads(r2.read())
        finally:
            conn.close()

    try:
        (status, msg), status2, body = await asyncio.to_thread(two_on_one_connection)
        assert status == 400 and msg.startswith("invalid request")
        assert status2 == 200 and body["choices"][0]["text"] == "hello there"

        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps({"model": "echo", "prompt": "x" * 2000}).encode()
        writer.write(
            b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
            b"Connection: close\r\nContent-Length: %d\r\n\r\n" % len(payload)
        )
        await writer.drain()
        assert (await reader.readline()).startswith(b"HTTP/1.1 100")
        await reader.readline()
        writer.write(payload)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        assert raw.startswith(b"HTTP/1.1 200") and b"x" * 2000 in raw
    finally:
        await svc.stop()


@pytest.mark.asyncio
async def test_chat_streaming_sse_and_unary():
    svc, base = await _serve(("echo", EchoEngineFull(chunk_chars=3)))
    body = {"model": "echo", "messages": [{"role": "user", "content": "hello world"}]}
    try:
        frames = [
            f async for f in client.sse_frames(
                base + "/v1/chat/completions", {**body, "stream": True})
        ]
        assert frames[-1].data == DONE_SENTINEL
        text, finish, _ = _content(frames)
        assert text == {0: "hello world"} and finish == {0: "stop"}
        assert frames[0].data["choices"][0]["delta"]["role"] == "assistant"
        r = await client.request(base + "/v1/chat/completions", "POST", body)
        assert r.json()["object"] == "chat.completion"
        assert r.json()["choices"][0]["message"]["content"] == "hello world"
    finally:
        await svc.stop()


@pytest.mark.asyncio
async def test_prompt_batch_fans_out_with_indexed_choices(tiny_model_dir):
    mdc = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    svc, base = await _serve(("tiny", build_pipeline_engine(mdc, EchoEngineCore())))
    try:
        r = await client.request(base + "/v1/completions", "POST",
                                 {"model": "tiny", "prompt": ["hello", "world"]})
        by_index = {c["index"]: c["text"] for c in r.json()["choices"]}
        assert r.status == 200 and by_index == {0: "hello", 1: "world"}
        frames = [
            f async for f in client.sse_frames(base + "/v1/completions", {
                "model": "tiny", "prompt": ["hello", "world"], "stream": True,
                "stream_options": {"include_usage": True}})
        ]
        text, finish, usage = _content(frames)
        assert text == {0: "hello", 1: "world"} and finish == {0: "length", 1: "length"}
        mdc.context_length = 4
        r = await client.request(base + "/v1/completions", "POST", {
            "model": "tiny", "prompt": "this prompt is longer than four tokens"})
        assert r.status == 400 and r.json()["error"]["type"] == "context_length_exceeded"
    finally:
        await svc.stop()


class _Recording:
    """Core-engine wrapper that keeps each request's context."""

    def __init__(self, engine):
        self.engine = engine
        self.contexts = []

    async def generate(self, request, context=None):
        self.contexts.append(context)
        return await self.engine.generate(request, context)


@pytest.mark.asyncio
async def test_disconnect_kills_context(tiny_model_dir):
    mdc = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    core = _Recording(EchoEngineCore(token_delay_ms=20))
    svc, base = await _serve(("tiny", build_pipeline_engine(mdc, core)))
    try:
        stream = client.sse_frames(base + "/v1/completions", {
            "model": "tiny", "prompt": "the quick brown fox jumps over the lazy dog",
            "stream": True})
        first = await stream.__anext__()
        assert first.data["choices"]
        await stream.aclose()  # the client goes away mid-stream
        for _ in range(200):
            if core.contexts[0].is_killed:
                break
            await asyncio.sleep(0.01)
        assert core.contexts[0].is_killed
    finally:
        await svc.stop()


def _fixture_config(model_dir):
    return replace(ModelConfig.from_pretrained(model_dir), dtype="float32")


def test_disconnect_frees_engine_slot_and_pages(tiny_model_dir):
    mdc = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    eng = TorchEngine(EngineConfig(model=_fixture_config(tiny_model_dir), **ENGINE_KW),
                      device="cpu", seed=1)

    async def go():
        svc, base = await _serve(("tiny", build_pipeline_engine(mdc, eng)))
        try:
            stream = client.sse_frames(base + "/v1/completions", {
                "model": "tiny", "prompt": [5] * 40, "max_tokens": 200,
                "stream": True, "nvext": {"ignore_eos": True}})
            for _ in range(3):
                await stream.__anext__()
            busy = eng.metrics()
            await stream.aclose()
            for _ in range(500):
                m = eng.metrics()
                if m["request_active_slots"] == 0 and m["kv_active_blocks"] == 0:
                    return busy, m
                await asyncio.sleep(0.01)
            return busy, eng.metrics()
        finally:
            await svc.stop()

    try:
        busy, after = _run(go())
    finally:
        eng.stop()
    assert busy["request_active_slots"] == 1 and busy["kv_active_blocks"] > 0
    assert after["request_active_slots"] == 0 and after["kv_active_blocks"] == 0
    assert eng.steps < 200  # generation stopped well before max_tokens


# ------------------------------------------------ end to end against JAX
def _requests(stop: str):
    chat = [{"role": "user", "content": "hello world, the quick brown fox"}]
    return [
        ("/v1/chat/completions", {"messages": chat, "max_tokens": 12, "stream": True,
                                  "stream_options": {"include_usage": True}}),
        ("/v1/chat/completions", {"messages": chat, "max_tokens": 10, "temperature": 0.8,
                                  "seed": 7, "top_k": 20}),
        ("/v1/completions", {"prompt": "café naïve 日本語", "max_tokens": 12,
                             "temperature": 0.7, "seed": 5, "frequency_penalty": 0.5,
                             "presence_penalty": 0.3, "repetition_penalty": 1.2,
                             "stream": True}),
        ("/v1/completions", {"prompt": "the lazy dog", "max_tokens": 16, "stop": [stop],
                             "stream_options": {"include_usage": True}}),
        ("/v1/completions", {"prompt": "the lazy dog", "max_tokens": 16, "stop": stop,
                             "stream": True, "stream_options": {"include_usage": True}}),
        ("/v1/completions", {"prompt": [5, 9, 33, 120, 7], "max_tokens": 9,
                             "min_tokens": 4, "stream": True}),
        ("/v1/completions", {"prompt": ["STOP stop", "emoji ☃"], "max_tokens": 6}),
    ]


async def _answer(base: str, path: str, body: dict):
    body = {"model": "tiny", **body}
    if body.get("stream"):
        frames = [f async for f in client.sse_frames(base + path, body)]
        assert frames[-1].data == DONE_SENTINEL
        return _content(frames)
    r = await client.request(base + path, "POST", body)
    assert r.status == 200, r.body
    return _unary_content(r.json())


def test_http_end_to_end_identical_to_jax_package(tiny_model_dir):
    jcfg = replace(JModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    jcard = JCard.from_local_path(tiny_model_dir, display_name="tiny")
    tcard = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    eos = list(tcard.eos_token_ids)
    jeng = TPUEngine(
        JEngineConfig(model=jcfg, attention_impl="xla", eos_token_ids=eos, **ENGINE_KW),
        params=jax.tree.map(jax.numpy.asarray, np_params), mesh=single_device_mesh(),
    )
    tcfg = _fixture_config(tiny_model_dir)
    teng = TorchEngine(
        EngineConfig(model=tcfg, eos_token_ids=eos, **ENGINE_KW),
        model=params_from_jax(np_params, tcfg, device="cpu"), device="cpu",
    )

    async def go():
        jsvc = JHttpService(host="127.0.0.1", port=0)
        jengine = j_build_pipeline_engine(jcard, jeng)
        jsvc.manager.add_chat_model("tiny", jengine)
        jsvc.manager.add_completion_model("tiny", jengine)
        jbase = f"http://127.0.0.1:{await jsvc.start()}"
        tsvc, tbase = await _serve(("tiny", build_pipeline_engine(tcard, teng)))
        try:
            # A stop string from the greedy output, cut out of its middle.
            free, _, _ = await _answer(jbase, "/v1/completions",
                                       {"prompt": "the lazy dog", "max_tokens": 16})
            stop = free[0][len(free[0]) // 2:][:3]
            assert stop
            out = []
            for path, body in _requests(stop):
                # One request at a time: each engine sees a lone stream.
                out.append((await _answer(jbase, path, body),
                            await _answer(tbase, path, body)))
            return stop, out
        finally:
            await tsvc.stop()
            await jsvc.stop()

    try:
        stop, out = _run(go())
    finally:
        jeng.stop()
        teng.stop()
    for i, (want, got) in enumerate(out):
        assert got == want, (i, got, want)
    texts = [t for (t, _, _), _ in out]
    assert all(s for t in texts for s in t.values()), texts  # no empty answers
    finishes = [f for (_, f, _), _ in out]
    assert finishes[3] == {0: "stop"} and finishes[4] == {0: "stop"}
    assert stop not in texts[3][0]
    assert out[0][0][2]["completion_tokens"] == 12 and out[5][0][2] is None
