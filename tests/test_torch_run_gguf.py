"""``run`` with a bare ``.gguf``, a ``tokenizer.model`` directory and a
GGUF without a tokenizer, on the CPU.

- ``run in=http out=cuda --device cpu --model-path tiny.gguf`` serves a
  streamed chat over HTTP from a float32 GGUF with an embedded Unigram
  tokenizer and chat template: its tokens equal the JAX ``TPUEngine``'s
  on the JAX loader's weights of the same file, and its text is those
  tokens streamed.
- A ``tokenizer.model`` directory is registrable: a worker registers it
  with the coordinator and an ingress with no ``--model-path``
  discovers it and serves a chat.
- A GGUF with no embedded tokenizer serves token ids on its endpoint
  and is not registered; a node that needs a template refuses it.
"""

import asyncio
import contextlib
import json
import os
from dataclasses import replace

import jax
import numpy as np
import pytest

import chip_smoke as cs
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import gguf as jgguf
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.models import gguf as tgguf
from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

from .fixtures import CHAT_TEMPLATE, build_tiny_model_dir
from .test_torch_gguf import gguf_metadata, gguf_tensors

CFG = replace(TINY, vocab_size=512, dtype="float32")
SMALL = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "256",
         "--kv-dtype", "float32", "--max-tokens", "8"]


def _pieces():
    with open(os.path.join(cs.HERE, "README.md"), encoding="utf-8") as f:
        return cs.unigram_pieces(f.read(), CFG.vocab_size, seed=3)


@pytest.fixture(scope="module")
def gguf_files(tmp_path_factory):
    """A float32 GGUF of JAX-initialised weights with its tokenizer and
    chat template embedded, and the same weights without them."""
    d = tmp_path_factory.mktemp("gguf")
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(7), CFG))
    tensors = gguf_tensors(CFG, params, "llama")
    md = gguf_metadata(CFG, "llama")
    pieces = _pieces()
    full, bare = str(d / "tiny.gguf"), str(d / "bare.gguf")
    tgguf.write_gguf(full, dict(md, **{
        "general.name": "tiny-gguf", "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": [p for p, _, _ in pieces],
        "tokenizer.ggml.scores": [s for _, s, _ in pieces],
        "tokenizer.ggml.token_type": [k for _, _, k in pieces],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.chat_template": CHAT_TEMPLATE}), tensors)
    tgguf.write_gguf(bare, md, tensors)
    return full, bare


def test_http_chat_over_a_gguf_equals_the_jax_engine(gguf_files, monkeypatch):
    full, _ = gguf_files
    read = tgguf.config_from_gguf
    # The file's weights are float32; serve them so (the CLI has no dtype flag).
    monkeypatch.setattr(tgguf, "config_from_gguf", lambda g: replace(read(g), dtype="float32"))
    opts = run.parse_args(["in=http", "out=cuda", "--device", "cpu", "--model-path", full,
                           "--http-host", "127.0.0.1", "--http-port", "0", *SMALL])
    messages = [{"role": "user", "content": "hello world, this is paged attention"}]

    async def go():
        ready = asyncio.get_running_loop().create_future()
        task = asyncio.ensure_future(run.main_async(opts, ready))
        served = await asyncio.wait_for(ready, 120)
        try:
            assert served.mdc.display_name == "tiny-gguf" and served.mdc.eos_token_ids == [2]
            r = await cs.sse_request(
                client, f"http://127.0.0.1:{served.port}/v1/chat/completions",
                {"model": "tiny-gguf", "messages": messages, "max_tokens": 8, "stream": True,
                 "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True}})
            ids, tok = cs.p17_prompt_ids(full, [messages], "tiny-gguf")
            stream = await served.torch_engine.generate({
                "token_ids": ids[0], "stop_conditions": {"max_tokens": 8, "ignore_eos": True}})
            tokens = [t async for item in stream for t in item.get("token_ids") or []]
            return r, ids[0], tok, tokens
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    r, ids, tok, tokens = asyncio.run(asyncio.wait_for(go(), 300))
    assert r["done"] and r["finish"] == "length"
    assert r["usage"]["prompt_tokens"] == len(ids)
    assert r["text"] == cs.streamed_text(tok, tokens)
    jcfg = replace(jgguf.config_from_gguf(jgguf.GGUFFile.parse(full)), dtype="float32")
    jparams, _ = jgguf.load_params_from_gguf(full, jcfg)
    jeng = TPUEngine(
        JEngineConfig(model=jcfg, attention_impl="xla", max_decode_slots=2, page_size=8,
                      max_model_len=256, num_pages=64, kv_dtype="float32", eos_token_ids=[]),
        params=jparams, mesh=single_device_mesh(),
    )

    async def jax_tokens():
        stream = await jeng.generate({"token_ids": ids,
                                      "stop_conditions": {"max_tokens": 8, "ignore_eos": True}})
        return [t async for item in stream for t in item.get("token_ids") or []]

    try:
        want = asyncio.run(asyncio.wait_for(jax_tokens(), 300))
    finally:
        jeng.stop()
    assert tokens == want and len(want) == 8


async def _worker(addr: str, endpoint: str, model_path: str, name: str):
    opts = run.parse_args([f"in=dyn://{endpoint}", "out=cuda", "--device", "cpu",
                           "--model-path", model_path, "--model-name", name, "--random-weights",
                           "--coordinator", addr, *SMALL])
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({task, ready}, return_when=asyncio.FIRST_COMPLETED)
    if task.done():
        task.result()
    return task


async def _stop(task) -> None:
    task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await task


def test_tokenizer_model_directory_is_registered_and_served(tmp_path):
    d = build_tiny_model_dir(str(tmp_path / "spdir"))
    os.remove(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "config.json")) as f:
        conf = json.load(f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(conf, vocab_size=CFG.vocab_size), f)
    with open(os.path.join(d, "tokenizer.model"), "wb") as f:
        f.write(cs.sp_model_bytes(_pieces()))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE, "bos_token": "<s>", "eos_token": "</s>"}, f)
    assert run.tokenizer_registrable(d)

    async def go():
        server = CoordinatorServer()
        await server.start()
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
        worker = ingress = None
        try:
            worker = await _worker(server.address, "t.sp.generate", d, "spdir")
            assert any("/spdir/" in k or k.startswith("models/spdir")
                       for k in await drt.discovery.kv_get_prefix("models/"))
            opts = run.parse_args(["in=http", "out=dyn://t.sp.generate", "--coordinator",
                                   server.address, "--http-host", "127.0.0.1", "--http-port",
                                   "0", "--router-mode", "round-robin"])
            ready = asyncio.get_running_loop().create_future()
            ingress = asyncio.ensure_future(run.main_async(opts, ready))
            base = f"http://127.0.0.1:{(await asyncio.wait_for(ready, 60)).port}"
            for _ in range(300):
                models = (await client.request(base + "/v1/models")).json()["data"]
                if "spdir" in [m["id"] for m in models]:
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError("the tokenizer.model directory was never discovered")
            r = await client.request(base + "/v1/chat/completions", "POST", {
                "model": "spdir", "messages": [{"role": "user", "content": "hello world"}],
                "max_tokens": 4, "nvext": {"ignore_eos": True}})
            assert r.status == 200, r.body
            choice = r.json()["choices"][0]
            assert choice["finish_reason"] == "length" and choice["message"]["content"]
        finally:
            for task in (ingress, worker):
                if task is not None:
                    await _stop(task)
            await drt.close()
            await server.close()

    asyncio.run(asyncio.wait_for(go(), 300))


def test_gguf_without_a_tokenizer_serves_token_ids_and_is_not_registered(gguf_files):
    _, bare = gguf_files
    assert not run.tokenizer_registrable(bare) and run.tokenizer_registrable(gguf_files[0])
    with pytest.raises(SystemExit, match="no embedded tokenizer"):
        run.require_mdc(run.parse_args(["in=http", "out=dyn://t.b.generate",
                                        "--model-path", bare]))

    async def go():
        server = CoordinatorServer()
        await server.start()
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
        worker = None
        try:
            worker = await _worker(server.address, "t.bare.generate", bare, "bare")
            assert await drt.discovery.kv_get_prefix("models/") == {}
            opts = run.parse_args(["in=http", "out=dyn://t.bare.generate", "--router-mode",
                                   "round-robin"])
            core, _ = await run.remote_core(opts, drt, 8)
            stream = await core.generate({"token_ids": [5, 9, 17, 23],
                                          "stop_conditions": {"max_tokens": 4,
                                                              "ignore_eos": True}})
            tokens = [t async for item in stream for t in item.get("token_ids") or []]
            assert len(tokens) == 4
        finally:
            if worker is not None:
                await _stop(worker)
            await drt.close()
            await server.close()

    asyncio.run(asyncio.wait_for(go(), 300))
