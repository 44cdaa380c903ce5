"""Logprobs in the port, on the CPU, against the JAX package.

- ``ops.sampling.token_logprobs`` equals JAX's on the same numpy logits
  (atol 1e-5, the same top ids).
- ``TorchEngine`` and ``TPUEngine`` (float32 TINY, the same weights)
  emit the same tokens with the same per-token packs (atol 1e-4): the
  first token (mixed shape), windows (chained), decode steps inside
  mixed batches, greedy and seeded rows, ``top_logprobs`` 0 and 3, and
  verify spans (speculation on in the port).
- Over HTTP, the port's service and the JAX ``HttpService`` give chat
  ``logprobs.content`` entries and legacy completions entries of the
  same shape and values, streaming and unary; ``top_logprobs`` above 5
  gets the same 400 from both.
"""

import asyncio
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.http import build_pipeline_engine as j_build_pipeline_engine
from dynamo_exp_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.ops import sampling as jsampling
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.http import HttpService, build_pipeline_engine, client
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.models import ModelConfig, params_from_jax
from dynamo_exp_tpu_torch.ops import sampling as tsampling
from dynamo_exp_tpu_torch.protocols.sse import DONE_SENTINEL
from dynamo_exp_tpu_torch.spec import Drafter

CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=256,
    prefill_chunk=16, decode_window=4, kv_dtype="float32",
)
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11, 44, 2, 9, 30, 31, 32, 33, 34, 35, 36]
ATOL = 1e-4


def _run(coro):
    """Run ``coro`` to its end, failing after 300 s instead of hanging."""
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_logprobs_equal_jax(seed):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(6, 300) * 4).astype(np.float32)
    chosen = rs.randint(0, 300, size=6).astype(np.int32)
    want = [np.asarray(x) for x in jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(chosen))]
    got = [x.numpy() for x in tsampling.token_logprobs(torch.from_numpy(logits), torch.from_numpy(chosen))]
    assert tsampling.TOP_LOGPROBS == jsampling.TOP_LOGPROBS == got[1].shape[1]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


# ------------------------------------------------------------- the engines
async def _packs(eng, prompt, max_tokens, **sampling):
    """(tokens, chosen logprobs, top dicts or None per token) of a stream."""
    stream = await eng.generate({
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
        "sampling_options": sampling,
    })
    toks, lps, tops = [], [], []
    async for item in stream:
        ids = item.get("token_ids", [])
        toks += ids
        if ids:
            assert len(item["logprobs"]) == len(ids)
            lps += item["logprobs"]
            tops += item.get("top_logprobs") or [None] * len(ids)
    return toks, lps, tops


REQUESTS = [
    (P1, 14, {"logprobs": 3}),
    (P2, 14, {"logprobs": 0, "temperature": 0.8, "seed": 9}),
    (P1[:5], 10, {"logprobs": 2, "temperature": 0.7, "seed": 4, "presence_penalty": 0.5}),
]


async def _staggered(eng):
    """The first two together, the third once tokens stream (its prompt
    rides a mixed batch beside decode steps)."""
    jobs = [asyncio.create_task(_packs(eng, p, n, **so)) for p, n, so in REQUESTS[:2]]
    await asyncio.sleep(0.05)
    jobs.append(asyncio.create_task(_packs(eng, REQUESTS[2][0], REQUESTS[2][1], **REQUESTS[2][2])))
    return await asyncio.gather(*jobs)


def _assert_packs_close(got, want):
    for (gt, glp, gtop), (wt, wlp, wtop) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, atol=ATOL)
        assert all(x <= 0 for x in glp)
        for g, w in zip(gtop, wtop):
            assert (g is None) == (w is None)
            if g is not None:
                assert list(g) == list(w)  # same ids, same order
                np.testing.assert_allclose(list(g.values()), list(w.values()), atol=ATOL)


class _Oracle(Drafter):
    """Proposes each stream's own continuation, one draft wrong in three
    proposals (long accepted verify spans and rejections)."""

    name = "oracle"

    def __init__(self, streams):
        self.streams, self.calls = streams, 0

    def propose(self, tokens, max_len):
        for prompt, want in self.streams:
            if list(tokens[: len(prompt)]) == list(prompt):
                i = len(tokens) - len(prompt)
                drafts = list(want[i : i + max_len])
                self.calls += 1
                if drafts and self.calls % 3 == 0:
                    drafts[-1] = (drafts[-1] + 1) % CFG.vocab_size
                return drafts
        return []


def test_engine_packs_equal_tpu_engine():
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))
    jeng = TPUEngine(
        JEngineConfig(model=CFG, attention_impl="xla", eos_token_ids=[], **ENGINE_KW),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )
    try:
        want = _run(_staggered(jeng))
    finally:
        jeng.stop()
    model = params_from_jax(np_params, CFG, device="cpu")
    for kw in ({}, {"attention_impl": "kernel", "spec_mode": "ngram"}):
        eng = TorchEngine(EngineConfig(model=CFG, eos_token_ids=[], **ENGINE_KW, **kw),
                          model=model, device="cpu")
        if eng._spec is not None:
            eng._spec.drafter = _Oracle([(p, w[0]) for (p, _, _), w in zip(REQUESTS, want)])
        try:
            got = _run(_staggered(eng))
            _assert_packs_close(got, want)
            m = eng.metrics()
            assert m["dispatches"]["mixed"] > 0
            if eng._spec is not None:
                assert m["spec_accepted_tokens"] > 0  # packs of verify spans
            else:
                assert m["dispatches"]["chained"] > 0  # packs of chained windows
        finally:
            eng.stop()


# ----------------------------------------------------------------- over HTTP
LP_REQUESTS = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello world"}],
                              "max_tokens": 8, "logprobs": True, "top_logprobs": 2,
                              "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "the quick fox"}],
                              "max_tokens": 6, "logprobs": True}),
    ("/v1/completions", {"prompt": "the lazy dog", "max_tokens": 7, "logprobs": 3,
                         "stream": True}),
    ("/v1/completions", {"prompt": "café naïve", "max_tokens": 6, "logprobs": 0,
                         "temperature": 0.7, "seed": 3}),
]


def _lp_of(frames_or_body, stream: bool, chat: bool):
    """The logprobs object(s) a response carries, merged over frames."""
    if not stream:
        return [c.get("logprobs") for c in frames_or_body["choices"]]
    merged = {"content": []} if chat else {"tokens": [], "token_logprobs": [], "top_logprobs": []}
    for f in frames_or_body:
        if f.data == DONE_SENTINEL:
            continue
        for c in f.data["choices"]:
            lp = c.get("logprobs")
            if not lp:
                continue
            for key in merged:
                merged[key] += lp.get(key) or []
    return [merged]


def _assert_same_shape(got, want, path="$"):
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= ATOL, (path, got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_shape(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_shape(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def test_http_logprobs_equal_jax_service(tiny_model_dir):
    jcfg = replace(JModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    jcard = JCard.from_local_path(tiny_model_dir, display_name="tiny")
    tcard = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="tiny")
    eos = list(tcard.eos_token_ids)
    jeng = TPUEngine(
        JEngineConfig(model=jcfg, attention_impl="xla", eos_token_ids=eos, **ENGINE_KW),
        params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh(),
    )
    tcfg = replace(ModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    teng = TorchEngine(EngineConfig(model=tcfg, eos_token_ids=eos, **ENGINE_KW),
                       model=params_from_jax(np_params, tcfg, device="cpu"), device="cpu")

    async def ask(base, path, body):
        body = {"model": "tiny", "nvext": {"ignore_eos": True}, **body}
        if body.get("stream"):
            frames = [f async for f in client.sse_frames(base + path, body)]
            assert frames[-1].data == DONE_SENTINEL
            return frames
        r = await client.request(base + path, "POST", body)
        assert r.status == 200, r.body
        return r.json()

    async def go():
        jsvc = JHttpService(host="127.0.0.1", port=0)
        jengine = j_build_pipeline_engine(jcard, jeng)
        jsvc.manager.add_chat_model("tiny", jengine)
        jsvc.manager.add_completion_model("tiny", jengine)
        jbase = f"http://127.0.0.1:{await jsvc.start()}"
        tsvc = HttpService(host="127.0.0.1", port=0)
        tengine = build_pipeline_engine(tcard, teng)
        tsvc.manager.add_chat_model("tiny", tengine)
        tsvc.manager.add_completion_model("tiny", tengine)
        tbase = f"http://127.0.0.1:{await tsvc.start()}"
        try:
            out = [(await ask(jbase, p, b), await ask(tbase, p, b)) for p, b in LP_REQUESTS]
            refused = []
            for path, body in (
                ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                                          "logprobs": True, "top_logprobs": 6}),
                ("/v1/completions", {"prompt": "x", "logprobs": 6}),
            ):
                body = {"model": "tiny", **body}
                refused.append((await client.request(jbase + path, "POST", body),
                                await client.request(tbase + path, "POST", body)))
            return out, refused
        finally:
            await tsvc.stop()
            await jsvc.stop()

    try:
        out, refused = _run(go())
    finally:
        jeng.stop()
        teng.stop()
    for (path, body), (want, got) in zip(LP_REQUESTS, out):
        chat, stream = "chat" in path, bool(body.get("stream"))
        w, g = _lp_of(want, stream, chat), _lp_of(got, stream, chat)
        _assert_same_shape(g, w)
        entries = w[0]["content"] if chat else w[0]["token_logprobs"]
        assert len(entries) == body["max_tokens"]
        if not chat and not body["logprobs"]:
            assert w[0]["top_logprobs"] is None  # logprobs=0: null, not []
    for jr, tr in refused:
        assert jr.status == tr.status == 400
        assert tr.json()["error"]["message"] == jr.json()["error"]["message"]
        assert "top_logprobs=6 exceeds the supported maximum of 5" in tr.json()["error"]["message"]
