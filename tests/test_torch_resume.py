"""Resumable streams on the port, on the CPU: a float32 stream broken
mid-way resumes on the other torch worker.

Two ``TorchEngine`` workers (float32, the same seeded weights) serve one
endpoint; the first one's stream drops after two frames, as a crashed
worker's connection does. The port's ``PushRouter`` journals the stream
and resumes it on the second worker with the prompt and the journaled
tokens (``ReplayJournal``): the tokens equal the unbroken run's, greedy
and seeded (the sampler's draws are keyed by seed and position), the
usage is the client's view, and ``dynamo_request_recoveries_total``
counts one. Over HTTP (the port's ``HttpService`` in front of the
routed pipeline) the SSE stream's ``seq_index`` rises strictly to the
token budget (no index delivered twice), and its text equals the
unbroken run's. The port's counterpart of ``tests/test_resumable.py``'s
non-penalized cases.
"""

import random

import pytest

from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.http import HttpService, build_pipeline_engine, client
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.runtime import (
    DistributedRuntime,
    PushRouter,
    RouterMode,
    annotated_stream,
)
from dynamo_exp_tpu_torch.telemetry import get_telemetry

SHAPE = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32"]
PROMPT = [5, 9, 17, 23, 4, 44, 61, 12, 7, 30, 2]
N = 24
CRASH_AFTER = 2  # frames the first worker delivers before its stream drops


def engine(model_dir):
    opts = run.parse_args(["out=cuda", "--device", "cpu", "--model-path", model_dir,
                           "--random-weights", *SHAPE])
    return run.build_cuda_engine(opts)[0]


def handler(eng, crash_after=None):
    async def serve(req, ctx):
        n = 0
        async for frame in annotated_stream(eng, req, ctx):
            if crash_after is not None and n == crash_after:
                raise ConnectionError("worker crashed mid-stream")
            n += 1
            yield frame

    return serve


async def two_workers(model_dir):
    """A static runtime with the crashing worker first (round-robin's
    first pick) and a healthy one; returns (router, engines, teardown)."""
    drt = DistributedRuntime.detached()
    ep = drt.namespace("ns").component("worker").endpoint("generate")
    engines = [engine(model_dir), engine(model_dir)]
    insts = [await ep.serve_endpoint(handler(engines[0], CRASH_AFTER)),
             await ep.serve_endpoint(handler(engines[1]))]
    cl = await ep.client()
    router = PushRouter(cl, RouterMode.ROUND_ROBIN, rng=random.Random(0))

    async def teardown():
        cl.close()
        for inst in insts:
            await inst.close()
        for e in engines:
            e.stop()
        await drt.close()

    return router, engines, teardown


def request(**sampling) -> dict:
    return {"token_ids": PROMPT, "stop_conditions": {"max_tokens": N, "ignore_eos": True},
            "sampling_options": sampling}


async def frames_of(stream) -> list[dict]:
    return [f async for f in stream]


@pytest.mark.parametrize("sampling", [{"temperature": 0.0},
                                      {"temperature": 0.8, "seed": 1234}],
                         ids=["greedy", "seeded"])
async def test_broken_stream_resumes_on_the_other_worker(tiny_model_dir, sampling):
    recoveries = get_telemetry().request_recoveries.labels("stream_drop")
    before = recoveries.get()
    router, engines, teardown = await two_workers(tiny_model_dir)
    try:
        got = await frames_of(await router.generate(request(**sampling)))
        alone = engine(tiny_model_dir)
        try:
            want = await frames_of(await alone.generate(request(**sampling)))
        finally:
            alone.stop()
    finally:
        await teardown()
    tokens = [t for f in got for t in f.get("token_ids", [])]
    assert tokens == [t for f in want for t in f.get("token_ids", [])]
    assert len(tokens) == N
    assert got[-1]["finish_reason"] == "length"
    assert (got[-1]["prompt_tokens"], got[-1]["completion_tokens"]) == (len(PROMPT), N)
    assert recoveries.get() - before == 1
    # The first worker delivered its frames, the second the rest.
    assert 0 < engines[0].metrics()["prefill_tokens_computed"] == len(PROMPT)
    assert engines[1].metrics()["prefill_tokens_computed"] > len(PROMPT)


async def test_sse_seq_index_rises_strictly_across_the_failover(tiny_model_dir):
    mdc = ModelDeploymentCard.from_local_path(tiny_model_dir, "tiny")
    body = {"model": "tiny", "prompt": PROMPT, "max_tokens": N, "temperature": 0,
            "ignore_eos": True, "stream": True}

    async def sse(engine) -> list[dict]:
        svc = HttpService(host="127.0.0.1", port=0)
        svc.manager.add_completion_model("tiny", engine)
        port = await svc.start()
        try:
            return [f.data async for f in client.sse_frames(
                f"http://127.0.0.1:{port}/v1/completions", body) if isinstance(f.data, dict)]
        finally:
            await svc.stop()

    router, _, teardown = await two_workers(tiny_model_dir)
    try:
        broken = await sse(build_pipeline_engine(mdc, router))
    finally:
        await teardown()
    alone = engine(tiny_model_dir)
    try:
        whole = await sse(build_pipeline_engine(mdc, alone))
    finally:
        alone.stop()

    def text(frames):
        return "".join(c.get("text") or "" for f in frames for c in f["choices"])

    # Strictly rising to N: every token index delivered once, in order
    # (a frame's index is the tokens delivered through it).
    idx = [f["seq_index"] for f in broken if f.get("seq_index") is not None]
    assert len(idx) > 2 and all(a < b for a, b in zip(idx, idx[1:])) and idx[-1] == N
    assert text(broken) == text(whole)
