"""The port's HTTP service behind a router, against the JAX service, on
the CPU: the answers the edge gives for the router's errors and the SSE
layer's ``seq_index`` dedupe.

- No live instance (a ``PushRouter`` with none): 503
  ``service_unavailable`` with ``Retry-After: 1``, stream or unary.
- A resumable stream whose recoveries ran out (``RecoveryExhaustedError``
  while a unary response is folded): 502 ``bad_gateway``.
- Chunks replayed with an already-emitted ``seq_index`` are dropped
  before the wire, and the replayed tokens counted on
  ``dynamo_tokens_deduplicated_total`` (the JAX hub counts the same).

Each case goes to both services with the same engine behind them; the
statuses, error bodies and texts are equal.
"""

import json

import pytest

import dynamo_exp_tpu.runtime as jrt
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.runtime.transports.inproc import InProcRequestPlane as JInProcPlane
from dynamo_exp_tpu.telemetry import get_telemetry as jget_telemetry
from dynamo_exp_tpu_torch import runtime as trt
from dynamo_exp_tpu_torch.http import HttpService, client
from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcRequestPlane
from dynamo_exp_tpu_torch.telemetry import get_telemetry


def chunk(text, si):
    return {"id": "c", "object": "text_completion", "created": 1, "model": "m",
            "choices": [{"index": 0, "text": text}], "seq_index": si}


def replaying(rt):
    """A splice that replays from index 1: the stale chunk, then the
    re-delivered one, then fresh tokens."""

    async def gen(request, ctx):
        for text, si in (("a", 1), ("bc", 3), ("a", 1), ("bc", 3), ("d", 4)):
            yield chunk(text, si)

    return rt.LambdaEngine(gen)


def exhausted(rt):
    async def gen(request, ctx):
        yield chunk("a", 1)
        raise rt.RecoveryExhaustedError("stream for request x broke 3 times")

    return rt.LambdaEngine(gen)


async def answer(svc_cls, engine, body):
    svc = svc_cls(host="127.0.0.1", port=0)
    svc.manager.add_completion_model("m", engine)
    if svc_cls is JHttpService:
        await svc.start()
        port = svc.port
    else:
        port = await svc.start()
    try:
        r = await client.request(f"http://127.0.0.1:{port}/v1/completions", "POST", body)
        return r.status, r.headers.get("retry-after"), r.body.decode()
    finally:
        await svc.stop()


def texts(raw: str) -> list[str]:
    return [json.loads(line[6:])["choices"][0]["text"] for line in raw.split("\n")
            if line.startswith("data: ") and line != "data: [DONE]"
            and json.loads(line[6:]).get("choices")]


def jdedup() -> float:
    return jget_telemetry().tokens_deduplicated._value.get()


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "unary"])
async def test_no_instances_is_a_503_as_in_jax(stream):
    body = {"model": "m", "prompt": "x", "stream": stream}
    want = await answer(JHttpService, jrt.PushRouter(jrt.Client.new_static(JInProcPlane(), [])),
                        body)
    got = await answer(HttpService, trt.PushRouter(
        trt.Client.new_static(InProcRequestPlane(), [])), body)
    assert got[:2] == want[:2] == (503, "1")
    assert json.loads(got[2]) == json.loads(want[2])
    assert json.loads(got[2])["error"]["type"] == "service_unavailable"


async def test_recovery_exhausted_is_a_502_as_in_jax():
    body = {"model": "m", "prompt": "x", "stream": False}
    want = await answer(JHttpService, exhausted(jrt), body)
    got = await answer(HttpService, exhausted(trt), body)
    assert got[0] == want[0] == 502
    assert json.loads(got[2]) == json.loads(want[2])
    assert json.loads(got[2])["error"]["type"] == "bad_gateway"


async def test_sse_drops_replayed_seq_index_as_jax_does():
    body = {"model": "m", "prompt": "x", "stream": True}
    j0, t0 = jdedup(), get_telemetry().tokens_deduplicated._only().get()
    want = await answer(JHttpService, replaying(jrt), body)
    got = await answer(HttpService, replaying(trt), body)
    assert texts(got[2]) == texts(want[2]) == ["a", "bc", "d"]
    # The re-delivered chunk repeats 2 tokens (indices 2-3 after the
    # stale 1); the stale chunk itself counts none.
    assert get_telemetry().tokens_deduplicated._only().get() - t0 == jdedup() - j0 == 2
