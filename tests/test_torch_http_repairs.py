"""Two faults of the port's HTTP edge against the JAX service, repaired.

- ``timeout_s`` (body) and ``X-Request-Timeout-S`` (header): the JAX
  service pops the field, answers 400 to a non-number or a value <= 0
  and otherwise arms a deadline. The port's service does the same since
  deadlines were ported (it first accepted and ignored the field, then
  refused it with a 400 naming ROADMAP Queue 1 item 9(b)): a well-formed
  value reaches the engine with the deadline armed on its context, and
  a deadline that passes before any instance takes the request (a
  ``PushRouter`` waiting for its first worker) is the JAX service's 504
  ``deadline_exceeded``, counted at stage ``router``.
- ``X-Request-Priority``: the body / nvext ``priority`` wins, else the
  header is read, and the class is written into the forwarded payload
  (it was ignored). Under KV pressure on the CPU a request whose class
  came only in the header is the preemption victim, as it is in
  ``TPUEngine`` given the same class.
"""

import asyncio
import time
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.engines.echo import EchoEngineFull as JEchoFull
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu.runtime import Client as JClient
from dynamo_exp_tpu.runtime import PushRouter as JPushRouter
from dynamo_exp_tpu.runtime.transports.inproc import InProcRequestPlane as JInProcPlane
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engines.echo import EchoEngineFull
from dynamo_exp_tpu_torch.http import HttpService, build_pipeline_engine, client
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.models import ModelConfig, params_from_jax
from dynamo_exp_tpu_torch.protocols.common import PRIORITY_HIGH, PRIORITY_LOW, parse_priority
from dynamo_exp_tpu_torch.runtime import Client, PushRouter
from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcRequestPlane
from dynamo_exp_tpu_torch.telemetry import get_telemetry

CHAT = {"model": "m", "messages": [{"role": "user", "content": "hello there"}]}


def _run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


class _Recording(EchoEngineFull):
    """The full echo engine, keeping every payload it is handed and the
    deadline armed on its context."""

    def __init__(self):
        super().__init__()
        self.requests: list[dict] = []
        self.deadlines: list = []

    async def generate(self, request, context=None):
        self.requests.append(request)
        self.deadlines.append(context.deadline)
        return await super().generate(request, context)


def _router(client_cls, router_cls, plane_cls):
    """A routed deployment before its first worker registers: the
    router waits 0.05 s for an instance, then dispatches, checking the
    request's deadline at stage ``router`` first."""
    return router_cls(client_cls.new_static(plane_cls(), []), ready_wait_s=0.05)


async def _serve(svc, engine) -> str:
    svc.manager.add_chat_model("m", engine)
    svc.manager.add_completion_model("m", engine)
    return f"http://127.0.0.1:{await svc.start()}"


@pytest.mark.parametrize(
    "body,headers,status_jax,expiring",
    [
        ({"timeout_s": -1}, {}, 400, False),
        ({"timeout_s": "soon"}, {}, 400, False),
        ({}, {"X-Request-Timeout-S": "0"}, 400, False),
        ({"timeout_s": 5}, {}, 200, False),
        ({}, {"X-Request-Timeout-S": "5"}, 200, False),
        ({"timeout_s": 5}, {"X-Request-Timeout-S": "5"}, 200, False),
        ({"timeout_s": 0.01}, {}, 504, True),
        ({}, {"X-Request-Timeout-S": "0.01"}, 504, True),
    ],
    ids=["body-negative", "body-nan", "header-zero", "body-5", "header-5", "both",
         "body-expired", "header-expired"],
)
def test_timeout_s_is_refused_until_deadlines_are_ported(body, headers, status_jax, expiring):
    """The name is the refusal's, kept: every case is now held to the JAX
    service's answer, status and body (the ``id`` and ``created``
    fields aside)."""

    async def go():
        jsvc, tsvc = JHttpService(host="127.0.0.1", port=0), HttpService(host="127.0.0.1", port=0)
        jengine = (_router(JClient, JPushRouter, JInProcPlane) if expiring else JEchoFull())
        tengine = (_router(Client, PushRouter, InProcRequestPlane) if expiring
                   else _Recording())
        jbase = await _serve(jsvc, jengine)
        tbase = await _serve(tsvc, tengine)
        try:
            payload = {**CHAT, **body}
            t0 = time.time()
            want = await client.request(jbase + "/v1/chat/completions", "POST", payload, headers)
            got = await client.request(tbase + "/v1/chat/completions", "POST", payload, headers)
            return want, got, tengine, t0
        finally:
            await tsvc.stop()
            await jsvc.stop()

    router_504 = get_telemetry().deadline_exceeded.labels("router")
    before = router_504.get()
    want, got, tengine, t0 = _run(go())
    assert router_504.get() - before == (1 if expiring else 0)
    assert want.status == status_jax and got.status == status_jax
    wbody, gbody = want.json(), got.json()
    if status_jax == 400:
        # A malformed value: the JAX service's own answer; the engine
        # never saw it.
        assert gbody == wbody
        assert gbody["error"]["message"].startswith("invalid request: timeout_s must be")
        assert tengine.requests == []
    elif status_jax == 504:
        assert gbody["error"]["type"] == wbody["error"]["type"] == "deadline_exceeded"
        assert gbody["error"]["code"] == wbody["error"]["code"] == 504
        assert "deadline exceeded at stage 'router'" in gbody["error"]["message"]
    else:
        for d in (wbody, gbody):
            d.pop("id"), d.pop("created")
        assert gbody == wbody
        # Popped before the engine, and armed on the context instead.
        (request,), (deadline,) = tengine.requests, tengine.deadlines
        assert "timeout_s" not in request
        assert t0 + 4 < deadline < time.time() + 5


def test_priority_header_reaches_the_forwarded_payload():
    """The JAX service's rules (``test_overload.py``): a header-only
    class is forwarded, the body / nvext class wins over the header, and
    an invalid spelling is a 400."""

    async def go():
        svc = HttpService(host="127.0.0.1", port=0)
        engine = _Recording()
        base = await _serve(svc, engine)
        url = base + "/v1/completions"
        body = {"model": "m", "prompt": "hi", "max_tokens": 4}
        try:
            r = await client.request(url, "POST", body, {"X-Request-Priority": "low"})
            assert r.status == 200 and engine.requests[-1]["priority"] == PRIORITY_LOW
            r = await client.request(url, "POST", {**body, "nvext": {"priority": "high"}},
                                     {"X-Request-Priority": "low"})
            assert r.status == 200 and engine.requests[-1]["priority"] == PRIORITY_HIGH
            r = await client.request(url, "POST", {**body, "priority": 0},
                                     {"X-Request-Priority": "high"})
            assert r.status == 200 and engine.requests[-1]["priority"] == PRIORITY_LOW
            n = len(engine.requests)
            r = await client.request(url, "POST", body, {"X-Request-Priority": "urgent"})
            assert r.status == 400 and "invalid priority" in r.json()["error"]["message"]
            assert len(engine.requests) == n
        finally:
            await svc.stop()

    _run(go())


# ---------------------------------------------------- preemption order
PS = 8
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11]
N = 40
PRESSURE_KW = dict(
    max_decode_slots=4, page_size=PS, num_pages=8, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
    preempt_stall_grace_s=0.05,
)


def _victims(engine, prompts) -> list[int]:
    """Record which request (index into ``prompts``) every preemption
    takes, by wrapping the engine's scheduler."""
    victims: list[int] = []
    preempt = engine.sched.preempt

    def spy(seq):
        victims.append(next(i for i, p in enumerate(prompts) if seq.prompt[: len(p)] == p))
        return preempt(seq)

    engine.sched.preempt = spy
    return victims


async def _jax_collect(eng, prompt, priority):
    stream = await eng.generate({
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": N, "ignore_eos": True},
        "priority": parse_priority(priority),
    })
    n = 0
    async for item in stream:
        n += len(item.get("token_ids") or [])
    return n


def test_header_priority_sets_the_preemption_victim_as_in_tpu_engine(tiny_model_dir):
    """An 8-page pool where the two prompts (40 tokens each) need 12
    pages, so a row is preempted. P1 is admitted first with ``low``
    given only in the header, P2 after it with none: the victim is P1
    (the lowest class; with the header ignored both would be ``normal``
    and the youngest, P2, would go). ``TPUEngine`` given the same
    classes in its requests takes the same victims."""
    jcfg = replace(JModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    jeng = TPUEngine(
        JEngineConfig(model=jcfg, attention_impl="xla", **PRESSURE_KW),
        params=jax.tree.map(jax.numpy.asarray, np_params), mesh=single_device_mesh(),
    )
    jvictims = _victims(jeng, (P1, P2))

    async def jax_burst():
        # Submitted in one pass, P1 first (P2 is the younger).
        return await asyncio.gather(
            _jax_collect(jeng, P1, PRIORITY_LOW), _jax_collect(jeng, P2, None))

    try:
        jcounts = _run(jax_burst())
    finally:
        jeng.stop()

    tcfg = replace(ModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    teng = TorchEngine(
        EngineConfig(model=tcfg, **PRESSURE_KW),
        model=params_from_jax(np_params, tcfg, device="cpu"), device="cpu",
    )
    tvictims = _victims(teng, (P1, P2))
    card = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="m")

    async def port_burst():
        svc = HttpService(host="127.0.0.1", port=0)
        base = await _serve(svc, build_pipeline_engine(card, teng))
        url = base + "/v1/completions"

        def body(p):
            return {"model": "m", "prompt": p, "max_tokens": N, "ignore_eos": True}

        try:
            # Both queued while the loop is held, P1 first: admitted
            # together, P2 the younger.
            with teng.hold_admission():
                first = asyncio.ensure_future(
                    client.request(url, "POST", body(P1), {"X-Request-Priority": "low"}))
                while teng.queued() < 1:
                    await asyncio.sleep(0.005)
                second = asyncio.ensure_future(client.request(url, "POST", body(P2)))
                while teng.queued() < 2:
                    await asyncio.sleep(0.005)
            return [await first, await second]
        finally:
            await svc.stop()

    try:
        answers = _run(port_burst())
    finally:
        teng.stop()
    assert jcounts == [N, N]
    for r in answers:
        assert r.status == 200, r.body
        assert r.json()["choices"][0]["finish_reason"] == "length"
    assert jvictims and set(jvictims) == {0}
    assert tvictims and set(tvictims) == {0}, tvictims
