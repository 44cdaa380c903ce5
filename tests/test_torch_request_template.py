"""Request templates (``protocols/request_template.py``) against the JAX
package's, on the CPU: the same file loads to the same template, a
template fills the same fields of the same requests (explicit client
values win), and through each package's HTTP service the engine
receives the same request; ``run.py --request-template`` wires it in.
"""

import asyncio
import contextlib
import json

import pytest
from aiohttp import ClientSession

from dynamo_exp_tpu.engines.echo import EchoEngineFull as JEchoFull
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.protocols.request_template import RequestTemplate as JTemplate
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.engines.echo import EchoEngineFull
from dynamo_exp_tpu_torch.http import HttpService, client
from dynamo_exp_tpu_torch.protocols.request_template import RequestTemplate

TEMPLATE = {"model": "foo", "temperature": 0.6, "max_completion_tokens": 42}


@pytest.mark.parametrize(
    "template,request_",
    [
        (TEMPLATE, {"messages": []}),
        (TEMPLATE, {"model": "bar", "temperature": 0.0, "max_tokens": 5}),
        (TEMPLATE, {"model": "", "temperature": None, "max_completion_tokens": 7}),
        ({"model": "foo"}, {"messages": [], "max_tokens": None}),
        ({"temperature": 1.5}, {"prompt": "x", "model": "m"}),
        ({}, {"prompt": "x"}),
    ],
    ids=["fills", "client-wins", "falsy-model", "model-only", "temperature-only", "empty"],
)
def test_template_applies_as_the_jax_one(template, request_, tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(template))
    jt, tt = JTemplate.load(str(path)), RequestTemplate.load(str(path))
    assert (tt.model, tt.temperature, tt.max_completion_tokens) == (
        jt.model, jt.temperature, jt.max_completion_tokens)
    want = jt.apply(json.loads(json.dumps(request_)))
    body = json.loads(json.dumps(request_))
    assert tt.apply(body) is body and body == want


class _Recording:
    """An echo engine that keeps every request it is given."""

    def __init__(self, engine):
        self.engine = engine
        self.seen = []

    async def generate(self, request, context=None):
        self.seen.append(json.loads(json.dumps(request)))
        return await self.engine.generate(request, context)


BODIES = [
    ("/v1/completions", {"prompt": "a b c d e"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}]}),
    ("/v1/chat/completions", {"model": "echo", "max_tokens": 2,
                              "messages": [{"role": "user", "content": "hi"}]}),
]


async def _jax_seen(template) -> list:
    engine = _Recording(JEchoFull())
    svc = JHttpService(host="127.0.0.1", port=0, request_template=template)
    svc.manager.add_completion_model("echo", engine)
    svc.manager.add_chat_model("echo", engine)
    port = await svc.start()
    try:
        async with ClientSession() as sess:
            for route, body in BODIES:
                async with sess.post(f"http://127.0.0.1:{port}{route}", json=body) as r:
                    assert r.status == 200, await r.text()
                    assert (await r.json())["model"] == "echo"
    finally:
        await svc.stop()
    return engine.seen


async def _port_seen(template) -> list:
    engine = _Recording(EchoEngineFull())
    svc = HttpService(host="127.0.0.1", port=0, request_template=template)
    svc.manager.add_completion_model("echo", engine)
    svc.manager.add_chat_model("echo", engine)
    port = await svc.start()
    try:
        for route, body in BODIES:
            r = await client.request(f"http://127.0.0.1:{port}{route}", "POST", body)
            assert r.status == 200, r.body
            assert r.json()["model"] == "echo"
    finally:
        await svc.stop()
    return engine.seen


async def test_template_through_the_http_service_as_the_jax_one():
    """A body with no model is routed by the template's; the engine gets
    the same request from both services (the template's fields filled,
    the client's kept)."""
    want = await _jax_seen(JTemplate(model="echo", max_completion_tokens=3))
    got = await _port_seen(RequestTemplate(model="echo", max_completion_tokens=3))
    assert got == want
    assert [r.get("max_completion_tokens") for r in got] == [3, 3, None]


async def test_run_request_template_flag_fills_a_minimal_body(tmp_path):
    """``run.py in=http out=echo_full --request-template``: a body with
    no ``model`` is served under the template's model."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"model": "default", "max_completion_tokens": 4}))
    opts = run.parse_args(["in=http", "out=echo_full", "--http-host", "127.0.0.1",
                           "--http-port", "0", "--request-template", str(path)])
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(run.main_async(opts, ready))
    try:
        served = await asyncio.wait_for(ready, 60)
        assert served.service.request_template == RequestTemplate("default", None, 4)
        r = await client.request(f"http://127.0.0.1:{served.port}/v1/chat/completions", "POST",
                                 {"messages": [{"role": "user", "content": "hello there"}]})
        assert r.status == 200, r.body
        assert r.json()["model"] == "default"
        assert r.json()["choices"][0]["message"]["content"] == "hello there"
    finally:
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
