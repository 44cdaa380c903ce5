"""The port's HTTP service against the JAX service, on the CPU, the same
tiny float32 model behind both (``TPUEngine`` on JAX's CPU, weights
carried to ``TorchEngine(device="cpu")`` by ``models/convert.py``).

- Overload: with the same admission bounds and the same requests held
  in flight, the same probes get the same answers (admitted, 429
  ``request_shed`` or 503 ``service_overloaded``, ``Retry-After`` and
  body), and every admitted request then completes with the same text.
- Deadlines: a request whose deadline passes before the engine can
  admit it gets what the JAX service answers (200, ``finish_reason``
  ``error``, no content; as an SSE stream, the same frames), and a
  request with a generous ``timeout_s`` the same answer as without one.
- ``/metrics``: the port renders the JAX service's families, all of
  them and no other; over the same traffic the edge's
  counters move alike (requests by status, sheds, deadlines, goodput,
  TTFT samples) and the admission gauge returns to 0.
- The SLO clock: engine outputs of several tokens each count every
  token, as in the JAX service, so the same paced streams give the same
  ``tokens``, the same ``itl_s`` within the pacing's slack, and the same
  goodput and ITL violations against a target some requests meet.
- The flight recorder: one float32 burst gives the same event kinds and
  payloads in both engines, request ids mapped by first appearance;
  the fields of unported features are named in ``UNPORTED_FIELDS`` (none
  occur in this burst).
"""

import asyncio
import itertools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.http import AdmissionController as JAdmission
from dynamo_exp_tpu.http import HttpService as JHttpService
from dynamo_exp_tpu.http.service import build_pipeline_engine as jbuild_pipeline
from dynamo_exp_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu.runtime.engine import ResponseStream as JResponseStream
from dynamo_exp_tpu.telemetry import SloAttribution as JSlo
from dynamo_exp_tpu.telemetry import SloConfig as JSloConfig
from dynamo_exp_tpu.telemetry import get_telemetry as jget_telemetry
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.http import AdmissionController, HttpService, build_pipeline_engine
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.models import ModelConfig, params_from_jax
from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext, ResponseStream
from dynamo_exp_tpu_torch.telemetry import SloAttribution, SloConfig, get_telemetry

ENGINE_KW = dict(max_decode_slots=2, page_size=8, num_pages=64, max_model_len=128,
                 prefill_chunk=16, decode_window=4, kv_dtype="float32")
# Flight-event fields of features the port does not have: leases and
# the G3 store (``lease_*``, ``persist``), copy-on-write (``cow``), the
# ledger auditor (``ledger_violation``), remote KV (``remote``).
UNPORTED_FIELDS = {"lease_grant", "lease_confirm", "lease_reap", "cow", "ledger_violation",
                   "persist", "remote"}
EDGE_FAMILIES = ("llm_http_service_requests_total", "dynamo_requests_shed_total",
                 "dynamo_deadline_exceeded_total", "dynamo_goodput_requests_total",
                 "dynamo_slo_violations_total",
                 "llm_http_service_time_to_first_token_seconds_count",
                 "dynamo_admission_inflight")


def _run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    """(JAX pipeline factory, port pipeline factory): each call builds a
    fresh engine pair on the same weights."""
    jcfg = replace(JModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    tcfg = replace(ModelConfig.from_pretrained(tiny_model_dir), dtype="float32")
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), jcfg))
    jcard = JCard.from_local_path(tiny_model_dir, display_name="m")
    tcard = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="m")

    def make():
        jeng = TPUEngine(
            JEngineConfig(model=jcfg, attention_impl="xla",
                          eos_token_ids=list(jcard.eos_token_ids), **ENGINE_KW),
            params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh())
        teng = TorchEngine(
            EngineConfig(model=tcfg, eos_token_ids=list(tcard.eos_token_ids), **ENGINE_KW),
            model=params_from_jax(np_params, tcfg, device="cpu"), device="cpu")
        return ((jeng, jbuild_pipeline(jcard, jeng)), (teng, build_pipeline_engine(tcard, teng)))

    return make


class Gated:
    """An engine whose requests wait at a gate before reaching ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.gate = asyncio.Event()
        self.held = 0

    async def generate(self, request, context=None):
        self.held += 1
        await self.gate.wait()
        return await self.inner.generate(request, context)


async def _serve(svc, engine) -> str:
    svc.manager.add_chat_model("m", engine)
    svc.manager.add_completion_model("m", engine)
    return f"http://127.0.0.1:{await svc.start()}"


def edge_counts(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name in EDGE_FAMILIES:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _scrape_delta(before: dict, text: str) -> dict:
    after = edge_counts(text)
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0) and k[0] != "dynamo_admission_inflight"}


def _norm(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


async def _frames(url, payload) -> list:
    out = []
    async for f in client.sse_frames(url, payload):
        out.append(f.data if f.data == "[DONE]" else _norm(f.data))
    return out


async def _traffic(base, gated):
    """The overload probes, then the deadline requests, against one
    service; returns every answer and the /metrics text."""
    url = base + "/v1/completions"

    def body(prompt, n=6, **kw):
        return {"model": "m", "prompt": prompt, "max_tokens": n, "ignore_eos": True, **kw}

    held = [asyncio.ensure_future(client.request(url, "POST", body(f"request {i}")))
            for i in range(3)]
    while gated.held < 3:
        await asyncio.sleep(0.005)
    probes = []
    for prio in ("low", "normal", "high", "high", "low"):
        task = asyncio.ensure_future(client.request(
            url, "POST", body("probe"), {"X-Request-Priority": prio}))
        n = gated.held
        while not task.done() and gated.held == n:
            await asyncio.sleep(0.005)
        if task.done():
            r = task.result()
            probes.append((prio, r.status, r.headers.get("retry-after"), r.json()))
        else:
            probes.append((prio, "admitted"))
            held.append(task)
    gated.gate.set()
    answers = [await t for t in held]
    admitted = [(r.status, _norm(r.json())) for r in answers]
    # Deadlines: one expired before admission, unary and streaming; one
    # generous, against the same request without a timeout.
    expired = await client.request(url, "POST", body("late", timeout_s=1e-4))
    expired_frames = await _frames(url, body("late", timeout_s=1e-4, stream=True))
    generous = await client.request(url, "POST", body("in time", n=8),
                                    {"X-Request-Timeout-S": "600"})
    plain = await client.request(url, "POST", body("in time", n=8))
    metrics = (await client.request(base + "/metrics")).body.decode()
    return dict(
        probes=probes, admitted=admitted,
        expired=(expired.status, _norm(expired.json())), expired_frames=expired_frames,
        generous=(generous.status, _norm(generous.json())),
        plain=(plain.status, _norm(plain.json())), metrics=metrics,
    )


def test_overload_deadlines_and_metrics_match_the_jax_service(engines):
    (jeng, jpipe), (teng, tpipe) = engines()
    jgated, tgated = Gated(jpipe), Gated(tpipe)

    async def go():
        # SLO targets no request meets: every completed request is a
        # violation on both axes (the same counts whatever the timing).
        jsvc = JHttpService(host="127.0.0.1", port=0,
                            admission=JAdmission(max_inflight=4, shed_watermark=2),
                            slo=JSlo(JSloConfig(ttft_s=1e-9, itl_s=1e-9), jget_telemetry()))
        tsvc = HttpService(host="127.0.0.1", port=0,
                           admission=AdmissionController(max_inflight=4, shed_watermark=2),
                           slo=SloAttribution(SloConfig(ttft_s=1e-9, itl_s=1e-9),
                                              get_telemetry()))
        jbase, tbase = await _serve(jsvc, jgated), await _serve(tsvc, tgated)
        try:
            jbefore = edge_counts((await client.request(jbase + "/metrics")).body.decode())
            want = await _traffic(jbase, jgated)
            tbefore = edge_counts((await client.request(tbase + "/metrics")).body.decode())
            got = await _traffic(tbase, tgated)
            return want, got, jbefore, tbefore
        finally:
            await tsvc.stop()
            await jsvc.stop()

    try:
        want, got, jbefore, tbefore = _run(go())
    finally:
        jeng.stop()
        teng.stop()
    # Overload.
    assert got["probes"] == want["probes"]
    statuses = [p[1] for p in got["probes"]]
    assert statuses == [429, 429, "admitted", 503, 503]
    assert all(p[2] == "1" for p in got["probes"] if p[1] != "admitted")
    assert {p[3]["error"]["type"] for p in got["probes"] if p[1] != "admitted"} == {
        "request_shed", "service_overloaded"}
    assert got["admitted"] == want["admitted"] and len(got["admitted"]) == 4
    assert all(s == 200 for s, _ in got["admitted"])
    # Deadlines.
    assert got["expired"] == want["expired"]
    assert got["expired"][0] == 200
    assert got["expired"][1]["choices"][0]["finish_reason"] == "error"
    assert got["expired_frames"] == want["expired_frames"] and got["expired_frames"][-1] == "[DONE]"
    assert got["generous"] == want["generous"] == got["plain"] == want["plain"]
    # /metrics: the families, then the edge's counters over the traffic.
    jfams = {f.name for f in text_string_to_metric_families(want["metrics"])}
    tfams = {f.name for f in text_string_to_metric_families(got["metrics"])}
    jfams = {f for f in jfams if not f.endswith("_created")}
    assert tfams == jfams
    jd, td = _scrape_delta(jbefore, want["metrics"]), _scrape_delta(tbefore, got["metrics"])
    assert td == jd
    assert td[("dynamo_requests_shed_total", (("code", "429"), ("priority", "low")))] == 1
    assert td[("dynamo_deadline_exceeded_total", (("stage", "engine_admission"),))] == 2
    ok = (("endpoint", "completions"), ("model", "m"), ("request_type", "unary"),
          ("status", "success"))
    # 4 admitted, the expired one, the generous one and the plain one;
    # the expired stream is a ``stream`` success.
    assert td[("llm_http_service_requests_total", ok)] == 7
    assert td[("llm_http_service_requests_total", ok[:2] + (("request_type", "stream"),
                                                             ("status", "success")))] == 1
    for text in (want["metrics"], got["metrics"]):
        assert edge_counts(text)[("dynamo_admission_inflight", ())] == 0


class Paced:
    """A core engine that streams ``chunks`` outputs of ``per_chunk``
    prompt tokens each, ``gap_s`` apart: a decode window's shape."""

    def __init__(self, stream_cls, gap_s: float):
        self.stream_cls, self.gap_s = stream_cls, gap_s

    async def generate(self, request, context):
        ids, per_chunk = request["token_ids"], request["stop_conditions"]["max_tokens"] // 4

        async def gen():
            for i in range(4):
                if i:
                    await asyncio.sleep(self.gap_s)
                yield {"token_ids": ids[i * per_chunk:(i + 1) * per_chunk]}
            yield {"token_ids": [], "finish_reason": "length"}

        return self.stream_cls(gen(), context)


def test_slo_clock_counts_every_token_of_a_chunk_as_the_jax_service(tiny_model_dir):
    """Four chunks 60 ms apart: 8 tokens a chunk give an ITL near
    180/32 ms, 1 token a chunk near 180/4 ms. Against a 20 ms target the
    first meets and the second misses, on both services; counting one
    token a chunk would make the first miss too."""
    gap = 0.06
    jcard = JCard.from_local_path(tiny_model_dir, display_name="m")
    tcard = ModelDeploymentCard.from_local_path(tiny_model_dir, display_name="m")
    prompt = " ".join(["hello world"] * 40)

    async def go(svc, pipe):
        spans = []
        record = svc._record_slo

        def capture(priority, t_arrival, lat, root):
            record(priority, t_arrival, lat, root)
            spans.append(dict(root.attrs))

        svc._record_slo = capture
        base = await _serve(svc, pipe)
        url = base + "/v1/completions"
        try:
            before = edge_counts((await client.request(base + "/metrics")).body.decode())
            for n in (32, 4):
                r = await client.request(url, "POST", {"model": "m", "prompt": prompt,
                                                       "max_tokens": n, "ignore_eos": True})
                assert r.status == 200
            text = (await client.request(base + "/metrics")).body.decode()
        finally:
            await svc.stop()
        return spans, _scrape_delta(before, text)

    slo = dict(ttft_s=10.0, itl_s=0.02)
    want = _run(go(JHttpService(host="127.0.0.1", port=0,
                                slo=JSlo(JSloConfig(**slo), jget_telemetry())),
                   jbuild_pipeline(jcard, Paced(JResponseStream, gap))))
    got = _run(go(HttpService(host="127.0.0.1", port=0,
                              slo=SloAttribution(SloConfig(**slo), get_telemetry())),
                  build_pipeline_engine(tcard, Paced(ResponseStream, gap))))
    (jspans, jd), (tspans, td) = want, got
    assert [s["tokens"] for s in tspans] == [s["tokens"] for s in jspans]
    assert [s["tokens"] for s in tspans][0] >= 32
    for js, ts, n in zip(jspans, tspans, (32, 4)):
        # The pacing sets the ITL: 3 gaps over the tokens after the first,
        # within a factor 2 of slack for a loaded host's sleeps.
        floor = 3 * gap / (js["tokens"] - 1)
        for s in (js, ts):
            assert floor * 0.9 <= s["itl_s"] <= 2 * floor
    assert td == jd
    assert td[("dynamo_slo_violations_total", (("priority", "normal"), ("slo", "itl")))] == 1
    assert td[("dynamo_goodput_requests_total", (("priority", "normal"),))] == 1


def test_flight_events_of_a_burst_match_tpu_engine(engines):
    (jeng, _), (teng, _) = engines()
    prompts = ([5, 9, 17, 23, 4, 31, 8, 2] * 3, [7, 3, 19, 28, 41, 13], [12, 60, 3, 3, 90])

    async def burst(eng, ctx_t):
        eng._running = True
        jobs = []
        for i, p in enumerate(prompts):
            stream = await eng.generate({
                "token_ids": p, "stop_conditions": {"max_tokens": 10, "ignore_eos": True},
                "sampling_options": {"temperature": 0.7, "seed": 3} if i == 1 else {},
            }, ctx_t(f"r{i}"))
            jobs.append(stream)
        eng._running = False
        eng.start()

        async def collect(s):
            return [t async for item in s for t in item.get("token_ids", [])]

        return await asyncio.gather(*(collect(s) for s in jobs))

    from dynamo_exp_tpu.runtime.engine import AsyncEngineContext as JContext

    try:
        want = _run(burst(jeng, JContext))
        got = _run(burst(teng, AsyncEngineContext))
    finally:
        jeng.stop()
        teng.stop()
    assert got == want

    def events(eng):
        ids = {}
        out = []
        for e in eng.flight.snapshot():
            e = {k: v for k, v in e.items() if k not in ("t", "seq")}
            if "req" in e:
                e["req"] = ids.setdefault(e["req"], len(ids))
            out.append(e)
        return out

    jev, tev = events(jeng), events(teng)
    assert not {e["kind"] for e in jev} & UNPORTED_FIELDS
    assert not {k for e in jev for k in e} & UNPORTED_FIELDS
    for a, b in itertools.zip_longest(jev, tev):
        assert a == b
    assert {"admit", "dispatch", "consume", "first_token", "finish"} <= {e["kind"] for e in tev}
    json.dumps(tev)  # payloads stay JSON
