"""The port's standalone components (``dynamo_exp_tpu_torch/components/``)
against the JAX package's, on the CPU.

- ``RouterService``: each package's service, on its own in-process
  runtime, watches two workers that announce the same KV events and
  report the same loads (the stats of ``tests/test_llmctl_router.py``);
  both answer every query with the same worker and ``overlap_blocks``.
- ``MockWorker``: with the same seed the port's drifting
  ``ForwardPassMetrics`` series equals the JAX mock worker's.
- ``MetricsService``: for the same workers and ``kv-hit-rate`` events,
  the ``llm_kv_*`` samples of the port's exporter equal the JAX
  exporter's (``prometheus_client``'s parser, as sample sets, the
  worker ids mapped to the workers they name); they are also served
  over HTTP; a departed worker's series go; a lost event stream is
  subscribed again.
"""

import asyncio
import contextlib
import random

import pytest
from prometheus_client.parser import text_string_to_metric_families

import dynamo_exp_tpu.components.metrics as jmetrics
import dynamo_exp_tpu.components.mock_worker as jmock
import dynamo_exp_tpu.components.router as jrouter
import dynamo_exp_tpu.kv_router.protocols as jproto
import dynamo_exp_tpu.runtime.component as jcomp
import dynamo_exp_tpu.runtime.transports.inproc as jinproc
from dynamo_exp_tpu import tokens as jtokens
from dynamo_exp_tpu_torch.components import metrics as tmetrics
from dynamo_exp_tpu_torch.components import mock_worker as tmock
from dynamo_exp_tpu_torch.components import router as trouter
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.kv_router import protocols as tproto
from dynamo_exp_tpu_torch.runtime import component as tcomp
from dynamo_exp_tpu_torch.runtime.transports import inproc as tinproc

BLOCK = 4
PROMPT = list(range(24))  # 6 blocks


def _stats(active_blocks: int, total_blocks: int = 64) -> dict:
    return {"request_active_slots": 1, "request_total_slots": 8,
            "kv_active_blocks": active_blocks, "kv_total_blocks": total_blocks,
            "num_requests_waiting": 0,
            "gpu_cache_usage_perc": active_blocks / total_blocks,
            "gpu_prefix_cache_hit_rate": 0.0}


PKGS = {
    "jax": (jcomp, jinproc, jproto, jrouter, jmetrics),
    "torch": (tcomp, tinproc, tproto, trouter, tmetrics),
}


def make_drt(pkg: str):
    comp, inproc = PKGS[pkg][:2]
    return comp.DistributedRuntime(discovery=inproc.InProcDiscovery(),
                                   request_plane=inproc.InProcRequestPlane())


async def _serve_workers(drt, stats: list[dict]):
    async def noop(request, context=None):
        yield {"data": {}}

    ep = drt.namespace("ns").component("Workers").endpoint("generate")
    return [await ep.serve_endpoint(noop, stats_handler=lambda s=s: s) for s in stats]


async def _route(pkg: str, stored: list[int], loads: list[int], queries):
    """Each query's (worker index, overlap_blocks) from ``pkg``'s router
    service over two workers, worker i holding the first ``stored[i]``
    blocks of ``PROMPT``."""
    _, _, proto, router, _ = PKGS[pkg]
    drt = make_drt(pkg)
    served = await _serve_workers(drt, [_stats(n) for n in loads])
    ids = [s.instance_id for s in served]
    svc = router.RouterService(drt, "ns", "Workers", block_size=BLOCK)
    svc.router.selector.rng = random.Random(0)  # the same tie-breaks in both
    try:
        await svc.start()
        hashes = jtokens.compute_block_hashes_for_seq(PROMPT, BLOCK)
        for wid, n in zip(ids, stored):
            if n:
                await drt.event_plane.publish(
                    proto.kv_events_subject(drt.namespace("ns").component("Workers").path),
                    proto.RouterEvent(worker_id=wid, data=proto.KvCacheEventData(
                        kind="stored", block_hashes=hashes[:n], parent_hash=None)).to_dict())
        await asyncio.sleep(0.3)  # the indexer consumes, the metrics are scraped
        ep = drt.namespace("ns").component("kv_aware_router").endpoint("generate")
        cl = await ep.client()
        await cl.wait_for_instances(1, timeout=10)
        out = []
        for q in queries:
            stream = await cl.generate_to(cl.instances[0], {"token_ids": q})
            reply = [a.data async for a in stream if a.data is not None][0]
            out.append((ids.index(reply["worker_id"]), reply["overlap_blocks"]))
        return out
    finally:
        await svc.stop()
        for s in served:
            await s.close()
        await drt.close()


@pytest.mark.parametrize(
    "stored,loads",
    [([2, 0], [4, 4]), ([1, 5], [4, 4]), ([6, 6], [4, 40]), ([0, 0], [40, 4])],
    ids=["one-holder", "longer-wins", "load-breaks-tie", "no-overlap"],
)
async def test_router_service_answers_equal_jax(stored, loads):
    """The same events and loads give the same worker and overlap from
    both services, for the prompt, a prefix of it and an unrelated
    prompt (overlap 0)."""
    queries = [PROMPT, PROMPT[:10], [1000 + i for i in range(12)]]
    want = await _route("jax", stored, loads, queries)
    got = await _route("torch", stored, loads, queries)
    assert got == want
    assert [o for _, o in got] == [max(stored), min(max(stored), 2), 0]


@pytest.mark.parametrize("seed", [0, 7])
async def test_mock_worker_series_equal_jax(seed, monkeypatch):
    """A seeded mock worker's drifting stats: the JAX series, step by step."""

    class Done(Exception):
        pass

    def recorder(worker, series: list, steps: int):
        async def sleep(_s):
            series.append(dict(worker.metrics.to_dict()))
            if len(series) == steps:
                raise Done

        return type("FakeAsyncio", (), {"sleep": staticmethod(sleep)})

    out = {}
    for name, mod in (("jax", jmock), ("torch", tmock)):
        worker = mod.MockWorker(component=None, seed=seed)
        series: list = []
        monkeypatch.setattr(mod, "asyncio", recorder(worker, series, 25))
        with pytest.raises(Done):
            await worker._drift()
        out[name] = series
    assert out["torch"] == out["jax"]
    assert len({s["kv_active_blocks"] for s in out["torch"]}) > 1


def _kv_samples(text: str, wid_names: dict[str, str]) -> set:
    """The ``llm_kv_*`` samples as (name, labels, value), the worker ids
    renamed; prometheus_client's ``_created`` samples left out."""
    out = set()
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.startswith("llm_kv_") and not s.name.endswith("_created"):
                labels = {k: wid_names.get(v, v) if k == "worker_id" else v
                          for k, v in s.labels.items()}
                out.add((s.name, tuple(sorted(labels.items())), float(s.value)))
    return out


async def _export(pkg: str, loads: list[int], events: list[dict]):
    _, _, proto, _, metrics = PKGS[pkg]
    drt = make_drt(pkg)
    served = await _serve_workers(drt, [_stats(n, 64 * (i + 1)) for i, n in enumerate(loads)])
    svc = metrics.MetricsService(drt.namespace("ns").component("Workers"), host="127.0.0.1",
                                 port=0, scrape_interval_s=0.05)
    try:
        port = await svc.start()
        for ev in events:
            await drt.event_plane.publish(proto.KV_HIT_RATE_SUBJECT, ev)
        await asyncio.sleep(0.3)
        names = {str(s.instance_id): f"w{i}" for i, s in enumerate(served)}
        text = svc.render().decode()
        http = None
        if pkg == "torch":
            r = await client.request(f"http://127.0.0.1:{port}/metrics")
            assert r.status == 200 and r.headers["content-type"].startswith("text/plain")
            http = r.body.decode()
        return _kv_samples(text, names), http and _kv_samples(http, names)
    finally:
        await svc.stop()
        for s in served:
            await s.close()
        await drt.close()


async def test_exporter_samples_equal_jax():
    events = [{"worker_id": 1, "isl_blocks": 10, "overlap_blocks": 4},
              {"worker_id": 2, "isl_blocks": 7, "overlap_blocks": 0},
              {"worker_id": 1, "isl_blocks": 3, "overlap_blocks": 3}]
    want, _ = await _export("jax", [4, 17], events)
    got, over_http = await _export("torch", [4, 17], events)
    assert got == want
    assert over_http == got
    assert ("llm_kv_hit_events_total", (), 3.0) in got
    assert ("llm_kv_kv_total_blocks", (("worker_id", "w1"),), 128.0) in got
    assert len(got) == 7 * 2 + 3


async def test_exporter_scrapes_the_mock_worker_and_drops_it_when_it_leaves():
    drt = make_drt("torch")
    comp = drt.namespace("m").component("worker")
    worker = tmock.MockWorker(comp)
    await worker.start()
    svc = tmetrics.MetricsService(comp, host="127.0.0.1", port=0, scrape_interval_s=0.05)
    try:
        await svc.start()
        await asyncio.sleep(0.3)
        text = svc.render().decode()
        assert 'llm_kv_request_total_slots{worker_id="' in text
        assert "dynamo_" in text  # the process registry rides along
        await worker.stop()  # the instance deregisters
        await asyncio.sleep(0.3)
        assert 'llm_kv_request_total_slots{worker_id="' not in svc.render().decode()
    finally:
        await svc.stop()
        await drt.close()


async def test_exporter_subscribes_again_when_the_event_stream_is_lost():
    drt = make_drt("torch")
    plane = drt.event_plane
    subscribe = plane.subscribe
    calls = []

    async def flaky_subscribe(subject):
        stream = await subscribe(subject)
        calls.append(subject)
        if len(calls) > 1:
            return stream

        async def dies():
            async for ev in stream:
                yield ev
                raise ConnectionError("event stream lost")

        return dies()

    plane.subscribe = flaky_subscribe
    svc = tmetrics.MetricsService(drt.namespace("m").component("w"), host="127.0.0.1",
                                  port=0, scrape_interval_s=0.05)
    try:
        await svc.start()
        ev = {"worker_id": 1, "isl_blocks": 2, "overlap_blocks": 1}
        await plane.publish(tproto.KV_HIT_RATE_SUBJECT, ev)
        for _ in range(100):  # the retry waits 1 s
            await asyncio.sleep(0.05)
            if len(calls) == 2:
                break
        assert len(calls) == 2
        await plane.publish(tproto.KV_HIT_RATE_SUBJECT, ev)
        await asyncio.sleep(0.1)
        assert "llm_kv_hit_events_total 2.0" in svc.render().decode()
    finally:
        with contextlib.suppress(Exception):
            await svc.stop()
        await drt.close()
