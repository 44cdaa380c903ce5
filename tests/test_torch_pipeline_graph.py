"""The port's pipeline node graph (``runtime/pipeline.py``) against the
JAX package's: ``tests/test_pipeline_graph.py``'s 11 cases, each run on
both packages (``P`` is the package under test) with the JAX suite's
expected outputs. Tolerances: none; outputs are compared exactly.
"""

import asyncio
import types

import pytest

import dynamo_exp_tpu.runtime as jrt
import dynamo_exp_tpu.runtime.engine as jengine
import dynamo_exp_tpu.runtime.pipeline as jpipe
import dynamo_exp_tpu_torch.runtime as trt
import dynamo_exp_tpu_torch.runtime.engine as tengine
import dynamo_exp_tpu_torch.runtime.pipeline as tpipe


def _ns(rt, engine, pipe):
    names = ("Context", "MapOperator", "Operator", "PipelineNode", "PipelineOperator",
             "SegmentSink", "SegmentSource", "ServiceBackend", "ServiceFrontend",
             "build_segment")
    return types.SimpleNamespace(
        DistributedRuntime=rt.DistributedRuntime, LambdaEngine=rt.LambdaEngine,
        Annotated=rt.Annotated, PushRouter=rt.PushRouter, RouterMode=rt.RouterMode,
        AsyncEngineContext=engine.AsyncEngineContext, ResponseStream=engine.ResponseStream,
        **{n: getattr(pipe, n) for n in names})


@pytest.fixture(params=["jax", "torch"])
def P(request):
    return {"jax": _ns(jrt, jengine, jpipe), "torch": _ns(trt, tengine, tpipe)}[request.param]


def counting_engine(P):
    """Engine yielding request['n'] integers 0..n-1."""

    async def gen(request, ctx):
        for i in range(request["n"]):
            yield {"i": i}

    return P.LambdaEngine(gen)


async def drain(stream):
    return [item async for item in stream]


# ------------------------------------------------------------- basic graph
async def test_frontend_backend_roundtrip(P):
    front = P.ServiceFrontend()
    front.link(P.ServiceBackend(counting_engine(P)))
    out = await drain(await front.generate({"n": 3}))
    assert out == [{"i": 0}, {"i": 1}, {"i": 2}]


async def test_edge_nodes_forward_and_backward(P):
    front = P.ServiceFrontend()
    front.link(
        P.PipelineNode(forward=lambda r: {"n": r["n"] + 1})
    ).link(
        P.PipelineNode(backward=lambda item: {"i": item["i"] * 10})
    ).link(P.ServiceBackend(counting_engine(P)))
    out = await drain(await front.generate({"n": 1}))
    assert out == [{"i": 0}, {"i": 10}]


async def test_pipeline_operator_sees_both_paths(P):
    """A bidirectional operator carries request info onto the response
    path — the capability edge nodes lack by design (nodes.rs doc)."""

    class Tagger(P.Operator):
        async def generate(self, request, next_engine, context):
            tag = request.pop("tag")
            stream = await next_engine.generate(request, context)

            async def wrapped():
                async for item in stream:
                    yield {**item, "tag": tag}

            return P.ResponseStream(wrapped(), context)

    front = P.build_segment([Tagger()], sink=counting_engine(P))
    out = await drain(await front.generate({"n": 2, "tag": "x"}))
    assert out == [{"i": 0, "tag": "x"}, {"i": 1, "tag": "x"}]


async def test_context_propagates_id_values_stages(P):
    seen = {}

    class Probe(P.Operator):
        async def generate(self, request, next_engine, context):
            seen["id"] = context.id
            return await next_engine.generate(request, context)

    front = P.build_segment([Probe()], sink=counting_engine(P))
    ctx = P.AsyncEngineContext("req-42")
    wrapped = P.Context({"n": 1}, controller=ctx)
    wrapped.insert("user", "alice")
    stream = await front.generate(wrapped)
    await drain(stream)
    assert seen["id"] == "req-42"
    assert wrapped.get("user") == "alice"
    assert wrapped.stages[0] == "ServiceFrontend"
    assert "Probe" in wrapped.stages


async def test_backend_error_propagates_to_caller(P):
    async def boom(request, ctx):
        raise RuntimeError("engine exploded")
        yield  # pragma: no cover

    class Boom:
        async def generate(self, request, context=None):
            raise RuntimeError("engine exploded")

    front = P.ServiceFrontend()
    front.link(P.ServiceBackend(Boom()))
    with pytest.raises(RuntimeError, match="engine exploded"):
        await front.generate({"n": 1})


async def test_unattached_segment_sink_fails_fast(P):
    front = P.ServiceFrontend()
    front.link(P.SegmentSink())
    with pytest.raises(RuntimeError, match="no transport"):
        await front.generate({"n": 1})


async def test_kill_stops_stream_mid_graph(P):
    front = P.ServiceFrontend()
    front.link(P.ServiceBackend(counting_engine(P)))
    ctx = P.AsyncEngineContext()
    stream = await front.generate({"n": 100}, ctx)
    got = []
    async for item in stream:
        got.append(item)
        if len(got) == 2:
            ctx.kill()
    assert len(got) == 2


# ------------------------------------------------- segment across transport
async def test_segment_cut_across_real_endpoint(P):
    """ingress segment → SegmentSink → (request plane) → SegmentSource →
    worker segment, over the in-process transport — the reference's
    frontend-node/worker-node split (SURVEY.md §3 ingress/worker call
    stacks)."""
    drt = P.DistributedRuntime.detached()

    # Worker side: SegmentSource feeding a local graph ending in the
    # engine; served as a normal endpoint handler (which speaks
    # Annotated frames on the wire).
    async def annotated_counting(request, ctx):
        for i in range(request["n"]):
            yield P.Annotated.from_data({"i": i}).to_dict()

    worker_seg = P.SegmentSource()
    worker_seg.link(
        P.PipelineNode(forward=lambda r: {"n": r["n"] * 2})
    ).link(P.ServiceBackend(P.LambdaEngine(annotated_counting)))
    ep = drt.namespace("seg").component("worker").endpoint("generate")
    await ep.serve_endpoint(worker_seg.endpoint_handler())

    # Ingress side: frontend → backward-unwrap node → SegmentSink
    # attached to a PushRouter over the endpoint's live instances.
    client = await ep.client()
    sink = P.SegmentSink()
    front = P.ServiceFrontend()
    front.link(
        P.PipelineNode(backward=lambda fr: {"got": fr["i"]})
    ).link(sink)
    sink.attach(P.PushRouter(client, P.RouterMode.RANDOM))

    out = await drain(await front.generate({"n": 2}))
    assert out == [{"got": 0}, {"got": 1}, {"got": 2}, {"got": 3}]
    await drt.close()


# -------------------------------------------------------------- build sugar
async def test_build_segment_mixes_operators_and_nodes(P):
    front = P.build_segment(
        [
            P.MapOperator(map_request=lambda r: {"n": r["n"] + 1}),
            P.PipelineNode(backward=lambda item: item["i"]),
        ],
        sink=counting_engine(P),
    )
    assert await drain(await front.generate({"n": 0})) == [0]


async def test_build_segment_rejects_double_link(P):
    front = P.ServiceFrontend()
    front.link(P.ServiceBackend(counting_engine(P)))
    with pytest.raises(RuntimeError, match="already linked"):
        front.link(P.ServiceBackend(counting_engine(P)))


async def test_forward_map_exception_fails_request_not_hangs(P):
    """A sync exception in a PipelineNode forward map under a
    PipelineOperator must error the caller's request — not leak the
    operator's slot and hang generate() forever."""

    class PassThrough(P.Operator):
        async def generate(self, request, next_engine, context):
            return await next_engine.generate(request, context)

    def bad_map(r):
        raise KeyError("malformed request")

    front = P.ServiceFrontend()
    op = P.PipelineOperator(PassThrough())
    front.link(op)
    op.link(P.PipelineNode(forward=bad_map)).link(
        P.ServiceBackend(counting_engine(P))
    )
    with pytest.raises(KeyError, match="malformed request"):
        await asyncio.wait_for(front.generate({"n": 1}), timeout=2)
