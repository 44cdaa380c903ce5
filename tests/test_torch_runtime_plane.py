"""The port's runtime plane (``dynamo_exp_tpu_torch/runtime/``) against
the JAX package's, on the CPU.

Each test runs one script twice, once on each package's classes
(``DistributedRuntime`` in static mode, ``serve_endpoint``, ``Client``,
``PushRouter``, ``HealthTracker``), and asserts that both observe the
same: the instance each request lands on (instances by registration
order), the frames, the errors and the deltas of the fault-tolerance
counters on each package's own telemetry hub. Covered: routing in each
mode (random under a seeded ``random.Random``, round-robin, direct),
stop and kill, lease revoke, drain, circuit-breaker transitions,
retries, the deadline at stage ``router``, and mid-stream recovery
through the replay journal.
"""

import asyncio
import random
from types import SimpleNamespace

from prometheus_client.parser import text_string_to_metric_families

import dynamo_exp_tpu.runtime as jrt
import dynamo_exp_tpu.telemetry as jtel
import dynamo_exp_tpu_torch.runtime as trt
import dynamo_exp_tpu_torch.telemetry as ttel

PKGS = {
    "jax": SimpleNamespace(rt=jrt, tel=jtel),
    "torch": SimpleNamespace(rt=trt, tel=ttel),
}


def counters(P) -> dict:
    """Every fault-tolerance sample of the package's telemetry hub."""
    names = ("dynamo_request_retries", "dynamo_circuit_breaker_transitions",
             "dynamo_drain_events", "dynamo_request_recoveries",
             "dynamo_tokens_deduplicated", "dynamo_deadline_exceeded")
    out = {}
    for fam in text_string_to_metric_families(P.tel.get_telemetry().render().decode()):
        if fam.name in names:
            for s in fam.samples:
                if not s.name.endswith("_created"):
                    out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def tag_engine(P, tag: int, n: int = 3, delay: float = 0.0):
    async def fn(req, ctx):
        for i in range(req.get("n", n)):
            if ctx.is_stopped:
                yield {"tag": tag, "stopped_at": i}
                return
            yield {"tag": tag, "i": i}
            if delay:
                await asyncio.sleep(delay)

    return P.rt.LambdaEngine(fn)


def handler_of(P, engine):
    async def handler(req, ctx):
        async for frame in P.rt.annotated_stream(engine, req, ctx):
            yield frame

    return handler


async def serve(P, ep, tag, **kw):
    return await ep.serve_endpoint(handler_of(P, tag_engine(P, tag, **kw)))


async def collect(stream) -> list:
    return [x async for x in stream]


async def run_both(script) -> dict:
    """``script(P)`` on each package; returns {pkg: observations}."""
    out = {}
    for name, P in PKGS.items():
        before = counters(P)
        obs = await asyncio.wait_for(script(P), 60)
        obs["counters"] = delta(counters(P), before)
        out[name] = obs
    assert out["torch"] == out["jax"]
    return out["torch"]


# ------------------------------------------------------------------ modes
async def test_routing_modes_match_jax():
    async def script(P):
        drt = P.rt.DistributedRuntime.detached()
        ep = drt.namespace("ns").component("w").endpoint("gen")
        insts = [await serve(P, ep, tag) for tag in range(3)]
        client = await ep.client()
        await client.wait_for_instances(3, 5)
        obs = {}
        for mode in ("RANDOM", "ROUND_ROBIN"):
            router = P.rt.PushRouter(client, P.rt.RouterMode[mode], rng=random.Random(5))
            obs[mode] = [[f["tag"] for f in await collect(await router.generate({"n": 2}))]
                         for _ in range(9)]
        direct = P.rt.PushRouter(client, P.rt.RouterMode.DIRECT)
        obs["DIRECT"] = [f["tag"] for f in await collect(
            await direct.generate_direct({"n": 2}, insts[1].instance_id))]
        try:
            await direct.generate({"n": 1})
        except ValueError as e:
            obs["direct_without_target"] = str(e)
        try:
            await direct.generate_direct({"n": 1}, 999_999_999)
        except P.rt.NoInstancesError as e:
            obs["stale_target"] = type(e).__name__
        client.close()
        for inst in insts:
            await inst.close()
        await drt.close()
        return obs

    obs = await run_both(script)
    assert obs["ROUND_ROBIN"] == [[i % 3] * 2 for i in range(9)]
    assert sorted({t[0] for t in obs["RANDOM"]}) == [0, 1, 2]
    assert obs["DIRECT"] == [1, 1] and obs["stale_target"] == "NoInstancesError"


# ----------------------------------------------------------- stop and kill
async def test_stop_and_kill_match_jax():
    async def script(P):
        drt = P.rt.DistributedRuntime.detached()
        ep = drt.namespace("ns").component("w").endpoint("gen")
        inst = await serve(P, ep, 0, delay=0.01)
        client = await ep.client()
        router = P.rt.PushRouter(client, P.rt.RouterMode.ROUND_ROBIN)
        obs = {}
        ctx = P.rt.AsyncEngineContext()
        stream = await router.generate({"n": 1000}, ctx)
        frames = []
        async for f in stream:
            frames.append(f)
            if len(frames) == 3:
                ctx.stop_generating()
        obs["stop"] = frames[-1]
        ctx = P.rt.AsyncEngineContext()
        stream = await router.generate({"n": 1000}, ctx)
        frames = []
        async for f in stream:
            frames.append(f)
            if len(frames) == 2:
                ctx.kill()
        obs["kill"] = len(frames)
        await asyncio.sleep(0.05)
        obs["inflight"] = (await drt.request_plane.scrape_stats(client.instances[0]))["inflight"]
        client.close()
        await inst.close()
        await drt.close()
        return obs

    obs = await run_both(script)
    assert obs["stop"] == {"tag": 0, "stopped_at": 3} and obs["kill"] == 2
    assert obs["inflight"] == 0


# ------------------------------------------------------ revoke and drain
async def test_lease_revoke_and_drain_match_jax():
    async def script(P):
        drt = P.rt.DistributedRuntime.detached()
        ep = drt.namespace("ns").component("w").endpoint("gen")
        leases = [await drt.discovery.create_lease() for _ in range(3)]
        insts = [await ep.serve_endpoint(handler_of(P, tag_engine(P, t, delay=0.01)),
                                         lease=lease) for t, lease in enumerate(leases)]
        client = await ep.client()
        await client.wait_for_instances(3, 5)
        router = P.rt.PushRouter(client, P.rt.RouterMode.ROUND_ROBIN)
        obs = {}

        async def tags(k):
            return [(await collect(await router.generate({"n": 1})))[0]["tag"] for _ in range(k)]

        await leases[0].revoke()
        for _ in range(100):
            if len(client.instances) == 2:
                break
            await asyncio.sleep(0.01)
        obs["after_revoke"] = sorted(set(await tags(4)))
        # Drain instance 1 while a request streams from it: the stream
        # finishes, new work goes to instance 2 only.
        ctx = P.rt.AsyncEngineContext()
        live = await router.generate_direct({"n": 5}, insts[1].instance_id, ctx)
        await insts[1].drain()
        for _ in range(100):
            if any(i.metadata.get("draining") for i in client.instances):
                break
            await asyncio.sleep(0.01)
        obs["during_drain"] = sorted(set(await tags(4)))
        obs["drained_stream"] = [f["i"] for f in await collect(live)]
        await insts[1].close()
        for _ in range(100):
            if len(client.instances) == 1:
                break
            await asyncio.sleep(0.01)
        obs["after_close"] = [P.rt.is_draining(i) for i in client.instances]
        client.close()
        await insts[2].close()
        await drt.close()
        return obs

    obs = await run_both(script)
    assert obs["after_revoke"] == [1, 2] and obs["during_drain"] == [2]
    assert obs["drained_stream"] == [0, 1, 2, 3, 4]
    assert obs["counters"] == {
        ("dynamo_drain_events_total", (("event", "started"),)): 1.0,
        ("dynamo_drain_events_total", (("event", "completed"),)): 1.0,
    }


# ------------------------------------------------------------------ breaker
async def test_breaker_transitions_match_jax():
    async def script(P):
        now = [0.0]
        health = P.rt.HealthTracker(failure_threshold=2, cooldown_s=5.0, clock=lambda: now[0])
        b = health.breaker(7)
        steps = []
        for op, dt in [("failure", 0), ("allow", 0), ("failure", 0), ("allow", 1),
                       ("allow", 5), ("allow", 0), ("failure", 0), ("allow", 6),
                       ("release", 0), ("allow", 0), ("success", 0), ("allow", 0)]:
            now[0] += dt
            r = getattr(health, {"failure": "record_failure", "success": "record_success",
                                 "release": "release", "allow": "acquire"}[op])(7)
            steps.append((op, r, b.state.value))
        return {"steps": steps}

    obs = await run_both(script)
    assert [s[2] for s in obs["steps"]][-1] == "closed"
    assert obs["counters"] == {
        ("dynamo_circuit_breaker_transitions_total", (("state", "open"),)): 2.0,
        ("dynamo_circuit_breaker_transitions_total", (("state", "half_open"),)): 2.0,
        ("dynamo_circuit_breaker_transitions_total", (("state", "closed"),)): 1.0,
    }


# ---------------------------------------------------- retries and deadline
async def test_retries_and_router_deadline_match_jax():
    async def script(P):
        drt = P.rt.DistributedRuntime.detached()
        ep = drt.namespace("ns").component("w").endpoint("gen")
        good = await serve(P, ep, 1)
        # Registered in discovery, served by no request plane: every
        # dispatch to it is refused at connect.
        ghost = P.rt.InstanceInfo(address=ep.address, instance_id=good.instance_id - 1)
        client = P.rt.Client.new_static(drt.request_plane, [ghost, good.info])
        obs = {}
        router = P.rt.PushRouter(client, P.rt.RouterMode.ROUND_ROBIN, rng=random.Random(0),
                                 backoff_base_s=0.001)
        obs["retried"] = [f["tag"] for f in await collect(await router.generate({"n": 2}))]
        strict = P.rt.PushRouter(client, P.rt.RouterMode.STATIC, retries=0)
        try:
            await strict.generate({"n": 1})
        except ConnectionError as e:
            obs["no_retry"] = type(e).__name__
        late = P.rt.AsyncEngineContext()
        late.start_timeout(-1.0)
        try:
            await router.generate({"n": 1}, late)
        except P.rt.DeadlineExceededError as e:
            obs["deadline"] = str(e).split(" deadline")[1]
        await good.close()
        await drt.close()
        return obs

    obs = await run_both(script)
    assert obs["retried"] == [1, 1] and obs["deadline"] == " exceeded at stage 'router'"
    assert obs["counters"] == {
        ("dynamo_request_retries_total", (("reason", "connect"),)): 1.0,
        ("dynamo_deadline_exceeded_total", (("stage", "router"),)): 1.0,
    }


# ----------------------------------------------------- mid-stream recovery
def next_token(ctx_tokens: list[int]) -> int:
    return (sum(ctx_tokens) * 31 + len(ctx_tokens)) % 1000


def token_handler(P, crash_after: int | None):
    """An engine-level worker's handler: greedy tokens as a pure
    function of the context (prompt + what it generated); the worker
    dies after ``crash_after`` frames (its stream drops, as a crashed
    worker's connection does)."""

    async def fn(req, ctx):
        toks = list(req["token_ids"])
        budget = req["stop_conditions"]["max_tokens"]
        for i in range(budget):
            t = next_token(toks)
            toks.append(t)
            done = i == budget - 1
            yield {"token_ids": [t], **({"finish_reason": "length", "prompt_tokens": len(
                req["token_ids"]), "completion_tokens": i + 1} if done else {})}

    inner = handler_of(P, P.rt.LambdaEngine(fn))

    async def handler(req, ctx):
        n = 0
        async for frame in inner(req, ctx):
            if n == crash_after:
                raise ConnectionError("worker crashed mid-stream")
            n += 1
            yield frame

    return handler


async def test_mid_stream_recovery_matches_jax():
    async def script(P):
        drt = P.rt.DistributedRuntime.detached()
        ep = drt.namespace("ns").component("w").endpoint("gen")
        first = await ep.serve_endpoint(token_handler(P, crash_after=4))
        second = await ep.serve_endpoint(token_handler(P, crash_after=None))
        client = await ep.client()
        await client.wait_for_instances(2, 5)
        router = P.rt.PushRouter(client, P.rt.RouterMode.ROUND_ROBIN, rng=random.Random(1))
        req = {"token_ids": [11, 12, 13], "stop_conditions": {"max_tokens": 10}}
        frames = await collect(await router.generate(req))
        client.close()
        await first.close()
        await second.close()
        await drt.close()
        return {"frames": frames}

    obs = await run_both(script)
    toks = [t for f in obs["frames"] for t in f["token_ids"]]
    want = [11, 12, 13]
    for _ in range(10):
        want.append(next_token(want))
    assert toks == want[3:]
    assert obs["frames"][-1]["completion_tokens"] == 10
    assert obs["frames"][-1]["prompt_tokens"] == 3
    assert obs["counters"] == {
        ("dynamo_request_recoveries_total", (("reason", "stream_drop"),)): 1.0,
    }


def test_engine_output_survives_the_wire_as_jax_reads_it():
    """Top logprobs keyed by token id cross the request plane as JSON
    (string keys); the port reads them back as ids, as the JAX model's
    validation does."""
    import json

    from dynamo_exp_tpu.protocols.common import LLMEngineOutput as JOut
    from dynamo_exp_tpu_torch.protocols.common import LLMEngineOutput as TOut

    frame = {"token_ids": [7, 9], "logprobs": [-0.5, -1.0],
             "top_logprobs": [{7: -0.5, 3: -2.0}, {9: -1.0}], "finish_reason": "length",
             "prompt_tokens": 4, "completion_tokens": 2}
    wire = json.loads(json.dumps(frame))
    assert TOut.from_dict(wire).to_dict() == JOut.from_dict(wire).to_dict() == {
        **frame, "finish_reason": "length"}
