"""The port's chaos planes (``runtime/transports/chaos.py``) against the
JAX package's: ``tests/test_fault_tolerance.py``'s request-plane,
breaker, discovery-flap, work-queue and determinism scenarios and
``tests/test_resumable.py``'s crash-at-token-K scenarios (its helpers at
``:41-99``), each run once over each package's runtime. For the same
seed and script both packages' planes inject the same faults (the
``injected`` lists, instance ids named by order of appearance) and the
clients observe the same outcomes (frames, handler calls, raised
errors, breaker states). Tolerances: none; every comparison is exact.
"""

import asyncio
import random
import re
import types

import pytest

import dynamo_exp_tpu.runtime as jrt
import dynamo_exp_tpu.runtime.transports.chaos as jchaos
import dynamo_exp_tpu.runtime.transports.inproc as jinproc
import dynamo_exp_tpu_torch.runtime as trt
import dynamo_exp_tpu_torch.runtime.transports.chaos as tchaos
import dynamo_exp_tpu_torch.runtime.transports.inproc as tinproc

SEEDS = (7, 21, 1337)
PROMPT = [11, 12, 13]
MAX_TOKENS = 10

PKGS = {
    "jax": types.SimpleNamespace(rt=jrt, chaos=jchaos, inproc=jinproc),
    "torch": types.SimpleNamespace(rt=trt, chaos=tchaos, inproc=tinproc),
}


# ------------------------------------------------------------------ helpers
def chaos_runtime(P, schedule):
    return P.rt.DistributedRuntime(
        discovery=P.chaos.ChaosDiscovery(P.inproc.InProcDiscovery(), schedule),
        request_plane=P.chaos.ChaosRequestPlane(P.inproc.InProcRequestPlane(), schedule),
    )


def make_worker(P, wid, calls, tokens=(1, 2, 3)):
    async def handler(request, context):
        calls.append(wid)
        for t in tokens:
            yield P.rt.Annotated.from_data({"tok": t, "worker": wid}).to_dict()

    return handler


def next_token(context_tokens, seed=0):
    return (sum(context_tokens) * 31 + len(context_tokens) + seed) % 97 + 3


def make_engine_worker(P, wid, calls):
    """A fake decode worker with engine semantics (the JAX suite's)."""

    async def handler(request, context=None):
        calls.append(wid)
        toks = list(request["token_ids"])
        sc = request.get("stop_conditions") or {}
        seed = (request.get("sampling_options") or {}).get("seed") or 0
        n = sc.get("max_tokens", MAX_TOKENS)
        for _ in range(n):
            t = next_token(toks, seed)
            toks.append(t)
            yield P.rt.Annotated.from_data({"token_ids": [t]}).to_dict()
        yield P.rt.Annotated.from_data({
            "finish_reason": "length", "prompt_tokens": len(request["token_ids"]),
            "completion_tokens": n}).to_dict()

    return handler


async def serve(P, drt, handlers, name="worker"):
    ep = drt.namespace("ft").component(name).endpoint("generate")
    served = [await ep.serve_endpoint(h, lease=await drt.discovery.create_lease())
              for h in handlers]
    client = await ep.client()
    await client.wait_for_instances(len(handlers), timeout=2)
    return ep, served, client


def router(P, client, seed=0, **kw):
    kw.setdefault("mode", P.rt.RouterMode.ROUND_ROBIN)
    kw.setdefault("backoff_base_s", 0.001)
    return P.rt.PushRouter(client, rng=random.Random(seed), **kw)


async def collect(stream):
    return [item async for item in stream]


def norm_injected(injected, names):
    """``op:iid:kind`` entries with instance ids replaced by worker names
    (ids are a process-wide counter, so they differ across runs)."""
    out = []
    for entry in injected:
        parts = entry.split(":")
        if len(parts) == 3 and parts[1].isdigit():
            parts[1] = names.get(int(parts[1]), "?")
        out.append(":".join(parts))
    return out


async def outcome(coro):
    """A call's result, or its error's type name and message (instance
    ids in it masked: they are a process-wide counter, which earlier
    tests in the same process advance by different amounts in the two
    packages; the normalized injection log names the worker)."""
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return (type(e).__name__, re.sub(r"instance \d+", "instance <id>", str(e)))


def both(scenario, *args):
    """Run one scenario over each package; they must agree."""
    got = {name: asyncio.run(asyncio.wait_for(scenario(P, *args), timeout=60))
           for name, P in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ------------------------------------------------ failover on worker crash
async def _failover(P, seed):
    sched = P.chaos.ChaosSchedule(seed)
    drt = chaos_runtime(P, sched)
    calls = []
    _, (a, b), client = await serve(P, drt, [make_worker(P, "a", calls),
                                             make_worker(P, "b", calls)])
    sched.fail_requests(instance_id=a.instance_id, times=1)
    out = await collect(await router(P, client, seed).generate({}))
    names = {a.instance_id: "a", b.instance_id: "b"}
    ba, bb = client.health.breaker(a.instance_id), client.health.breaker(b.instance_id)
    res = dict(out=out, calls=calls, injected=norm_injected(sched.injected, names),
               a=(ba.consecutive_failures, ba.state.name), b=bb.consecutive_failures)
    await drt.close()
    return res


@pytest.mark.parametrize("seed", SEEDS)
def test_request_survives_worker_crash_via_failover(seed):
    r = both(_failover, seed)
    assert [o["worker"] for o in r["out"]] == ["b", "b", "b"]
    assert r["calls"] == ["b"] and r["injected"] == ["request:a:error"]
    assert r["a"] == (1, "CLOSED") and r["b"] == 0


async def _no_retry_after_first_token(P):
    sched = P.chaos.ChaosSchedule(SEEDS[0])
    drt = chaos_runtime(P, sched)
    calls = []
    _, (a, _b), client = await serve(P, drt, [make_worker(P, "a", calls),
                                              make_worker(P, "b", calls)])
    sched.fail_requests(instance_id=a.instance_id, times=1, after_frames=1)
    stream = await router(P, client, retries=5).generate({})
    res = dict(outcome=await outcome(collect(stream)), calls=calls)
    await drt.close()
    return res


def test_no_retry_after_first_token():
    r = both(_no_retry_after_first_token)
    assert r["outcome"][0] == "ConnectionError" and "stream dropped" in r["outcome"][1]
    assert r["calls"] == ["a"]


async def _exhaustion(P):
    sched = P.chaos.ChaosSchedule(SEEDS[0])
    drt = chaos_runtime(P, sched)
    calls = []
    _, (a, b), client = await serve(P, drt, [make_worker(P, "a", calls),
                                             make_worker(P, "b", calls)])
    sched.partition(a.instance_id, b.instance_id)
    res = dict(outcome=await outcome(router(P, client, retries=1).generate({})), calls=calls,
               strikes=[client.health.breaker(i.instance_id).consecutive_failures
                        for i in (a, b)],
               injected=norm_injected(sched.injected, {a.instance_id: "a", b.instance_id: "b"}))
    await drt.close()
    return res


def test_failover_exhaustion_surfaces_error():
    r = both(_exhaustion)
    assert r["outcome"][0] == "ConnectionError" and "partition" in r["outcome"][1]
    assert r["calls"] == [] and r["strikes"] == [1, 1]


# ----------------------------------------------------------- circuit breaker
async def _breaker(P, threshold, heal):
    sched = P.chaos.ChaosSchedule(SEEDS[0])
    drt = chaos_runtime(P, sched)
    ep = drt.namespace("ft").component("worker").endpoint("generate")
    calls = []
    a = await ep.serve_endpoint(make_worker(P, "a", calls))
    t = [0.0]
    health = P.rt.HealthTracker(failure_threshold=threshold, cooldown_s=5.0, clock=lambda: t[0])
    client = await ep.client(health=health)
    await client.wait_for_instances(1, timeout=2)
    r = router(P, client, retries=0)
    steps = []
    sched.partition(a.instance_id)
    for _ in range(threshold):
        steps.append((await outcome(r.generate({})))[0])
    breaker = health.breaker(a.instance_id)
    steps.append(breaker.state.name)
    n = len(sched.injected)
    steps.append((await outcome(r.generate({})))[0])  # open: no dispatch
    steps.append(len(sched.injected) - n)
    if heal:
        sched.heal()
    t[0] = 6.0
    got = await outcome(r.generate({}))
    if got[0] == "ok":
        got = ("ok", [o["worker"] for o in await collect(got[1])])
    steps += [got, breaker.state.name, (await outcome(r.generate({})))[0]]
    res = dict(steps=steps, calls=calls,
               injected=norm_injected(sched.injected, {a.instance_id: "a"}))
    await drt.close()
    return res


def test_breaker_opens_blocks_and_recovers_via_half_open_probe():
    r = both(_breaker, 3, True)
    assert r["steps"] == ["ConnectionError"] * 3 + [
        "OPEN", "NoHealthyInstancesError", 0, ("ok", ["a", "a", "a"]), "CLOSED", "ok"]


def test_half_open_failed_probe_reopens_breaker():
    r = both(_breaker, 2, False)
    assert r["steps"][:5] == ["ConnectionError"] * 2 + ["OPEN", "NoHealthyInstancesError", 0]
    assert r["steps"][5][0] == "ConnectionError" and r["steps"][6] == "OPEN"
    assert r["steps"][7] == "NoHealthyInstancesError"


# -------------------------------------------------------------- discovery flap
async def _watch_flap(P):
    sched = P.chaos.ChaosSchedule(SEEDS[0])
    drt = chaos_runtime(P, sched)
    ep = drt.namespace("ft").component("worker").endpoint("generate")
    await ep.serve_endpoint(make_worker(P, "a", []), lease=await drt.discovery.create_lease())
    client = await ep.client()
    await client.wait_for_instances(1, timeout=2)
    sched.fail_watch(times=2)
    counts = []
    for wid, n in (("b", 2), ("c", 3)):
        await ep.serve_endpoint(make_worker(P, wid, []), lease=await drt.discovery.create_lease())
        await client.wait_for_instances(n, timeout=5)
        counts.append(len(client.instances))
    res = dict(counts=counts, injected=[e.split(":")[0] + ":" + e.split(":")[-1]
                                        for e in sched.injected])
    await drt.close()
    return res


def test_client_watch_resubscribes_after_discovery_flap():
    r = both(_watch_flap)
    assert r["counts"] == [2, 3]
    assert r["injected"] == ["watch:error", "watch:error"]


# --------------------------------------------------------------- work queue
async def _queue_outage(P):
    sched = P.chaos.ChaosSchedule(SEEDS[0])
    q = P.chaos.ChaosWorkQueue(P.inproc.InProcWorkQueue(), sched)
    sched.fail_queue("size", times=-1)
    sched.fail_queue("push", times=1)
    steps = [await outcome(q.size()), await outcome(q.push(b"x")),
             await outcome(q.push(b"y")), await outcome(q.pull(timeout_s=1)),
             await outcome(q.size())]
    sched.clear()
    steps.append(await outcome(q.size()))
    return dict(steps=steps, injected=list(sched.injected))


def test_queue_faults_fire_in_script_order():
    r = both(_queue_outage)
    assert r["steps"][0][0] == "ConnectionError" and r["steps"][1][0] == "ConnectionError"
    assert r["steps"][2] == ("ok", None) and r["steps"][3] == ("ok", b"y")
    assert r["steps"][5] == ("ok", 0)


# --------------------------------------------------------------- determinism
async def _failover_scenario(P, seed):
    sched = P.chaos.ChaosSchedule(seed)
    drt = chaos_runtime(P, sched)
    calls = []
    _, (a, b), client = await serve(P, drt, [make_worker(P, "a", calls),
                                             make_worker(P, "b", calls)])
    r = router(P, client, seed)
    sched.fail_requests(instance_id=a.instance_id, times=1)
    sched.delay_requests(0.002, times=2)
    results = []
    for _ in range(4):
        results.append([o["worker"] for o in await collect(await r.generate({}))])
    res = dict(results=results, calls=calls, rng=sched.rng.random(),
               injected=norm_injected(sched.injected, {a.instance_id: "a", b.instance_id: "b"}))
    await drt.close()
    return res


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_schedule_is_deterministic_across_runs(seed):
    first = both(_failover_scenario, seed)
    assert both(_failover_scenario, seed) == first


def test_storage_chaos_draws_as_jax():
    """The storage schedule's consume order and seeded bit positions."""
    for seed in SEEDS:
        j = jchaos.StorageChaos(seed).torn_write().bitflip_read(times=2).enospc()
        t = tchaos.StorageChaos(seed).torn_write().bitflip_read(times=2).enospc()
        for op in ("store_read", "store_write", "store_write", "store_read", "store_read",
                   "store_write"):
            fj, ft = j.take(op), t.take(op)
            assert (fj and fj.kind) == (ft and ft.kind)
        assert t.injected == j.injected
        assert [t.rng.randrange(1 << 20) for _ in range(8)] == [
            j.rng.randrange(1 << 20) for _ in range(8)]


def test_overload_burst_equals_jax():
    for seed in SEEDS:
        kw = dict(n=40, seed=seed)
        assert [vars(b) for b in tchaos.overload_burst(**kw)] == [
            vars(b) for b in jchaos.overload_burst(**kw)]


# ------------------------------------------------- resumable: crash at token K
def expected_greedy(seed=0):
    toks, out = list(PROMPT), []
    for _ in range(MAX_TOKENS):
        t = next_token(toks, seed)
        toks.append(t)
        out.append(t)
    return out


async def _crash_at_token(P, seed, k, sampling):
    sched = P.chaos.ChaosSchedule(seed)
    drt = chaos_runtime(P, sched)
    calls = []
    _, (a, b), client = await serve(P, drt, [make_engine_worker(P, "a", calls),
                                             make_engine_worker(P, "b", calls)])
    sched.crash_at_token(k, instance_id=a.instance_id)
    req = {"token_ids": list(PROMPT), "stop_conditions": {"max_tokens": MAX_TOKENS}}
    if sampling:
        req["sampling_options"] = {"seed": seed, "temperature": 0.8}
    tokens, final = [], None
    async for item in await router(P, client, seed).generate(req):
        tokens.extend(item.get("token_ids", []))
        if item.get("finish_reason"):
            final = item
    res = dict(tokens=tokens, calls=calls, final=final,
               strikes=client.health.breaker(a.instance_id).consecutive_failures,
               injected=norm_injected(sched.injected, {a.instance_id: "a", b.instance_id: "b"}))
    await drt.close()
    return res


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [1, 4, MAX_TOKENS - 1])
def test_greedy_stream_identical_after_crash_at_token_k(seed, k):
    r = both(_crash_at_token, seed, k, False)
    assert r["tokens"] == expected_greedy()
    assert r["calls"] == ["a", "b"]
    assert r["final"]["finish_reason"] == "length"
    assert r["final"]["prompt_tokens"] == len(PROMPT)
    assert r["final"]["completion_tokens"] == MAX_TOKENS
    assert r["strikes"] == 1


def test_crash_between_last_token_and_finish_frame():
    r = both(_crash_at_token, SEEDS[0], MAX_TOKENS, False)
    assert r["tokens"] == expected_greedy()
    assert r["calls"] == ["a"]
    assert r["final"]["finish_reason"] == "length"
    assert r["final"]["completion_tokens"] == MAX_TOKENS


@pytest.mark.parametrize("seed", SEEDS)
def test_sampled_continuation_replays_deterministically(seed):
    first = both(_crash_at_token, seed, 4, True)
    assert both(_crash_at_token, seed, 4, True) == first
    assert first["tokens"] == expected_greedy(seed)
