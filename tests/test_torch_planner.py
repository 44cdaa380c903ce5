"""The port's planner (``dynamo_exp_tpu_torch/planner/``): its pure
policies against the JAX package's on seeded cases, the threshold loop's
decisions, the CLI's flags, the ``dynamo_config_swaps`` family, and the
whole loop scaling a real supervisor's worker fleet up and down."""

import asyncio
import contextlib
import os
from dataclasses import fields

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_exp_tpu.planner import policy as jpolicy
from dynamo_exp_tpu.planner.planner import PlannerConfig as JPlannerConfig
from dynamo_exp_tpu.telemetry import fingerprint as jfp
from dynamo_exp_tpu_torch.planner import (
    CatalogEntry,
    Planner,
    PlannerConfig,
    PlannerConnector,
    PlannerObservation,
    PlannerState,
    SloTargets,
    arm_decode_grace,
    maybe_swap_config,
    plan_step,
    plan_step_slo,
)
from dynamo_exp_tpu_torch.planner import planner as tplanner
from dynamo_exp_tpu_torch.planner.planner import NEW_DECODE_WORKER_GRACE_PERIOD, prefill_queue_name
from dynamo_exp_tpu_torch.telemetry import fingerprint as tfp

# The card budget's fields: the port's name -> the JAX package's.
BUDGET = {"max_gpu_budget": "max_tpu_budget", "decode_engine_num_gpu": "decode_engine_num_tpu",
          "prefill_engine_num_gpu": "prefill_engine_num_tpu"}


class FakeConnector(PlannerConnector):
    def __init__(self, fail=False):
        self.calls: list[tuple[str, str]] = []
        self.fail = fail

    async def add_component(self, name):
        self.calls.append(("add", name))
        return not self.fail

    async def remove_component(self, name):
        self.calls.append(("remove", name))
        return not self.fail


def make_planner(connector, **kw) -> Planner:
    """A planner over a null runtime: the tests feed it samples and fleet
    counts directly, so no coordinator is needed."""

    class _NullQueue:
        async def size(self):
            return 0

    class _NullDrt:
        def namespace(self, name):
            return self

        def component(self, name):
            return self

        def work_queue(self, name):
            return _NullQueue()

    return Planner(_NullDrt(), PlannerConfig(adjustment_interval=0.1, **kw), connector=connector)


# ------------------------------------------------------- parity with JAX
def _fingerprint(rs):
    """The same random fingerprint in both packages' types."""
    kw = dict(
        n=int(rs.randint(1, 500)),
        isl_hist=tuple(int(x) for x in rs.randint(0, 20, size=len(tfp.ISL_BUCKETS) + 1)),
        osl_hist=tuple(int(x) for x in rs.randint(0, 20, size=len(tfp.OSL_BUCKETS) + 1)),
        priority_mix=tuple(round(float(x), 4) for x in rs.dirichlet([1, 1, 1])),
        prefix_share=round(float(rs.rand()), 4),
        spec_accept=round(float(rs.rand() * 3), 4),
    )
    return tfp.WorkloadFingerprint(**kw), jfp.WorkloadFingerprint(**kw)


def _draw(rs):
    """One seeded case: (port cfg, JAX cfg, port obs, JAX obs, port
    state, JAX state, port SLO, JAX SLO)."""
    catalog, jcatalog = [], []
    for i in range(int(rs.randint(0, 4))):
        fp, jf = _fingerprint(rs)
        over = (("max_decode_slots", int(rs.randint(1, 32))),)
        catalog.append(CatalogEntry(f"c{i}", fp, over, f"h{i}"))
        jcatalog.append(jpolicy.CatalogEntry(f"c{i}", jf, over, f"h{i}"))
    common = dict(
        decode_component="Decode", prefill_component="Prefill",
        adjustment_interval=float(rs.choice([0.5, 2.0, 10.0])),
        min_endpoint=int(rs.randint(0, 3)),
        prefill_queue_scale_up_threshold=float(rs.uniform(1, 8)),
        prefill_queue_scale_down_threshold=float(rs.uniform(0, 1)),
        decode_kv_scale_up_threshold=float(rs.uniform(0.5, 1.0)),
        decode_kv_scale_down_threshold=float(rs.uniform(0.0, 0.5)),
    )
    budget = dict(max_gpu_budget=int(rs.randint(1, 10)),
                  decode_engine_num_gpu=int(rs.randint(1, 3)),
                  prefill_engine_num_gpu=int(rs.randint(1, 3)))
    cfg = PlannerConfig(**common, **budget, config_catalog=tuple(catalog))
    jcfg = JPlannerConfig(**common, **{BUDGET[k]: v for k, v in budget.items()},
                          config_catalog=tuple(jcatalog))

    def samples(hi, n_max):
        return tuple(float(x) for x in rs.uniform(0, hi, size=rs.randint(0, n_max + 1)))

    def maybe(x):
        return x if rs.rand() < 0.5 else None

    live, jlive = _fingerprint(rs)
    obs_kw = dict(
        num_prefill=int(rs.randint(0, 4)), num_decode=int(rs.randint(0, 6)),
        prefill_queue=samples(20.0, 4), kv_load=samples(1.3, 4),
        ttft_p99_s=maybe(float(rs.uniform(0, 5))), itl_p99_s=maybe(float(rs.uniform(0, 0.5))),
        now=float(rs.uniform(0, 100)), drift_score=maybe(float(rs.uniform(0, 1))),
    )
    with_fp = rs.rand() < 0.7
    obs = PlannerObservation(**obs_kw, fingerprint=live if with_fp else None)
    jobs = jpolicy.PlannerObservation(**obs_kw, fingerprint=jlive if with_fp else None)
    names = [""] + [e.name for e in catalog]
    st = dict(decode_grace_remaining=int(rs.randint(0, 4)),
              active_config=names[rs.randint(len(names))])
    slo_kw = dict(ttft_p99_slo_s=float(rs.uniform(0.1, 3)), itl_p99_slo_s=float(rs.uniform(0.01, 0.3)),
                  forecast_horizon=float(rs.uniform(0, 4)), decode_kv_target=float(rs.uniform(0.3, 0.9)),
                  prefill_queue_target=float(rs.uniform(0.5, 4)), max_scale_step=int(rs.randint(1, 5)),
                  scale_down_headroom=float(rs.uniform(0.2, 0.9)), max_pressure=float(rs.uniform(1, 4)),
                  provision_s=float(rs.choice([0.0, rs.uniform(0, 20)])))
    return (cfg, jcfg, obs, jobs, PlannerState(**st), jpolicy.PlannerState(**st),
            SloTargets(**slo_kw), jpolicy.SloTargets(**slo_kw))


def _decision(d) -> tuple:
    return ([(a.op, a.component, a.signal, a.as_log()) for a in d.actions], d.notes,
            d.arm_decode_grace, d.config_swap)


def _state(s) -> tuple:
    return s.decode_grace_remaining, s.active_config


CASES = 400


@pytest.mark.parametrize("seed", range(4))
def test_policies_equal_the_jax_package_on_seeded_cases(seed):
    """``plan_step``, ``plan_step_slo``, ``maybe_swap_config`` and
    ``arm_decode_grace`` of both packages, fed the same observations,
    states and configs (the budget fields mapped), decide alike field
    for field."""
    rs = np.random.RandomState(seed)
    seen = {"add": 0, "remove": 0, "swap": 0, "grace": 0, "notes": 0}
    for _ in range(CASES // 4):
        cfg, jcfg, obs, jobs, st, jst, slo, jslo = _draw(rs)
        got, gst = plan_step(obs, st, cfg)
        want, wst = jpolicy.plan_step(jobs, jst, jcfg)
        assert _decision(got) == _decision(want) and _state(gst) == _state(wst)
        got_s, gst_s = plan_step_slo(obs, st, cfg, slo)
        want_s, wst_s = jpolicy.plan_step_slo(jobs, jst, jcfg, jslo)
        assert _decision(got_s) == _decision(want_s) and _state(gst_s) == _state(wst_s)
        assert maybe_swap_config(obs, st, cfg) == jpolicy.maybe_swap_config(jobs, jst, jcfg)
        assert _state(arm_decode_grace(st)) == _state(jpolicy.arm_decode_grace(jst))
        for d in (got, got_s):
            for a in d.actions:
                seen[a.op] += 1
            seen["grace"] += d.arm_decode_grace
            seen["notes"] += bool(d.notes)
        seen["swap"] += got_s.config_swap is not None
    # The draws reach every branch: adds, removes, swaps, grace, notes.
    assert all(v > 0 for v in seen.values()), seen


def test_config_fields_map_to_the_jax_config():
    """Every JAX PlannerConfig field has its port field, the budget's
    under its GPU name, with the same default; only the component
    defaults name the port's services."""
    tf = {f.name: f for f in fields(PlannerConfig)}
    jf = {f.name: f for f in fields(JPlannerConfig)}
    back = {v: k for k, v in BUDGET.items()}
    assert {back.get(n, n) for n in jf} == set(tf)
    t, j = PlannerConfig(), JPlannerConfig()
    for n in jf:
        if n in ("decode_component", "prefill_component"):
            continue
        assert getattr(t, back.get(n, n)) == getattr(j, n), n
    assert (t.decode_component, t.prefill_component) == ("CudaWorker", "PrefillCudaWorker")


# -------------------------------------------------------- threshold loop
async def test_decode_scale_up_on_high_kv_load():
    conn = FakeConnector()
    p = make_planner(conn)
    p.kv_load = [0.95, 0.97]
    await p.make_adjustments_with_counts([], [1])
    assert ("add", p.cfg.decode_component) in conn.calls
    assert p.decode_worker_remaining_grace_period == NEW_DECODE_WORKER_GRACE_PERIOD - 1
    assert p.adjustments == [{"op": "add", "component": "CudaWorker", "signal": 0.96}]


async def test_failed_decode_add_does_not_arm_grace():
    """An add the connector rejected spawned nothing: no grace, no log."""
    conn = FakeConnector(fail=True)
    p = make_planner(conn)
    p.kv_load = [0.95, 0.97]
    await p.make_adjustments_with_counts([], [1])
    assert ("add", p.cfg.decode_component) in conn.calls
    assert p.decode_worker_remaining_grace_period == 0
    assert p.adjustments == []


async def test_decode_scale_down_blocked_by_grace_period_then_allowed():
    conn = FakeConnector()
    p = make_planner(conn)
    p.decode_worker_remaining_grace_period = 2
    p.kv_load = [0.1]
    await p.make_adjustments_with_counts([], [1, 2])
    assert conn.calls == []
    p.kv_load = [0.1]
    await p.make_adjustments_with_counts([], [1, 2])
    p.kv_load = [0.1]
    await p.make_adjustments_with_counts([], [1, 2])
    assert ("remove", p.cfg.decode_component) in conn.calls


async def test_decode_scale_down_respects_min_endpoint():
    conn = FakeConnector()
    p = make_planner(conn, min_endpoint=1)
    p.kv_load = [0.0]
    await p.make_adjustments_with_counts([], [1])
    assert conn.calls == []


async def test_budget_caps_scale_up():
    conn = FakeConnector()
    p = make_planner(conn, max_gpu_budget=2, decode_engine_num_gpu=1)
    p.kv_load = [0.99]
    await p.make_adjustments_with_counts([], [1, 2])  # 2 cards in use already
    assert conn.calls == []


async def test_prefill_scale_up_needs_persistent_trend():
    conn = FakeConnector()
    p = make_planner(conn)
    p.prefill_queue_load = [20.0, 6.0]  # deep but draining fast
    await p.make_adjustments_with_counts([1], [2])
    assert ("add", p.cfg.prefill_component) not in conn.calls
    p.prefill_queue_load = [6.0, 20.0]  # deep and rising
    await p.make_adjustments_with_counts([1], [2])
    assert ("add", p.cfg.prefill_component) in conn.calls


async def test_prefill_scale_down_when_queue_idle():
    conn = FakeConnector()
    p = make_planner(conn)
    p.prefill_queue_load = [0.0, 0.0]
    p.kv_load = [0.7]
    await p.make_adjustments_with_counts([1, 2], [3])
    assert ("remove", p.cfg.prefill_component) in conn.calls


def test_prefill_queue_name_stable():
    from dynamo_exp_tpu.planner.planner import prefill_queue_name as jname

    assert prefill_queue_name("m") == "prefill-m" == jname("m")


def _swaps(text: str) -> float:
    for fam in text_string_to_metric_families(text):
        if fam.name == "dynamo_config_swaps":
            return sum(s.value for s in fam.samples if s.name.endswith("_total"))
    raise AssertionError("no dynamo_config_swaps family")


async def test_config_swap_is_logged_and_counted():
    """A drifted live fingerprint under the SLO policy swaps to the
    nearest catalog entry: one adjustment-log entry and one more
    ``dynamo_config_swaps`` sample on the port's ``/metrics`` text."""
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    rs = np.random.RandomState(5)
    ref, _ = _fingerprint(rs)
    live, _ = _fingerprint(rs)
    near = CatalogEntry("near", live, (("max_decode_slots", 4),), "hash-near")
    p = make_planner(FakeConnector(), slo=SloTargets(), config_catalog=(near,))
    p.drift_score = max(tfp.drift_score(live, ref), tfp.DRIFT_ALERT_THRESHOLD + 0.1)
    p.live_fingerprint = live
    before = _swaps(get_telemetry().render().decode())
    await p.make_adjustments_with_counts([], [1])
    assert _swaps(get_telemetry().render().decode()) == before + 1
    (entry,) = [a for a in p.adjustments if a["op"] == "config_swap"]
    assert entry["name"] == "near" and entry["config_hash"] == "hash-near"
    assert p._plan_state.active_config == "near"
    await p.make_adjustments_with_counts([], [1])  # already active: no second swap
    assert _swaps(get_telemetry().render().decode()) == before + 1


def test_cli_flags():
    """The CLI's flags set every threshold, interval and card-budget
    field (the JAX CLI's, the budget under its GPU names)."""
    args = tplanner.build_parser().parse_args([
        "--coordinator", "127.0.0.1:1", "--namespace", "ns", "--decode-component", "W",
        "--metric-pulling-interval", "0.5", "--adjustment-interval", "2",
        "--decode-kv-scale-up-threshold", "0.7", "--decode-kv-scale-down-threshold", "0.3",
        "--max-gpu-budget", "2", "--decode-engine-num-gpu", "1", "--min-endpoint", "1",
        "--prefill-engine-num-gpu", "3", "--no-operation"])
    cfg = tplanner.config_from_args(args)
    assert args.coordinator == "127.0.0.1:1"
    assert (cfg.namespace, cfg.decode_component, cfg.metric_pulling_interval,
            cfg.adjustment_interval, cfg.decode_kv_scale_up_threshold,
            cfg.decode_kv_scale_down_threshold, cfg.max_gpu_budget,
            cfg.decode_engine_num_gpu, cfg.prefill_engine_num_gpu, cfg.min_endpoint,
            cfg.no_operation) == ("ns", "W", 0.5, 2.0, 0.7, 0.3, 2, 1, 3, 1, True)
    assert tplanner.config_from_args(
        tplanner.build_parser().parse_args(["--coordinator", "x:1"])) == PlannerConfig()
    with pytest.raises(SystemExit):
        tplanner.build_parser().parse_args(["--max-tpu-budget", "2", "--coordinator", "x:1"])


async def test_planner_counts_registered_prefill_workers():
    """``PrefillWorker.register()`` makes the fleet visible to the
    planner's discovery (the ``pull`` presence endpoint)."""
    from dynamo_exp_tpu_torch.disagg import PrefillWorker
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_exp_tpu_torch.models import TINY
    from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    server = CoordinatorServer()
    await server.start()
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
    eng = TorchEngine(EngineConfig(model=TINY, max_decode_slots=1, num_pages=16,
                                   max_model_len=64, kv_dtype="float32"), device="cpu")
    worker = PrefillWorker(eng, drt.work_queue(prefill_queue_name("m")),
                           component=drt.namespace("plan").component("PrefillWorker"))
    try:
        await worker.register()
        cfg = PlannerConfig(namespace="plan", prefill_component="PrefillWorker",
                            decode_component="CudaWorker")
        planner = Planner(drt, cfg, connector=FakeConnector())
        p, d = await planner.get_workers_info()
        assert len(p) == 1 and d == []
    finally:
        if worker._presence is not None:
            await worker._presence.close()
        eng.stop()
        await drt.close()
        await server.close()


# ------------------------------------------------------------------- e2e
async def test_planner_scales_supervisor_up_and_down_under_load():
    """Synthetic load -> scale-up through the supervisor (a second
    ``CudaAllocator`` slot of card 0); idle -> scale-down; a discovery
    client (the router's membership view) follows both."""
    from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.push_router import PushRouter
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer
    from dynamo_exp_tpu_torch.sdk.allocator import CudaAllocator
    from dynamo_exp_tpu_torch.sdk.config import ServiceConfig
    from dynamo_exp_tpu_torch.sdk.serve import Supervisor
    from dynamo_exp_tpu_torch.sdk.service import discover_graph

    from .torch_sdk_graphs import LoadWorker

    server = CoordinatorServer()
    await server.start()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    alloc = CudaAllocator("0,0")
    sup = Supervisor("tests.torch_sdk_graphs:LoadWorker", discover_graph(LoadWorker),
                     ServiceConfig.load(None), alloc, server.address)
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
    control = await sup.serve_control(drt, "plan")
    planner = None
    tasks: list[asyncio.Task] = []
    old_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = repo
    try:
        await sup.start_initial()
        assert alloc.available == 1
        ep = drt.namespace("plan").component("LoadWorker").endpoint("generate")
        client = await ep.client()
        await client.wait_for_instances(1, timeout=30)

        cfg = PlannerConfig(namespace="plan", decode_component="LoadWorker",
                            metric_pulling_interval=0.2, adjustment_interval=1.0,
                            decode_kv_scale_up_threshold=0.7,
                            decode_kv_scale_down_threshold=0.3, max_gpu_budget=2,
                            decode_engine_num_gpu=1)
        planner = Planner(drt, cfg)
        tasks.append(asyncio.ensure_future(planner.run()))
        router = PushRouter(client)

        async def drive():
            stream = await router.generate({"steps": 200})
            with contextlib.suppress(Exception):
                async for _ in stream:
                    pass

        load = [asyncio.ensure_future(drive()) for _ in range(4)]

        async def wait_for(cond, timeout):
            deadline = asyncio.get_running_loop().time() + timeout
            while asyncio.get_running_loop().time() < deadline:
                if cond():
                    return True
                await asyncio.sleep(0.2)
            return False

        assert await wait_for(lambda: sup.counts()["LoadWorker"] >= 2, 30), planner.adjustments
        assert await wait_for(lambda: len(client.instance_ids()) >= 2, 30)
        for t in load:
            t.cancel()
        await asyncio.gather(*load, return_exceptions=True)
        assert await wait_for(lambda: sup.counts()["LoadWorker"] == 1, 60), planner.adjustments
        assert await wait_for(lambda: len(client.instance_ids()) == 1, 30)
        # The removed worker's slot came back.
        assert await wait_for(lambda: alloc.available == 1, 30)
        ops = {(a["op"], a["component"]) for a in planner.adjustments}
        assert ops == {("add", "LoadWorker"), ("remove", "LoadWorker")}, planner.adjustments
    finally:
        if old_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_path
        if planner is not None:
            planner.stop()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await sup.stop_all()
        await control.close()
        await drt.close()
        await server.close()
