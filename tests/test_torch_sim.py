"""Port parity: the cluster simulator (``dynamo_exp_tpu_torch/sim/``)
against the JAX package's (``dynamo_exp_tpu/sim/``).

The same (seed, workload, ``SimConfig``) triple goes through both
packages' ``ClusterSim``: the event logs are equal line for line and the
reports key for key (``SimReport.to_dict``), for the four workloads
(burst, ramp, diurnal, synthetic users) under no planner, the reactive
planner and the SLO planner, and for the pressure harness of the JAX
suite. The one name that differs by design is the planner's worker
component (``TpuWorker`` there, ``CudaWorker`` here: ROADMAP Queue 3),
which the comparison maps. The generators, the trace format, the
event loop, ``AdmissionController.resize`` and the service-time fits
are held to the JAX package's too; the span fit on a file the port's
own engine recorded on the CPU gives the JAX fit's values on the same
spans. Everything is exact (the simulator is host arithmetic, seeded)."""

import asyncio
import json

import pytest

from dynamo_exp_tpu import sim as J
from dynamo_exp_tpu.http.admission import AdmissionController as JAdmission
from dynamo_exp_tpu.planner.planner import PlannerConfig as JPlannerConfig
from dynamo_exp_tpu_torch import sim as T
from dynamo_exp_tpu_torch.http.admission import AdmissionController as TAdmission
from dynamo_exp_tpu_torch.planner.planner import PlannerConfig as TPlannerConfig

WORKLOADS = {
    "burst": lambda m, seed: m.burst_workload(seed, n=40),
    "ramp": lambda m, seed: m.ramp_workload(seed, duration_s=60.0, rps_start=1.0, rps_end=8.0),
    "diurnal": lambda m, seed: m.diurnal_workload(seed, duration_s=60.0, period_s=30.0),
    "users": lambda m, seed: list(m.synthetic_users(seed, users=200, duration_s=60.0)),
}
PRESSURE_CFG = dict(slots_per_instance=4, pages_per_instance=8, page_size=8,
                    preempt_stall_grace_s=0.05, max_inflight=6, shed_watermark=3,
                    initial_instances=1)


def _run(pkg, planner_cls, budget_field, workload, planner, seed, **kw):
    cfg = pkg.SimConfig(
        seed=seed, slots_per_instance=4, pages_per_instance=32, page_size=8,
        planner=planner, admission_per_instance=planner is not None,
        planner_cfg=planner_cls(**{budget_field: 4, "min_endpoint": 1}), **kw)
    sim = pkg.ClusterSim(cfg, WORKLOADS[workload](pkg, seed))
    return sim.event_log, sim.run().to_dict()


def _mapped(report: dict) -> dict:
    """The JAX report with its worker component named as the port's."""
    out = dict(report)
    out["planner_actions"] = [
        dict(a, component="CudaWorker" if a["component"] == "TpuWorker" else a["component"])
        for a in report["planner_actions"]
    ]
    return out


@pytest.mark.parametrize("planner", [None, "reactive", "slo"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_cluster_sim_matches_jax(workload, planner):
    jlog, jrep = _run(J, JPlannerConfig, "max_tpu_budget", workload, planner, 3)
    tlog, trep = _run(T, TPlannerConfig, "max_gpu_budget", workload, planner, 3)
    assert tlog == jlog
    assert trep == _mapped(jrep)
    assert trep["submitted"] == trep["completed"] + trep["shed"] + trep["errors"]
    if planner is not None and workload != "burst":
        assert trep["planner_actions"]  # the planner acted on the ramp


@pytest.mark.parametrize("seed", [7, 21, 1337])
def test_pressure_harness_matches_jax(seed):
    def run(pkg):
        sim = pkg.ClusterSim(pkg.SimConfig(seed=seed, **PRESSURE_CFG),
                             pkg.burst_workload(seed, n=8, osl_range=(6, 12)))
        return sim.event_log, sim.run().to_dict()

    jlog, jrep = run(J)
    tlog, trep = run(T)
    assert tlog == jlog and trep == jrep
    assert trep["submitted"] == 8 and "wall_clock_s" not in trep


def test_tiering_sharing_reclaim_restart_match_jax():
    """The rest of the model: prefix groups with sharing on and off, the
    host tier's proactive offload, the G3 store with a restart drill,
    and spot reclamation through the triage planner."""
    from dataclasses import replace

    def run(pkg, **kw):
        wl = [replace(r, prefix_group=r.index % 3, prefix_len=min(48, r.prompt_len))
              for r in pkg.ramp_workload(5, duration_s=40.0, rps_start=2.0, rps_end=10.0)]
        cfg = pkg.SimConfig(seed=5, slots_per_instance=4, pages_per_instance=48, page_size=8,
                            initial_instances=3, **kw)
        sim = pkg.ClusterSim(cfg, wl)
        return sim.event_log, sim.run().to_dict()

    for kw in (dict(prefix_sharing=False), dict(host_pages_per_instance=32),
               dict(g3_pages_per_instance=64, restart_at_s=10.0),
               dict(spot_fraction=0.5, reclaim_rate_per_min=6.0)):
        assert run(T, **kw) == run(J, **kw), kw


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_generators_match_jax(name):
    assert [tuple(vars(r).values()) for r in WORKLOADS[name](T, 11)] == [
        tuple(vars(r).values()) for r in WORKLOADS[name](J, 11)]


def test_burst_workload_mirrors_the_ports_chaos_generator():
    from dynamo_exp_tpu_torch.protocols.common import parse_priority
    from dynamo_exp_tpu_torch.runtime.transports.chaos import overload_burst

    reqs = T.burst_workload(7, n=8, osl_range=(6, 12))
    burst = overload_burst(7, n=8, osl_range=(6, 12))
    assert [(r.prompt_len, r.max_tokens, r.priority) for r in reqs] == [
        (len(b.prompt), b.max_tokens, parse_priority(b.priority)) for b in burst]


def test_traces_cross_load(tmp_path):
    reqs = T.ramp_workload(5, duration_s=20.0, rps_start=1.0, rps_end=4.0)
    T.save_trace(tmp_path / "t.jsonl", reqs)
    J.save_trace(tmp_path / "j.jsonl", J.ramp_workload(5, duration_s=20.0, rps_start=1.0,
                                                        rps_end=4.0))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert T.load_trace(tmp_path / "j.jsonl") == reqs


def test_event_loop_breaks_ties_in_insertion_order():
    loop = T.EventLoop()
    fired = []
    for i in range(5):
        loop.at(1.0, fired.append, i)
    loop.at(0.5, fired.append, "early")
    loop.after(-3.0, fired.append, "now")  # the past is clamped to now
    loop.run()
    assert fired == ["now", "early", 0, 1, 2, 3, 4]
    assert loop.now == 1.0 and loop.processed == 7
    with pytest.raises(RuntimeError, match="runaway"):
        loop.at(2.0, lambda: loop.after(0.0, fired.append, "x"))
        loop.run(max_events=8)


@pytest.mark.parametrize("size,wm", [(10, None), (8, 3), (2, 9)])
def test_admission_resize_moves_bounds_as_jax(size, wm):
    t, j = TAdmission(max_inflight=4), JAdmission(max_inflight=4)
    t.resize(size, wm)
    j.resize(size, wm)
    assert (t.max_inflight, t.shed_watermark) == (j.max_inflight, j.shed_watermark)
    assert [t.threshold(p) for p in range(3)] == [j.threshold(p) for p in range(3)]
    with pytest.raises(ValueError):
        t.resize(0)


def test_sim_scales_admission_with_the_fleet():
    sim = T.ClusterSim(T.SimConfig(max_inflight=8, shed_watermark=6, initial_instances=3,
                                   admission_per_instance=True), [])
    assert (sim.admission.max_inflight, sim.admission.shed_watermark) == (24, 18)


def _fit(m) -> tuple:
    """A fitted model's numbers (the two packages' classes differ)."""
    return (vars(m.prefill_token_s), vars(m.itl_s), m.spec_tokens_per_dispatch, m.provision_s)


def _bench_lines(kind: str) -> list[dict]:
    return [{"metric": "decode_tiny_c0", "value": 10.0, "decode_window": 8,
             "dispatch": {kind: {"in_flight_p50_s": 0.016, "host_gap_p50_s": 0.0008}}},
            {"metric": "ttft_tiny_isl128_osl32", "value": 1.0, "p50_ttft_s": 0.256}]


@pytest.mark.parametrize("kind", ["ragged", "decode", "window"])
def test_bench_fit_reads_the_jax_kinds_and_the_ports_window(tmp_path, kind):
    path = tmp_path / "bench.jsonl"
    path.write_text("\n".join(json.dumps(d) for d in _bench_lines(kind)) + "\n")
    t = T.ServiceTimeModel.from_bench_json([path])
    assert t.itl_s.median_s == pytest.approx((0.016 + 0.0008) / 8)
    assert t.prefill_token_s.median_s == pytest.approx(0.256 / 128)
    if kind != "window":  # the JAX fit reads its own kinds alike
        j = J.ServiceTimeModel.from_bench_json([path])
        assert _fit(t) == _fit(j)


def test_span_fit_on_a_file_the_port_engine_recorded(tmp_path):
    """A CPU ``TorchEngine`` records a burst to a span file (prefill spans
    with prompt and cached tokens, decode spans with generated tokens and
    the dispatch profiler's medians); the port's fit reads the
    recorder's lines, and equals the JAX fit on the same spans (which
    reads bare span objects), also through ``from_telemetry``."""
    from dynamo_exp_tpu_torch import telemetry as tel
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_exp_tpu_torch.models import TINY

    eng = TorchEngine(EngineConfig(model=TINY, max_decode_slots=4, page_size=8, num_pages=64,
                                   max_model_len=128, prefill_chunk=16, decode_window=4,
                                   kv_dtype="float32", eos_token_ids=[]), device="cpu")
    path = tmp_path / "spans.jsonl"

    async def burst():
        async def one(i):
            with tel.span("http_request"):
                stream = await eng.generate({
                    "token_ids": [3 + (7 * i + k) % 200 for k in range(10 + 9 * i)],
                    "stop_conditions": {"max_tokens": 9 + i, "ignore_eos": True}})
            async for _ in stream:
                pass
        await asyncio.gather(*[one(i) for i in range(6)])

    eng.start()
    tel.get_telemetry().configure(str(path))
    try:
        asyncio.run(asyncio.wait_for(burst(), 120))
    finally:
        tel.get_telemetry().configure(None)
        eng.stop()
    events = [json.loads(line)["event"] for line in path.read_text().splitlines()]
    stages = {e["stage"] for e in events}
    assert {"prefill", "decode"} <= stages
    decode = [e for e in events if e["stage"] == "decode"]
    assert all("dispatch_p50_s" in e["attrs"] and e["attrs"]["decode_window"] == 4
               for e in decode)
    bare = tmp_path / "bare.jsonl"
    bare.write_text("".join(json.dumps(e) + "\n" for e in events))
    t = T.ServiceTimeModel.from_spans([path])
    j = J.ServiceTimeModel.from_spans([bare])
    assert _fit(t) == _fit(j)
    assert t.prefill_token_s != T.ServiceTimeModel.default().prefill_token_s
    assert T.ServiceTimeModel.from_spans([bare]) == t
    tt = T.ServiceTimeModel.from_telemetry(span_paths=[path])
    jt = J.ServiceTimeModel.from_telemetry(span_paths=[bare])
    assert _fit(tt) == _fit(jt) == _fit(t)
