"""The port's telemetry (``dynamo_exp_tpu_torch/telemetry/``) against the
JAX package's, on the CPU.

- ``prom.py`` renders what ``prometheus_client`` renders for the same
  families and increments: both texts parsed by ``prometheus_client``'s
  parser (and by ``telemetry.fleet.parse_prometheus_text``) give the same
  samples, ``_created`` aside (a hypothesis property over labels, label
  values that need escaping, and increments).
- The port's ``Telemetry`` hub registers JAX families only, each with
  the JAX family's type, labels and buckets; the JAX families it leaves
  out are listed by name, with the module that feeds them.
- ``SloAttribution``, ``FlightRecorder`` (dump without ``t``),
  ``Watchdog`` (one dump per stall episode, a fake clock) and
  ``DispatchProfiler`` (a fake clock; the port's ``mixed`` kind against
  the JAX ``ragged``) give the JAX results for the same numpy-seeded
  inputs; floats compared exactly unless stated.
- ``TorchEngine`` with graphs (a CPU stub of the CUDA graph runner) and
  without gives the same flight events (``t`` aside) and the same
  counter deltas, and ``dynamo_compile_seconds`` counts one sample per
  graph captured, by kind.
"""

import asyncio
import json
import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import prometheus_client
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from prometheus_client.parser import text_string_to_metric_families

from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.telemetry import dispatch as jdispatch
from dynamo_exp_tpu.telemetry import flight as jflight
from dynamo_exp_tpu.telemetry.fleet import parse_prometheus_text
from dynamo_exp_tpu.telemetry.slo import SloAttribution as JSlo
from dynamo_exp_tpu.telemetry.slo import SloConfig as JSloConfig
from dynamo_exp_tpu.telemetry.spans import Telemetry as JTelemetry
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.graphs import DispatchGraphs
from dynamo_exp_tpu_torch.models import params_from_jax
from dynamo_exp_tpu_torch.telemetry import dispatch as tdispatch
from dynamo_exp_tpu_torch.telemetry import flight as tflight
from dynamo_exp_tpu_torch.telemetry import get_telemetry, prom
from dynamo_exp_tpu_torch.telemetry.slo import SloAttribution, SloConfig
from dynamo_exp_tpu_torch.telemetry.spans import Telemetry

def samples(text: str) -> dict:
    """{(family, type): {(sample name, sorted labels): value}}, without
    the ``_created`` samples prometheus_client adds."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        out[(fam.name, fam.type)] = {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for s in fam.samples if not s.name.endswith("_created")
        }
    return out


# ------------------------------------------------------- exposition format
LABEL_VALUES = st.text(alphabet='ab"\\\n ,=é{}', min_size=0, max_size=5)


@st.composite
def families(draw):
    fams = []
    for i in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(["counter", "gauge", "histogram"]))
        labels = draw(st.lists(st.sampled_from(["stage", "kind", "code"]), max_size=2,
                               unique=True))
        buckets = sorted(draw(st.sets(st.sampled_from(
            [0.001, 0.25, 1, 2.5, 16, 1e7]), min_size=1, max_size=4)))
        ops = draw(st.lists(st.tuples(
            st.lists(LABEL_VALUES, min_size=len(labels), max_size=len(labels)),
            st.floats(0, 1e8, allow_nan=False)), max_size=6))
        name = f"fam{i}_{kind}" + ("_total" if kind == "counter" and i % 2 else "")
        fams.append((name, kind, labels, buckets, ops))
    return fams


@settings(max_examples=60, deadline=None)
@given(families())
def test_prom_text_parses_as_prometheus_clients(fams):
    jreg, treg = prometheus_client.CollectorRegistry(), prom.Registry()
    for name, kind, labels, buckets, ops in fams:
        help_ = f"help of {name} with \\ and\nnewline"
        cls = {"counter": "Counter", "gauge": "Gauge", "histogram": "Histogram"}[kind]
        kw = {"buckets": buckets} if kind == "histogram" else {}
        jm = getattr(prometheus_client, cls)(name, help_, labels, registry=jreg, **kw)
        tm = getattr(prom, cls)(name, help_, labels, registry=treg, **kw)
        for values, x in ops:
            jc = jm.labels(*values) if labels else jm
            tc = tm.labels(*values) if labels else tm
            method = {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind]
            for c in (jc, tc):
                getattr(c, method)(x)
    want = prometheus_client.generate_latest(jreg).decode()
    got = treg.render().decode()
    assert samples(got) == samples(want)
    assert parse_prometheus_text(got) == {
        k: v for k, v in parse_prometheus_text(want).items() if not k.endswith("_created")}
    # HELP / TYPE lines as prometheus_client writes them.
    assert [ln for ln in got.splitlines() if ln.startswith("#")] == [
        ln for ln in want.splitlines() if ln.startswith("#") and "_created" not in ln]


def test_hub_families_are_the_jax_families():
    """Both hubs register the same families, and the same increments
    into each give equal samples."""
    jtel, ttel = JTelemetry(), Telemetry()
    jfam = {f.name: f for f in jtel.registry.collect()}
    tfam = {f.name: f for f in ttel.registry.families()}
    assert set(tfam) == set(jfam)
    rs = np.random.RandomState(3)
    for attr, tm in vars(ttel).items():
        jm = getattr(jtel, attr, None)
        if attr == "engine_gauges":
            for key, g in tm.items():
                v = float(rs.rand())
                g.set(v)
                jm[key].set(v)
            continue
        if not isinstance(tm, (prom.Counter, prom.Gauge, prom.Histogram)):
            continue
        for _ in range(3):
            values = [f"v{rs.randint(2)}" for _ in tm.labelnames]
            x = float(rs.choice([0.0003, 0.02, 3.0, 70.0, 9.0]))
            method = {prom.Counter: "inc", prom.Gauge: "set", prom.Histogram: "observe"}[
                type(tm)]
            for m in (jm, tm):
                getattr(m.labels(*values) if tm.labelnames else m, method)(x)
    want, got = samples(jtel.render().decode()), samples(ttel.render().decode())
    assert set(got) <= set(want)
    for key, s in got.items():
        assert s == want[key], key


# -------------------------------------------------------------------- SLO
@pytest.mark.parametrize("ttft,itl", [(0.5, 0.05), (None, 0.05), (0.5, None), (None, None)])
def test_slo_attribution_matches_jax(ttft, itl):
    rs = np.random.RandomState(11)
    jtel, ttel = JTelemetry(), Telemetry()
    ja = JSlo(JSloConfig(ttft_s=ttft, itl_s=itl), jtel, window=64)
    ta = SloAttribution(SloConfig(ttft_s=ttft, itl_s=itl), ttel, window=64)
    for i in range(1500):
        prio = [0, 1, 2, "high"][rs.randint(4)]
        t = float(rs.exponential(0.4))
        lt = None if rs.rand() < 0.2 else float(rs.exponential(0.04))
        assert ta.record(prio, ttft_s=t, itl_s=lt) == ja.record(prio, ttft_s=t, itl_s=lt)
        if i % 500 == 499:
            assert ta.window_percentiles() == ja.window_percentiles()
            ta.reset_window()
            ja.reset_window()
    assert ta.completed == ja.completed == 1500
    assert ta.violations == ja.violations
    assert ta.goodput_by_priority == ja.goodput_by_priority
    assert ta.goodput_total == ja.goodput_total
    assert ta.burn_rates() == ja.burn_rates()
    want, got = samples(jtel.render().decode()), samples(ttel.render().decode())
    for fam in ("dynamo_slo_violations", "dynamo_goodput_requests", "dynamo_slo_burn_rate"):
        key = next(k for k in got if k[0] == fam)
        assert got[key] == want[key], fam


# ----------------------------------------------------------------- flight
def _events(rs, n):
    kinds = ["admit", "dispatch", "consume", "finish", "stall_start", "chain_break"]
    return [(kinds[rs.randint(len(kinds))], {"req": f"r{rs.randint(5)}",
                                              "slot": int(rs.randint(4)),
                                              "rows": int(rs.randint(9))}) for _ in range(n)]


def _strip_t(block):
    return {
        "header": {k: v for k, v in block["header"].items() if k not in ("t", "pid")},
        "events": [{k: v for k, v in e.items() if k != "t"} for e in block["events"]],
        "snapshot": {k: v for k, v in (block["snapshot"] or {}).items() if k != "t"},
    }


def test_flight_recorder_dump_matches_jax(tmp_path):
    rs = np.random.RandomState(5)
    evs = _events(rs, 50)
    jr, tr = jflight.FlightRecorder(capacity=32), tflight.FlightRecorder(capacity=32)
    for kind, data in evs:
        jr.record(kind, **data)
        tr.record(kind, **data)
    snap = {"slots": [{"slot": 1, "req": "r1", "state": "active", "generated": 3,
                       "pages": 2, "stalled": True}], "waiting": 2}
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    for reason in ("watchdog", "sigusr1"):
        jr.dump(jpath, reason, snapshot=snap)
        tr.dump(tpath, reason, snapshot=snap)
    jb, tb = jflight.load_dumps(jpath), tflight.load_dumps(tpath)
    assert [_strip_t(b) for b in tb] == [_strip_t(b) for b in jb]
    assert len(tb) == 2 and len(tb[0]["events"]) == 32 and tb[0]["events"][0]["seq"] == 18
    # The rendered timelines agree but for the wall offsets.
    strip = lambda s: [ln.split("s  ", 1)[-1] for ln in s.splitlines()[1:]]  # noqa: E731
    assert strip(tflight.render_flight(tb[0])) == strip(jflight.render_flight(jb[0]))


class FakeClock:
    """``time`` stand-in: ``monotonic`` moves only when told to."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    @staticmethod
    def time():
        return time.time()


def _watchdog_episodes(module, monkeypatch) -> list[int]:
    """Drive ``module.Watchdog`` through progress, a stall, a longer
    stall, progress, a second stall and idle time on a fake clock; the
    dump count after each step."""
    clock = FakeClock()
    monkeypatch.setattr(module, "time", clock)
    state = {"progress": 0, "busy": True, "polls": 0}
    polled = threading.Condition()

    def has_work():
        with polled:
            state["polls"] += 1
            polled.notify_all()
        return state["busy"]

    dumps = []
    wd = module.Watchdog(stall_s=10.0, progress=lambda: state["progress"], has_work=has_work,
                         dump_fn=dumps.append, poll_s=0.001)

    def settle():
        with polled:
            n = state["polls"]
            assert polled.wait_for(lambda: state["polls"] >= n + 3, timeout=10)

    counts = []
    wd.start()
    try:
        for step in (("tick", 5), ("tick", 5), ("advance", 11), ("advance", 30),
                     ("tick", 1), ("advance", 8), ("advance", 2), ("idle", 50),
                     ("busy", 0), ("advance", 10)):
            what, dt = step
            if what == "tick":
                state["progress"] += 1
            elif what == "idle":
                state["busy"] = False
            elif what == "busy":
                state["busy"] = True
            settle()
            clock.now += dt
            settle()
            counts.append(len(dumps))
    finally:
        wd.stop()
    assert all(d == "watchdog" for d in dumps)
    return counts


def test_watchdog_dumps_once_per_stall_episode_as_jax(monkeypatch):
    want = _watchdog_episodes(jflight, monkeypatch)
    got = _watchdog_episodes(tflight, monkeypatch)
    assert got == want == [0, 0, 1, 1, 1, 1, 2, 2, 2, 3]


# ----------------------------------------------------------------- profiler
def _profile(module, kinds, monkeypatch, tel):
    """A scripted run of begin/end/consume/idle on a fake clock: (op,
    kind, fresh, dt) steps from a seeded generator; returns the summary."""
    clock = FakeClock()
    monkeypatch.setattr(module, "time", clock)
    prof = module.DispatchProfiler(tel, reservoir=16)
    rs = np.random.RandomState(9)
    pending = {}
    for _ in range(300):
        kind = kinds[rs.randint(len(kinds))]
        op = rs.randint(4)
        clock.now += float(rs.exponential(0.01))
        if op == 0 or kind not in pending:
            t0 = prof.begin(kind)
            clock.now += float(rs.exponential(0.002))
            pending[kind] = prof.end(kind, t0, fresh=bool(rs.rand() < 0.1))
        elif op in (1, 2):
            prof.consume(kind, pending.pop(kind))
        else:
            prof.mark_idle()
    assert prof.first_variant("w", 1) and not prof.first_variant("w", 1)
    return prof.summary()


def test_dispatch_profiler_matches_jax_with_a_fake_clock(monkeypatch):
    jtel, ttel = JTelemetry(), Telemetry()
    jsum = _profile(jdispatch, ["ragged", "kv_move", "offload"], monkeypatch, jtel)
    tsum = _profile(tdispatch, ["mixed", "kv_move", "offload"], monkeypatch, ttel)
    assert tsum["mixed"] == jsum["ragged"] and tsum["window"]["count"] == 0
    for k in ("kv_move", "offload"):
        assert tsum[k] == jsum[k]
    assert jsum["ragged"]["compile_misses"] > 0 and jsum["ragged"]["host_gap_p50_s"]
    want, got = samples(jtel.render().decode()), samples(ttel.render().decode())
    for fam in ("dynamo_dispatch_seconds", "dynamo_host_gap_seconds", "dynamo_compile_seconds",
                "dynamo_compile_cache_misses"):
        key = next(k for k in got if k[0] == fam)
        rename = {(n, tuple((a, "ragged" if (a, v) == ("kind", "mixed") else v)
                            for a, v in lab)): x for (n, lab), x in got[key].items()}
        assert rename.keys() == want[key].keys(), fam
        for s, x in rename.items():
            assert x == pytest.approx(want[key][s], rel=1e-12), (fam, s)


# ----------------------------------------------------------- spans + files
def test_trace_file_lines_have_the_jax_recorder_shape(tmp_path):
    from dynamo_exp_tpu_torch.telemetry import span
    from dynamo_exp_tpu_torch.telemetry.context import current_trace

    tel = get_telemetry()
    path = tmp_path / "spans.jsonl"
    tel.configure(str(path))
    try:
        with span("http_request", model="m") as root:
            inner = current_trace()
            tel.emit_stage("queue_wait", 1.0, 1.5, inner, prompt_tokens=3, skipped=None)
            root.set(ttft_s=0.25)
    finally:
        tel.configure(None)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [set(ln) for ln in lines] == [{"ts", "event"}] * 2
    child, parent = (ln["event"] for ln in lines)
    assert child["stage"] == "queue_wait" and parent["stage"] == "http_request"
    assert child["trace_id"] == parent["trace_id"] and child["parent_span_id"] == parent["span_id"]
    assert child["attrs"] == {"prompt_tokens": 3, "instance": tel.instance}
    assert parent["attrs"]["ttft_s"] == 0.25 and parent["parent_span_id"] == ""
    assert lines[0]["ts"] == child["end"] == 1.5


# ---------------------------------------------- graphed and eager engines
CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
                 prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[])
PROMPTS = ([5, 9, 17, 23, 4, 31, 8, 2, 5, 9], [7, 3, 19, 28, 41, 13], [12, 60, 3, 3] * 6)
SAMPLING = [{}, {"temperature": 0.8, "seed": 21}, {"logprobs": 1}]


class StubRunner:
    """The CUDA graph runner's CPU stand-in: a capture runs the body once
    (all padding), a replay runs it again on the graph's buffers."""

    def capture(self, fn):
        fn()
        return fn

    @staticmethod
    def replay(fn):
        fn()

    @staticmethod
    def pool_bytes():
        return 0


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))


COUNTERS = ("dynamo_decode_wasted_steps", "dynamo_decode_batch_rows",
            "dynamo_engine_queue_wait_seconds", "dynamo_engine_prefill_seconds",
            "dynamo_engine_time_between_tokens_seconds", "dynamo_kv_page_moves",
            "dynamo_spec_draft_tokens", "dynamo_spec_accepted_tokens",
            "dynamo_spec_tokens_per_dispatch", "dynamo_stage_duration_seconds",
            "dynamo_compile_seconds", "dynamo_compile_cache_misses", "dynamo_dispatch_seconds",
            "dynamo_host_gap_seconds")


def counts(text: str) -> dict:
    """Per sample, the counter value or a histogram's ``_count`` (the
    times, sums and buckets of a timing family are wall readings)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _graph_burst(np_params, graphs: bool, chained: bool):
    # Chained: every row greedy (two sampler partitions never chain) and
    # no speculation (a row that wants a draft never chains).
    eng = TorchEngine(
        EngineConfig(model=CFG, chained_decode=chained, spec_mode="off" if chained else "ngram",
                     **ENGINE_KW),
        model=params_from_jax(np_params, CFG, device="cpu"), device="cpu",
    )
    if graphs:
        eng.graphs = DispatchGraphs(eng, runner=StubRunner())
    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext

    async def collect(stream):
        toks = []
        async for item in stream:
            toks += item.get("token_ids", [])
        return toks

    async def go():
        streams = [eng.submit({"token_ids": list(p),
                               "stop_conditions": {"max_tokens": 14, "ignore_eos": True},
                               "sampling_options": {} if chained else so},
                              AsyncEngineContext(f"r{i}"))
                   for i, (p, so) in enumerate(zip(PROMPTS, SAMPLING))]
        eng.start()
        return await asyncio.gather(*(collect(s) for s in streams))

    before = counts(get_telemetry().render().decode())
    try:
        out = asyncio.run(asyncio.wait_for(go(), 300))
    finally:
        eng.stop()
    after = counts(get_telemetry().render().decode())
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()
             if k[0].startswith(COUNTERS) and v != before.get(k, 0.0)}
    events = [{k: v for k, v in e.items() if k != "t"} for e in eng.flight.snapshot()]
    return out, events, delta, eng


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "unchained"])
def test_graphed_and_eager_runs_record_the_same_telemetry(np_params, chained):
    """The hooks sit outside the captured bodies: a graphed run (stub
    runner) and an eager one give the same flight events and counter
    deltas, chained (greedy rows) and unchained (greedy, seeded and
    logprob rows with ngram speculation). The compile families count one first use per key: the
    graphed run's captures by kind, the eager run's first dispatch of
    each key."""
    got, g_events, g_delta, geng = _graph_burst(np_params, True, chained)
    want, e_events, e_delta, eeng = _graph_burst(np_params, False, chained)
    assert got == want and all(len(t) == 14 for t in got)
    assert g_events == e_events
    assert {e["kind"] for e in g_events} >= {"admit", "dispatch", "consume", "first_token",
                                             "finish", "spec_accept" if not chained else
                                             "chain_break"}
    assert g_delta == e_delta
    m = geng.metrics()
    for kind in ("window", "mixed"):
        captured = m["graphs"][kind]["captured"]
        assert captured > 0
        assert g_delta[("dynamo_compile_cache_misses_total", (("kind", kind),))] == captured
        assert g_delta[("dynamo_compile_seconds_count", (("kind", kind),))] == captured
        assert m["dispatch"][kind]["compile_misses"] == captured
        assert eeng.metrics()["dispatch"][kind]["compile_misses"] == captured
    disp = m["dispatches"]
    assert sum(e["kind"] == "dispatch" and e["dispatch"] == "ragged" for e in g_events) == (
        disp["windowed"] + disp["mixed"])
    assert m["dispatch"]["window"]["count"] == disp["windowed"]
    assert m["dispatch"]["mixed"]["count"] == disp["mixed"]
    assert (sum(e["kind"] == "dispatch" and e.get("chained", False) for e in g_events)
            == disp["chained"]) and (disp["chained"] > 0) == chained


class _StepClock:
    """A monotonic clock that moves only when :meth:`step` moves it;
    ``step`` returns once the clock has been read after it (the
    watchdog reads it once a poll), or at once when nothing polls."""

    def __init__(self):
        self.now = 0.0
        self.reads = 0
        self._cv = threading.Condition()

    def monotonic(self) -> float:
        with self._cv:
            self.reads += 1
            self._cv.notify_all()
            return self.now

    def step(self, dt: float, polled: bool) -> None:
        with self._cv:
            self.now += dt
            seen = self.reads
            if polled:
                assert self._cv.wait_for(lambda: self.reads > seen, 60), "the watchdog stopped"


def test_watchdog_does_not_fire_across_slow_captures(np_params, tmp_path, monkeypatch):
    """Each capture counts as progress: a burst whose captures each take
    just over half the stall limit, several in a row, dumps nothing. The
    watchdog's clock is the test's own: it moves only inside a capture,
    and the capture waits until the watchdog has polled after that step,
    so the wall clock (a loaded host's) never counts as a stall, while
    two captures with no progress between them would fire it (as they
    do when a capture is not counted as progress)."""
    clock = _StepClock()
    monkeypatch.setattr(tflight, "time", SimpleNamespace(time=time.time,
                                                         monotonic=clock.monotonic))
    stall_s, step_s = 0.3, 0.3 * 0.55

    class SlowRunner(StubRunner):
        def capture(self, fn):
            clock.step(step_s, polled=eng._watchdog is not None)
            return super().capture(fn)

    eng = TorchEngine(
        EngineConfig(model=CFG, watchdog_stall_s=stall_s,
                     flight_dump_path=str(tmp_path / "f"), **ENGINE_KW),
        model=params_from_jax(np_params, CFG, device="cpu"), device="cpu",
    )
    eng.graphs = DispatchGraphs(eng, runner=SlowRunner())

    async def go():
        streams = [eng.submit({"token_ids": list(p),
                               "stop_conditions": {"max_tokens": 24, "ignore_eos": True},
                               "sampling_options": so})
                   for p, so in zip(PROMPTS, SAMPLING)]
        eng.start()
        for s in streams:
            async for _ in s:
                pass

    try:
        asyncio.run(asyncio.wait_for(go(), 300))
        assert eng._watchdog is not None and eng._watchdog.dumps == 0
    finally:
        eng.stop()
    captured = sum(g["captured"] for g in eng.metrics()["graphs"].values())
    assert captured >= 4 and clock.now >= captured * step_s - 1e-9 >= 2 * stall_s
    assert clock.reads > captured  # the watchdog polled the test's clock
    assert not (tmp_path / "f").exists()
