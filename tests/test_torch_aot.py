"""Warm boot in the port (``dynamo_exp_tpu_torch/aot``), on the CPU.

- The window lattice: every key a CPU engine dispatches over a
  chained / unchained burst with greedy, seeded, penalized and
  logprob rows (``tests/test_torch_chained.py``'s shape) is in
  ``build_manifest(cfg)``; the manifest's hash is the same in two
  processes; its rows buckets are the JAX package's
  ``windowed_token_buckets`` on the same config.
- ``prewarm`` leaves the KV pools and penalty counts bit-identical to a
  cold engine's, and a following burst's tokens too; it refuses a
  running engine; with ``--compile-cache-dir`` it writes
  ``manifest.json`` (no kernel build on the CPU).
- Graph bookkeeping: the CUDA graph runner is replaced by a CPU stub
  that runs the captured dispatch (a window or a mixed dispatch) on the
  graph's own input and output buffers (a capture records the kernel
  wrappers' launches; a replay runs the body again, uncounted). Tokens
  equal the eager engine's, and the launch counters equal the eager
  run's, which equal, for each graph, its replays times its recorded
  launches: every window and every mixed dispatch is a replay. A
  prewarmed engine (speculation on) captures every window and mixed
  key, verify spans' too, and its traffic captures none, with the eager
  engine's tokens and logprobs.
- ``run.py --prewarm --compile-cache-dir`` parse as the JAX CLI's and
  prewarm the engine; ``cuda_graphs=True`` on the CPU raises.
"""

import asyncio
import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu import run as jrun
from dynamo_exp_tpu.aot import lattice as jlattice
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.models import TINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.aot import build_manifest, lattice, prewarm_engine, read_manifest
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.graphs import DispatchGraphs
from dynamo_exp_tpu_torch.models import llama as tllama
from dynamo_exp_tpu_torch.models import params_from_jax
from dynamo_exp_tpu_torch.ops import launches as tlaunches
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(
    max_decode_slots=4, page_size=8, num_pages=64, max_model_len=128,
    prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
)
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11, 44, 2, 9]
P3 = [12, 60, 3, 3, 90]
SAMPLING = [
    {},
    {"temperature": 0.8, "seed": 21, "top_k": 30},
    {"temperature": 0.7, "seed": 5, "frequency_penalty": 0.5, "presence_penalty": 0.3,
     "repetition_penalty": 1.2, "logprobs": 2},
]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))


def _engine(np_params, **kw):
    cfg = EngineConfig(model=CFG, **{**ENGINE_KW, **kw})
    return TorchEngine(cfg, model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")


async def _collect(eng, prompt, n, **sampling):
    stream = eng.submit({
        "token_ids": list(prompt),
        "stop_conditions": {"max_tokens": n, "ignore_eos": True},
        "sampling_options": sampling,
    })
    out = []
    async for item in stream:
        out.extend(item.get("token_ids", []))
    return out


async def _burst(eng, n=24):
    """P1..P3 queued before the loop starts (admitted together): a
    greedy, a seeded and a penalized row asking for logprobs; then a
    longer greedy prompt alone, asking for logprobs (one row, a page
    bound past the floor)."""
    jobs = [asyncio.ensure_future(_collect(eng, p, n, **so))
            for p, so in zip((P1, P2, P3), SAMPLING)]
    await asyncio.sleep(0)
    eng.start()
    out = await asyncio.gather(*jobs)
    out.append(await _collect(eng, P1 + [3] * 32, 40, logprobs=1))
    return out


def _keys_spy(eng) -> list:
    keys = []
    launch = eng._launch_window

    def spy(rows, key, *a, **kw):
        keys.append(key)
        return launch(rows, key, *a, **kw)

    eng._launch_window = spy
    return keys


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "unchained"])
def test_every_dispatched_window_key_is_in_the_manifest(np_params, chained):
    eng = _engine(np_params, chained_decode=chained)
    keys = _keys_spy(eng)
    try:
        out = _run(_burst(eng))
    finally:
        eng.stop()
    assert all(len(t) == n for t, n in zip(out, (24, 24, 24, 40)))
    manifest = build_manifest(eng.cfg, eng.attn_impl)
    assert keys and set(keys) <= set(manifest.windows)
    assert len(set(keys)) >= 3  # several rows / pages / sampler / logprob variants
    assert len({k.pages for k in keys}) > 1
    assert any(k.rows < eng.cfg.max_decode_slots for k in keys)  # padded, not exact


@pytest.mark.parametrize("slots", [1, 3, 4, 6, 8])
def test_rows_buckets_equal_the_jax_lattice(slots):
    tcfg = EngineConfig(model=CFG, **{**ENGINE_KW, "max_decode_slots": slots})
    jcfg = JEngineConfig(model=CFG, **{**ENGINE_KW, "max_decode_slots": slots})
    assert lattice.windowed_row_buckets(tcfg) == jlattice.windowed_token_buckets(jcfg)
    assert lattice.page_bound_buckets(tcfg)[-1] == tcfg.max_pages_per_seq
    manifest = build_manifest(tcfg, "reference")
    rows = len(lattice.windowed_row_buckets(tcfg))
    pages = len(lattice.page_bound_buckets(tcfg))
    assert len(manifest) == rows * pages * 2 * 2


def test_resolve_window_key_pads_rows_and_pages():
    cfg = EngineConfig(model=CFG, **{**ENGINE_KW, "max_decode_slots": 6,
                                     "max_model_len": 2048, "page_size": 16})
    k = lattice.resolve_window_key(cfg, 3, 5, True, False)
    assert (k.rows, k.pages, k.full_sampler, k.want_lp) == (4, 8, True, False)
    assert lattice.resolve_window_key(cfg, 5, 1, False, True).rows == 6  # capped at the slots
    assert lattice.resolve_window_key(cfg, 1, 1, False, False).pages == 4  # 64-token floor
    assert lattice.resolve_window_key(cfg, 1, 128, False, False).pages == 128


_HASH = """
from dynamo_exp_tpu_torch.aot import build_manifest
from dynamo_exp_tpu_torch.engine import EngineConfig
from dynamo_exp_tpu_torch.models import LLAMA_8B
cfg = EngineConfig(model=LLAMA_8B, max_decode_slots=8, max_model_len=2096, num_pages=1048)
print(build_manifest(cfg, "kernel").hash())
"""


def test_manifest_hash_is_stable_across_processes():
    from dynamo_exp_tpu_torch.models import LLAMA_8B

    env = dict(os.environ, PYTHONPATH=REPO)
    hashes = {
        subprocess.run([sys.executable, "-c", _HASH], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=120, check=True).stdout.strip()
        for _ in range(2)
    }
    cfg = EngineConfig(model=LLAMA_8B, max_decode_slots=8, max_model_len=2096, num_pages=1048)
    assert hashes == {build_manifest(cfg, "kernel").hash()}
    other = build_manifest(replace(cfg, decode_window=4), "kernel")
    assert other.hash() not in hashes


def test_prewarm_leaves_the_engine_as_a_cold_one(np_params, tmp_path):
    cold, warm = _engine(np_params), _engine(np_params)
    report = prewarm_engine(warm, cache_dir=str(tmp_path / "cache"))
    manifest = build_manifest(warm.cfg, warm.attn_impl)
    assert report.variants == len(manifest) and report.graphs == 0 and report.builds == 0
    assert report.mixed_variants == len(manifest.mixed) > 0 and report.mixed_graphs == 0
    assert warm.metrics()["prewarm"]["variants"] == report.variants
    record = read_manifest(str(tmp_path / "cache"))
    assert record["manifest_hash"] == manifest.hash() == report.manifest_hash
    assert set(record["kernels"]) >= {"ragged_mixed_tc.cu", "ragged_decode_split.cu", "nvcc_flags"}
    for name in ("k_cache", "v_cache", "_counts"):
        assert getattr(warm, name).equal(getattr(cold, name)), name
    try:
        want, got = _run(_burst(cold)), _run(_burst(warm))
    finally:
        cold.stop()
        warm.stop()
    assert got == want
    warm.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            prewarm_engine(warm)
    finally:
        warm.stop()


# ------------------------------------------------- graph bookkeeping
class _StubRunner:
    """A CUDA graph runner for the CPU: a capture runs the window once
    (all padding: nothing lands) and records its launches; a replay
    runs it again on the graph's own buffers, its launches not counted
    (the engine adds the capture's record, as for a real graph)."""

    def __init__(self):
        self.replays: dict[int, int] = {}

    def capture(self, fn):
        fn()
        return fn

    def replay(self, fn):
        with tlaunches.record():
            fn()
        self.replays[id(fn)] = self.replays.get(id(fn), 0) + 1

    @staticmethod
    def pool_bytes():
        return 0


def test_prewarm_after_traffic_replays_only_padding(np_params):
    """An engine that served traffic and stopped may be prewarmed. A
    key its traffic captured still holds the last real dispatch in its
    inputs; prewarm uploads padding before the replay, so the KV pools
    and penalty counts stay as the traffic left them (the scratch page
    past the pool, which prewarm zeroes, aside) and every window and
    mixed dispatch it runs is all padding."""
    eng = _engine(np_params)
    eng.graphs = DispatchGraphs(eng, runner=_StubRunner())
    try:
        _run(_burst(eng))
    finally:
        eng.stop()
    traffic_keys = set(eng.graphs.graphs)
    assert any(k.full_sampler for k in traffic_keys)
    assert {type(k) for k in traffic_keys} == {lattice.WindowKey, lattice.MixedKey}
    pool = slice(0, eng._drop_page)
    state = lambda: (eng.k_cache[:, pool], eng.v_cache[:, pool], eng._counts)  # noqa: E731
    before = [t.clone() for t in state()]
    seen, window_body, mixed_body = [], eng._window_body, eng._mixed_body
    scratch = eng.cfg.max_decode_slots

    def window_spy(key, ins):
        seen.append((key, bool((ins["positions"] < 0).all()), bool(
            (ins["slot"] == scratch).all())))
        return window_body(key, ins)

    def mixed_spy(key, ins):
        seen.append((key, bool((ins["positions"] < 0).all()), bool(
            (ins["row_of"] == scratch).all())))
        return mixed_body(key, ins)

    eng._window_body, eng._mixed_body = window_spy, mixed_spy
    report = prewarm_engine(eng)
    manifest = build_manifest(eng.cfg, eng.attn_impl)
    assert report.variants == len(manifest) and report.mixed_variants == len(manifest.mixed)
    windows = {k for k in traffic_keys if isinstance(k, lattice.WindowKey)}
    assert report.graphs == report.variants - len(windows)
    assert report.mixed_graphs == report.mixed_variants - len(traffic_keys - windows)
    assert {k for k, _, _ in seen} >= traffic_keys
    assert all(padding and scratch for _, padding, scratch in seen)
    for name, now, then in zip(("k_cache", "v_cache", "_counts"), state(), before):
        assert now.equal(then), name


@pytest.fixture
def counted_wrappers(monkeypatch):
    """The kernel wrappers' CPU path (the plain version) counted as the
    card's launches are, so a CPU run has launch counts."""
    mixed, decode = tllama.ragged_paged_attention, tllama.ragged_decode_attention

    def mixed_c(q, *a, **kw):
        out = mixed(q, *a, **kw)
        tra._count("ragged_paged_attention", "mixed_f32")
        return out

    def decode_c(q, *a, **kw):
        out = decode(q, *a, **kw)
        tra._count("ragged_decode_attention", "decode_split")
        return out

    monkeypatch.setattr(tllama, "ragged_paged_attention", mixed_c)
    monkeypatch.setattr(tllama, "ragged_decode_attention", decode_c)


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "unchained"])
def test_graph_replays_count_the_eager_launches(np_params, counted_wrappers, chained):
    def go(graphs: bool):
        eng = _engine(np_params, attention_impl="kernel", chained_decode=chained)
        runner = None
        if graphs:
            runner = _StubRunner()
            eng.graphs = DispatchGraphs(eng, runner=runner)
        tlaunches.reset()
        try:
            out = _run(_burst(eng))
        finally:
            eng.stop()
        return out, dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES), eng, runner

    want, launches, designs, eager, _ = go(False)
    got, g_launches, g_designs, eng, runner = go(True)
    assert got == want
    assert g_launches == launches and g_designs == designs
    assert launches["ragged_decode_attention"] > 0 and launches["ragged_paged_attention"] > 0
    m = eng.metrics()
    assert m["graphs_captured"] == len(eng.graphs.graphs) == m["compiled_ragged_variants"] > 1
    assert m["graph_capture_seconds"] > 0 and eager.metrics()["graph_capture_seconds"] == 0
    disp = m["dispatches"]
    assert m["graph_replays"] == sum(runner.replays.values()) == disp["windowed"] + disp["mixed"]
    assert m["graphs"]["window"]["replays"] == disp["windowed"]
    assert m["graphs"]["mixed"]["replays"] == disp["mixed"] > 0
    assert eager.metrics()["graphs"] == {} and eager.metrics()["graph_replays"] == 0
    replayed = {
        name: sum(runner.replays.get(id(g.graph), 0) * g.launches["attention_entries"][name]
                  for g in eng.graphs.graphs.values())
        for name in tra.LAUNCHES
    }
    # Every launch of the graphed run is a replay's: windows launch only
    # the decode kernel, mixed dispatches only the mixed one.
    assert replayed == launches
    for key, g in eng.graphs.graphs.items():
        assert g.replays == runner.replays[id(g.graph)]
        layers = eng.cfg.model.num_layers
        if isinstance(key, lattice.MixedKey):
            assert g.launches["attention_entries"] == {"ragged_paged_attention": layers,
                                             "ragged_decode_attention": 0}
        else:
            assert g.launches["attention_entries"] == {"ragged_paged_attention": 0,
                                             "ragged_decode_attention":
                                             eng.cfg.decode_window * layers}
    assert eager.metrics()["dispatches"] == m["dispatches"]


async def _lp_burst(eng):
    """``_burst``'s rows with their logprobs, and a row the n-gram
    drafter predicts (verify spans), admitted together."""
    async def collect(prompt, n, **so):
        stream = eng.submit({"token_ids": list(prompt), "sampling_options": so,
                             "stop_conditions": {"max_tokens": n, "ignore_eos": True}})
        out = []
        async for item in stream:
            out.append((item.get("token_ids", []), item.get("logprobs")))
        return out

    jobs = [asyncio.ensure_future(collect(p, 20, **so)) for p, so in zip((P1, P2, P3), SAMPLING)]
    jobs.append(asyncio.ensure_future(collect([5, 9, 17, 3] * 5, 20, logprobs=1)))
    await asyncio.sleep(0)
    eng.start()
    return await asyncio.gather(*jobs)


def test_prewarmed_graphs_serve_traffic_without_capture(np_params, counted_wrappers):
    """Speculation on, the kernel wrappers' spans: prewarm captures every
    window and mixed key of the manifest (verify-span keys too); the
    burst then replays every dispatch, mixed ones through
    ``graphs.get(MixedKey)``, captures nothing, and gives the eager
    engine's tokens, logprobs and launch counts."""
    def go(graphs: bool):
        eng = _engine(np_params, attention_impl="kernel", spec_mode="ngram")
        gets = []
        if graphs:
            eng.graphs = DispatchGraphs(eng, runner=_StubRunner())
            get = eng.graphs.get
            eng.graphs.get = lambda key: gets.append(key) or get(key)
        report = prewarm_engine(eng)
        tlaunches.reset()
        try:
            out = _run(_lp_burst(eng))
        finally:
            eng.stop()
        return out, dict(tra.KERNEL_LAUNCHES), eng, report, gets

    want, launches, eager, _, _ = go(False)
    got, g_launches, eng, report, gets = go(True)
    assert got == want and g_launches == launches
    manifest = build_manifest(eng.cfg, eng.attn_impl)
    assert any(k.with_spec for k in manifest.mixed)
    assert report.mixed_graphs == report.mixed_variants == len(manifest.mixed)
    assert report.graphs == report.variants == len(manifest)
    m = eng.metrics()
    assert m["graphs_captured"] == report.graphs + report.mixed_graphs
    assert m["prewarmed_variants"] == len(manifest) + len(manifest.mixed)
    mixed = [k for k in gets[len(manifest) + len(manifest.mixed):]
             if isinstance(k, lattice.MixedKey)]
    assert len(mixed) == m["dispatches"]["mixed"] == eager.metrics()["dispatches"]["mixed"]
    assert any(k.with_spec for k in mixed) and m["spec_row_dispatches"] > 0
    assert m["graphs"]["mixed"]["replays"] == report.mixed_variants + len(mixed)


def test_record_launches_keeps_launches_apart_until_added():
    tlaunches.reset()
    with tlaunches.record() as rec:
        tra._count("ragged_decode_attention", "decode_split")
        with tlaunches.record() as inner:
            tra._count("ragged_paged_attention", "mixed_tc_bf16")
        tra._count("ragged_decode_attention", "decode_split")
    assert sum(tra.LAUNCHES.values()) == sum(tra.KERNEL_LAUNCHES.values()) == 0
    assert rec["attention_entries"] == {"ragged_paged_attention": 0, "ragged_decode_attention": 2}
    assert inner["attention_kernels"]["mixed_tc_bf16"] == 1
    for _ in range(3):  # three replays
        tlaunches.add(rec)
    tra._count("ragged_paged_attention", "mixed_f32")
    assert tra.LAUNCHES == {"ragged_paged_attention": 1, "ragged_decode_attention": 6}
    assert tra.KERNEL_LAUNCHES == {"mixed_tc_bf16": 0, "mixed_f32": 1, "decode_split": 6}
    tlaunches.reset()


def test_cuda_graphs_true_on_the_cpu_raises(np_params):
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA device"):
        _engine(np_params, cuda_graphs=True)
    assert _engine(np_params).graphs is None
    assert _engine(np_params, cuda_graphs=False).graphs is None


# ------------------------------------------------------------- run.py
SMALL = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32", "--max-tokens", "6"]


def test_prewarm_flags_parse_as_the_jax_cli_and_prewarm(tiny_model_dir, tmp_path):
    cache = str(tmp_path / "cc")
    argv = ["in=http", "out=cuda", "--model-path", tiny_model_dir, "--random-weights",
            *SMALL, "--prewarm", "--compile-cache-dir", cache]
    opts, jopts = run.parse_args(argv + ["--device", "cpu"]), jrun.parse_args(argv)
    assert (opts.prewarm, opts.compile_cache_dir) == (jopts.prewarm, jopts.compile_cache_dir)
    engine, _ = run.build_cuda_engine(opts)
    try:
        report = engine.metrics()["prewarm"]
        assert report["variants"] == len(build_manifest(engine.cfg, engine.attn_impl))
        assert report["builds"] == 0 and report["graphs"] == 0
        with open(os.path.join(cache, "manifest.json")) as f:
            assert json.load(f)["manifest_hash"] == report["manifest_hash"]
    finally:
        engine.stop()
    cold, _ = run.build_cuda_engine(run.parse_args(argv[:-3] + ["--device", "cpu"]))
    assert cold.metrics()["prewarm"] is None
