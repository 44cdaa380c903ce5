"""Port parity: the autotuner (``dynamo_exp_tpu_torch/tune/``) against the
JAX package's (``dynamo_exp_tpu/tune/``), and ``llmctl sim|tune|aot``.

- **Registry**: the knobs (names, owners, kinds, grids, sim / live
  flags, sim mirrors) equal the JAX registry's, so ``space_digest`` and
  ``config_hash`` do too; the registry walk covers every scalar field of
  the port's ``EngineConfig``, ``PlannerConfig``, ``SloTargets`` and
  ``SimConfig`` (bool / int / float defaults and the optional scalars
  such as ``cuda_graphs: bool | None``), registered or allowlisted,
  never both, none stale.
- **Search**: the same seed, budget and target give byte-identical
  journals and the same ``best_overrides`` in both packages (synthetic
  targets, a fingerprint target, the planner's knobs); a torn journal
  resumes byte-identical; a foreign one is refused.
- **Validation**: the contrasting pair ``[{}, {"max_inflight": 1}]``
  ranks the default first in the sim and on a CPU ``TorchEngine``: tau
  1.0.
- **Artifact**: a boot from it hashes to its ``config_hash``, builds
  nothing, captures nothing under traffic after ``prewarm_engine`` with
  its manifest, and a second boot's tokens equal the first's.
- **CLI**: ``llmctl sim``, ``tune --check`` and ``aot list|smoke`` exit
  0 (``--device cpu``); ``tune --top-k`` and ``aot warm|smoke`` on the
  default device exit 2 where there is no card.
"""

import asyncio
import contextlib
import io
import json
import os
from dataclasses import MISSING, fields

import pytest
import torch

from dynamo_exp_tpu.tune import search as JS
from dynamo_exp_tpu.tune import space as JSp
from dynamo_exp_tpu_torch import llmctl
from dynamo_exp_tpu_torch.engine import TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.telemetry.fingerprint import WorkloadFingerprint, load_fingerprint
from dynamo_exp_tpu_torch.tune import (
    SearchSettings,
    TuneResult,
    TuneTarget,
    build_artifact,
    catalog_entry_from_artifact,
    engine_config_from_artifact,
    evaluate,
    load_artifact,
    manifest_from_artifact,
    run_search,
    target_from_fingerprint,
    top_candidates,
    validate_candidates,
    write_artifact,
)
from dynamo_exp_tpu_torch.tune import search as TS
from dynamo_exp_tpu_torch.tune import space

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tune_fingerprint.json")


# ------------------------------------------------------------- registry
def test_knobs_equal_the_jax_registry():
    def spec(k):
        return (k.name, k.owner, k.kind, k.grid, k.sim, k.live, k.sim_field)

    assert [spec(k) for k in space.KNOBS] == [spec(k) for k in JSp.KNOBS]
    assert space.space_digest() == JSp.space_digest()
    knobs = space.defaults("engine")
    assert knobs == JSp.defaults("engine")
    assert space.config_hash(knobs) == JSp.config_hash(knobs)
    assert space.defaults() == JSp.defaults()


def _scalar_fields(cls) -> set[str]:
    """What the registry must decide: fields with a bool / int / float
    default, and the optional scalars (``bool | None`` and the like)."""
    optional = {"bool | None", "int | None", "float | None"}
    return {
        f.name for f in fields(cls)
        if (f.default is not MISSING and isinstance(f.default, (bool, int, float)))
        or (f.default is None and str(f.type) in optional)
    }


@pytest.mark.parametrize("owner", ["engine", "planner", "slo", "sim"])
def test_registry_covers_every_scalar_config_field(owner):
    cls = space.owner_classes()[owner]
    scalar = _scalar_fields(cls)
    registered = {k.name for k in space.KNOBS if k.owner == owner}
    allowed = space.NON_TUNABLE[owner]
    assert not scalar - registered - allowed, f"{owner}: undecided {scalar - registered - allowed}"
    assert not registered & allowed
    assert not allowed - scalar, f"{owner}: stale NON_TUNABLE {allowed - scalar}"
    assert not registered - scalar
    # Nothing of the JAX-only fields is left, and the budget is the card's.
    assert not {"pallas_interpret", "max_tpu_budget"} & allowed
    if owner == "engine":
        assert "cuda_graphs" in scalar and "cuda_graphs" in allowed
    if owner == "planner":
        assert {"max_gpu_budget", "decode_engine_num_gpu", "prefill_engine_num_gpu"} <= allowed


def test_registry_defaults_sit_on_their_grids_and_map_like_jax():
    for knob in space.KNOBS:
        assert space.default_value(knob) in knob.grid, knob.name
    over = {"max_decode_slots": 16, "max_inflight": 32, "decode_window": 8}
    assert space.sim_kwargs_from_overrides(over) == JSp.sim_kwargs_from_overrides(over)
    assert space.engine_kwargs_from_overrides(over) == JSp.engine_kwargs_from_overrides(over)
    assert space.split_overrides(over) == JSp.split_overrides(over)
    with pytest.raises(KeyError):
        space.split_overrides({"not_a_knob": 1})
    assert space.render_knob_table().splitlines()[0].startswith("| knob |")


# --------------------------------------------------------------- search
CASES = {
    "burst": (dict(kind="synthetic", name="burst", requests=16), dict(seed=3, budget=10)),
    "ramp": (dict(kind="synthetic", name="ramp", requests=16, rate_rps=2.0, duration_s=20.0),
             dict(seed=1, budget=12, eval_seeds=1)),
    "fingerprint": ("fixture", dict(seed=0, budget=10)),
    "planner": (dict(kind="synthetic", name="ramp", requests=16, rate_rps=2.0,
                     duration_s=20.0), dict(seed=2, budget=8, eval_seeds=1, planner=True)),
}


def _case(pkg_search, case):
    tgt, st = CASES[case]
    if tgt == "fixture":
        from dynamo_exp_tpu.telemetry.fingerprint import load_fingerprint as jload

        loader = load_fingerprint if pkg_search is TS else jload
        target = pkg_search.target_from_fingerprint(loader(FIXTURE), requests=16)
    else:
        target = pkg_search.TuneTarget(**tgt)
    settings = pkg_search.SearchSettings(**dict(dict(eval_seeds=2, base_sim={
        "initial_instances": 1}), **st))
    return target, settings


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_journal_equals_jax(case, tmp_path):
    t_path, j_path = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    tr = TS.run_search(*_case(TS, case), journal_path=t_path)
    jr = JS.run_search(*_case(JS, case), journal_path=j_path)
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    assert tr.best_overrides == jr.best_overrides and tr.trials == jr.trials
    assert top_candidates(tr, 3) == JS.top_candidates(jr, 3)


def test_truncated_journal_resumes_byte_identical_and_refuses_a_foreign_one(tmp_path):
    path = str(tmp_path / "j.jsonl")
    target, settings = _case(TS, "burst")
    run_search(target, settings, journal_path=path)
    with open(path, "rb") as f:
        full = f.read()
    with open(path, "w") as f:
        f.write("\n".join(full.decode().splitlines()[:5]) + '\n{"kind": "tri')
    run_search(target, settings, journal_path=path, resume=True)
    with open(path, "rb") as f:
        assert f.read() == full
    with pytest.raises(ValueError, match="different run"):
        run_search(target, SearchSettings(seed=4, budget=10, eval_seeds=2,
                                          base_sim={"initial_instances": 1}),
                   journal_path=path, resume=True)


def test_evaluate_and_top_candidates_as_jax():
    target = TuneTarget(kind="synthetic", name="burst", requests=8)
    settings = SearchSettings(seed=3, budget=10, eval_seeds=2)
    workload = target.workload(123)
    assert evaluate({}, target, settings, seed=999, workload=workload) == JS.evaluate(
        {}, JS.TuneTarget(kind="synthetic", name="burst", requests=8),
        JS.SearchSettings(seed=3, budget=10, eval_seeds=2), seed=999,
        workload=JS.TuneTarget(kind="synthetic", name="burst", requests=8).workload(123))
    assert evaluate({}, target, settings, seed=123, workload=workload) == evaluate(
        {}, target, settings, seed=123)

    def trial(overrides, rung, score):
        return {"kind": "trial", "overrides": overrides, "rung": rung, "score": score}

    result = TuneResult(best_overrides={}, best_score=3.0, default_score=1.0, trials=5,
                        journal=[{"kind": "header"}, trial({}, 1, 1.0), trial({"a": 1}, 0, 9.0),
                                 trial({"a": 1}, 1, 3.0), trial({"a": 1}, 1, 2.5),
                                 trial({"b": 2}, 1, 2.0)], target_digest="t", seed=0)
    assert top_candidates(result, 9) == [{"a": 1}, {"b": 2}, {}]


# ----------------------------------------------------------- validation
def test_sim_and_live_rank_agree_on_contrasting_candidates():
    fp = WorkloadFingerprint(n=48, isl_hist=(0, 0, 0, 48, 0, 0, 0, 0, 0, 0, 0),
                             osl_hist=(0, 0, 0, 48, 0, 0, 0, 0, 0, 0, 0),
                             priority_mix=(0.0, 1.0, 0.0), arrival_rate_rps=8.0)
    verdict = asyncio.run(validate_candidates(
        [{}, {"max_inflight": 1}], target_from_fingerprint(fp), seed=5, n=8,
        slo_ttft_s=1e9, slo_itl_s=1e9, device="cpu"))
    assert verdict["kendall_tau"] == 1.0 and verdict["top1_agreement"] and verdict["agreed"]
    assert verdict["sim_scores"][0] > verdict["sim_scores"][1]
    assert verdict["live_scores"][0] > verdict["live_scores"][1]
    live = verdict["candidates"][0]["live"]
    assert live["device"] == "cpu" and live["layers"] == TINY.num_layers


def test_validation_refuses_the_cpu_unless_asked():
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(validate_candidates([{}], TuneTarget(kind="synthetic", name="burst"),
                                        seed=0, n=2))


# ------------------------------------------------------------- artifact
def _result() -> TuneResult:
    return TuneResult(best_overrides={"max_decode_slots": 2, "num_pages": 64, "page_size": 8,
                                      "prefill_chunk": 16, "decode_window": 4},
                      best_score=2.0, default_score=1.0, trials=7, journal=[],
                      target_digest="fixture", seed=0)


async def _collect(engine, prompt, max_tokens=8):
    stream = await engine.generate({"token_ids": list(prompt),
                                    "stop_conditions": {"max_tokens": max_tokens,
                                                        "ignore_eos": True}})
    toks = []
    async for item in stream:
        toks.extend(item.get("token_ids", []))
    return toks


def test_artifact_round_trip_boots_with_zero_builds_and_captures(tmp_path):
    from dynamo_exp_tpu.tune import artifact as jart
    from dynamo_exp_tpu_torch.aot import manifest_for_engine, prewarm_engine

    fp = load_fingerprint(FIXTURE)
    shape = {"max_model_len": 128, "kv_dtype": "float32"}
    art0 = build_artifact(_result(), preset="tiny", shape=shape, fingerprint=fp)
    assert art0["config_hash"] == jart.build_artifact(_result(), preset="tiny")["config_hash"]
    probe = TorchEngine(engine_config_from_artifact(art0, model=TINY), device="cpu")
    art = build_artifact(_result(), preset="tiny", shape=shape,
                         manifest=manifest_for_engine(probe), fingerprint=fp)
    path = str(tmp_path / "tuned.json")
    write_artifact(art, path)
    art = load_artifact(path)
    manifest = manifest_from_artifact(art)
    assert manifest.hash() == manifest_for_engine(probe).hash()
    cache = str(tmp_path / "cache")

    def boot():
        cfg = engine_config_from_artifact(art, model=TINY)
        assert space.config_hash(space.resolved_engine_knobs(cfg)) == art["config_hash"]
        eng = TorchEngine(cfg, device="cpu")
        report = prewarm_engine(eng, manifest_from_artifact(art), cache_dir=cache)
        eng.start()
        try:
            toks = asyncio.run(_collect(eng, range(20, 36)))
            m = eng.metrics()
        finally:
            eng.stop()
        return report, m, toks

    r1, m1, toks1 = boot()
    r2, m2, toks2 = boot()
    assert r1.builds == r2.builds == 0 and r2.variants == len(manifest.windows)
    for m in (m1, m2):
        assert all(m["dispatch"][k]["compile_misses"] == 0 for k in ("window", "mixed"))
    assert toks1 == toks2 and len(toks1) == 8
    assert os.path.exists(os.path.join(cache, "manifest.json"))
    entry = catalog_entry_from_artifact(art, name="tuned-burst")
    assert entry.config_hash == art["config_hash"] and dict(entry.overrides) == art["overrides"]
    assert entry.fingerprint.digest() == fp.digest()


def test_artifact_guards(tmp_path):
    art = build_artifact(_result(), preset="tiny")
    assert art["fingerprint"] is None and manifest_from_artifact(art) is None
    with pytest.raises(ValueError, match="no target fingerprint"):
        catalog_entry_from_artifact(art)
    path = str(tmp_path / "a.json")
    write_artifact(dict(art, version=99), path)
    with pytest.raises(ValueError, match="version"):
        load_artifact(path)


# ------------------------------------------------------------------ CLI
def _llmctl(*argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = llmctl.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_llmctl_sim_matches_the_jax_cli(tmp_path):
    from dynamo_exp_tpu import llmctl as jctl

    argv = ["sim", "ramp", "--seed", "7", "--duration-s", "30", "--planner", "slo",
            "--trace-out", str(tmp_path / "t.jsonl")]
    rc, out, _ = _llmctl(*argv[:-1], str(tmp_path / "t.jsonl"), "--max-gpu-budget", "4")
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout), contextlib.redirect_stderr(io.StringIO()):
        jrc = jctl.main(argv[:-1] + [str(tmp_path / "j.jsonl"), "--max-tpu-budget", "4"])
    assert rc == jrc == 0
    rep, jrep = json.loads(out), json.loads(jout.getvalue())
    for a in jrep["planner_actions"]:
        a["component"] = "CudaWorker"
    assert rep == jrep and rep["planner_actions"]
    rc, out2, _ = _llmctl("sim", "burst", "--trace-in", str(tmp_path / "t.jsonl"),
                          "--planner", "slo", "--max-gpu-budget", "4", "--seed", "7")
    assert rc == 0 and json.loads(out2) == rep  # the trace replays the same run


def test_llmctl_tune_check_and_aot(tmp_path):
    art = str(tmp_path / "a.json")
    rc, out, err = _llmctl("tune", "--workload", "burst", "--seed", "1", "--budget", "16",
                           "--eval-seeds", "1", "--journal", str(tmp_path / "j.jsonl"),
                           "--out", art, "--check", "--json", "--device", "cpu",
                           "--max-model-len", "128")
    assert rc == 0, err
    summary = json.loads(out)
    assert summary["improvement"] > 0 and load_artifact(art)["manifest"]
    rc, out, err = _llmctl("aot", "list", "--preset", "llama-8b")  # no weights, no card
    assert rc == 0 and "hash " in err and json.loads(out)["engine"]["attention_impl"] == "kernel"
    rc, out, err = _llmctl("aot", "smoke", "--preset", "tiny", "--device", "cpu",
                           "--max-decode-slots", "2", "--page-size", "8", "--max-model-len",
                           "64", "--prefill-chunk", "16", "--decode-window", "4",
                           "--kv-dtype", "float32", "--no-lp")
    assert rc == 0, err
    verdict = json.loads(out)
    assert verdict["ok"] and verdict["boot2"]["builds"] == 0
    rc, out, err = _llmctl("aot", "compile", "--preset", "tiny", "--device", "cpu",
                           "--compile-cache-dir", str(tmp_path / "cc"), "--max-model-len", "64")
    assert rc == 0 and json.loads(out)["builds"] == 0
    assert os.path.exists(tmp_path / "cc" / "manifest.json")


@pytest.mark.parametrize("argv", [
    ("tune", "--workload", "burst", "--budget", "2", "--top-k", "1"),
    ("aot", "warm", "--preset", "tiny"),
    ("aot", "smoke", "--preset", "tiny"),
])
def test_card_commands_refuse_to_carry_on_without_a_card(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _llmctl(*argv)
    assert rc == 2 and "CUDA" in err
    assert not hasattr(llmctl, "NOT_PORTED")  # lint, the last refused plane, runs
