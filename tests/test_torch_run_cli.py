"""The port's CLI (``python -m dynamo_exp_tpu_torch.run``), on the CPU.

``parse_args`` keeps the JAX CLI's ``in=``/``out=`` form and flag
names and refuses what is not ported with its ROADMAP item;
``in=batch:…`` prints the JAX ``run_batch`` stats line; ``in=http``
serves; SIGTERM stops the process; ``out=cuda`` without ``--device
cpu`` raises on a host without a card; a directory of real weights is
loaded, never served with random ones.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from dynamo_exp_tpu import run as jrun
from dynamo_exp_tpu.engines.echo import EchoEngineFull as JEchoFull
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.models import ModelConfig, init_params
from dynamo_exp_tpu_torch.models.loader import hf_tensor_names, save_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32", "--max-tokens", "6"]


def test_parse_args_keeps_the_jax_cli_form():
    argv = ["in=http", "out=cuda", "--model-path", "/m", "--model-name", "x",
            "--random-weights", "--http-host", "127.0.0.1", "--http-port", "0",
            "--max-decode-slots", "3", "--page-size", "8", "--num-pages", "99",
            "--max-model-len", "512", "--kv-dtype", "float32", "--max-tokens", "7"]
    opts, jopts = run.parse_args(argv + ["--device", "cpu"]), jrun.parse_args(argv)
    for name in ("input", "output", "model_path", "model_name", "random_weights",
                 "http_host", "http_port", "max_decode_slots", "page_size",
                 "num_pages", "max_model_len", "kv_dtype", "max_tokens"):
        assert getattr(opts, name) == getattr(jopts, name), name
    assert opts.device == "cpu" and run.parse_args(["out=cuda"]).device == "cuda"


@pytest.mark.parametrize(
    "argv,item",
    [
        (["in=text", "out=cuda"], "item 9(d)"),
        (["in=stdin"], "item 9(d)"),
        (["in=http", "out=dyn://ns.c.ep"], "item 9(e)"),
        (["in=dyn://ns.c.ep", "out=cuda"], "item 9(e)"),
        (["--coordinator", "h:1"], "item 9(e)"),
        (["--profiler-port=6009"], "runtime/profiler.py"),
        (["--request-template", "t.json"], "item 9(c)"),
        (["--profiler-port", "6009"], "runtime/profiler.py"),
        (["--tp", "2"], "item 7"),
        (["--router-mode", "kv"], "item 9(e)"),
        (["--echo-token-delay-ms", "20"], "item 9(i)"),
        (["out=tpu"], "out=cuda"),
    ],
)
def test_unported_inputs_outputs_and_flags_are_refused(argv, item):
    with pytest.raises(SystemExit, match="not ported") as err:
        run.parse_args(argv)
    assert item in str(err.value)


@pytest.mark.parametrize(
    "flags",
    [["--spec", "ngram"], ["--spec", "ngram", "--spec-draft-len", "2", "--spec-max-draft", "5",
                           "--spec-ngram", "2"]],
    ids=["spec", "spec-knobs"],
)
def test_spec_flags_reach_the_engine_config(tiny_model_dir, flags):
    """``--spec*`` are no longer refused: they parse as the JAX CLI
    parses them and reach ``EngineConfig`` (the JAX ``run.py`` fields)."""
    argv = ["in=http", "out=cuda", "--model-path", tiny_model_dir, "--random-weights",
            *SMALL, *flags]
    opts, jopts = run.parse_args(argv + ["--device", "cpu"]), jrun.parse_args(argv)
    engine, _ = run.build_cuda_engine(opts)
    for name in ("spec", "spec_draft_len", "spec_max_draft", "spec_ngram"):
        assert getattr(opts, name) == getattr(jopts, name), name
        field = "spec_mode" if name == "spec" else name
        assert getattr(engine.cfg, field) == getattr(jopts, name), name
    assert engine._spec is not None and engine._spec.drafter.name == "ngram"


def test_host_cache_pages_reaches_the_engine_config(tiny_model_dir):
    """``--host-cache-pages`` (the G2 host KV tier) is no longer refused:
    it parses as the JAX CLI parses it and sizes the engine's host pool."""
    argv = ["in=http", "out=cuda", "--model-path", tiny_model_dir, "--random-weights",
            *SMALL, "--host-cache-pages", "24"]
    opts = run.parse_args(argv + ["--device", "cpu"])
    assert opts.host_cache_pages == jrun.parse_args(argv).host_cache_pages == 24
    engine, _ = run.build_cuda_engine(opts)
    assert engine.cfg.host_cache_pages == 24 and engine.host_pool.num_pages == 24
    default, _ = run.build_cuda_engine(run.parse_args(argv[:-2] + ["--device", "cpu"]))
    assert default.cfg.host_cache_pages == 0 and default.host_pool is None


@pytest.mark.parametrize(
    "flags,name,value",
    [
        (["--max-inflight", "4"], "max_inflight", 4),
        (["--max-inflight=8", "--shed-watermark", "3"], "shed_watermark", 3),
        (["--slo-ttft-ms", "250"], "slo_ttft_ms", 250.0),
        (["--slo-itl-ms=40"], "slo_itl_ms", 40.0),
        (["--trace-file", "spans.jsonl"], "trace_file", "spans.jsonl"),
    ],
    ids=["max-inflight", "shed-watermark", "slo-ttft", "slo-itl", "trace-file"],
)
def test_overload_slo_and_trace_flags_are_accepted_and_wired(flags, name, value):
    """``--max-inflight`` (refused until deadlines and admission were
    ported), ``--shed-watermark``, ``--slo-*`` and ``--trace-file`` parse
    as the JAX CLI parses them and build what the JAX ``run_http`` builds
    from them: the admission controller's bounds (the same watermark
    rule) and the SLO targets in seconds."""
    argv = ["in=http", "out=echo_full", *flags]
    opts, jopts = run.parse_args(argv), jrun.parse_args(argv)
    assert getattr(opts, name) == getattr(jopts, name) == value
    admission = run.build_admission(opts)
    if opts.max_inflight:
        from dynamo_exp_tpu.http import AdmissionController as JAdmission

        want = JAdmission(max_inflight=jopts.max_inflight,
                          shed_watermark=jopts.shed_watermark or None)
        assert (admission.max_inflight, admission.shed_watermark) == (
            want.max_inflight, want.shed_watermark)
    else:
        assert admission is None
    slo = run.build_slo(opts)
    if opts.slo_ttft_ms or opts.slo_itl_ms:
        assert (slo.cfg.ttft_s, slo.cfg.itl_s) == (
            opts.slo_ttft_ms / 1e3 or None, opts.slo_itl_ms / 1e3 or None)
    else:
        assert slo is None


def test_real_weights_are_never_served_random(tiny_model_dir, tmp_path):
    """A directory with safetensors is loaded (no --random-weights
    needed); one without them is refused unless --random-weights."""
    base = ["in=http", "out=cuda", "--device", "cpu", *SMALL, "--model-path"]
    with pytest.raises(SystemExit, match="--random-weights"):
        run.build_cuda_engine(run.parse_args(base + [tiny_model_dir]))
    for name in os.listdir(tiny_model_dir):
        if name != "config.json":
            os.symlink(os.path.join(tiny_model_dir, name), tmp_path / name)
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        conf = json.load(f)
    conf["torch_dtype"] = "float32"
    (tmp_path / "config.json").write_text(json.dumps(conf))
    mcfg = ModelConfig.from_pretrained(str(tmp_path))
    gen = torch.Generator().manual_seed(5)
    want = init_params(mcfg, gen, "cpu")
    save_safetensors(str(tmp_path / "model.safetensors"), {
        name: getattr(want if li is None else want.layers[li], attr)
        for name, (li, attr) in hf_tensor_names(mcfg).items()
    })
    engine, _ = run.build_cuda_engine(run.parse_args(base + [str(tmp_path)]))
    got = dict(engine.model.named_parameters())
    assert got.keys() == dict(want.named_parameters()).keys()
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name
    rand, _ = run.build_cuda_engine(run.parse_args(base + [str(tmp_path), "--random-weights"]))
    assert not torch.equal(rand.model.embed, want.embed)


def test_out_cuda_without_device_cpu_raises_without_a_card(tiny_model_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    opts = run.parse_args(["out=cuda", "--model-path", tiny_model_dir, "--random-weights"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.build_cuda_engine(opts)


def test_batch_stats_line_has_the_jax_keys(tiny_model_dir, tmp_path, capsys):
    path = tmp_path / "prompts.jsonl"
    path.write_text('{"text": "hello world"}\n\n{"prompt": "the quick fox"}\n')
    opts = run.parse_args([f"in=batch:{path}", "out=cuda", "--device", "cpu",
                           "--model-path", tiny_model_dir, "--random-weights", *SMALL])
    asyncio.run(asyncio.wait_for(run.main_async(opts), timeout=300))
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    jopts = jrun.parse_args([f"in=batch:{path}", "out=echo_full", "--max-tokens", "6"])
    asyncio.run(jrun.run_batch(jopts, None, JEchoFull(), None, str(path)))
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats.keys() == jstats.keys()
    assert stats["requests"] == jstats["requests"] == 2
    assert 0 < stats["output_tokens"] <= 12


@pytest.mark.asyncio
async def test_http_serves_a_request_then_stops_the_engine(tiny_model_dir):
    opts = run.parse_args(["in=http", "out=cuda", "--device", "cpu", "--model-path",
                           tiny_model_dir, "--model-name", "tiny", "--random-weights",
                           "--http-host", "127.0.0.1", "--http-port", "0", *SMALL])
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(run.main_async(opts, ready))
    served = await asyncio.wait_for(ready, 60)
    base = f"http://127.0.0.1:{served.port}"
    r = await client.request(base + "/v1/chat/completions", "POST", {
        "model": "tiny", "messages": [{"role": "user", "content": "hi"}]})
    assert r.status == 200
    choice = r.json()["choices"][0]
    assert choice["finish_reason"] in ("length", "stop")
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert served.torch_engine._thread is None  # stopped on the way out


def _cli(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "dynamo_exp_tpu_torch.run", *args],
                            cwd=REPO, env=env, text=True, **kw)


def test_module_help_runs():
    proc = _cli("--help", stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "in=http out=cuda" in out and "--device" in out


def test_sigterm_stops_the_server():
    proc = _cli("in=http", "out=echo_full", "--http-host", "127.0.0.1",
                "--http-port", "0", stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on http://127.0.0.1:"), proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
