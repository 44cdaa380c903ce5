"""The port's CLI (``python -m dynamo_exp_tpu_torch.run``), on the CPU.

``parse_args`` keeps the JAX CLI's ``in=``/``out=`` form and flag
names and refuses what is not ported with its ROADMAP item;
``in=batch:…`` prints the JAX ``run_batch`` stats line; ``in=http``
serves; SIGTERM stops the process; ``out=cuda`` without ``--device
cpu`` raises on a host without a card; a directory of real weights is
loaded, never served with random ones. ``dyn://`` endpoints,
``--coordinator`` and ``--router-mode`` parse as the JAX CLI parses
them, a ``dyn://`` endpoint without a coordinator is refused with the
JAX CLI's message, and three processes (the port's coordinator CLI, an
``in=dyn:// out=echo_core`` worker, an ``in=http out=dyn://`` ingress)
serve with model discovery and drop the model when the worker exits.
``--tp`` and the multi-node flags parse as the JAX CLI parses them,
what tp > 1 does not serve is refused with its ROADMAP item, and two
CPU nodes at tp=2 serve a batch of ``token_ids`` lines with a tp=1
run's tokens. ``in=text`` and ``in=stdin`` give the JAX CLI's replies
on ``out=echo_full`` and serve ``out=cuda --device cpu``;
``--echo-token-delay-ms`` spaces the echo engines' frames.
"""

import asyncio
import contextlib
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from dynamo_exp_tpu.runtime.push_router import RouterMode as JRouterMode

from dynamo_exp_tpu import run as jrun
from dynamo_exp_tpu.engines.echo import EchoEngineFull as JEchoFull
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.models import ModelConfig, init_params
from dynamo_exp_tpu_torch.models.loader import hf_tensor_names, save_safetensors

from .fixtures import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32", "--max-tokens", "6"]


def test_parse_args_keeps_the_jax_cli_form():
    argv = ["in=http", "out=cuda", "--model-path", "/m", "--model-name", "x",
            "--random-weights", "--http-host", "127.0.0.1", "--http-port", "0",
            "--max-decode-slots", "3", "--page-size", "8", "--num-pages", "99",
            "--max-model-len", "512", "--kv-dtype", "float32", "--max-tokens", "7",
            "--profiler-port", "6009"]
    opts, jopts = run.parse_args(argv + ["--device", "cpu"]), jrun.parse_args(argv)
    for name in ("input", "output", "model_path", "model_name", "random_weights",
                 "http_host", "http_port", "max_decode_slots", "page_size",
                 "num_pages", "max_model_len", "kv_dtype", "max_tokens", "profiler_port"):
        assert getattr(opts, name) == getattr(jopts, name), name
    assert opts.device == "cpu" and run.parse_args(["out=cuda"]).device == "cuda"


@pytest.mark.parametrize("argv,item", [(["out=tpu"], "out=cuda")])
def test_unported_inputs_outputs_and_flags_are_refused(argv, item):
    """``out=tpu`` is answered with the port's own output, not with
    "not ported": it never will be."""
    with pytest.raises(SystemExit, match="use that") as err:
        run.parse_args(argv)
    assert item in str(err.value) and "not ported" not in str(err.value)


@pytest.mark.parametrize(
    "argv",
    [["in=text", "out=cuda"], ["in=stdin"], ["in=http", "--request-template", "t.json"],
     ["in=http", "--echo-token-delay-ms", "20"]],
    ids=["text", "stdin", "request-template", "echo-token-delay-ms"],
)
def test_text_stdin_template_and_echo_delay_parse_as_the_jax_cli(argv):
    """No longer refused: ``in=text``, ``in=stdin``, ``--request-template``
    and ``--echo-token-delay-ms`` parse as the JAX CLI parses them."""
    opts, jopts = run.parse_args(argv), jrun.parse_args(argv)
    for name in ("input", "output", "request_template", "echo_token_delay_ms"):
        assert getattr(opts, name) == getattr(jopts, name), name


STDIN = "hello world\n\nthe quick brown fox\n"


def _drive_stdin(mod, argv, monkeypatch, capsys) -> list[str]:
    """``mod``'s CLI (``run.main_async``) on ``STDIN``: the replies, one a
    line (the ``> `` prompts of ``in=text``, which its reader thread
    prints as it pleases, taken out)."""
    import io

    monkeypatch.setattr(sys, "stdin", io.StringIO(STDIN))
    if mod is jrun:  # its replies' stream is bound at import: capsys's here
        monkeypatch.setattr(jrun._stream_chat, "__defaults__", (sys.stdout,))
    asyncio.run(asyncio.wait_for(mod.main_async(mod.parse_args(argv)), timeout=120))
    out = capsys.readouterr().out.replace("> ", "").splitlines()
    return [x for x in out if x != "Ctrl-D to exit." and "runtime closed" not in x]


@pytest.mark.parametrize("source", ["text", "stdin"])
def test_text_and_stdin_on_echo_equal_the_jax_cli(source, monkeypatch, capsys):
    argv = [f"in={source}", "out=echo_full"]
    want = _drive_stdin(jrun, argv, monkeypatch, capsys)
    got = _drive_stdin(run, argv, monkeypatch, capsys)
    # in=text echoes the empty line too; in=stdin skips it.
    assert got == want == ["hello world", *([""] if source == "text" else []),
                           "the quick brown fox"]


@pytest.mark.parametrize("source", ["text", "stdin"])
def test_text_and_stdin_on_out_cuda_device_cpu(source, tiny_model_dir, monkeypatch, capsys):
    """One streamed chat a line (in=text: the empty one too) through
    ``TorchEngine`` on the CPU, each reply written."""
    engines = []
    build = run.build_cuda_engine

    def spy(opts, comm=None):
        engines.append(build(opts, comm))
        return engines[-1]

    monkeypatch.setattr(run, "build_cuda_engine", spy)
    got = _drive_stdin(run, [f"in={source}", "out=cuda", "--device", "cpu", "--model-path",
                             tiny_model_dir, "--random-weights", *SMALL],
                       monkeypatch, capsys)
    chats = 3 if source == "text" else 2
    assert engines[0][0].metrics()["workload_requests"] == chats
    assert len(got) >= chats  # a random model's reply may hold newlines


@pytest.mark.parametrize("output", ["echo_full", "echo_core"])
async def test_echo_token_delay_spaces_the_frames(output, tiny_model_dir):
    """``--echo-token-delay-ms 40``: content frames 40 ms apart or more,
    as the JAX echo engines sleep before each frame."""
    import time

    gaps = {}
    for delay in ("0", "40"):
        opts = run.parse_args(["in=http", f"out={output}", "--http-host", "127.0.0.1",
                               "--http-port", "0", "--model-path", tiny_model_dir,
                               "--model-name", "tiny", "--echo-token-delay-ms", delay])
        ready = asyncio.get_running_loop().create_future()
        task = asyncio.ensure_future(run.main_async(opts, ready))
        served = await asyncio.wait_for(ready, 60)
        times = []
        async for f in client.sse_frames(
                f"http://127.0.0.1:{served.port}/v1/chat/completions",
                {"model": "tiny", "stream": True, "max_tokens": 6,
                 "messages": [{"role": "user", "content": "one two three four five six"}]}):
            if f.data != "[DONE]" and any((c.get("delta") or {}).get("content")
                                          for c in f.data["choices"]):
                times.append(time.monotonic())
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        assert len(times) >= 3
        gaps[delay] = min(b - a for a, b in zip(times, times[1:]))
    assert gaps["40"] >= 0.035 and gaps["0"] < gaps["40"]


@pytest.mark.parametrize(
    "argv",
    [
        ["out=cuda", "--dist-leader=h:1", "--num-nodes", "2", "--tp", "2"],
        ["out=cuda", "--num-nodes", "2", "--node-rank", "1", "--tp", "4", "--dist-port",
         "7000", "--deployment", "blue"],
        ["out=cuda", "--tensor-parallel-size", "2"],
    ],
    ids=["dist-leader", "num-nodes", "tp"],
)
def test_tp_and_multinode_flags_parse_as_the_jax_cli(argv):
    """No longer refused: ``--tp`` / ``--tensor-parallel-size``,
    ``--num-nodes``, ``--node-rank``, ``--dist-leader``, ``--dist-port``
    and ``--deployment`` parse as the JAX CLI parses them (and
    ``--dist-backend``, the port's own, defaults to nccl on a card)."""
    opts, jopts = run.parse_args(argv), jrun.parse_args(argv)
    for name in ("tp", "num_nodes", "node_rank", "dist_leader", "dist_port", "deployment"):
        assert getattr(opts, name) == getattr(jopts, name), name
    assert opts.dist_backend is None
    assert run.parse_args(argv + ["--dist-backend", "gloo"]).dist_backend == "gloo"


@pytest.mark.parametrize(
    "argv,item",
    [
        (["--prewarm"], "item 7(b)"),
        (["--compile-cache-dir", "/tmp/x"], "item 7(b)"),
        (["--sp", "2"], "forward_ring_prefill"),
    ],
    ids=["prewarm", "compile-cache-dir", "sp"],
)
def test_what_tp_does_not_serve_is_refused_with_its_item(argv, item):
    with pytest.raises(SystemExit) as err:
        run.parse_args(["out=cuda", "--tp", "2", *argv])
    assert item in str(err.value)


@pytest.mark.parametrize("tier", ["host-cache-pages", "DYN_KV_STORE"])
def test_tp_serves_the_host_tier_and_the_store(tmp_path, monkeypatch, tier):
    """``--tp 2`` takes ``--host-cache-pages`` and ``DYN_KV_STORE``, as
    tp = 1 does: the engine config carries them to every rank (rank 0
    alone builds the tiers)."""
    argv = ["out=cuda", "--tp", "2"]
    if tier == "DYN_KV_STORE":
        monkeypatch.setenv("DYN_KV_STORE", str(tmp_path))
        argv += ["--host-cache-pages", "16"]
    else:
        argv += ["--host-cache-pages", "64"]
    opts = run.parse_args(argv)
    assert opts.tp == 2 and opts.host_cache_pages > 0
    assert opts.engine_env.get("kv_store_dir", "") == (
        str(tmp_path) if tier == "DYN_KV_STORE" else "")


def test_tp_needs_out_cuda_and_a_whole_split():
    with pytest.raises(SystemExit, match="out=echo_core"):
        run.parse_args(["out=echo_core", "--tp", "2"])
    with pytest.raises(SystemExit, match="multiple of --num-nodes"):
        run.parse_args(["out=cuda", "--tp", "3", "--num-nodes", "2"])
    with pytest.raises(SystemExit, match="--node-rank 2"):
        run.parse_args(["out=cuda", "--tp", "2", "--num-nodes", "2", "--node-rank", "2"])


@pytest.mark.parametrize(
    "argv",
    [
        ["in=http", "out=dyn://ns.c.ep"],
        ["in=dyn://ns.c.ep", "out=cuda"],
        ["in=dyn://ns.c.ep", "out=echo_core", "--coordinator", "h:1"],
        ["in=http", "out=dyn://ns.c.ep", "--coordinator=h:2", "--router-mode", "kv"],
        ["in=http", "out=dyn://ns.c.ep", "--router-mode", "round-robin"],
    ],
    ids=["out-dyn", "in-dyn", "coordinator", "router-mode-kv", "router-mode-rr"],
)
def test_dyn_endpoints_coordinator_and_router_mode_are_accepted(argv, monkeypatch):
    """No longer refused: ``dyn://`` endpoints, ``--coordinator`` (default
    ``DYN_COORDINATOR``) and ``--router-mode`` parse as the JAX CLI
    parses them, and the mode maps to the same ``RouterMode``."""
    monkeypatch.setenv("DYN_COORDINATOR", "env-host:7")
    opts, jopts = run.parse_args(argv), jrun.parse_args(argv)
    for name in ("input", "output", "coordinator", "router_mode"):
        assert getattr(opts, name) == getattr(jopts, name), name
    assert run.router_mode(opts).name == jrun.router_mode(jopts).name
    assert run.router_mode(opts).value == JRouterMode[run.router_mode(opts).name].value
    with pytest.raises(SystemExit):
        run.parse_args(argv + ["--router-mode", "direct"])


@pytest.mark.parametrize("argv", [["in=http", "out=dyn://ns.c.ep"],
                                  ["in=dyn://ns.c.ep", "out=echo_core"]])
def test_dyn_endpoints_need_a_coordinator(argv, monkeypatch):
    monkeypatch.delenv("DYN_COORDINATOR", raising=False)
    opts = run.parse_args(argv)
    with pytest.raises(SystemExit, match=r"dyn:// endpoints need --coordinator \(or "
                       r"DYN_COORDINATOR\)"):
        asyncio.run(run.main_async(opts))


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


async def test_three_process_serve_with_discovery(tiny_model_dir):
    """The port's coordinator CLI, an ``in=dyn:// out=echo_core`` worker
    and an ``in=http out=dyn://`` ingress without ``--model-path``: the
    model appears at the ingress through discovery, serves a chat, and
    leaves when the worker exits on SIGTERM. A second ingress with
    ``--model-path`` serves the same worker through a static chain."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    coord = subprocess.Popen(
        [sys.executable, "-m", "dynamo_exp_tpu_torch.runtime.transports.coordinator",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    worker = ingress = None
    try:
        line = await asyncio.to_thread(coord.stdout.readline)
        assert line.strip() == f"coordinator ready on 127.0.0.1:{port}"
        worker = _cli("in=dyn://t.worker.generate", "out=echo_core", "--model-path",
                      tiny_model_dir, "--model-name", "tiny", "--coordinator",
                      f"127.0.0.1:{port}", stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        opts = run.parse_args(["in=http", "out=dyn://t.worker.generate", "--coordinator",
                               f"127.0.0.1:{port}", "--http-host", "127.0.0.1",
                               "--http-port", "0", "--router-mode", "round-robin"])
        ready = asyncio.get_running_loop().create_future()
        ingress = asyncio.ensure_future(run.main_async(opts, ready))
        served = await asyncio.wait_for(ready, 30)
        base = f"http://127.0.0.1:{served.port}"

        async def models():
            return [m["id"] for m in (await client.request(base + "/v1/models")).json()["data"]]

        for _ in range(300):
            assert worker.poll() is None
            if "tiny" in await models():
                break
            await asyncio.sleep(0.1)
        else:
            raise AssertionError("model never discovered")
        r = await client.request(base + "/v1/chat/completions", "POST", {
            "model": "tiny", "messages": [{"role": "user", "content": "hello world"}],
            "max_tokens": 3})
        assert r.status == 200, r.body
        assert r.json()["choices"][0]["message"]["content"]
        # With --model-path the ingress serves that card over a static
        # chain, routed kv, to the same worker.
        static = run.parse_args(["in=http", "out=dyn://t.worker.generate", "--coordinator",
                                 f"127.0.0.1:{port}", "--http-host", "127.0.0.1",
                                 "--http-port", "0", "--router-mode", "kv", "--model-path",
                                 tiny_model_dir, "--model-name", "tiny"])
        ready2 = asyncio.get_running_loop().create_future()
        ingress2 = asyncio.ensure_future(run.main_async(static, ready2))
        try:
            served2 = await asyncio.wait_for(ready2, 30)
            r = await client.request(
                f"http://127.0.0.1:{served2.port}/v1/completions", "POST",
                {"model": "tiny", "prompt": "hello world", "max_tokens": 3})
            assert r.status == 200, r.body
            assert r.json()["choices"][0]["text"]
        finally:
            ingress2.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await ingress2
        worker.send_signal(signal.SIGTERM)
        for _ in range(300):
            if worker.poll() is not None:
                break
            await asyncio.sleep(0.1)
        assert worker.returncode == 0
        for _ in range(300):
            if "tiny" not in await models():
                break
            await asyncio.sleep(0.1)
        else:
            raise AssertionError("model not removed after the worker left")
        r = await client.request(base + "/v1/chat/completions", "POST", {
            "model": "tiny", "messages": [{"role": "user", "content": "hi"}]})
        assert r.status == 404
    finally:
        if ingress is not None:
            ingress.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await ingress
        for proc in (worker, coord):
            if proc is not None and proc.poll() is None:
                proc.kill()
                await asyncio.to_thread(proc.wait, 30)


def _f32_model_dir(tiny_model_dir, path) -> str:
    """The tiny model directory with float32 weights (tp=2 equals tp=1
    token for token only in float32: bf16 partial sums round apart)."""
    for name in os.listdir(tiny_model_dir):
        if name != "config.json":
            os.symlink(os.path.join(tiny_model_dir, name), path / name)
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        conf = json.load(f)
    (path / "config.json").write_text(json.dumps(dict(conf, torch_dtype="float32")))
    return str(path)


def _token_batch(path, vocab: int) -> str:
    import numpy as np

    rs = np.random.RandomState(3)
    lines = [{"token_ids": [int(t) for t in rs.randint(3, vocab, size=n)], "max_tokens": 8,
              "ignore_eos": True} for n in (5, 17, 9, 30)]
    lines[2].update(temperature=0.8, seed=21, logprobs=2)
    path.write_text("".join(json.dumps(d) + "\n" for d in lines))
    return str(path)


def _outputs(stdout: str) -> list[dict]:
    rows = [json.loads(line) for line in stdout.splitlines() if line.startswith('{"index"')]
    return sorted(rows, key=lambda r: r["index"])


def test_batch_token_lines_print_their_outputs(tiny_model_dir, tmp_path, capsys):
    """``token_ids`` lines go to the core engine, admitted together, and
    print one output line each before the stats line."""
    d = _f32_model_dir(tiny_model_dir, tmp_path)
    batch = _token_batch(tmp_path / "b.jsonl", 384)
    opts = run.parse_args([f"in=batch:{batch}", "out=cuda", "--device", "cpu",
                           "--model-path", d, "--random-weights", *SMALL])
    asyncio.run(asyncio.wait_for(run.main_async(opts), timeout=300))
    lines = capsys.readouterr().out.strip().splitlines()
    rows, stats = _outputs("\n".join(lines)), json.loads(lines[-1])
    assert [r["index"] for r in rows] == [0, 1, 2, 3]
    assert all(len(r["token_ids"]) == 8 and r["finish_reason"] == "length" for r in rows)
    assert len(rows[2]["logprobs"]) == 8 and len(rows[2]["top_logprobs"][0]) == 2
    assert stats["requests"] == 4 and stats["output_tokens"] == 32


def test_two_nodes_at_tp2_give_the_tokens_of_tp1(tiny_model_dir, tmp_path):
    """Two ``run.py`` processes, ``--num-nodes 2 --node-rank 0/1
    --dist-leader 127.0.0.1:<port> --tp 2 --dist-backend gloo``, on the
    CPU: node 0 serves the batch with the tokens of a tp=1 run, node 1
    follows and prints no output; node 0's ``{"tp": ...}`` line shows
    both ranks' digests equal."""
    d = _f32_model_dir(tiny_model_dir, tmp_path)
    batch = _token_batch(tmp_path / "b.jsonl", 384)
    base = [f"in=batch:{batch}", "out=cuda", "--device", "cpu", "--model-path", d,
            "--random-weights", *SMALL]
    one = _cli(*base, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port = free_port()
    nodes = [_cli(*base, "--tp", "2", "--num-nodes", "2", "--node-rank", str(r),
                  "--dist-leader", f"127.0.0.1:{port}", "--dist-backend", "gloo",
                  stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in (0, 1)]
    outs = []
    try:
        for p in [one, *nodes]:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in [one, *nodes]:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for p, (_, err) in zip([one, *nodes], outs):
        assert p.returncode == 0, err[-3000:]
    want, got, follower = (_outputs(o) for o, _ in outs)
    assert [r["token_ids"] for r in got] == [r["token_ids"] for r in want]
    assert len(want) == 4 and not follower
    import numpy as np

    np.testing.assert_allclose(got[2]["logprobs"], want[2]["logprobs"], atol=1e-4)
    (tp,) = [json.loads(line)["tp"] and json.loads(line) for line in outs[1][0].splitlines()
             if line.startswith('{"tp"')]
    assert tp["tp"] == 2 and tp["backend"] == "gloo"
    assert [r["rank"] for r in tp["ranks"]] == [0, 1]
    assert len({(r["digest"], r["dispatches"]) for r in tp["ranks"]}) == 1
