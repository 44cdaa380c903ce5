"""The port's ``runtime/profiler.py`` (``torch.profiler`` where the JAX
package starts ``jax.profiler``).

On the CPU: ``trace_to`` around an engine burst writes a Chrome trace
with the burst's CPU operators in it, ``capture_trace`` records a fixed
window, and the ``--profiler-port`` listener answers a capture request
with the directory it wrote (and 404 elsewhere), also when started by
``run.main_async``. Asking for CUDA activity without a card raises
instead of handing back a trace without device time. On the card
(``cuda`` marker, skipped here): the trace names the kernels of both
bf16 ragged kernels, one record a launch counted by the wrappers.
"""

import asyncio
import json
import os
import urllib.request
from dataclasses import replace

import pytest
import torch

from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.runtime import profiler


def _engine(device="cpu", dtype="float32"):
    # Heads of 64: a layout the CUDA kernels take (the card's case).
    mcfg = replace(TINY, dtype=dtype, head_dim=64, num_heads=4, num_kv_heads=2, hidden_size=256)
    cfg = EngineConfig(model=mcfg, max_decode_slots=2, page_size=16, num_pages=32,
                       max_model_len=128, kv_dtype=dtype, eos_token_ids=[])
    return TorchEngine(cfg, device=device)


def _burst(eng, n=2, max_tokens=6, first=3):
    """``n`` requests of 17, 18, ... tokens from token ``first`` on,
    admitted together: bursts with another ``first`` share no prefix
    and have the same schedule and keys."""

    async def all_():
        with eng.hold_admission():
            streams = [eng.submit({"token_ids": list(range(first, first + 17 + i)),
                                   "stop_conditions": {"max_tokens": max_tokens,
                                                       "ignore_eos": True}})
                       for i in range(n)]
        for stream in streams:
            async for _ in stream:
                pass

    asyncio.run(asyncio.wait_for(all_(), 120))


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_to_records_an_engine_burst_on_the_cpu(tmp_path):
    eng = _engine()
    try:
        with profiler.trace_to(str(tmp_path / "t"), device="cpu") as cap:
            _burst(eng)
    finally:
        eng.stop()
    assert cap.path == str(tmp_path / "t" / "trace.json") and os.path.exists(cap.path)
    names = {e.get("name") for e in _trace_events(cap.path)}
    assert any(n and n.startswith("aten::") for n in names)
    assert cap.events == len(_trace_events(cap.path)) > 0
    assert cap.kernels == {} and cap.summary()["kernel_launches"] == 0


def test_capture_trace_and_the_listener_write_traces(tmp_path):
    cap = profiler.capture_trace(str(tmp_path / "c"), duration_ms=50, device="cpu")
    assert os.path.exists(cap.path) and cap.seconds >= 0.05
    server = profiler.start_profiler_server(0, device="cpu", base_dir=str(tmp_path / "srv"))
    try:
        assert profiler.start_profiler_server(0, device="cpu") is server  # once a process
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{url}/capture?duration_ms=30", timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["trace_dir"].startswith(str(tmp_path / "srv"))
        assert os.path.exists(doc["trace_file"]) and doc["events"] >= 0
        assert server.captures == [doc]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/nope", timeout=10)
        assert err.value.code == 404
    finally:
        profiler.stop_profiler_server()


def test_run_serves_the_profiler_port(tmp_path):
    import socket

    from dynamo_exp_tpu_torch import run

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    opts = run.parse_args(["in=http", "out=echo_full", "--http-port", "0", "--http-host",
                           "127.0.0.1", "--profiler-port", str(port), "--device", "cpu"])

    async def main():
        ready = asyncio.get_running_loop().create_future()
        task = asyncio.ensure_future(run.main_async(opts, ready))
        await asyncio.wait({task, ready}, return_when=asyncio.FIRST_COMPLETED)
        try:
            body = await asyncio.to_thread(
                lambda: urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/capture?duration_ms=20", timeout=60).read())
            return json.loads(body)
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    doc = asyncio.run(asyncio.wait_for(main(), 120))
    assert os.path.exists(doc["trace_file"])
    assert profiler._server is None  # main_async closed it on the way out


def test_cuda_profiling_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="without a CUDA device"):
        with profiler.trace_to(str(tmp_path / "x"), device="cuda"):
            pass
    with pytest.raises(RuntimeError, match="without a CUDA device"):
        profiler.start_profiler_server(0, device="cuda")
    assert profiler._server is None


@pytest.mark.cuda
def test_card_trace_names_both_bf16_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trace's kernels run only on the card")
    from dynamo_exp_tpu_torch.ops import launches as tlaunches
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    eng = _engine(device="cuda", dtype="bfloat16")
    try:
        _burst(eng)  # captures the burst's graph keys first
        captured = eng.metrics()["graphs_captured"]
        tlaunches.reset()
        with profiler.trace_to(str(tmp_path / "g")) as cap:
            _burst(eng, first=4)
        launches = dict(tra.KERNEL_LAUNCHES)
        assert eng.metrics()["graphs_captured"] == captured  # replays only
    finally:
        eng.stop()
    assert launches["mixed_tc_bf16"] > 0 and launches["decode_split"] > 0
    assert cap.count("mixed_tc_kernel") == launches["mixed_tc_bf16"]
    assert cap.count("decode_split_kernel") == launches["decode_split"]
