"""The port's LLM graphs (``dynamo_exp_tpu_torch/examples/llm/``) served
by ``python -m dynamo_exp_tpu_torch.sdk.serve`` on the CPU (``device:
cpu``): Frontend -> Processor -> CudaWorker over HTTP, the disaggregated
fleet with its KV-routed processor, and the graph's greedy tokens
against the port's ``TorchEngine`` on the same weights."""

import asyncio
import json
import os
import subprocess
import sys

from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.sdk.service import discover_graph

from .fixtures import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = {"random_weights": True, "max_decode_slots": 2, "num_pages": 64,
          "max_model_len": 128, "page_size": 8, "kv_dtype": "float32", "device": "cpu"}


def test_graph_discovery_shapes():
    from examples.llm.graphs import agg as jagg
    from examples.llm.graphs import disagg as jdisagg

    from dynamo_exp_tpu.sdk.service import discover_graph as jdiscover
    from dynamo_exp_tpu_torch.examples.llm.graphs import agg, agg_router, disagg, disagg_router

    names = {"TpuWorker": "CudaWorker", "PrefillTpuWorker": "PrefillCudaWorker"}
    assert [s.name for s in discover_graph(agg.Frontend)] == ["CudaWorker", "Processor", "Frontend"]
    assert [s.name for s in discover_graph(agg_router.Frontend)] == [
        names.get(s.name, s.name) for s in jdiscover(jagg.Frontend)]
    dis = [s.name for s in discover_graph(disagg.Graph)]
    assert set(dis) == {"CudaWorker", "Processor", "Frontend", "PrefillCudaWorker", "Graph"}
    assert dis == [names.get(s.name, s.name) for s in jdiscover(jdisagg.Graph)]
    assert [s.name for s in discover_graph(disagg_router.Graph)] == dis
    specs = {s.name: s for s in discover_graph(disagg.Graph)}
    assert specs["CudaWorker"].resources == {"gpu": 1} == specs["PrefillCudaWorker"].resources
    assert specs["Frontend"].gpus == specs["Processor"].gpus == 0


class Graph:
    """A supervisor subprocess serving a graph: one card slot a worker
    by default (the CPU runs the engine), its own coordinator; its output
    is drained into ``lines``."""

    def __init__(self, proc, addr: str, lines: list, drain):
        self.proc, self.addr, self.lines, self._drain = proc, addr, lines, drain

    @classmethod
    async def start(cls, target: str, overrides: dict, config_path: str | None = None,
                    slots: str = "0") -> "Graph":
        env = dict(os.environ, PYTHONPATH=REPO, DYN_SERVICE_CONFIG=json.dumps(overrides))
        argv = [sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve", target,
                "--start-coordinator", "--cuda-devices", slots]
        proc = await asyncio.create_subprocess_exec(
            *argv, *(["-f", config_path] if config_path else []), env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        lines: list[str] = []
        addr = asyncio.get_running_loop().create_future()

        async def drain():
            async for raw in proc.stdout:
                line = raw.decode(errors="replace").rstrip()
                lines.append(line)
                if line.startswith("coordinator on ") and not addr.done():
                    addr.set_result(line.removeprefix("coordinator on "))

        task = asyncio.ensure_future(drain())
        await asyncio.wait({task, addr}, timeout=60, return_when=asyncio.FIRST_COMPLETED)
        assert addr.done(), "\n".join(lines)
        return cls(proc, addr.result(), lines, task)

    async def wait_models(self, base: str, timeout_s: float = 90.0) -> list[str]:
        """The Frontend's ``/v1/models`` once the whole graph serves."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while loop.time() < deadline and self.proc.returncode is None:
            try:
                r = await client.request(base + "/v1/models")
                if r.status == 200 and r.json()["data"]:
                    return [m["id"] for m in r.json()["data"]]
            except OSError:
                pass
            await asyncio.sleep(0.25)
        raise AssertionError(f"frontend never served (rc={self.proc.returncode}):\n"
                             + "\n".join(self.lines[-80:]))

    async def stop(self) -> int:
        self.proc.terminate()
        try:
            await asyncio.wait_for(self.proc.wait(), 30)
        except asyncio.TimeoutError:
            self.proc.kill()
            await self.proc.wait()
        await self._drain
        return self.proc.returncode


async def chat(base: str, content: str, max_tokens: int) -> list[dict]:
    body = {"model": "tiny", "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "stream": True}
    frames = [f.data async for f in client.sse_frames(base + "/v1/chat/completions", body)]
    assert frames[-1] == "[DONE]"
    return frames[:-1]


async def test_agg_graph_serves_openai_over_http(tiny_model_dir, tmp_path):
    """The agg graph from its JSON config file (the overrides on top): a
    streamed chat and a unary completion through Frontend -> Processor
    -> CudaWorker."""
    port = free_port()
    cfg = tmp_path / "agg.json"
    with open(os.path.join(REPO, "dynamo_exp_tpu_torch/examples/llm/configs/agg.json")) as f:
        base_cfg = json.load(f)
    base_cfg["Frontend"].update(served_model_name="tiny", port=port, host="127.0.0.1")
    base_cfg["Processor"].update(model_path=tiny_model_dir, served_model_name="tiny",
                                 page_size=8)
    cfg.write_text(json.dumps(base_cfg))
    overrides = {"CudaWorker": {"model_path": tiny_model_dir, "served_model_name": "tiny",
                                **WORKER}}
    g = await Graph.start("dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend",
                          overrides, str(cfg))
    base = f"http://127.0.0.1:{port}"
    try:
        assert await g.wait_models(base) == ["tiny"]
        chunks = await chat(base, "hi", 6)
        assert chunks and chunks[0]["object"] == "chat.completion.chunk"
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        r = await client.request(base + "/v1/completions", "POST",
                                 {"model": "tiny", "prompt": "x", "max_tokens": 4})
        assert r.status == 200, r.body
        assert r.json()["choices"][0]["finish_reason"] == "length"
    finally:
        rc = await g.stop()
    assert rc == 0, "\n".join(g.lines[-40:])


async def test_disagg_router_graph_remote_prefill_over_http(tiny_model_dir):
    """The full fleet shape: a KV-routed processor, a disaggregated decode
    worker and a prefill worker. ``max_local_prefill_length`` 0 sends
    every prefill through the queue and the KV transfer plane; llmctl
    then retunes the live-watched config."""
    from dynamo_exp_tpu_torch import llmctl
    from dynamo_exp_tpu_torch.disagg.config import DisaggConfig, disagg_config_key
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorDiscovery

    port = free_port()
    worker = {"model_path": tiny_model_dir, "served_model_name": "tiny", **WORKER}
    overrides = {
        "Frontend": {"served_model_name": "tiny", "port": port, "host": "127.0.0.1"},
        "Processor": {"model_path": tiny_model_dir, "served_model_name": "tiny",
                      "page_size": 8, "router": "kv"},
        "CudaWorker": {**worker, "disagg_mode": "decode", "max_local_prefill_length": 0},
        "PrefillCudaWorker": {k: v for k, v in worker.items() if k != "max_decode_slots"},
    }
    # Two slots of one card: the decode and the prefill worker share it.
    g = await Graph.start("dynamo_exp_tpu_torch.examples.llm.graphs.disagg_router:Graph",
                          overrides, slots="0,0")
    addr, base = g.addr, f"http://127.0.0.1:{port}"
    try:
        assert await g.wait_models(base) == ["tiny"]
        chunks = await chat(base, "hello " * 40, 5)
        assert chunks, "no SSE chunks through the disagg chain"
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        rc = await llmctl.run(llmctl.build_parser().parse_args([
            "--coordinator", addr, "disagg", "set", "tiny",
            "--max-local-prefill-length", "2048", "--max-prefill-queue-size", "5"]))
        assert rc == 0
        disc = CoordinatorDiscovery(addr)
        cfg = DisaggConfig.from_bytes(await disc.kv_get(disagg_config_key("tiny")))
        await disc.close()
        assert cfg.max_local_prefill_length == 2048 and cfg.max_prefill_queue_size == 5
    finally:
        await g.stop()


async def test_agg_graph_gives_the_engines_greedy_tokens(tiny_model_dir, tmp_path):
    """At float32, 4 greedy completions through Frontend -> Processor ->
    CudaWorker give a ``TorchEngine``'s tokens on the same seed-0 random
    weights and prompt ids, as the service shows tokens (each decoded
    alone), with their logprobs; a divergence only at a float32 tie."""
    import numpy as np

    import chip_smoke as cs
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_exp_tpu_torch.models import ModelConfig
    from dynamo_exp_tpu_torch.models.llama import init_params
    from dynamo_exp_tpu_torch.tokenizer import Tokenizer

    import torch

    import shutil

    model_dir = str(tmp_path / "tiny-f32")
    shutil.copytree(tiny_model_dir, model_dir)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg, "torch_dtype": "float32"}, f)
    mcfg = ModelConfig.from_pretrained(model_dir)
    assert mcfg.dtype == "float32"
    rs = np.random.RandomState(7)
    prompts = [[int(t) for t in rs.randint(3, mcfg.vocab_size, size=n)] for n in (5, 17, 30, 44)]
    tokens = 6
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    eng = TorchEngine(EngineConfig(model=mcfg, max_decode_slots=2, page_size=8, num_pages=64,
                                   max_model_len=128, kv_dtype="float32"),
                      model=init_params(mcfg, gen, torch.device("cpu")), device="cpu")

    async def direct(ids):
        r = dict(tokens=[], lps=[], tops=[])
        async for item in await eng.generate({
                "token_ids": ids, "stop_conditions": {"max_tokens": tokens, "ignore_eos": True},
                "sampling_options": {"logprobs": 2}}):
            r["tokens"] += item.get("token_ids") or []
            r["lps"] += item.get("logprobs") or []
            r["tops"] += item.get("top_logprobs") or []
        return r

    eng.start()
    try:
        want = [await direct(p) for p in prompts]
    finally:
        eng.stop()
    tok = Tokenizer.from_pretrained(model_dir)
    ref = [dict(tokens=[tok.decode([t]) for t in w["tokens"]], lps=w["lps"],
                tops=[{tok.decode([a]): lp for a, lp in t.items()} for t in w["tops"]])
           for w in want]

    port = free_port()
    overrides = {
        "Frontend": {"served_model_name": "tiny", "port": port, "host": "127.0.0.1"},
        "Processor": {"model_path": model_dir, "served_model_name": "tiny", "page_size": 8},
        "CudaWorker": {"model_path": model_dir, "served_model_name": "tiny", **WORKER},
    }
    g = await Graph.start("dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend", overrides)
    base = f"http://127.0.0.1:{port}"
    try:
        await g.wait_models(base)
        got = []
        for ids in prompts:  # one at a time, as the direct engine served them
            r = dict(tokens=[], lps=[], tops=[])
            async for f in client.sse_frames(base + "/v1/completions", {
                    "model": "tiny", "prompt": ids, "max_tokens": tokens, "temperature": 0,
                    "logprobs": 2, "stream": True, "nvext": {"ignore_eos": True}}):
                if f.data == "[DONE]":
                    break
                for c in f.data["choices"]:
                    lp = c.get("logprobs") or {}
                    r["tokens"] += lp.get("tokens") or []
                    r["lps"] += lp.get("token_logprobs") or []
                    r["tops"] += lp.get("top_logprobs") or []
            got.append(r)
    finally:
        await g.stop()
    assert [len(r["tokens"]) for r in got] == [tokens] * len(prompts)
    faults, _ties = cs.divergences(ref, got, cs.F32_TIE)
    assert not faults, faults
    for r, w in zip(ref, got):
        if r["tokens"] == w["tokens"]:
            assert np.allclose(r["lps"], w["lps"], atol=1e-4), (r["lps"], w["lps"])
