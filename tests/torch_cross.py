"""Helpers of the cross-framework tests (``test_torch_cross_*.py``): a
float32 checkpoint both packages load, worker processes of either
package's CLI, and the greedy reference of a single ``TPUEngine``."""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import ModelConfig as JModelConfig
from dynamo_exp_tpu.models import loader as jloader
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu.runtime.transports.coordinator import CoordinatorServer as JCoordinator
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

from .test_torch_loader import hf_tensors, jax_params, write_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The engine shape every process of these tests serves.
SHAPE = ["--max-decode-slots", "2", "--page-size", "8", "--max-model-len", "128",
         "--kv-dtype", "float32"]
PAGE = 8
# Either package's coordinator serves both packages' processes.
COORDINATORS = {"jax": JCoordinator, "torch": CoordinatorServer}


def checkpoint_dir(tiny_model_dir: str, path: str, seed: int = 3) -> str:
    """The tiny fixture's tokenizer and config (float32) with seeded JAX
    weights as a safetensors checkpoint."""
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(tiny_model_dir):
        if name != "config.json":
            os.symlink(os.path.join(tiny_model_dir, name), os.path.join(path, name))
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        conf = json.load(f)
    conf["torch_dtype"] = "float32"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    cfg = JModelConfig.from_pretrained(path)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      hf_tensors(cfg, jax_params(cfg, seed=seed)))
    return path


def spawn(module: str, *args: str) -> subprocess.Popen:
    """``python -m <module> <args>`` from the repo root, on the CPU, its
    output captured."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


async def stop(proc: subprocess.Popen, timeout: float = 30.0) -> str:
    """SIGTERM, wait (off the loop), SIGKILL if needed; its output."""
    if proc.poll() is None:
        proc.terminate()
    try:
        out, _ = await asyncio.to_thread(proc.communicate, timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = await asyncio.to_thread(proc.communicate)
    return out or ""


async def wait_for_model(base: str, name: str, procs=(), timeout_s: float = 90.0) -> None:
    for _ in range(int(timeout_s / 0.1)):
        for p in procs:
            assert p.poll() is None, f"a worker exited early:\n{await stop(p)}"
        try:
            r = await client.request(base + "/v1/models")
            if name in [m["id"] for m in r.json()["data"]]:
                return
        except OSError:
            pass
        await asyncio.sleep(0.1)
    raise AssertionError(f"model {name!r} never appeared at {base}")


def reference_tokens(model_dir: str, prompts: list[list[int]], n: int) -> list[list[int]]:
    """Greedy tokens of one ``TPUEngine`` on the checkpoint, the shape
    of ``SHAPE``."""
    params, cfg = jloader.load_params(model_dir)
    eng = TPUEngine(JEngineConfig(model=cfg, attention_impl="xla", max_decode_slots=2,
                                  page_size=PAGE, max_model_len=128, num_pages=64,
                                  kv_dtype="float32", eos_token_ids=[]),
                    params=params, mesh=single_device_mesh())

    async def one(p):
        stream = await eng.generate({"token_ids": p, "stop_conditions": {
            "max_tokens": n, "ignore_eos": True}})
        return [t async for item in stream for t in (item.get("token_ids") or [])]

    async def run():
        return [await one(p) for p in prompts]

    try:
        return asyncio.run(asyncio.wait_for(run(), 300))
    finally:
        eng.stop()


def prompts(seed: int, vocab: int) -> list[list[int]]:
    rs = np.random.RandomState(seed)
    return [rs.randint(10, vocab, size=n).tolist() for n in (21, 9)]


def greedy_request(prompt: list[int], n: int) -> dict:
    return {"token_ids": prompt, "stop_conditions": {"max_tokens": n, "ignore_eos": True},
            "sampling_options": {"temperature": 0.0}}
