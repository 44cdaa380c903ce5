"""The span attributes the request anatomy reads, against the JAX engine.

``telemetry/anatomy.py`` carves the compile stall out of prefill with
the ``prefill`` span's ``compile_s`` (the profiler's first-use seconds
since admission) and the swap stall out of decode with the ``decode``
span's ``swap_stall_s`` (the row's stall and swap windows). The same
float32 traffic under page pressure goes through ``TPUEngine`` and
``TorchEngine``: a lone warm-up request (its prefill holds the first
compile or capture), then two prompts that outgrow the 8-page pool
together (the JAX package's ``tests/test_overload.py`` shape), with a
host tier, so each row stalls and one swaps. Both engines' prefill and
decode spans carry the same attribute keys, and the same requests carry
``swap_stall_s``. The span file is read as plain JSON lines.
"""

import asyncio
import json
from dataclasses import replace

import jax
import numpy as np
import pytest

from dynamo_exp_tpu import telemetry as J
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu_torch import telemetry as T
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY, params_from_jax

JCFG = replace(JTINY, dtype="float32")
TCFG = replace(TINY, dtype="float32")
PS = 8
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11]
# The host tier swaps a stalled row out at once (proactive offload), well
# inside the default preemption grace: no row is preempted.
KW = dict(max_decode_slots=4, page_size=PS, num_pages=8, max_model_len=128, prefill_chunk=16,
          decode_window=4, kv_dtype="float32", eos_token_ids=[], host_cache_pages=32)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), JCFG))


def _engines(np_params):
    yield "jax", J, TPUEngine(JEngineConfig(model=JCFG, attention_impl="xla", **KW),
                              params=jax.tree.map(jax.numpy.asarray, np_params),
                              mesh=single_device_mesh())
    yield "torch", T, TorchEngine(EngineConfig(model=TCFG, **KW),
                                  model=params_from_jax(np_params, TCFG, device="cpu"),
                                  device="cpu")


async def _traced(eng, mod, rid, prompt, max_tokens):
    with mod.span("http_request", request_id=rid):
        req = {"token_ids": list(prompt),
               "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
        stream = await eng.generate(req)
        tokens = []
        async for item in stream:
            tokens.extend(item.get("token_ids", []))
        return tokens


def _stage_attrs(path):
    """(keys of every prefill and decode span, request id -> whether its
    decode span carries swap_stall_s) from a span file."""
    traces = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            ev = json.loads(line)["event"]
            traces.setdefault(ev["trace_id"], []).append(ev)
    keys = {"prefill": set(), "decode": set()}
    swap = {}
    for group in traces.values():
        rid = next(e["attrs"]["request_id"] for e in group if e["stage"] == "http_request")
        for e in group:
            if e["stage"] in keys:
                keys[e["stage"]] |= set(e["attrs"])
            if e["stage"] == "decode":
                swap[rid] = "swap_stall_s" in e["attrs"]
    return keys, swap


def test_prefill_and_decode_spans_carry_the_jax_anatomy_attrs(np_params, tmp_path):
    out = {}
    for name, mod, eng in _engines(np_params):
        path = str(tmp_path / f"{name}.jsonl")
        mod.get_telemetry().configure(path)
        try:
            _run(_traced(eng, mod, "warm", P1[:4], 2))

            async def burst():
                return await asyncio.gather(_traced(eng, mod, "p1", P1, 40),
                                            _traced(eng, mod, "p2", P2, 40))

            tokens = _run(burst())
        finally:
            eng.stop()
            mod.get_telemetry().configure(None)
        out[name] = (tokens, *_stage_attrs(path))
    (jtok, jkeys, jswap), (ttok, tkeys, tswap) = out["jax"], out["torch"]
    assert ttok == jtok
    assert tkeys == jkeys
    assert "compile_s" in tkeys["prefill"] and "swap_stall_s" in tkeys["decode"]
    assert tswap == jswap and tswap["p1"] and tswap["p2"]
