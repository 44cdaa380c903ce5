"""``chip_smoke.py``'s phase 11 rehearsed on the CPU at a small size: the
port's coordinator CLI, two worker processes (``run.main_async`` with
``in=dyn://… out=cuda --device cpu``, spawned as on the card) and the
HTTP ingress in this process (``--router-mode kv``, then
``round-robin``), at SMALL widths. (a) the model arrives through
discovery and both instances are listed; (b) every stream of both modes
finishes at full length, the kv decisions' overlap blocks equal the
prefix-hit pages the workers attached, and kv computes fewer prefill
tokens than round-robin; (c) a lone greedy request on each worker gives
a direct ``TorchEngine``'s tokens on the same seeded weights; (d) one
worker is SIGKILLed mid-stream: every stream finishes, ``seq_index``
rises by its logprob entries, the recoveries equal the streams on the
killed worker, and the model stays listed past the lease TTL (2 s here).
The kernel-launch checks are the card's only."""

import asyncio
from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

# Wide enough that a 160-token stream decodes for a few seconds on the
# CPU, so the kill lands mid-stream.
SMALL = replace(TINY, vocab_size=2048, hidden_size=256, intermediate_size=512, num_layers=4,
                max_position_embeddings=1024)
SH = cs.Phase11(device="cpu", groups=4, prefix_tokens=64, suffix_tokens=(8, 24), per_group=3,
                max_tokens=4, num_pages=256, slots=4, max_model_len=512, failover_streams=4,
                failover_prompt=16, failover_tokens=160, kill_after_tokens=8, lease_ttl_s=2.0)


def lone_request():
    """A greedy request served alone by a direct engine on the workers'
    weights (seed 0)."""
    ids = [int(t) for t in np.random.RandomState(11).randint(3, SMALL.vocab_size, size=40)]
    eng = TorchEngine(EngineConfig(model=SMALL, max_decode_slots=SH.slots, page_size=cs.PS,
                                   num_pages=SH.num_pages, max_model_len=SH.max_model_len),
                      device="cpu")

    async def run():
        stream = eng.submit({"token_ids": ids, "stop_conditions": {"max_tokens": 6,
                                                                   "ignore_eos": True}})
        eng.start()
        return [t async for f in stream for t in f.get("token_ids", [])]

    try:
        return ids, asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        eng.stop()


def test_smoke_phase11_on_cpu(monkeypatch):
    monkeypatch.setenv("DYN_RUNTIME_LEASE_TTL_S", "2")
    out = cs.phase11(torch, np, pkg, tra, "cpu", lone_request(), sh=SH, mcfg=SMALL)
    kv, rr = out["modes"]["kv"], out["modes"]["round-robin"]
    assert out["overlap"] == kv["shared"] > 0
    assert kv["prefill"] < rr["prefill"]
    assert out["d"]["recoveries"] == out["d"]["on_victim"] > 0
    assert out["both_s"] < SH.discovery_s
