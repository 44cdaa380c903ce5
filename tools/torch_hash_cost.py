#!/usr/bin/env python3
"""What the host C++ block hash saves: the ingress's and the engine
loop's hash time, and a burst's TTFT, with the hashes computed by the
C++ library (``native/blockhash.cpp``) against its pure-Python mirror
(``tokens.py``'s ``py_*`` functions), on one NVIDIA GPU and its host.

    python3 tools/torch_hash_cost.py [--layers N] [--pairs N]

Run from the root of the repository on a machine with the card and
``nvcc``. The traffic is phase 11 (b)'s of ``chip_smoke.py``: 16 prefix
groups of 4 prompts, a 1,024-token shared prefix and a 64-256-token
suffix each (seed 101).

1. The ingress: each prompt hashed as the KV-aware router hashes it
   (``KvIndexer.block_hashes``, 16-token blocks), by both, best of 5
   passes over the 64 prompts; the hashes compared.
2. The engine: one llama-8b ``TorchEngine`` (full width, ``--layers``
   deep, default 32; bf16; phase 11's worker pool: 2,048 pages, 8 rows)
   serves the 64 prompts as one burst, 32 greedy tokens each, admitted
   together, with every hash function the engine, its scheduler, its
   tiering and the router's indexer import switched to one of the two
   and timed. After a warm-up burst, ``--pairs`` pairs in the order
   native, Python, Python, native, ...: each burst's TTFT p50 and max,
   its wall, the loop thread's CPU seconds and the seconds it spent
   hashing. Every burst's tokens are held to the first's.

It prints one line per burst and a JSON summary as its last line.
"""

import argparse
import asyncio
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHED = ("engine.engine", "engine.kv_manager", "engine.scheduler", "engine.tiering",
          "kv_router.indexer")
NAMES = ("compute_block_hashes_for_seq", "compute_block_hash", "chain_hash")


def switch(pkg, tokens, impl: str, spent: list) -> None:
    """Point every module's imported hash functions at ``impl``'s
    ("native" or "python"), each call's seconds added to ``spent[0]``."""
    import importlib

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t
        return call

    funcs = {name: getattr(tokens, name if impl == "native" else {
        "compute_block_hashes_for_seq": "py_block_hashes_for_seq",
        "compute_block_hash": "py_compute_block_hash",
        "chain_hash": "py_chain_hash"}[name]) for name in NAMES}
    for mod in HASHED:
        m = importlib.import_module(f"{pkg.__name__}.{mod}")
        for name in NAMES:
            if hasattr(m, name):
                setattr(m, name, timed(funcs[name]))


def ingress(tokens, prompts, block: int) -> dict:
    out = {}
    for impl, fn in (("native", tokens.compute_block_hashes_for_seq),
                     ("python", tokens.py_block_hashes_for_seq)):
        per, total = [], float("inf")
        for _ in range(5):
            times = []
            for p in prompts:
                t = time.perf_counter()
                fn(p, block)
                times.append(time.perf_counter() - t)
            if sum(times) < total:
                total, per = sum(times), times
        out[impl] = dict(per_request_p50_ms=statistics.median(per) * 1e3,
                         per_request_max_ms=max(per) * 1e3, burst_ms=total * 1e3)
    assert all(tokens.compute_block_hashes_for_seq(p, block)
               == tokens.py_block_hashes_for_seq(p, block) for p in prompts)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from dataclasses import replace

    import numpy as np
    import torch

    import chip_smoke as cs
    import dynamo_exp_tpu_torch as pkg
    import dynamo_exp_tpu_torch.engine  # noqa: F401
    import dynamo_exp_tpu_torch.kv_router.indexer  # noqa: F401
    import dynamo_exp_tpu_torch.models  # noqa: F401
    from dynamo_exp_tpu_torch import native, tokens
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    if not torch.cuda.is_available():
        print("torch_hash_cost: no CUDA device", file=sys.stderr)
        return 2
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    sh = cs.Phase11()
    mcfg = replace(pkg.models.LLAMA_8B, num_layers=args.layers)
    prompts = [p for g in cs._p11_groups(np, mcfg.vocab_size, sh, 101) for p in g]
    assert native.native_available()
    ing = ingress(tokens, prompts, cs.PS)
    print(f"ingress ({os.cpu_count()} host cores): {len(prompts)} prompts of "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens: {json.dumps(ing)}",
          flush=True)

    cs.build(tra)
    model = cs.seeded_model(torch, pkg, mcfg, "cuda")
    ecfg = pkg.engine.EngineConfig(model=mcfg, max_decode_slots=sh.slots, page_size=cs.PS,
                                   num_pages=sh.num_pages, max_model_len=sh.max_model_len,
                                   kv_dtype="bfloat16")
    eng = pkg.engine.TorchEngine(ecfg, model=model, device="cuda")
    requests = [{"token_ids": p, "stop_conditions": {"max_tokens": cs.MAX_TOKENS,
                                                      "ignore_eos": True}} for p in prompts]
    order = ["native"] + ["native", "python", "python", "native"] * args.pairs
    order = order[:1 + 2 * args.pairs]
    bursts, want = [], None
    try:
        for i, impl in enumerate(order):
            spent = [0.0]
            switch(pkg, tokens, impl, spent)
            out, wall, _, loop_cpu = asyncio.run(cs.direct_burst(eng, requests))
            stats = cs.edge_stats(out, wall, 0.0, loop_cpu)
            got = [r["tokens"] for r in out]
            want = want or got
            same = sum(a == b for a, b in zip(got, want))
            row = dict(impl=impl, warm=i == 0, ttft_p50_s=stats["ttft_p50_s"],
                       ttft_max_s=stats["ttft_max_s"], wall_s=wall,
                       loop_cpu_s=stats["loop_cpu_s"], hash_s=spent[0], same_tokens=same)
            bursts.append(row)
            print(f"{smi}: burst {i} {json.dumps(row)}", flush=True)
    finally:
        eng.stop()
    summary = {"device": smi, "layers": args.layers, "ingress": ing, "bursts": bursts}
    for impl in ("native", "python"):
        rows = [b for b in bursts if b["impl"] == impl and not b["warm"]]
        summary[impl] = {k: statistics.mean(b[k] for b in rows)
                         for k in ("ttft_p50_s", "ttft_max_s", "wall_s", "hash_s")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
