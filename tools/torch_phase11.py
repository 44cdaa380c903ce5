#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 11 alone, on one NVIDIA GPU.

    python3 tools/torch_phase11.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, serves phase 6's lone
greedy request (300 seeded token ids, 32 tokens) on a direct
``TorchEngine`` with phase 6's configuration and seeded llama-8b
weights (the reference of phase 11 (c)), frees it, then runs
``chip_smoke.phase11``: the port's coordinator, two llama-8b worker
processes and the kv / round-robin ingress. It prints the phase's
lines, the kernels' launches in the workers and the wall. The workers
are spawned processes that import this script again, so everything
runs under ``if __name__ == "__main__"``.
"""

import asyncio
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    import dynamo_exp_tpu_torch as pkg
    import dynamo_exp_tpu_torch.engine  # noqa: F401
    import dynamo_exp_tpu_torch.models  # noqa: F401
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    cs.build(tra)
    mcfg = pkg.models.LLAMA_8B
    max_len = max(cs.PROMPT_LENS) + cs.MAX_TOKENS + cs.PS
    ecfg = pkg.engine.EngineConfig(model=mcfg, max_decode_slots=8, page_size=cs.PS,
                                   max_model_len=max_len, num_pages=8 * -(-max_len // cs.PS),
                                   kv_dtype="bfloat16")
    rs = np.random.RandomState(11)
    lone_ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=cs.LONE_PROMPT_LEN)]
    eng = pkg.engine.TorchEngine(ecfg, device="cuda")

    async def lone():
        stream = eng.submit({"token_ids": lone_ids, "stop_conditions": {
            "max_tokens": cs.MAX_TOKENS, "ignore_eos": True}})
        eng.start()
        return [t async for f in stream for t in f.get("token_ids", [])]

    try:
        tokens = asyncio.run(lone())
    finally:
        eng.stop()
    del eng
    cs.free(torch, "cuda")
    out = cs.phase11(torch, np, pkg, tra, smi, (lone_ids, tokens))
    print(f"launches of both workers by kernel {out['designs']}; total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
