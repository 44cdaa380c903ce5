#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone, on NVIDIA GPUs.

    python3 tools/torch_phase18.py

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase18``: ``python -m dynamo_exp_tpu_torch.run ... --tp
2`` in subprocesses (one card: both ranks on it over gloo; two or more:
a card each over NCCL): (a) llama-8b at full width and 8 of its 32
layers, bf16, phase 5's prompts and a rerun; (b) llama-8b's width at 4
layers, float32, against the tp=1 engine; (c) Qwen1.5-MoE-A2.7B's width
at 4 layers, bf16, and a rerun. It prints the phase's lines, rank 0's
launches by kernel and the wall.
"""

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

    if not torch.cuda.is_available():
        print("torch_phase18: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase18(torch, np, pkg, tra, smi)
    print(f"backend {out['backend']} over {out['cards']} card(s); launches by kernel "
          f"(rank 0): (a) {out['designs']}, (b) {out['designs_f32']}, (c) "
          f"{out['designs_moe']}; total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
