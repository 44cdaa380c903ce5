#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 16 alone, on one NVIDIA GPU.

    python3 tools/torch_phase16.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase16``: mixtral-8x7b at 24 of its 32 layers through
``run.build_cuda_engine(--model-path <dir> --random-weights)`` with
prompts that share partial tails (copy-on-write), the grouped MoE
products against their plain version at Qwen3-30B-A3B's,
Qwen1.5-MoE-A2.7B's and mixtral's widths (4 layers each, the FFN timed
at a decode batch of 8 and a 512-token chunk), and prefix sharing on
against off at float32. It prints the phase's lines, the kernels'
launches and the wall.
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
        print("torch_phase16: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase16(torch, np, pkg, tra, smi)
    print(f"launches by kernel {out['designs']} (mixtral), {out['designs_f32']} (float32); "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
