#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 19 alone, on one NVIDIA GPU.

    python3 tools/torch_phase19.py

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does (the graph's workers
load that build), then runs ``chip_smoke.phase19``: ``python -m
dynamo_exp_tpu_torch.sdk.serve`` serving (a) the agg_router graph with
llama-8b at full width and depth (8 chats, admitted together, twice),
(b) with ``python -m dynamo_exp_tpu_torch.planner.planner`` beside it,
scaling the CudaWorker fleet 1 -> 2 -> 1 under two waves of long chats,
and (c) the agg graph at llama-8b's width, 4 layers, float32, against a
``TorchEngine`` in this process. It prints the phase's lines, the
workers' launches by kernel and the wall.
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
        print("torch_phase19: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase19(torch, np, pkg, tra, smi)
    print(f"launches by kernel: (a) + (b) {out['designs']}, (c) {out['designs_f32']}; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
