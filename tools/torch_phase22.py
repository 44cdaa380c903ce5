#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 alone, on one NVIDIA GPU.

    python3 tools/torch_phase22.py

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase22``: (a) phase 5's burst on llama-8b under
``torch.cuda.set_sync_debug_mode("warn")``, every reported sync site in
a hot-path zone held against the lint's waived lines; (b) the CLIP
ViT-L/14-336 tower's 576 soft tokens and an 8-token prompt through one
mixed dispatch of llama-8b's width at 4 layers, then greedy tokens
through the decode kernel; (c) the ring prefill over sp = 2 gloo ranks
on the card against one single-rank float32 dispatch. It prints the
phase's lines, the launches by kernel and the wall.
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
        print("torch_phase22: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase22(torch, np, pkg, tra, smi)
    print(f"launches by kernel: (a) {out['designs_a']}, (b) {out['designs_b']}, (c) "
          f"{out['designs_c']}; phase 22 {out['wall_s']:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
