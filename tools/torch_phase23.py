#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 23 alone, on one NVIDIA GPU.

    python3 tools/torch_phase23.py

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase23``, the KV tiers at tp=2 (two ranks over gloo on the
one card, or a card each over NCCL), llama-8b's width at 4 of its 32
layers: (a) ``run.py --tp 2 --host-cache-pages`` under KV pressure, a
rerun, and float32 tp=2 against tp=1 with the tier; (b) each degree's
G3 store read by a restarted engine of the other; (c) a tp=1 prefill
worker feeding a tp=2 decode worker over the KV wire, and a
suffix-only transfer; (d) SIGTERM to a ``run.py --tp 2`` worker
migrating its streams to a tp=1 survivor. It prints the phase's lines,
the launches by kernel and the wall.
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
        print("torch_phase23: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase23(torch, np, pkg, tra, smi)
    print(f"launches by kernel: (a) {out['designs_a']}, (b) {out['designs_b']}, (c) "
          f"{out['designs_c']}, (d) {out['designs_d']}; phase 23 {out['wall_s']:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
