#!/usr/bin/env python3
"""``chip_smoke.py``'s windowed kernel cases and phase 15 alone, on one
NVIDIA GPU.

    python3 tools/torch_phase15.py [--skip-windowed]

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, runs phase 3's
windowed and softcapped cases (``chip_smoke.check_windowed``, whose
softcap rows time ``flex_attention`` as their library yardstick) unless
``--skip-windowed``, then ``chip_smoke.phase15``: the G3 persistent KV
tier at llama-8b width and depth (demotion, hard kill, reboot, restore),
its fault containment at float32, ``DYN_KV_STORE`` across processes,
and the chaos planes in front of two engines. It prints the phase's
lines, the kernels' launches and the wall.
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
        print("torch_phase15: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    if "--skip-windowed" not in sys.argv[1:]:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        t1 = time.perf_counter()
        cs.check_windowed(torch, np, tra, flush)
        print(f"windowed cases in {time.perf_counter() - t1:.1f} s", flush=True)
        del flush
    out = cs.phase15(torch, np, pkg, tra, smi)
    print(f"launches by kernel {out['designs_g3']} (G3), {out['designs_chaos']} (chaos); "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
