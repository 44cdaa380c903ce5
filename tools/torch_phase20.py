#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone, on one NVIDIA GPU.

    python3 tools/torch_phase20.py

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does (the rendered workers
reuse that build, copied into the unpacked artifact with its stamp),
then runs ``chip_smoke.phase20``: the deploy CLI builds, renders, pushes
and deploys the port's agg_router graph (llama-8b at full width and
depth, two CudaWorkers on the card), the operator reconciles it, the
rendered commands run as processes with only the unpacked artifact on
``PYTHONPATH`` and serve phase 5's lengths as chats, and the router
service and the metrics exporter beside them answer for the fleet. It
prints the phase's lines, the workers' launches by kernel and the wall.
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
        print("torch_phase20: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase20(torch, np, pkg, tra, smi)
    print(f"launches by kernel: (a) {out['designs_a']}, (b) {out['designs_b']}; phase 20 "
          f"{out['wall_s']:.1f} s, total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
