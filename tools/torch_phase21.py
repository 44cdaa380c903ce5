#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 21 alone, with phase 3's other q tiles, on
one NVIDIA GPU.

    python3 tools/torch_phase21.py [--skip-q-tiles]

Run from the root of the repository on a machine with a card and
``nvcc``. It builds the kernels as the smoke does, holds the mixed
kernels at q_tile 1, 4 and 16 against their plain version
(``chip_smoke.check_q_tiles``: llama-8b's heads and gemma2's D=256 with
its softcap and window, both pool dtypes; q_tile 16 timed), then runs
``chip_smoke.phase21``: (a) the simulator's calibration bridge and the
service-time fit at llama-8b's full width and depth, (b) ``llmctl tune
--top-k 3`` with live validation on llama-8b engines and the
contrasting pair at 4 layers, (c) a warm boot from the tuned artifact.
It prints the phase's lines, the launches by kernel and the wall.
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
        print("torch_phase21: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    if "--skip-q-tiles" not in sys.argv:
        flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        t1 = time.perf_counter()
        cs.check_q_tiles(torch, np, tra, flush)
        del flush
        print(f"phase 3's q tiles in {time.perf_counter() - t1:.1f} s", flush=True)
    out = cs.phase21(torch, np, pkg, tra, smi)
    print(f"launches by kernel: (a) {out['designs_a']}, (b) {out['designs_b']}, (c) "
          f"{out['designs_c']}; phase 21 {out['wall_s']:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
