#!/usr/bin/env python3
"""``chip_smoke.py``'s windowed kernel cases and phase 14 alone, on one
NVIDIA GPU.

    python3 tools/torch_phase14.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, holds all three
designs against their plain versions on phase 3's windowed and
softcapped cases (``chip_smoke.check_windowed``: gemma2-9b's sliding
layers at head dim 256, mistral-7b's window at head dim 128; times,
bounds and SDPA beside them), then runs ``chip_smoke.phase14``: gemma2-9b
at full width and depth through ``TorchEngine`` (8 requests, two past
the 4,096 window, a token-identical rerun), plain against kernel at 4
layers of gemma2-9b's and mistral-7b's widths, and over HTTP with a
SentencePiece-BPE tokenizer. It prints the phase's lines, the kernels'
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
        print("torch_phase14: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    cs.check_windowed(torch, np, tra, flush)
    del flush
    out = cs.phase14(torch, np, pkg, tra, smi)
    print(f"launches by kernel {out['designs']} (engine), {out['designs_http']} (HTTP); "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
