#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 17 alone, on one NVIDIA GPU.

    python3 tools/torch_phase17.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase17``: Mistral-7B-Instruct-v0.2's width at 4 of its 32
layers written as one Q8_0 GGUF (F32 norms, F16 ``token_embd``, BF16
``output``, an embedded Unigram tokenizer and chat template), served by
``run.main_async(--model-path x.gguf)`` (load GB/s, weights bit-equal
to the file's decoding, 8 streamed chats and a rerun), then the same
model as ``config.json`` + ``tokenizer.model`` + bf16 safetensors (the
same prompt ids and tokens). It prints the phase's lines, the kernels'
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
        print("torch_phase17: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase17(torch, np, pkg, tra, smi)
    print(f"launches by kernel {out['designs']} (GGUF), {out['designs_dir']} (directory); "
          f"load {out['load_s']:.3f} s, {out['load_gbps']:.2f} GB/s; total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
