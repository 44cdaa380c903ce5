#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 13 alone, on one NVIDIA GPU.

    python3 tools/torch_phase13.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase13``: llama-8b served over HTTP in this process under
KV pressure with ``--trace-file``, ``--profiler-port`` and a pinned
``DYN_WORKLOAD_REF``; (a) the request anatomy offline and live, (b)
the workload fingerprint's digest, (c) drift, (d) ``torch.profiler``
traces by call and through the listener, (e) ``llmctl`` on the phase's
own trace file and flight dump. It prints the phase's lines, the
kernels' launches and the wall.
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

    t0 = time.perf_counter()
    _, smi = cs.device_info(torch)
    print(smi, flush=True)
    cs.build(tra)
    out = cs.phase13(torch, np, pkg, tra, smi)
    print(f"launches by kernel {out['designs']}; total {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
