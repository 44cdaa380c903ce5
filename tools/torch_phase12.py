#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 12 alone, on one NVIDIA GPU.

    python3 tools/torch_phase12.py

Run from the root of the repository on a machine with the card and
``nvcc``. It builds the kernels as the smoke does, then runs
``chip_smoke.phase12``: the port's coordinator, a llama-8b prefill
worker and decode worker process behind the HTTP ingress ((a) a burst
of remote and local prompts and lone requests against a direct
``TorchEngine``, (b) suffix-only transfers, (c) a lease never
confirmed), then two aggregated llama-8b workers, one reclaimed by
SIGTERM mid-stream ((d) live KV migration). It prints the phase's
lines, the kernels' launches in the workers and the wall. The workers
are spawned processes that import this script again, so everything
runs under ``if __name__ == "__main__"``.
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
    cs.build(tra)
    out = cs.phase12(torch, np, pkg, tra, smi)
    print(f"launches by kernel: prefill worker {out['designs_prefill']}, decode worker "
          f"{out['designs_decode']}, reclaim workers {out['designs_reclaim']}; total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
