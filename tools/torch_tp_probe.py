#!/usr/bin/env python3
"""The tensor-parallel ranks' collectives alone, on NVIDIA GPUs.

    python3 tools/torch_tp_probe.py [--backend gloo|nccl]

Run from the root of the repository on a machine with a card. Two rank
processes join one group through ``parallel.initialize_multihost`` as
``run.py --tp 2`` does (one card: both on ``cuda:0`` over gloo, staged
through pinned host memory; two or more: ``cuda:0`` / ``cuda:1`` over
NCCL, unless ``--backend`` says otherwise), and time ``Comm.all_reduce``
of bf16 ``[n, 4096]`` (llama-8b's hidden width: a decode step's 8 rows
up to a 4,096-token prefill chunk) and ``Comm.all_gather`` of float32
``[rows, 64128]`` (llama-8b's logits, half the vocabulary a rank): ms
per call over 20 calls after 3, the card synchronised before and after
(host wall: everything a call costs the loop). With NCCL it also prints
the transports NCCL chose (its ``NCCL_DEBUG=INFO`` lines with ``via``).
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (8, 64, 512, 2048, 4096)
LOGIT_ROWS = (9, 90)


def rank_main(rank: int, addr: str, backend: str, out) -> None:
    sys.path.insert(0, HERE)
    import torch

    from dynamo_exp_tpu_torch.parallel import MultiNodeConfig, initialize_multihost, rank_layout

    layout = rank_layout(tp=2, rank=rank)
    device = layout.device("cuda")
    comm = initialize_multihost(MultiNodeConfig(), addr, layout=layout, backend=backend,
                                device=device)

    def per_call(fn, x) -> float:
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(20):
            fn(x)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t) / 20 * 1e3

    res = {}
    for n in ROWS:
        x = torch.ones(n, 4096, dtype=torch.bfloat16, device=device)
        res[f"all_reduce bf16 [{n}, 4096]"] = per_call(comm.all_reduce, x)
    for n in LOGIT_ROWS:
        x = torch.ones(n, 64128, dtype=torch.float32, device=device)
        res[f"all_gather f32 [{n}, 64128]"] = per_call(comm.all_gather, x)
    if rank == 0:
        out.put(res)
    comm.close()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", choices=["gloo", "nccl"], default=None)
    args = p.parse_args()
    sys.path.insert(0, HERE)
    from multiprocessing import get_context

    import torch

    if not torch.cuda.is_available():
        print("torch_tp_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    _, smi = cs.device_info(torch)
    cards, backend = cs.p18_placement(torch, "cuda")
    backend = args.backend or backend
    logs = tempfile.mkdtemp()
    if backend == "nccl":
        os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=os.path.join(logs, "nccl.%p"))
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, addr, backend, q)) for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        res = q.get(timeout=300)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    print(f"[tp-probe] {smi}: 2 ranks over {cards} card(s), backend {backend}, ms per call: "
          + json.dumps({k: round(v, 4) for k, v in res.items()}), flush=True)
    if backend == "nccl":
        via = set()
        for path in glob.glob(os.path.join(logs, "nccl.*")):
            with open(path, encoding="utf-8", errors="replace") as f:
                via |= {line.split(" via ", 1)[1].strip() for line in f if " via " in line}
        print(f"[tp-probe] NCCL transports: {sorted(via)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
