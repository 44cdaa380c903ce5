#!/usr/bin/env python3
"""Whether ``torch._grouped_mm`` can carry the MoE FFN's grouped
products on this card, as ``ops/moe.py`` uses it.

    python3 tools/torch_grouped_mm_probe.py

On a machine with an NVIDIA GPU: prints the Python, torch and CUDA
versions and the card's name and power limit; then, at mixtral-8x7b's
gate shape (8 experts of 14,336 x 4,096, bf16), for 16, 1,024 and 5
rows (the last all in one expert) the product's largest difference from
a per-expert loop of ``x @ w[e].T`` and its mean device ms over 20
launches (CUDA events, no L2 flush); whether the dispatch (group sizes
by ``scatter_add_``, ends by ``cumsum``, a stable sort) runs under
``torch.cuda.set_sync_debug_mode("error")`` and replays from a CUDA
graph equal to an eager call; and the same three checks (equality
with the loop, sync debug "error", a graph replay) in float32.
"""

import subprocess
import sys

import torch


def dispatch_checks(w, E: int, D: int, dev: str, dt) -> None:
    """16 rows routed at random: the dispatch and the grouped product
    against the per-expert loop, under sync debug "error", and replayed
    from a CUDA graph."""
    x = torch.randn(16, D, device=dev, dtype=dt)
    ids = torch.randint(0, E, (16,), device=dev)

    def f():
        counts = torch.zeros(E, dtype=torch.int32, device=dev)
        counts.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        order = torch.sort(ids, stable=True).indices
        return torch._grouped_mm(x[order], w.transpose(-1, -2), offs=offs), order

    name = str(dt).split(".")[-1]
    try:
        out, order = f()
        ref = torch.stack([x[order][i] @ w[int(e)].T for i, e in enumerate(ids[order].tolist())])
        print(name, "loop maxerr", (out.float() - ref.float()).abs().max().item(), flush=True)
    except Exception as e:
        print(name, "ERR", type(e).__name__, str(e)[:300], flush=True)
        return
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        f()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(name, "sync-free ok", flush=True)
    except Exception as e:
        torch.cuda.set_sync_debug_mode(0)
        print(name, "sync ERR", str(e)[:300], flush=True)
    try:
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            f()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got, _ = f()
        g.replay()
        torch.cuda.synchronize()
        print(name, "graph ok", (got.float() - f()[0].float()).abs().max().item(), flush=True)
    except Exception as e:
        print(name, "graph ERR", type(e).__name__, str(e)[:300], flush=True)


def main() -> None:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi","--query-gpu=name,power.limit","--format=csv,noheader"],capture_output=True,text=True).stdout)
    print("has _grouped_mm", hasattr(torch, "_grouped_mm"))
    dev = "cuda"
    E, D, I = 8, 4096, 14336
    w = torch.randn(E, I, D, device=dev, dtype=torch.bfloat16) * D**-0.5
    for M in (16, 1024, 5):
        counts = torch.zeros(E, dtype=torch.int32, device=dev)
        ids = torch.randint(0, E, (M,), device=dev)
        if M == 5:
            ids = torch.zeros(M, dtype=torch.long, device=dev)
        counts.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        ids_sorted = torch.sort(ids, stable=True)
        x = torch.randn(M, D, device=dev, dtype=torch.bfloat16)
        try:
            out = torch._grouped_mm(x, w.transpose(-1, -2), offs=offs)
            ref = torch.empty_like(out)
            c = counts.tolist(); s = 0
            for e in range(E):
                ref[s:s+c[e]] = x[s:s+c[e]] @ w[e].T; s += c[e]
            print("M", M, "shape", tuple(out.shape), "maxerr", (out.float()-ref.float()).abs().max().item(), flush=True)
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
            for _ in range(3): torch._grouped_mm(x, w.transpose(-1, -2), offs=offs)
            ev0.record()
            for _ in range(20): torch._grouped_mm(x, w.transpose(-1, -2), offs=offs)
            ev1.record(); torch.cuda.synchronize()
            print("  ms", ev0.elapsed_time(ev1)/20)
        except Exception as e:
            print("M", M, "ERR", type(e).__name__, str(e)[:500], flush=True)
    # Sync debug and graph capture, in bf16 and in float32.
    for dt in (torch.bfloat16, torch.float32):
        dispatch_checks(w.to(dt), E, D, dev, dt)
    print(torch.backends.cuda.matmul.allow_tf32)
    print(subprocess.run(["ls","/usr/local/cuda/bin"],capture_output=True,text=True).stdout[:300])


if __name__ == "__main__":
    main()
