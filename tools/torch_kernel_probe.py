#!/usr/bin/env python3
"""What holds the port's ragged attention kernels back, on one NVIDIA GPU.

    python3 tools/torch_kernel_probe.py [--parent DIR]

Run from the root of the repository on a machine with the card and
``nvcc``. It imports the port and ``chip_smoke.py``'s helpers (shapes,
inputs, timer), never JAX. Every time is the mean device time of a
call after an L2 flush, by CUDA events (``chip_smoke.timed``); bf16
pools, llama-8b attention shapes (H=32, Hkv=8, D=128, page 16).

1. The tensor-core mixed kernel (``csrc/ragged_mixed_tc.cu``) on the
   smoke's mixed batch (MIXED), on one run of 32 queries over 2,048
   tokens (one block per kv head: the time of one block's walk), and on
   four 512-query prefill chunks at context 2,048 (enough blocks to fill
   the card): the full kernel, then copies of its source with one part
   taken out, each built in a temporary directory and timed in turn. A
   copy computes wrong values; only its time is read.
2. With ``--parent DIR`` (an unpacked checkout of an earlier commit):
   that checkout's two entry points against this one's on the smoke's
   mixed batch and decode rows, in the order parent, this, this,
   parent, by the same timer, and each design's hand-written kernels'
   device time a call by ``torch.profiler``. The parent builds into its
   own ``_build/``.
3. The split-KV decode kernel (``csrc/ragged_decode_split.cu``) at
   growing row lengths (its fixed cost), at three split lengths on the
   smoke's decode rows in five interleaved rounds, and its two passes'
   device time by ``torch.profiler``.

Prints one line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Parts of the mixed kernel taken out, as (label, [(text, replacement)]).
ABLATIONS = [
    ("full kernel", []),
    ("no K/V staging after the first chunks", [(
        "      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * LD);\n"
        "      if (nx + 1 < nchunks)",
        "      if (nx + 1 < nchunks)",
    )]),
    ("no K fragment loads (ldmatrix)", [(
        "        ldmatrix_x4(b, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +\n"
        "                           ((lane >> 3) & 1) * 8);",
        "        b[0] = a[0][0] + np; b[1] = a[0][1] ^ ks; b[2] = a[0][2]; b[3] = a[0][3];",
    )]),
    ("no softmax", [
        ("  // Online softmax; a row's 4 threads (one quad) share its max.",
         "  float al[kMT][2];\n  bool moved = false;\n  if (false) {"),
        ("    l[mt][1] = l[mt][1] * al[mt][1] + sum[1];\n  }",
         "    l[mt][1] = l[mt][1] * al[mt][1] + sum[1];\n  }\n  }"),
    ]),
    ("no PV", [(
        "    if (!kMasked || kk < pairs) {\n      uint32_t a[kMT][4];",
        "    if (false) {\n      uint32_t a[kMT][4];",
    )]),
    ("no QK and no PV", [
        ("    if (!kMasked || kk < pairs) {\n      uint32_t a[kMT][4];",
         "    if (false) {\n      uint32_t a[kMT][4];"),
        ("  for (int ks = 0; ks < KS; ++ks) {\n    uint32_t a[kMT][4];",
         "  for (int ks = 0; ks < 0; ++ks) {\n    uint32_t a[kMT][4];"),
    ]),
]
# Names of the hand-written kernels, as torch.profiler lists them.
KERNEL_NAMES = ("ragged_attention_kernel", "mixed_tc_kernel", "decode_split_kernel",
                "decode_combine_kernel")


def mixed_launch(torch, lib, q, k, v, table, row_of, pos, hkv, ps):
    """One launch of ``dx_ragged_mixed_tc`` from ``lib`` (q_tile 8)."""
    out = torch.empty_like(q)
    N, H, D = q.shape
    err = lib.dx_ragged_mixed_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), row_of.data_ptr(),
        pos.data_ptr(), out.data_ptr(), N, H, hkv, D, ps, table.shape[1], 8,
        float(D**-0.5), torch.cuda.current_stream().cuda_stream,
    )
    assert err == 0, f"launch failed: cudaError {err}"
    return out


def kernel_ms(torch, fn, reps):
    """Device time a call of the hand-written kernels ``fn`` launches,
    by torch.profiler (L2 warm: no flush between calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.time_range.end - e.time_range.start
        for e in prof.events()
        if e.device_type.name == "CUDA" and any(n in e.name for n in KERNEL_NAMES)
    )
    return us / 1e3 / reps


def import_parent(path):
    """The port's ragged attention module of the checkout at ``path``,
    imported as ``parent_port``."""
    pkg = os.path.join(os.path.abspath(path), "dynamo_exp_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_port.ops.ragged_attention")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to time against this one")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke as cs
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    # 1. the mixed kernel and its ablations
    batches = {
        "MIXED": cs.MIXED_SPANS,
        "one run 32@2048": [(32, 2048)],
        "4 x 512@2048": [(512, 2048)] * 4,
    }
    inputs = {
        name: cs.flat_batch(torch, np, 0, spans, 8, torch.bfloat16, dev)
        for name, spans in batches.items()
    }
    source = open(os.path.join(HERE, "dynamo_exp_tpu_torch", "csrc",
                               "ragged_mixed_tc.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        copies = []
        for i, (label, edits) in enumerate(ABLATIONS):
            text = source
            for old, new in edits:
                assert old in text, f"{label}: the kernel source changed"
                text = text.replace(old, new)
            copies.append(os.path.join(tmp, f"ablation_{i}.cu"))
            with open(copies[-1], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(len(copies)) as pool:  # one nvcc each, together
            paths = list(pool.map(lambda c: tra.build_kernel(
                force=True, sources=(c,), lib_path=c[:-3] + ".so"), copies))
        for (label, _), path in zip(ABLATIONS, paths):
            lib = tra.open_library(path, ("dx_ragged_mixed_tc",))
            times = []
            for name, batch in inputs.items():
                def call(batch=batch, lib=lib):
                    return mixed_launch(torch, lib, *batch, cs.HKV, cs.PS)
                times.append(f"{name} {cs.timed(torch, call, 20, flush):.4f} ms")
            print(f"[probe] mixed, {label}: " + ", ".join(times), flush=True)

    # The smoke's decode rows.
    B = len(cs.DECODE_LENGTHS)
    spans = [(1, max(cs.DECODE_LENGTHS))] * B
    q, k, v, table, _, _ = cs.flat_batch(torch, np, 1, spans, 1, torch.bfloat16, dev)
    q, table = q[:B].contiguous(), table[:B].contiguous()

    def decode(lens, split=None, mod=tra):
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = {} if split is None else {"split": split}
        return lambda: mod.ragged_decode_attention(
            q, k, v, table, lens, num_kv_heads=cs.HKV, **kw)

    # 2. the parent's designs against this one's
    if args.parent:
        parent = import_parent(args.parent)
        parent.load_kernel()
        mq, mk, mv, mt, mr, mp = inputs["MIXED"]
        for entry, make in (
            ("mixed", lambda mod: lambda: mod.ragged_paged_attention(
                mq, mk, mv, mt, mr, mp, num_kv_heads=cs.HKV, q_tile=8)),
            ("decode", lambda mod: decode(cs.DECODE_LENGTHS, mod=mod)),
        ):
            reps = 20 if entry == "mixed" else 50
            got = {"parent": make(parent)(), "this": make(tra)()}
            err = float((got["parent"].float() - got["this"].float()).abs().max())
            for who, mod in (("parent", parent), ("this", tra), ("this", tra),
                             ("parent", parent)):
                fn = make(mod)
                print(f"[probe] {entry} bf16, {who} design: "
                      f"{cs.timed(torch, fn, reps, flush):.4f} ms (events), "
                      f"{kernel_ms(torch, fn, reps):.4f} ms kernels (torch.profiler); "
                      f"outputs differ by {err:.3e}", flush=True)

    # 3. the decode kernel
    for n in (1, 32, 128, 256, 1024, max(cs.DECODE_LENGTHS)):
        ms = cs.timed(torch, decode([n] * B, tra.DECODE_SPLIT), 50, flush)
        print(f"[probe] decode, {B} rows of length {n}, split {tra.DECODE_SPLIT}: "
              f"{ms:.4f} ms", flush=True)
    splits = (64, 128, 256)
    by_split = {sp: [] for sp in splits}
    for _ in range(5):
        for sp in splits:
            by_split[sp].append(cs.timed(torch, decode(cs.DECODE_LENGTHS, sp), 50, flush))
    for sp, ts in by_split.items():
        print(f"[probe] decode, lengths {cs.DECODE_LENGTHS}, split {sp}: mean "
              f"{sum(ts) / len(ts):.4f} ms, min {min(ts):.4f}, rounds "
              + " ".join(f"{t:.4f}" for t in ts), flush=True)
    from torch.profiler import ProfilerActivity, profile

    call = decode(cs.DECODE_LENGTHS, tra.DECODE_SPLIT)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "decode_" in e.key:
            print(f"[probe] decode pass {e.key.split('(')[0][-40:]}: "
                  f"{e.device_time_total / e.count / 1e3:.4f} ms a call "
                  f"({e.count} calls, torch.profiler)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
