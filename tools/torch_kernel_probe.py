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
   mixed batch, verify spans and decode rows (bf16 pools), and its mixed entry point
   on float32 pools at the smoke's mixed batch and verify spans (the
   float32 mixed kernel, ``csrc/ragged_attention.cu``), in the order
   parent, this, this, parent, by the same timer, and each design's
   hand-written kernels' device time a call by ``torch.profiler``. The
   parent builds into its own ``_build/``.
3. The split-KV decode kernel (``csrc/ragged_decode_split.cu``) at
   growing row lengths (its fixed cost), at three split lengths on the
   smoke's decode rows in five interleaved rounds, and its two passes'
   device time by ``torch.profiler``.
4. The float32 mixed kernel's chunk length, ring depth and warps an
   m-tile: copies of ``csrc/ragged_attention.cu`` with other values of
   ``kChunk``, ``kStages`` and ``kSplit`` (and one with blocks in stream
   order), and copies with a part taken out or cut to one TF32 term,
   each built in a temporary directory, timed in three interleaved
   rounds on the mixed batch, the verify spans, a lone decode row at
   2,049, one run of 32 queries at 2,048 and four 512-query chunks at
   context 2,048 (float32 pools), with each copy's largest difference
   from this build's output.

``--float32-only`` runs only the float32 parts of 2 and 4.

Prints one line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import re
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
        "      if (nx + 1 < nch)",
        "      if (nx + 1 < nch)",
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
# Float32 mixed kernel variants (kChunk, kStages, kSplit: warps an
# m-tile, blocks in reverse stream order): every (chunk, stages) that
# fits one block's 227 KB of shared memory at D = 128 with one warp an
# m-tile (128 rows a block) and with two (64 rows), and the committed
# one (first) in stream order.
F32_VARIANTS = [(64, 2, 2, True), (32, 2, 1, True), (32, 3, 1, True), (32, 4, 1, True),
                (64, 2, 1, True), (64, 2, 2, False)]
# Parts of the float32 mixed kernel taken out or cut to one TF32 term,
# as ABLATIONS (a copy computes wrong or less exact values; its time and
# its difference from this build are read).
F32_ABLATIONS = [
    ("no PV", [(
        "    if (!kMasked || kk < nn) {\n      uint32_t ah[4], al[4];",
        "    if (false) {\n      uint32_t ah[4], al[4];",
    )]),
    ("no QK products (nor their splits)", [(
        "        mma_3xtf32_apart(s[n], sa[n], sb[n], ah, al, kb.x, kb.y);",
        "        s[n][0] += kb.x; s[n][1] += kb.y;",
    )]),
    ("QK's three terms in one accumulator", [(
        "        mma_3xtf32_apart(s[n], sa[n], sb[n], ah, al, kb.x, kb.y);",
        "        mma_3xtf32(s[n], ah, al, kb.x, kb.y);",
    )]),
    ("QK in one TF32 term", [(
        "        mma_3xtf32_apart(s[n], sa[n], sb[n], ah, al, kb.x, kb.y);",
        "        mma_tf32(s[n], ah, __float_as_uint(kb.x), __float_as_uint(kb.y));",
    )]),
    ("PV in one TF32 term", [(
        "      for (int n = 0; n < NT; ++n) mma_3xtf32(acc[n], ah, al, vr[n * 8], "
        "vr[L::LDV + n * 8]);",
        "      for (int n = 0; n < NT; ++n)\n"
        "        mma_tf32(acc[n], ah, __float_as_uint(vr[n * 8]),"
        " __float_as_uint(vr[L::LDV + n * 8]));",
    )]),
    ("no K/V staging after the first chunks", [(
        "      stager.issue(k, v, ps, ps_log2, fused, kvh, nb, nb + kChunk * L::LDK);\n"
        "      if (nx + 1 < nch)",
        "      if (nx + 1 < nch)",
    )]),
]
# Names of the hand-written kernels, as torch.profiler lists them.
KERNEL_NAMES = ("ragged_attention_kernel", "mixed_tc_kernel", "decode_split_kernel",
                "decode_combine_kernel")


def mixed_launch(torch, lib, q, k, v, table, row_of, pos, hkv, ps, fn="dx_ragged_mixed_tc"):
    """One launch of the mixed launcher ``fn`` from ``lib`` (q_tile 8,
    no window, no softcap)."""
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    out = torch.empty_like(q)
    N, H, D = q.shape
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), row_of.data_ptr(),
        pos.data_ptr(), out.data_ptr(), N, H, hkv, D, ps, table.shape[1], 8,
        float(D**-0.5), tra.NO_WINDOW, 0.0, torch.cuda.current_stream().cuda_stream,
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


def f32_variant(source, chunk, stages, split, reverse):
    """``csrc/ragged_attention.cu`` at D <= 128 with ``kChunk = chunk``,
    ``kStages = stages``, ``kSplit = split`` and, unless ``reverse``,
    blocks in stream order; D = 256 is taken out (its ring would not fit
    some of these depths)."""
    text = source
    edits = ((r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};"),
             (r"constexpr int kSplit = \d+;", f"constexpr int kSplit = {split};"),
             (r"int kChunk = D > 128 \? 32 : \d+;", f"int kChunk = D > 128 ? 32 : {chunk};"),
             (r"static_assert\(Layout<256>.*\n", ""),
             (r"DX_LAUNCH\(256\);", "return (int)cudaErrorInvalidValue;"))
    for old, new in edits:
        text, n = re.subn(old, new, text)
        assert n == 1, "the float32 kernel source changed"
    if not reverse:
        old = "const int tile = n_tiles - 1 - (int)(blockIdx.x / Hkv);"
        assert old in text, "the float32 kernel source changed"
        text = text.replace(old, "const int tile = (int)(blockIdx.x / Hkv);")
    return text


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
    ap.add_argument("--float32-only", action="store_true",
                    help="only the float32 mixed kernel's parts (2 and 4)")
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
    if not args.float32_only:
        ablations(torch, np, cs, tra, batches, flush, dev)

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

    def mixed(batch):
        return lambda mod: lambda: mod.ragged_paged_attention(
            *batch, num_kv_heads=cs.HKV, q_tile=8)

    f32 = {
        name: cs.flat_batch(torch, np, 0, spans, 8, torch.float32, dev)
        for name, spans in (("mixed", cs.MIXED_SPANS), ("verify", cs.VERIFY_SPANS),
                            ("lone 1@2049", [(1, 2049)]), ("one run 32@2048", [(32, 2048)]),
                            ("4 x 512@2048", batches["4 x 512@2048"]))
    }

    # 2. the parent's designs against this one's
    if args.parent:
        parent = import_parent(args.parent)
        parent.load_kernel()
        entries = [("mixed float32", mixed(f32["mixed"]), 10),
                   ("verify float32", mixed(f32["verify"]), 20)]
        if not args.float32_only:
            bf16_mixed = cs.flat_batch(torch, np, 0, cs.MIXED_SPANS, 8, torch.bfloat16, dev)
            bf16_verify = cs.flat_batch(torch, np, 0, cs.VERIFY_SPANS, 8, torch.bfloat16, dev)
            entries = [("mixed bf16", mixed(bf16_mixed), 20),
                       ("verify bf16", mixed(bf16_verify), 20),
                       ("decode bf16", lambda mod: decode(cs.DECODE_LENGTHS, mod=mod), 50),
                       *entries]
        for entry, make, reps in entries:
            got = {"parent": make(parent)(), "this": make(tra)()}
            err = float((got["parent"].float() - got["this"].float()).abs().max())
            for who, mod in (("parent", parent), ("this", tra), ("this", tra),
                             ("parent", parent)):
                fn = make(mod)
                print(f"[probe] {entry}, {who} design: "
                      f"{cs.timed(torch, fn, reps, flush):.4f} ms (events), "
                      f"{kernel_ms(torch, fn, reps):.4f} ms kernels (torch.profiler); "
                      f"outputs differ by {err:.3e}", flush=True)

    # 3. the decode kernel
    if not args.float32_only:
        decode_probe(torch, cs, tra, decode, flush)

    # 4. the float32 mixed kernel's chunk and ring depth
    f32_sweep(torch, cs, tra, f32, flush)
    return 0


def ablations(torch, np, cs, tra, batches, flush, dev):
    """Section 1: the bf16 mixed kernel and copies with a part taken out."""
    inputs = {
        name: cs.flat_batch(torch, np, 0, spans, 8, torch.bfloat16, dev)
        for name, spans in batches.items()
    }
    source = open(os.path.join(HERE, "dynamo_exp_tpu_torch", "csrc",
                               "ragged_mixed_tc.cu")).read()
    texts = []
    for label, edits in ABLATIONS:
        text = source
        for old, new in edits:
            assert old in text, f"{label}: the kernel source changed"
            text = text.replace(old, new)
        texts.append(text)
    with tempfile.TemporaryDirectory() as tmp:
        paths = build_copies(tra, texts, tmp)
        for (label, _), path in zip(ABLATIONS, paths):
            lib = tra.open_library(path, ("dx_ragged_mixed_tc",))
            times = []
            for name, batch in inputs.items():
                def call(batch=batch, lib=lib):
                    return mixed_launch(torch, lib, *batch, cs.HKV, cs.PS)
                times.append(f"{name} {cs.timed(torch, call, 20, flush):.4f} ms")
            print(f"[probe] mixed, {label}: " + ", ".join(times), flush=True)


def build_copies(tra, texts, tmp):
    """Build each source text into its own library in ``tmp``, one nvcc
    each, all together; returns the libraries' paths."""
    copies = []
    for i, text in enumerate(texts):
        copies.append(os.path.join(tmp, f"copy_{i}.cu"))
        with open(copies[-1], "w") as f:
            f.write(text)
    with ThreadPoolExecutor(len(copies)) as pool:
        return list(pool.map(lambda c: tra.build_kernel(
            force=True, sources=(c,), lib_path=c[:-3] + ".so"), copies))


def decode_probe(torch, cs, tra, decode, flush):
    """Section 3: the split-KV decode kernel."""
    B = len(cs.DECODE_LENGTHS)
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


def f32_sweep(torch, cs, tra, inputs, flush):
    """Section 4: ``F32_VARIANTS`` and ``F32_ABLATIONS`` of the float32
    mixed kernel, three interleaved rounds on each of ``inputs``."""
    source = open(os.path.join(HERE, "dynamo_exp_tpu_torch", "csrc",
                               "ragged_attention.cu")).read()
    labels, texts = [], []
    for chunk, stages, split, reverse in F32_VARIANTS:
        order = "reverse" if reverse else "stream"
        labels.append(f"chunk {chunk}, {stages} stages, {split} warps an m-tile, blocks in "
                      f"{order} order")
        texts.append(f32_variant(source, chunk, stages, split, reverse))
    for label, edits in F32_ABLATIONS:
        text = source
        for old, new in edits:
            assert old in text, f"{label}: the kernel source changed"
            text = text.replace(old, new)
        labels.append(f"committed, {label}")
        texts.append(text)
    with tempfile.TemporaryDirectory() as tmp:
        paths = build_copies(tra, texts, tmp)
        libs = [tra.open_library(p, ("dx_ragged_attention",)) for p in paths]
        times = {(i, name): [] for i in range(len(libs)) for name in inputs}
        errs = {}
        for name, batch in inputs.items():
            want = tra.ragged_paged_attention(*batch, num_kv_heads=cs.HKV, q_tile=8)
            for i, lib in enumerate(libs):
                got = mixed_launch(torch, lib, *batch, cs.HKV, cs.PS, "dx_ragged_attention")
                errs[i, name] = float((got - want).abs().max())
        for _ in range(3):
            for i, lib in enumerate(libs):
                for name, batch in inputs.items():
                    def call(batch=batch, lib=lib):
                        return mixed_launch(torch, lib, *batch, cs.HKV, cs.PS,
                                            "dx_ragged_attention")
                    times[i, name].append(cs.timed(torch, call, 10, flush))
        for i, label in enumerate(labels):
            print(f"[probe] float32 mixed, {label}: " + "; ".join(
                      f"{name} mean {sum(ts) / len(ts):.4f} ms, min {min(ts):.4f} "
                      f"(differs from this build by {errs[i, name]:.3e})"
                      for (j, name), ts in times.items() if j == i), flush=True)


if __name__ == "__main__":
    sys.exit(main())
