#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dynamo_exp_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. the card's name and power limit, the torch and CUDA versions;
2. build the ragged attention kernels from ``dynamo_exp_tpu_torch/csrc``
   (one nvcc per source, all started together, sm_90a) and load them;
   print each kernel's registers and spills;
3. hold both kernel entry points against their plain PyTorch version on
   the card at the llama-8b attention shapes (H=32, Hkv=8, D=128, page
   size 16): the mixed shape (q_tile=8) with ragged spans, page-boundary
   lengths, 1-token rows and an empty tile, and the decode shape
   (q_tile=1) with inactive rows, which must be exact zeros; once with
   bf16 pools (the main path's: the tensor-core mixed kernel and the
   split-KV decode kernel) and once with float32 pools at a tight
   tolerance (the CUDA-core mixed kernel and the split-KV decode
   kernel); the bf16 kernels are also held, at a tolerance set by
   bf16's rounding, against the plain version on float32 copies of the
   same inputs; time the bf16 kernel, the plain version and, as a
   yardstick only, one ``scaled_dot_product_attention`` call over the
   gathered pages;
4. llama-8b's logits through the kernel agree with the plain path on a
   short prompt;
5. the main path: ``TorchEngine`` serving llama-8b at full width and
   depth (random bf16 weights from a seed) answers 8 concurrent requests
   (prompts of 64 to 2048 tokens, 32 tokens each, seven greedy and one
   seeded at temperature 0.8); every request finishes with ``length``
   and 32 tokens, both entry points' launch counters rose during the
   run, the bf16 mixed dispatches went through the tensor-core kernel
   and the decode steps through the split-KV kernel, and a rerun of the
   same requests gives the same tokens; the model is then freed;
6. the entry point a user calls: ``run.main_async(in=http out=cuda)``
   in this process serves a model directory written here (the
   llama-8b preset's config.json, read back equal to the preset; a
   Llama-3-layout byte-level BPE tokenizer.json of 128,256 entries
   with merges learned from README.md; a Llama-3-style chat template;
   EOS 128009) with the same seeded random weights. A stdlib client
   sends (a) phase 5's requests as 8 streaming ``/v1/completions``,
   admitted together, and again after the prefix cache is dropped;
   (b) 2 streaming chats; (c) a unary completion; (d) (c) again with a
   stop string cut from (c)'s text; and a lone greedy request, also
   served straight by a ``TorchEngine`` on the same weights. Every
   stream ends with ``[DONE]``; finish reasons and usage are checked,
   the rerun's text is identical, (d)'s text is (c)'s up to the stop
   string, the lone request's HTTP text equals its direct tokens
   decoded, and every attention launch of the phase went through the
   tensor-core mixed and the split-KV decode kernels. Printed: TTFT at
   the edge (p50, max), the mean gap between content frames, tokens/s
   and wall time of (a) beside phase 5's, and the host's encode time;
7. KV pressure, with a G2 host tier of 1024 pages (pinned memory) fed by
   the copy stream's side CUDA streams. (a) phase 5's 8 requests at 128
   tokens each (466 pages of 16 at their end) on a 416-page pool,
   llama-8b at full width and depth, bf16: all finish ``length`` with
   128 tokens, rows were swapped out or preempted, the page audit is
   clean with no page held, both bf16 kernels ran; printed: wall,
   tokens/s, swaps, preemptions and the copy streams' pages, bytes and
   GB/s each way (CUDA events). (b) the 2048-token prompt three times:
   cold, a G1 hit, then, after 4 other 2048-token prompts evicted its
   pages to the host tier, a G2 hit: the host tier's bytes and the
   injected pages' bytes equal (on the card) what the pages held when
   they were evicted, and the G1 and G2 hits give the same tokens. (c)
   llama-8b's width at 4 layers with float32 weights and pools: the
   pressured burst of (a) gives each request's tokens run alone on the
   same engine, through the float32 mixed kernel and the split-KV
   decode kernel.

The kernels' line has one entry per kernel design (the bf16 mixed,
split-KV decode and float32 mixed kernels), with its launches in the
main path of its dtype (phase 5; phase 7 (c) for float32), over HTTP
(phase 6) and under KV pressure (phase 7 (a), (c)).

The last three lines of standard output are the card's name and power
limit, the kernels' JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

# llama-8b attention shapes.
H, HKV, D, PS = 32, 8, 128, 16
PROMPT_LENS = (64, 160, 320, 512, 768, 1024, 1536, 2048)
MAX_TOKENS = 32
SEEDED = 5  # index of the request sampled at temperature 0.8
SEEDED_OPTIONS = {"temperature": 0.8, "seed": 1234}
# Mixed dispatch spans (q_len, kv_len): prefill chunks of 512 at several
# offsets, a short prompt, decode tokens at page boundaries and mid-page.
MIXED_SPANS = [
    (512, 512), (512, 1024), (512, 2048), (64, 64), (1, 17), (1, 1),
    (16, 32), (1, 2049), (1, 1536),
]
# Decode rows: the main path's lengths at its 16th token, two inactive.
DECODE_LENGTHS = [n + 16 for n in PROMPT_LENS]
DECODE_LENGTHS[1] = DECODE_LENGTHS[6] = 0
# Tolerances (atol, rtol) by pool dtype: see check_kernels.
TOL = {"bfloat16": (2e-2, 2.0**-7), "float32": (1e-4, 0.0)}
# Phase 7: phase 5's prompts at 128 tokens each need 466 pages of 16 at
# the burst's end; the pool holds about 0.89 of that, the host tier 1024
# pages (2 GiB pinned at llama-8b's 2 MiB a page).
PRESSURE_TOKENS = 128
PRESSURE_PAGES = 416
HOST_PAGES = 1024
F32_LAYERS = 4  # phase 7 (c): llama-8b's width, 4 layers, float32


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1
def device_info(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    return name, smi


# ------------------------------------------------------------ phase 2
def build(tra) -> float:
    t0 = time.perf_counter()
    path = tra.build_kernel(force=True)
    tra.load_kernel()
    dt = time.perf_counter() - t0
    srcs = ", ".join(os.path.basename(f) for f in tra.KERNEL_SOURCES)
    log(f"[build] {os.path.relpath(path, HERE)} from {srcs} in {dt:.1f} s "
        f"(nvcc sm_90a, one process per source)")
    # ptxas: "Compiling entry function '<mangled name>'", then its
    # spills, then its registers; one line per kernel instantiation,
    # named by its kernel and (mangled) template arguments.
    name = spill = None
    for line in tra.build_log().splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"[a-z_]+_kernel(I\w*?E)?(?=E?v)", line.split("'")[1])
            name = found.group(0) if found else line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"[build] {name}: {regs}; {spill}")
            name = None
    return dt


# ------------------------------------------------------------ phase 3
def flat_batch(torch, np, seed, spans, q_tile, dtype, device):
    """A q_tile-aligned flat stream over a scrambled page pool, one
    empty tile at the end. Returns (q, k, v, table, row_of, positions)."""
    rs = np.random.RandomState(seed)
    pmax = max(-(-max(kv, 1) // PS) for _, kv in spans)
    pages = sum(-(-max(kv, 1) // PS) for _, kv in spans) + 8
    k = torch.from_numpy(rs.standard_normal((pages, PS, HKV * D)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((pages, PS, HKV * D)).astype(np.float32))
    perm = rs.permutation(pages)
    table = np.zeros((len(spans) + 1, pmax), np.int32)
    used, row_of, positions = 0, [], []
    for r, (q_len, kv_len) in enumerate(spans):
        n = -(-max(kv_len, 1) // PS)
        table[r, :n] = perm[used : used + n]
        used += n
        pad = (-q_len) % q_tile
        row_of += [r] * (q_len + pad)
        positions += list(range(kv_len - q_len, kv_len)) + [-1] * pad
    row_of += [len(spans)] * q_tile
    positions += [-1] * q_tile
    q = torch.from_numpy(rs.standard_normal((len(row_of), H, D)).astype(np.float32))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            i32(table), i32(row_of), i32(positions))


def timed(torch, fn, reps, flush):
    """Mean device ms of ``fn`` over ``reps`` launches, each after an
    L2 flush (the engine finds a layer's KV cold), timed by CUDA events.
    A spin kernel of about 0.5 ms after the flush keeps the card busy
    while the host enqueues ``fn``, so the events time the device work
    and not the wrapper's Python."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def bound(torch, q, k, table, row_of, positions, peak=BF16_FLOP_PER_S):
    """Least time for the attention function on these inputs: each
    input byte it needs read once (q, the live K/V tokens of every row,
    the live page-table entries and the per-token indices), the output
    written once, against the flops of QK and PV over the live context,
    at the card's rate ``peak`` for the inputs' type (bf16 tensor cores;
    float32 outside them). Returns (ms, "bytes" | "operations", bytes,
    flops)."""
    pos = positions.long().cpu()
    rows = row_of.long().cpu()
    live = pos >= 0
    ctx = {}
    for r, p in zip(rows[live].tolist(), pos[live].tolist()):
        ctx[r] = max(ctx.get(r, 0), p + 1)
    tokens = sum(ctx.values())
    pages = sum(-(-n // PS) for n in ctx.values())
    el = q.element_size()
    nbytes = (
        2 * q.numel() * el  # q in, out
        + 2 * tokens * HKV * D * el  # K and V of the live context
        + pages * 4 + 2 * rows.numel() * 4
    )
    flops = 4 * H * D * int((pos[live] + 1).sum())  # QK and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def sdpa_inputs(torch, q, k, v, table, row_of, positions):
    """The same attention as one padded dense batch for
    ``scaled_dot_product_attention``: per row its queries [R, H, Tq, D]
    and its gathered pages [R, Hkv, S, D], with a causal position mask.
    Padding queries attend to key 0 (their output is ignored)."""
    rows = row_of.long().cpu().tolist()
    pos = positions.long().cpu().tolist()
    by_row: dict[int, list[int]] = {}
    for i, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            by_row.setdefault(r, []).append(i)
    R = len(by_row)
    Tq = max(len(ix) for ix in by_row.values())
    S = table.shape[1] * PS
    dev = q.device
    qd = torch.zeros(R, H, Tq, D, dtype=q.dtype, device=dev)
    qpos = torch.zeros(R, Tq, dtype=torch.long, device=dev)
    rsel = []
    for j, (r, ix) in enumerate(sorted(by_row.items())):
        ixt = torch.tensor(ix, device=dev)
        qd[j, :, : len(ix)] = q[ixt].transpose(0, 1)
        qpos[j, : len(ix)] = positions[ixt].long()
        rsel.append(r)
    t = table[torch.tensor(rsel, device=dev).long()].long()
    kd = k[t].reshape(R, S, HKV, D).transpose(1, 2).contiguous()
    vd = v[t].reshape(R, S, HKV, D).transpose(1, 2).contiguous()
    mask = torch.arange(S, device=dev)[None, None, None, :] <= qpos[:, None, :, None]
    return qd, kd, vd, mask


def close(torch, got, want, what) -> float:
    """Assert finite output within atol + rtol * |want| (``TOL`` for
    the dtype); return the max abs error."""
    atol, rtol = TOL[str(want.dtype).removeprefix("torch.")]
    g, w = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(g).all(), f"{what}: bad output"
    diff = (g - w).abs()
    excess = float((diff - (atol + rtol * w.abs())).max())
    assert excess <= 0, f"{what}: kernel and plain differ beyond tolerance by {excess}"
    return float(diff.max())


def close_to_f32(torch, got, plain, q, k, v, what) -> tuple[float, float]:
    """Read a bf16 kernel's output against the plain version on float32
    copies of the same q, k and v. The kernel rounds each unnormalised
    probability p_j to bf16 before PV (relative error at most 2^-8) and
    the output to bf16 (at most 2^-8 of it); the rest (float32 sums in
    another order, exp2.approx) is below 2^-12 of the weights. So
    element by element |got - want| <= 2^-8 |want| + (2^-8 + 2^-12)
    sum_j P_j |v_j|, where P is the normalised softmax; the plain
    version with |v| gives that sum. Dropping one 32-token chunk of a
    2,049-token row moves its outputs by up to about 2e-2: several
    times this limit (about 3e-3 there), and near the bf16 tolerance of
    ``close``, which may pass it. Returns (max abs error, max of error / limit); the
    caller asserts the latter is at most 1."""
    f32 = (q.float(), k.float(), v.float())
    want = plain(*f32)
    reach = plain(f32[0], f32[1], f32[2].abs())
    limit = 2.0**-8 * want.abs() + (2.0**-8 + 2.0**-12) * reach
    diff = (got.float() - want).abs()
    ratio = float((diff / limit.clamp_min(1e-30)).max())
    log(f"[kernel] {what} against float32 plain: max abs err {float(diff.max()):.3e}, "
        f"max err / limit {ratio:.3f} (limit 2^-8 |want| + (2^-8 + 2^-12) P|v|)")
    return float(diff.max()), ratio


def check_case(torch, call, plain, q, k, v, zeros, what) -> tuple:
    """One kernel call against the plain version: within ``close``'s
    tolerance, exact zeros where ``zeros`` selects, and for bf16 pools
    within ``close_to_f32``'s limit (read first, asserted last, so a
    failing run prints both readings). Returns (max abs error, the
    float32 reading or None)."""
    got = call()
    torch.cuda.synchronize()
    tight = close_to_f32(torch, got, plain, q, k, v, what) if q.dtype == torch.bfloat16 else None
    err = close(torch, got, plain(), what)
    assert (got[zeros] == 0).all(), f"{what}: empty tiles / inactive rows are not exact zeros"
    assert tight is None or tight[1] <= 1.0, (
        f"{what}: kernel and float32 plain differ beyond bf16 rounding")
    return err, tight


def mixed_case(torch, np, tra, dt) -> tuple:
    """The mixed shape, q_tile = 8, one empty tile at the end, against
    the plain version with ``dt`` pools. Returns (max abs err, the
    float32 reading, the inputs, the call, the plain call, the (row_of,
    positions) the plain call reads)."""
    dev = torch.device("cuda", 0)
    q, k, v, table, row_of, pos = flat_batch(torch, np, 0, MIXED_SPANS, 8, dt, dev)

    def call():
        return tra.ragged_paged_attention(
            q, k, v, table, row_of, pos, num_kv_heads=HKV, q_tile=8)

    def plain(q=q, k=k, v=v):
        return tra.ragged_paged_attention_ref(
            q, k, v, table, row_of, pos, num_kv_heads=HKV)

    zeros = slice(-8, None)  # the empty tile
    err, tight = check_case(torch, call, plain, q, k, v, zeros, f"mixed {dt}")
    return err, tight, (q, k, v, table), call, plain, (row_of, pos)


def decode_case(torch, np, tra, dt) -> tuple:
    """The decode shape, q_tile = 1, two inactive rows; as mixed_case."""
    dev = torch.device("cuda", 0)
    spans = [(1, max(n, 1)) for n in DECODE_LENGTHS]
    q, k, v, table, _, _ = flat_batch(torch, np, 1, spans, 1, dt, dev)
    B = len(DECODE_LENGTHS)
    q, table = q[:B].contiguous(), table[:B].contiguous()
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    rows = torch.arange(B, dtype=torch.int32, device=dev)

    def call():
        return tra.ragged_decode_attention(q, k, v, table, lens, num_kv_heads=HKV)

    def plain(q=q, k=k, v=v):
        return tra.ragged_paged_attention_ref(
            q, k, v, table, rows, lens - 1, num_kv_heads=HKV)

    err, tight = check_case(torch, call, plain, q, k, v, lens == 0, f"decode {dt}")
    return err, tight, (q, k, v, table), call, plain, (rows, lens - 1)


def check_kernels(torch, np, tra, flush) -> dict:
    """Kernel against plain version at the main path's shapes, with
    float32 pools and then with bf16 pools (the main path's), which are
    also timed.

    Tolerance: the kernel follows the TPU kernel's numerics (q and K in
    float32 for QK, unnormalised probabilities rounded to the pool dtype
    before PV, the softmax sum from the unrounded ones); the plain
    version rounds q to the pool dtype and the normalised probabilities.
    With float32 pools neither rounds, so the two differ only in
    summation order: atol 1e-4, rtol 0 (dropping or masking one 32-token
    chunk of a 2048-token row moves an output element by about 1e-3).
    With bf16 pools both round the output to bf16, so the two differ by
    a few bf16 ulps: atol 2e-2 (the JAX suite's bf16 bound) + rtol 2^-7,
    one bf16 ulp of the output's own size. That bound is loose beside
    the kernel's own rounding, so the bf16 kernels are also held against
    the plain version on float32 copies (``close_to_f32``)."""
    F = torch.nn.functional
    cases = {
        "ragged_paged_attention":
            (mixed_case, 8, f"mixed q_tile=8 rows={len(MIXED_SPANS)}"),
        "ragged_decode_attention":
            (decode_case, 1, f"decode q_tile=1 lengths={DECODE_LENGTHS}"),
    }
    results = {}

    def measure(inputs, call, plain, rows, pos, reps, plain_reps, peak):
        """(kernel ms, plain ms, SDPA ms, bound ms, bound_by, bytes, flops)."""
        q, k, v, table = inputs
        qd, kd, vd, mask = sdpa_inputs(torch, q, k, v, table, rows, pos)
        ms = timed(torch, call, reps, flush)
        plain_ms = timed(torch, plain, plain_reps, flush)
        lib_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), reps, flush)
        return (ms, plain_ms, lib_ms) + bound(torch, q, k, table, rows, pos, peak)

    for entry, (case, q_tile, what) in cases.items():
        err32, _, inputs32, call32, plain32, (rows32, pos32) = case(
            torch, np, tra, torch.float32)
        if q_tile == 8:
            # The float32 mixed design (csrc/ragged_attention.cu), timed
            # on its own inputs at float32 rates.
            ms, plain_ms, lib_ms, b_ms, b_by, nbytes, flops = measure(
                inputs32, call32, plain32, rows32, pos32, 10, 3, F32_FLOP_PER_S)
            log(f"[kernel] {what} float32 (mixed_f32) N={inputs32[0].shape[0]}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop at float32 rates)")
            results[entry + "_f32"] = dict(
                max_abs_err=err32, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
            )
        del inputs32, call32, plain32
        err, (err_f32, ratio), inputs, call, plain, (rows, pos) = case(
            torch, np, tra, torch.bfloat16)
        q = inputs[0]
        ms, plain_ms, lib_ms, b_ms, b_by, nbytes, flops = measure(
            inputs, call, plain, rows, pos, 20 if q_tile == 8 else 50,
            3 if q_tile == 8 else 5, BF16_FLOP_PER_S)
        log(f"[kernel] {what} N={q.shape[0]}: max_abs_err float32 {err32:.3e} "
            f"(atol, rtol {TOL['float32']}), bf16 {err:.3e} (atol, rtol "
            f"{TOL['bfloat16']}; against float32 plain {err_f32:.3e}, {ratio:.3f} of "
            f"its limit), empty tiles / inactive rows exact zeros; bf16 "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop)")
        results[entry] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        )
    return results


# ------------------------------------------------------------ engine helpers
async def serve(engine, requests):
    """Submit every request at once (admitted together) and collect
    (tokens, finish_reason, ttft_s) per request."""
    t0 = time.perf_counter()

    async def collect(stream):
        toks, finish, ttft = [], None, None
        async for item in stream:
            if item.get("token_ids") and ttft is None:
                ttft = time.perf_counter() - t0
            toks.extend(item.get("token_ids", []))
            finish = item.get("finish_reason", finish)
        return toks, finish, ttft

    # Queued before the loop thread starts, so admitted together.
    streams = [engine.submit(r) for r in requests]
    engine.start()
    out = await asyncio.wait_for(
        asyncio.gather(*(collect(s) for s in streams)), timeout=600
    )
    return out, time.perf_counter() - t0


def run_engine(engine, requests):
    try:
        return asyncio.run(serve(engine, requests))
    finally:
        engine.stop()


# ------------------------------------------------------------ phase 4
def check_full_logits(torch, np, pkg, model, mcfg):
    """llama-8b at full width: one 64-token prompt and a decode step
    through forward_ragged, kernel against plain attention."""
    llama = pkg.models.llama
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(1)
    n = 64
    toks = torch.tensor(rs.randint(3, mcfg.vocab_size, size=n), device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)
    logits = {}
    for impl in ("kernel", "reference"):
        kc, vc = llama.init_kv_cache(mcfg, 8, PS, torch.bfloat16, device=dev)
        lg, _, _ = llama.forward_ragged(
            model, mcfg, toks, pos, rows, table, kc, vc, last, attn_impl=impl, q_tile=8,
        )
        logits[impl] = lg
        del kc, vc
    a, b = logits["kernel"], logits["reference"]
    assert a.shape == (1, mcfg.vocab_size) and torch.isfinite(a).all()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    log(f"[full] llama-8b logits, 64-token prompt: kernel vs plain max abs err "
        f"{err:.4e} (logit scale {scale:.3f}), argmax {int(a.argmax())} vs {int(b.argmax())}")
    # bf16 activations through 32 layers: the two attention numerics
    # (see check_kernels) differ by bf16 ulps per layer.
    assert err <= 0.05 * scale, f"full logits differ: {err} > 5% of {scale}"


def profile(torch, engine, requests):
    """``--profile`` only: one more pass of the main path under
    torch.profiler. Prints device time by kernel and the device's busy
    share of the wall time (the union of kernel intervals over the span
    from the first to the last kernel)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = run_engine(engine, requests)
        torch.cuda.synchronize()
    assert all(f == "length" for _, f, _ in out)
    report_profile(prof, wall, "[profile]")


def report_profile(prof, wall: float, tag: str, top: int = 15) -> None:
    """Print a trace's device busy / idle share (the union of kernel
    intervals over the span from the first to the last kernel) and its
    device time by kernel."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            d = by_name.setdefault(e.name, [0.0, 0])
            d[0] += e.time_range.end - e.time_range.start
            d[1] += 1
    total = sum(v[0] for v in by_name.values())
    log(f"{tag} wall {wall:.3f} s traced; device busy {busy / 1e6:.3f} s of "
        f"{span / 1e6:.3f} s kernel span ({100 * busy / max(span, 1):.1f} %), idle "
        f"{100 * (1 - busy / max(span, 1)):.1f} %; kernel time {total / 1e6:.3f} s")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"{tag} {100 * us / max(total, 1):5.1f} % {us / 1e3:10.3f} ms "
            f"{n:6d} x  {name[:110]}")


# ------------------------------------------------------------ phase 5
def phase5_prompts(np, vocab: int, lens) -> list[list[int]]:
    """The main path's prompts: seeded random token ids."""
    rs = np.random.RandomState(7)
    return [[int(t) for t in rs.randint(3, vocab, size=n)] for n in lens]


def main_path(torch, np, pkg, tra):
    mcfg = pkg.models.LLAMA_8B
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = pkg.models.init_params(mcfg, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[engine] llama-8b: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
        f"H {mcfg.num_heads}/Hkv {mcfg.num_kv_heads} x {mcfg.head_dim_}, ffn "
        f"{mcfg.intermediate_size}, vocab {mcfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params bf16, random from seed 0 in {time.perf_counter() - t0:.1f} s")

    check_full_logits(torch, np, pkg, model, mcfg)

    requests = [
        {
            "token_ids": ids,
            "stop_conditions": {"max_tokens": MAX_TOKENS, "ignore_eos": True},
            "sampling_options": SEEDED_OPTIONS if i == SEEDED else {},
        }
        for i, ids in enumerate(phase5_prompts(np, mcfg.vocab_size, PROMPT_LENS))
    ]
    max_len = max(PROMPT_LENS) + MAX_TOKENS + PS
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
        num_pages=8 * (-(-max_len // PS)), kv_dtype="bfloat16",
    )

    def engine():
        return pkg.engine.TorchEngine(ecfg, model=model, device="cuda")

    eng = engine()
    log(f"[engine] attention_impl={ecfg.attention_impl} -> {eng.attn_impl}, "
        f"slots {ecfg.max_decode_slots}, page {ecfg.page_size}, pages {ecfg.num_pages}, "
        f"prefill_chunk {ecfg.prefill_chunk}, decode_window {ecfg.decode_window}")
    torch.cuda.synchronize()
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    launches = dict(tra.LAUNCHES)
    designs = dict(tra.KERNEL_LAUNCHES)
    metrics = eng.metrics()
    del eng
    torch.cuda.empty_cache()

    for i, (toks, finish, _) in enumerate(out):
        assert finish == "length", f"request {i} finished {finish!r}"
        assert len(toks) == MAX_TOKENS, f"request {i} gave {len(toks)} tokens"
        assert all(0 <= t < mcfg.vocab_size for t in toks)
    assert launches["ragged_paged_attention"] > 0, launches
    assert launches["ragged_decode_attention"] > 0, launches
    # bf16 pools: every mixed call went through the tensor-core kernel.
    assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
    assert designs["mixed_f32"] == 0, designs
    assert designs["decode_split"] == launches["ragged_decode_attention"], designs
    disp = metrics["dispatches"]
    ttfts = sorted(t for _, _, t in out)
    total = sum(len(t) for t, _, _ in out)
    log(f"[engine] 8 requests (prompts {list(PROMPT_LENS)}, {MAX_TOKENS} tokens each, "
        f"request {SEEDED} seeded at T=0.8): all finished 'length' with {MAX_TOKENS} tokens")
    log(f"[engine] launches {launches}, by kernel {designs}; dispatches {disp}; decode steps "
        f"{metrics['decode_steps']} (wasted {metrics['decode_wasted_steps']}); "
        f"per mixed dispatch {launches['ragged_paged_attention'] / max(disp['mixed'], 1):.1f}, "
        f"per windowed step {launches['ragged_decode_attention'] / max(disp['windowed'] * ecfg.decode_window, 1):.1f}")

    rerun, wall2 = run_engine(engine(), requests)
    assert [t for t, _, _ in rerun] == [t for t, _, _ in out], "rerun gave other tokens"
    log("[engine] rerun of the same requests: identical tokens (greedy and seeded)")
    if "--profile" in sys.argv:
        profile(torch, engine(), requests)
    rerun_ttfts = sorted(t for _, _, t in rerun)
    stats = dict(
        wall_s=wall, rerun_wall_s=wall2, completion_tokens=total,
        tokens_per_s=total / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
        ttft_max_s=ttfts[-1], rerun_tokens_per_s=total / wall2,
        rerun_ttft_p50_s=rerun_ttfts[len(rerun_ttfts) // 2],
        rerun_ttft_max_s=rerun_ttfts[-1], launches=launches,
        mixed_dispatches=disp["mixed"], windowed_dispatches=disp["windowed"],
        tokens=[t for t, _, _ in out],
    )
    # Phase 6 builds its own llama-8b behind the HTTP server.
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------ phase 6
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# Llama-3.1's 256 special tokens: these 11 names, then reserved ones.
LLAMA3_SPECIALS = [
    "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
    "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>",
]
N_SPECIAL = 256
EOT_OFFSET = 9  # <|eot_id|>: 128009 for llama-8b
CHAT_TEMPLATE = (
    "{{- bos_token }}"
    "{%- for message in messages %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    " + message['content'] | trim + '<|eot_id|>' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{%- endif %}"
)
CHATS = [
    [{"role": "system", "content": "You are a terse assistant."},
     {"role": "user", "content": "Name three uses of paged attention."}],
    [{"role": "user", "content": "Ünïcödé, 日本語 and emoji ☃ in one prompt."}],
]
UNARY_PROMPT = "The quick brown fox"
LONE_PROMPT_LEN = 300


def learn_merges(word_counts: dict[str, int], n_merges: int) -> list[tuple[str, str]]:
    """Byte-level BPE training, deterministic: merge the most frequent
    pair (the smallest pair among equal counts) until ``n_merges`` or
    no pair occurs twice. ``word_counts`` maps byte-level words to
    counts; pair counts are updated only in the words a merge touches."""
    import heapq
    from collections import defaultdict

    words = [list(w) for w in word_counts]
    counts = list(word_counts.values())
    pairs: dict[tuple[str, str], int] = defaultdict(int)
    where: dict[tuple[str, str], set[int]] = defaultdict(set)
    for i, syms in enumerate(words):
        for p in zip(syms, syms[1:]):
            pairs[p] += counts[i]
            where[p].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < n_merges:
        negc, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -negc:
            continue  # stale entry
        if -negc < 2:
            break
        merges.append(pair)
        a, b = pair
        touched = set()
        for i in where.pop(pair, ()):
            syms, c = words[i], counts[i]
            for p in zip(syms, syms[1:]):
                pairs[p] -= c
                touched.add(p)
            new, j = [], 0
            while j < len(syms):
                if j + 1 < len(syms) and syms[j] == a and syms[j + 1] == b:
                    new.append(a + b)
                    j += 2
                else:
                    new.append(syms[j])
                    j += 1
            words[i] = new
            for p in zip(new, new[1:]):
                pairs[p] += c
                where[p].add(i)
                touched.add(p)
        pairs.pop(pair, None)
        for p in touched:
            if pairs.get(p, 0) > 0:
                heapq.heappush(heap, (-pairs[p], p))
    return merges


def tokenizer_spec(tokmod, vocab_size: int, text: str, n_merges: int = 1500) -> dict:
    """A Llama-3-layout byte-level BPE ``tokenizer.json`` of exactly
    ``vocab_size`` entries: the 256 byte symbols; merges learned from
    ``text``; deterministic filler entries (whole and split CJK
    characters, so random ids decode to partial UTF-8 too, then words
    of learned pieces) up to ``vocab_size - 256``; Llama-3's special
    tokens in the last 256 ids."""
    import random
    import re as _re

    enc = tokmod.BYTE_ENCODER
    n_regular = vocab_size - N_SPECIAL
    pat = _re.compile(tokmod.translate_pattern(LLAMA3_PATTERN))
    word_counts: dict[str, int] = {}
    for w in pat.findall(text):
        bw = "".join(enc[b] for b in w.encode("utf-8"))
        word_counts[bw] = word_counts.get(bw, 0) + 1
    merges = learn_merges(word_counts, min(n_merges, (n_regular - 256) // 2))
    vocab: dict[str, int] = {}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < n_regular:
            vocab[tok] = len(vocab)

    for b in range(256):
        add(enc[b])
    for a, b in merges:
        add(a + b)
    n_cjk = min(2000, (n_regular - len(vocab)) // 8)
    for k in range(n_cjk):
        raw = chr(0x4E00 + 7 * k).encode("utf-8")
        for piece in (raw, raw[:2], b" " + raw):
            add("".join(enc[x] for x in piece))
    pieces = [a + b for a, b in merges] or [enc[b] for b in range(ord("a"), ord("z") + 1)]
    rng = random.Random(0)
    while len(vocab) < n_regular:
        word = "".join(rng.choice(pieces) for _ in range(rng.randint(1, 3)))
        add(("Ġ" if rng.random() < 0.6 else "") + word)
    specials = LLAMA3_SPECIALS + [
        f"<|reserved_special_token_{i}|>" for i in range(3, 3 + N_SPECIAL - len(LLAMA3_SPECIALS))
    ]
    added = [
        {"id": n_regular + i, "content": name, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, name in enumerate(specials)
    ]
    bos = specials[0]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_regular], "tokens": [bos]}}},
        ]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def write_model_dir(path: str, tokmod, mcfg, text: str) -> str:
    """config.json of ``mcfg`` (read back equal to it), the tokenizer
    of ``tokenizer_spec``, a Llama-3-style chat template and EOS
    ``<|eot_id|>`` in generation_config.json. No weights: the server
    runs with --random-weights."""
    os.makedirs(path, exist_ok=True)
    bos = mcfg.vocab_size - N_SPECIAL
    cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": mcfg.model_type,
        "vocab_size": mcfg.vocab_size, "hidden_size": mcfg.hidden_size,
        "intermediate_size": mcfg.intermediate_size,
        "num_hidden_layers": mcfg.num_layers, "num_attention_heads": mcfg.num_heads,
        "num_key_value_heads": mcfg.num_kv_heads, "rope_theta": mcfg.rope_theta,
        "rms_norm_eps": mcfg.rms_norm_eps,
        "max_position_embeddings": mcfg.max_position_embeddings,
        "tie_word_embeddings": mcfg.tie_word_embeddings,
        "attention_bias": mcfg.attention_bias, "torch_dtype": mcfg.dtype,
        "bos_token_id": bos,
        # The preset's MoE routing default (unused by a dense model), so
        # that the file reads back equal to the preset.
        "norm_topk_prob": mcfg.norm_topk_prob,
    }
    if mcfg.head_dim:
        cfg["head_dim"] = mcfg.head_dim
    files = {
        "config.json": cfg,
        "generation_config.json": {"bos_token_id": bos, "eos_token_id": bos + EOT_OFFSET},
        "tokenizer_config.json": {"bos_token": LLAMA3_SPECIALS[0],
                                  "eos_token": "<|eot_id|>",
                                  "chat_template": CHAT_TEMPLATE},
        "tokenizer.json": tokenizer_spec(tokmod, mcfg.vocab_size, text),
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return path


async def sse_request(client, url: str, body: dict) -> dict:
    """One streaming request: its text, finish reason, usage, the time
    it was sent, the arrival time of every content frame, and whether
    it ended with [DONE]."""
    sent = time.perf_counter()
    text, frames, finish, usage, done = [], [], None, None, False
    async for f in client.sse_frames(url, body):
        assert f.event != "error", f"stream error: {f.comment}"
        if f.data == "[DONE]":
            done = True
            break
        usage = f.data.get("usage") or usage
        for c in f.data["choices"]:
            piece = c["text"] if "text" in c else (c.get("delta") or {}).get("content")
            if piece:
                text.append(piece)
                frames.append(time.perf_counter())
            finish = c.get("finish_reason") or finish
    return dict(text="".join(text), frames=frames, sent=sent, finish=finish,
                usage=usage, done=done)


async def burst(client, eng, url: str, bodies: list[dict], reset_cache: bool) -> tuple:
    """Send ``bodies`` at once with the engine's admission held until
    every one is queued, so the batch's schedule is phase 5's (all
    admitted together); ``reset_cache`` first drops the prefix cache a
    previous burst left. Returns (results, wall seconds, CPU seconds of
    this thread, where the server and the client run, and of the
    engine's loop thread)."""
    cpu0 = time.thread_time()
    with eng.hold_admission():
        if reset_cache:
            eng.reset_prefix_cache()
        tasks = [asyncio.ensure_future(sse_request(client, url, b)) for b in bodies]
        while eng.queued() < len(bodies) and not any(t.done() for t in tasks):
            await asyncio.sleep(0.001)
    out = await asyncio.gather(*tasks)
    wall = time.perf_counter() - min(r["sent"] for r in out)
    return out, wall, time.thread_time() - cpu0, eng.loop_cpu_seconds()


async def direct_burst(eng, requests: list[dict]) -> tuple:
    """``burst``'s requests straight into the same engine (no HTTP, no
    tokenizer): each result holds its tokens and the arrival times of
    the engine's outputs that carried tokens."""

    async def collect(stream, sent):
        tokens, frames = [], []
        async for item in stream:
            if item.get("token_ids"):
                tokens += item["token_ids"]
                frames.append(time.perf_counter())
        return dict(tokens=tokens, frames=frames, sent=sent,
                    usage={"completion_tokens": len(tokens)})

    cpu0 = time.thread_time()
    with eng.hold_admission():
        eng.reset_prefix_cache()
        sent = time.perf_counter()
        streams = [eng.submit(r) for r in requests]
    out = await asyncio.gather(*(collect(s, sent) for s in streams))
    return out, time.perf_counter() - sent, time.thread_time() - cpu0, eng.loop_cpu_seconds()


def edge_stats(results: list[dict], wall: float, edge_cpu: float, loop_cpu: float) -> dict:
    ttft = sorted(r["frames"][0] - r["sent"] for r in results)
    gaps = [b - a for r in results for a, b in zip(r["frames"], r["frames"][1:])]
    tokens = sum(r["usage"]["completion_tokens"] for r in results)
    return dict(ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
                frame_gap_mean_s=sum(gaps) / max(len(gaps), 1), frames=sum(
                    len(r["frames"]) for r in results), completion_tokens=tokens,
                tokens_per_s=tokens / wall, wall_s=wall, edge_cpu_s=edge_cpu,
                loop_cpu_s=loop_cpu)


def streamed_text(tok, ids: list[int]) -> str:
    """What the backend emits for ``ids``: the DecodeStream pieces (a
    partial UTF-8 character at the very end is never emitted)."""
    ds = tok.decode_stream()
    return "".join(p for p in (ds.step(i) for i in ids) if p)


def http_path(torch, np, pkg, tra, phase5_tokens, *, device="cuda", mcfg=None,
              prompt_lens=PROMPT_LENS, max_tokens=MAX_TOKENS, seeded=SEEDED) -> dict:
    """Phase 6: the port's real entry point. ``run.main_async(in=http
    out=cuda)`` serves a model directory written here (llama-8b's
    config, a 128,256-entry tokenizer, a chat template) with seeded
    random weights, in this process; a stdlib client sends (a) phase
    5's requests as streaming completions, twice, (b) two streaming
    chats, (c) a unary completion, (d) (c) again with a stop string cut
    from (c)'s text, and a lone greedy request; the kernels' launch
    counts are read there, so they hold only what HTTP requests ran.
    Then the lone request is served straight by a ``TorchEngine`` on the
    same weights, and (a) goes in turns straight into the engine and
    over HTTP."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        t_write = time.perf_counter() - t0
        assert pkg.models.ModelConfig.from_pretrained(model_dir) == mcfg
        t0 = time.perf_counter()
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        t_load = time.perf_counter() - t0
        assert tok.vocab_size == mcfg.vocab_size
        eot = mcfg.vocab_size - N_SPECIAL + EOT_OFFSET
        assert tok.eos_token_ids == [eot], tok.eos_token_ids
        log(f"[http] model dir: config.json of the preset, tokenizer.json of "
            f"{tok.vocab_size} entries (written in {t_write:.2f} s, loaded in "
            f"{t_load:.2f} s), EOS {eot}")
        max_len = max(prompt_lens) + max_tokens + PS
        argv = [
            "in=http", "out=cuda", "--device", device, "--model-path", model_dir,
            "--model-name", "llama-8b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max_len), "--num-pages", str(8 * -(-max_len // PS)),
            "--kv-dtype", "bfloat16", "--max-tokens", str(max_tokens),
        ]
        stats = asyncio.run(asyncio.wait_for(
            _drive_http(torch, np, pkg, tra, tok, run.parse_args(argv), client,
                        phase5_tokens, device, mcfg, prompt_lens, max_tokens, seeded),
            timeout=900))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return stats


async def _drive_http(torch, np, pkg, tra, tok, opts, client, phase5_tokens, device,
                      mcfg, prompt_lens, max_tokens, seeded) -> dict:
    from dynamo_exp_tpu_torch import run

    t0 = time.perf_counter()
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    served = ready.result()
    base = f"http://127.0.0.1:{served.port}"
    models = (await client.request(base + "/v1/models")).json()
    assert [m["id"] for m in models["data"]] == ["llama-8b"], models
    eng = served.torch_engine
    log(f"[http] run.main_async(in=http out=cuda --device {device}) listening on "
        f"{base} in {time.perf_counter() - t0:.1f} s; engine {eng.attn_impl} attention, "
        f"{eng.cfg.num_pages} pages")
    try:
        return await _traffic(torch, np, pkg, tra, tok, client, base, eng, opts.model_path,
                              phase5_tokens, device, mcfg, prompt_lens, max_tokens,
                              seeded)
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server


async def _traffic(torch, np, pkg, tra, tok, client, base, eng, model_dir, phase5_tokens,
                   device, mcfg, prompt_lens, max_tokens, seeded) -> dict:
    from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_exp_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_exp_tpu_torch.protocols.openai import ChatCompletionRequest

    cmpl, chat = base + "/v1/completions", base + "/v1/chat/completions"
    prompts = phase5_prompts(np, mcfg.vocab_size, prompt_lens)
    bodies = [
        {"model": "llama-8b", "prompt": ids, "max_tokens": max_tokens, "stream": True,
         "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True},
         **(SEEDED_OPTIONS if i == seeded else {})}
        for i, ids in enumerate(prompts)
    ]
    if device == "cuda":
        torch.cuda.synchronize()
    tra.reset_launches()
    # Only HTTP requests from here to the read of the launch counts.
    # (a), twice.
    a_out, *a_times = await burst(client, eng, cmpl, bodies, reset_cache=False)
    per_burst = dict(tra.LAUNCHES)
    for i, (r, ids) in enumerate(zip(a_out, prompts)):
        assert r["done"], f"(a) request {i} did not end with [DONE]"
        assert r["finish"] == "length", f"(a) request {i} finished {r['finish']!r}"
        assert r["usage"] == {"prompt_tokens": len(ids), "completion_tokens": max_tokens,
                              "total_tokens": len(ids) + max_tokens}, r["usage"]
        assert r["text"], f"(a) request {i} gave no text"
    rerun, *rerun_times = await burst(client, eng, cmpl, bodies, reset_cache=True)
    assert [r["text"] for r in rerun] == [r["text"] for r in a_out], "(a) rerun differs"
    assert {k: v - per_burst[k] for k, v in tra.LAUNCHES.items()} == per_burst, (
        "(a) and its rerun launched the kernels a different number of times")
    after_bursts = dict(tra.LAUNCHES)
    same_as_phase5 = [
        r["text"] == streamed_text(tok, t) for r, t in zip(a_out, phase5_tokens or [])
    ]
    # (b) two streaming chats through the template.
    pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(model_dir, "llama-8b"), tok)
    t0 = time.perf_counter()
    chat_ids = [
        pre.preprocess_chat(
            ChatCompletionRequest.from_dict({"model": "llama-8b", "messages": m})
        ).token_ids
        for m in CHATS
    ]
    t_chat_pre = time.perf_counter() - t0
    b_out = await asyncio.gather(*(
        sse_request(client, chat, {"model": "llama-8b", "messages": m,
                                   "max_tokens": max_tokens, "stream": True,
                                   "stream_options": {"include_usage": True}})
        for m in CHATS))
    for r, ids in zip(b_out, chat_ids):
        assert r["done"] and r["finish"] in ("length", "stop"), r
        n = r["usage"]["completion_tokens"]
        assert r["usage"]["prompt_tokens"] == len(ids) and 0 < n <= max_tokens, r["usage"]
        assert n == max_tokens or r["finish"] == "stop", r
    # (c) unary, then (d) with a stop string cut from its text.
    c = await client.request(cmpl, "POST", {"model": "llama-8b", "prompt": UNARY_PROMPT,
                                            "max_tokens": max_tokens})
    assert c.status == 200, c.body
    c_choice = c.json()["choices"][0]
    c_text = c_choice["text"]
    assert c_choice["finish_reason"] in ("length", "stop") and c_text, c_choice
    stop = next(
        (c_text[i : i + 4] for i in range(len(c_text) // 3, len(c_text) - 4)
         if c_text[i : i + 4].strip() and "�" not in c_text[i : i + 4]),
        None)
    assert stop, f"no stop string in {c_text!r}"
    d = await sse_request(client, cmpl, {"model": "llama-8b", "prompt": UNARY_PROMPT,
                                         "max_tokens": max_tokens, "stop": [stop],
                                         "stream": True,
                                         "stream_options": {"include_usage": True}})
    assert d["done"] and d["finish"] == "stop", d
    assert d["text"] == c_text[: c_text.find(stop)], (d["text"], c_text, stop)
    # A lone greedy request, through HTTP.
    rs = np.random.RandomState(11)
    lone_len = min(LONE_PROMPT_LEN, max(prompt_lens))
    lone_ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=lone_len)]
    lone = await sse_request(client, cmpl, {
        "model": "llama-8b", "prompt": lone_ids, "max_tokens": max_tokens, "stream": True,
        "nvext": {"ignore_eos": True}})
    if device == "cuda":
        torch.cuda.synchronize()
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    rest = {k: v - after_bursts[k] for k, v in launches.items()}
    if device == "cuda":
        # Each burst, and the requests after them, reached both kernels.
        for counts in (per_burst, rest):
            assert counts["ragged_paged_attention"] > 0, counts
            assert counts["ragged_decode_attention"] > 0, counts
        assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
        assert designs["mixed_f32"] == 0, designs
        assert designs["decode_split"] == launches["ragged_decode_attention"], designs
    # ... and straight to a TorchEngine on the same weights.
    eng2 = pkg.engine.TorchEngine(eng.cfg, model=eng.model, device=device)
    try:
        stream = eng2.submit({"token_ids": lone_ids,
                              "stop_conditions": {"max_tokens": max_tokens,
                                                  "ignore_eos": True}})
        eng2.start()
        direct = [t async for item in stream for t in item.get("token_ids", [])]
    finally:
        eng2.stop()
    del eng2
    full = tok.decode(direct)
    assert len(direct) == max_tokens
    assert lone["text"] == streamed_text(tok, direct), (lone["text"], full)
    assert lone["text"] == full or (full.endswith("�") and full.startswith(lone["text"]))
    # What the edge costs: the same burst straight into the same engine
    # and over HTTP, in turns; the schedule (and the tokens) are equal.
    direct_requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == seeded else {}}
        for i, ids in enumerate(prompts)
    ]
    turns = [("http", edge_stats(rerun, *rerun_times))]
    for kind in ("direct", "http", "direct"):
        if kind == "http":
            res, *times = await burst(client, eng, cmpl, bodies, reset_cache=True)
            assert [r["text"] for r in res] == [r["text"] for r in a_out]
        else:
            res, *times = await direct_burst(eng, direct_requests)
            assert [streamed_text(tok, r["tokens"]) for r in res] == [
                r["text"] for r in a_out], "HTTP text is not the engine's tokens decoded"
        turns.append((kind, edge_stats(res, *times)))
    if "--profile" in sys.argv and device == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced, wall, _, _ = await burst(client, eng, cmpl, bodies, reset_cache=True)
            torch.cuda.synchronize()
        assert [r["text"] for r in traced] == [r["text"] for r in a_out]
        report_profile(prof, wall, "[profile http]", top=8)
    # Host cost of the edge's text work, on this run's prompts.
    texts = [tok.decode(ids) for ids in prompts]
    t0 = time.perf_counter()
    encoded = [tok.encode(t, add_special_tokens=False).ids for t in texts]
    t_encode = time.perf_counter() - t0
    return dict(
        a=edge_stats(a_out, *a_times), a_rerun=edge_stats(rerun, *rerun_times), turns=turns,
        launches=launches, designs=designs, per_burst=per_burst, rest=rest,
        same_as_phase5=same_as_phase5,
        chat_preprocess_s=t_chat_pre, chat_prompt_tokens=[len(i) for i in chat_ids],
        encode_s=t_encode, encode_chars=sum(len(t) for t in texts),
        encode_tokens=sum(len(e) for e in encoded), lone_text=lone["text"],
        stop=stop, b_finish=[r["finish"] for r in b_out],
    )

# ------------------------------------------------------------ phase 7
@dataclass
class Pressure:
    """Phase 7's sizes: the card's by default; the CPU tests rehearse it
    smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = PRESSURE_TOKENS
    num_pages: int = PRESSURE_PAGES
    host_pages: int = HOST_PAGES
    hit_tokens: int = MAX_TOKENS  # (b)'s requests


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def pages_needed(prompt_lens, max_tokens: int) -> int:
    """Pages of PS the burst holds at its end (the last sampled token
    has no KV)."""
    return sum(-(-(n + max_tokens - 1) // PS) for n in prompt_lens)


def pressure_requests(np, vocab: int, sh: Pressure) -> list[dict]:
    return [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == min(SEEDED, len(sh.prompt_lens) - 1) else {}}
        for i, ids in enumerate(phase5_prompts(np, vocab, sh.prompt_lens))
    ]


def pressure_engine(pkg, mcfg, model, kv_dtype: str, sh: Pressure):
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, num_pages=sh.num_pages,
        max_model_len=max(sh.prompt_lens) + sh.max_tokens + PS, kv_dtype=kv_dtype,
        host_cache_pages=sh.host_pages,
    )
    return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)


def seeded_model(torch, pkg, mcfg, device: str):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return pkg.models.init_params(mcfg, gen, torch.device(device))


def check_drained(eng, what: str) -> dict:
    """The engine is stopped: the page audit is clean and no page is
    held. Returns the audit's counts."""
    audit = eng.kv_audit()
    assert audit["ok"], f"{what}: page audit {audit['violations'][:5]}"
    assert audit["counts"]["active"] == 0, f"{what}: pages still held {audit['counts']}"
    return audit["counts"]


def copy_rates(c: dict) -> str:
    def rate(b, s):
        return f"{b / s / 1e9:.2f} GB/s" if s else "no timed copy"
    return (f"device->host {c.get('d2h_pages', 0)} pages, {c.get('d2h_bytes', 0)} B in "
            f"{c.get('d2h_s', 0) * 1e3:.3f} ms of copy = {rate(c.get('d2h_bytes', 0), c.get('d2h_s', 0))}; "
            f"host->device {c.get('h2d_pages', 0)} pages, {c.get('h2d_bytes', 0)} B in "
            f"{c.get('h2d_s', 0) * 1e3:.3f} ms = {rate(c.get('h2d_bytes', 0), c.get('h2d_s', 0))} "
            f"(host enqueue {c.get('h2d_host_s', 0) * 1e3:.3f} ms, uploads from pageable "
            f"memory {c.get('h2d_pageable', 0)})")


def copy_probe(torch, pkg, mcfg, counts=(42, 128), reps=3) -> dict:
    """The copy stream's two legs alone, at llama-8b bf16 pages (2 MiB a
    page, K and V) in batches of ``counts`` pages: device -> host
    through ``offload_batch`` and host (pinned) -> device through
    ``upload``. A spin kernel ahead of each leg's events holds its stream
    until the host has enqueued the copies, so the events time the
    transfer alone, not host gaps between the enqueues (the in-run
    readings of phase 7 include those). Returns {pages: (d2h GB/s, h2d
    GB/s)}, each the mean over ``reps``."""
    from dynamo_exp_tpu_torch.engine.offload import CopyStream, HostKvPool, pinned_empty

    dev = torch.device("cuda", 0)
    page = (mcfg.num_layers, PS, mcfg.num_kv_heads * mcfg.head_dim_)
    pool = HostKvPool(max(counts), page, torch.bfloat16, pin_memory=True)
    cs = CopyStream(pool, device=dev)
    out = {}
    try:
        for n in counts:
            k_b = torch.randn((page[0], n) + page[1:], device=dev).to(torch.bfloat16)
            v_b = -k_b
            k_h, v_h = (pinned_empty(k_b.shape, k_b.dtype, dev) for _ in range(2))
            k_h.copy_(k_b)
            v_h.copy_(v_b)
            d2h = h2d = 0.0
            for _ in range(reps):
                s0 = cs.stats()
                torch.cuda._sleep(20_000_000)
                ready = torch.cuda.Event()
                ready.record()
                assert cs.offload_batch(list(range(n)), k_b, v_b, ready=ready)
                cs.drain(timeout=60)
                assert cs.error is None and cs.pending == 0
                with torch.cuda.stream(cs.h2d):
                    torch.cuda._sleep(20_000_000)
                k_d, v_d = cs.upload(k_h, v_h)
                torch.cuda.synchronize()
                assert torch.equal(k_d, k_b) and torch.equal(v_d, v_b)
                s1 = cs.stats()
                d2h += (s1["d2h_bytes"] - s0["d2h_bytes"]) / (s1["d2h_s"] - s0["d2h_s"]) / 1e9
                h2d += (s1["h2d_bytes"] - s0["h2d_bytes"]) / (s1["h2d_s"] - s0["h2d_s"]) / 1e9
            assert all(torch.equal(pool.fetch(j)[0], k_h[:, j]) for j in range(n))
            out[n] = (d2h / reps, h2d / reps)
            del k_b, v_b, k_d, v_d
    finally:
        cs.stop()
    return out


def pressure_burst(torch, np, pkg, tra, smi: str, mcfg=None, sh: Pressure = Pressure()) -> dict:
    """Phase 7 (a) and (b): llama-8b at full width and depth, bf16."""
    mcfg = mcfg or pkg.models.LLAMA_8B
    cuda = sh.device == "cuda"
    model = seeded_model(torch, pkg, mcfg, sh.device)
    need = pages_needed(sh.prompt_lens, sh.max_tokens)
    requests = pressure_requests(np, mcfg.vocab_size, sh)

    # (a) the burst under a pool smaller than its need.
    eng = pressure_engine(pkg, mcfg, model, "bfloat16", sh)
    sync(torch, sh.device)
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    sync(torch, sh.device)
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    m, copies = eng.metrics(), eng.copy_stats()
    for i, (toks, finish, _) in enumerate(out):
        assert finish == "length", f"(a) request {i} finished {finish!r}"
        assert len(toks) == sh.max_tokens, f"(a) request {i} gave {len(toks)} tokens"
    assert m["swapped_out"] > 0 or m["preempted"] > 0, f"(a) no pressure: {m}"
    counts = check_drained(eng, "(a)")
    if cuda:
        assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
        assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
    total = sum(len(t) for t, _, _ in out)
    log(f"[pressure] (a) {smi}: {len(out)} requests (prompts {list(sh.prompt_lens)}, "
        f"{sh.max_tokens} tokens each) need {need} pages of {PS} at their end; pool "
        f"{sh.num_pages} pages ({sh.num_pages / need:.3f} of need), host tier "
        f"{sh.host_pages} pages: all finished 'length' with {sh.max_tokens} tokens in "
        f"{wall:.3f} s, {total / wall:.2f} tokens/s; swapped out {m['swapped_out']}, "
        f"swapped in {m['swapped_in']}, preempted {m['preempted']}, prefetched pages "
        f"{m['prefetched_pages']}, offload hits {m['offload_hits']}; pages moved: "
        f"{copy_rates(copies)}")
    log(f"[pressure] (a) launches {launches}, by kernel {designs}; dispatches "
        f"{m['dispatches']}; audit clean, pages {counts}")
    a = dict(wall_s=wall, tokens_per_s=total / wall, launches=launches, designs=designs,
             copies=copies, swapped_out=m["swapped_out"], swapped_in=m["swapped_in"],
             preempted=m["preempted"], need=need)
    del eng
    if cuda:
        torch.cuda.empty_cache()

    # (b) the longest prompt: cold, a G1 hit, then a G2 hit after other
    # traffic has evicted its pages to the host tier.
    eng = pressure_engine(pkg, mcfg, model, "bfloat16", sh)
    dev = eng.device
    prompt = requests[int(np.argmax(sh.prompt_lens))]["token_ids"]
    req = {"token_ids": prompt,
           "stop_conditions": {"max_tokens": sh.hit_tokens, "ignore_eos": True}}
    hashes = pkg.tokens.compute_block_hashes_for_seq(prompt, PS)
    run_engine(eng, [req])
    (g1, _, _), = run_engine(eng, [req])[0]
    pids = eng.kv.match_resident_hashes(hashes)
    assert len(pids) == len(hashes), "(b) the G1 run did not hit every prompt page"
    saved = {h: (eng.k_cache[:, p].clone(), eng.v_cache[:, p].clone())
             for h, p in zip(hashes, pids)}
    # Other prompts as long as it, enough to fill the pool once more.
    evictors = -(-sh.num_pages // pages_needed([len(prompt)], 4)) + 1
    rs = np.random.RandomState(13)
    for _ in range(evictors):
        other = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=len(prompt))]
        run_engine(eng, [{"token_ids": other,
                          "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}])
    assert eng.kv.match_resident_hashes(hashes) == [], "(b) the prompt's pages stayed resident"
    assert eng.host_pool.match_chain(hashes) == hashes, "(b) the host tier lost pages"
    for h in hashes:
        k_h, v_h = eng.host_pool.fetch(h)
        assert torch.equal(k_h.to(dev), saved[h][0]) and torch.equal(v_h.to(dev), saved[h][1]), (
            "(b) host-tier bytes differ from the device's at eviction")
    injected = {}
    apply_uploads = eng._apply_uploads

    def spy(seq):
        """The injected pages' bytes, read on the device right after the
        inject, before any forward."""
        ups = [(pid, h) for pid, h, _, _ in seq.pending_uploads]
        apply_uploads(seq)
        for pid, h in ups:
            injected[h] = (eng.k_cache[:, pid].clone(), eng.v_cache[:, pid].clone())

    eng._apply_uploads = spy
    hits0 = eng.kv.offload_hits
    (g2, _, _), = run_engine(eng, [req])[0]
    hits = eng.kv.offload_hits - hits0
    assert hits == len(hashes) and sorted(injected) == sorted(hashes), (hits, len(injected))
    for h in hashes:
        assert torch.equal(injected[h][0], saved[h][0]) and torch.equal(injected[h][1], saved[h][1]), (
            "(b) injected bytes differ from the bytes gathered at eviction")
    assert g2 == g1, "(b) the G2 hit gave other tokens than the G1 hit"
    check_drained(eng, "(b)")
    copies_b = eng.copy_stats()
    log(f"[pressure] (b) {smi}: {len(prompt)}-token prompt, G1 hit then G2 hit after "
        f"{evictors} other {len(prompt)}-token prompts: {hits} pages restored from the "
        f"host tier, bytes after injection equal the bytes gathered at eviction (and the "
        f"host tier's), {sh.hit_tokens} tokens equal between the G1 and G2 hits; pages "
        f"moved: {copy_rates(copies_b)}")
    del eng, model, saved, injected
    gc.collect()
    rates = {}
    if cuda:
        torch.cuda.empty_cache()
        rates = copy_probe(torch, pkg, mcfg)
        log(f"[pressure] copy stream alone, {smi}, llama-8b bf16 pages of 2 MiB (K+V), "
            f"events gated behind a spin kernel: " + "; ".join(
                f"{n} pages device->host {d:.2f} GB/s, host->device {h:.2f} GB/s"
                for n, (d, h) in rates.items())
            + " (host link nominal: PCIe Gen5 x16, 64 GB/s each way)")
    return dict(a=a, b_hits=hits, b_copies=copies_b, rates=rates)


def pressure_identity_f32(torch, np, pkg, tra, smi: str, mcfg=None,
                          sh: Pressure = Pressure()) -> dict:
    """Phase 7 (c): the pressured burst at float32 (llama-8b's width,
    F32_LAYERS layers, float32 weights and pools) gives each request's
    tokens run alone on the same engine."""
    from dataclasses import replace

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=F32_LAYERS, dtype="float32")
    cuda = sh.device == "cuda"
    model = seeded_model(torch, pkg, mcfg, sh.device)
    requests = pressure_requests(np, mcfg.vocab_size, sh)
    eng = pressure_engine(pkg, mcfg, model, "float32", sh)
    sync(torch, sh.device)
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    sync(torch, sh.device)
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    m, copies = eng.metrics(), eng.copy_stats()
    assert m["swapped_out"] > 0 or m["preempted"] > 0, f"(c) no pressure: {m}"
    if cuda:
        assert designs["mixed_f32"] > 0 and designs["decode_split"] > 0, designs
        assert designs["mixed_tc_bf16"] == 0, designs
    check_drained(eng, "(c) burst")
    solo = [run_engine(eng, [r])[0][0][0] for r in requests]
    for i, ((toks, finish, _), want) in enumerate(zip(out, solo)):
        assert finish == "length" and len(toks) == sh.max_tokens, (i, finish, len(toks))
        assert toks == want, f"(c) request {i}: pressured tokens differ from its solo run"
    check_drained(eng, "(c) solo")
    log(f"[pressure] (c) {smi}: width {mcfg.hidden_size}, {mcfg.num_layers} layers, float32 "
        f"weights and pools; the pressured burst ({sh.num_pages} pages, host "
        f"{sh.host_pages}; swapped out {m['swapped_out']}, in {m['swapped_in']}, preempted "
        f"{m['preempted']}) in {wall:.3f} s gives each request's solo tokens; launches "
        f"{launches}, by kernel {designs}; pages moved: {copy_rates(copies)}")
    del eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(launches=launches, designs=designs, wall_s=wall, copies=copies,
                swapped_out=m["swapped_out"], preempted=m["preempted"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import dynamo_exp_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported the port from {pkg.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    import numpy as np

    import dynamo_exp_tpu_torch.engine  # noqa: F401
    import dynamo_exp_tpu_torch.models  # noqa: F401
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = device_info(torch)
    build(tra)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    kern = check_kernels(torch, np, tra, flush)
    del flush
    stats = main_path(torch, np, pkg, tra)
    log(f"[engine] {name} ({smi}): wall {stats['wall_s']:.3f} s (rerun "
        f"{stats['rerun_wall_s']:.3f} s), {stats['completion_tokens']} tokens, "
        f"{stats['tokens_per_s']:.2f} tokens/s, TTFT p50 {stats['ttft_p50_s']:.3f} s "
        f"max {stats['ttft_max_s']:.3f} s")
    h = http_path(torch, np, pkg, tra, stats["tokens"])
    a, r = h["a"], h["a_rerun"]
    log(f"[http] {name} ({smi}): (a) 8 streaming completions over HTTP: wall "
        f"{a['wall_s']:.3f} s (rerun {r['wall_s']:.3f} s), {a['completion_tokens']} "
        f"tokens, {a['tokens_per_s']:.2f} tokens/s, edge TTFT p50 {a['ttft_p50_s']:.3f} s "
        f"max {a['ttft_max_s']:.3f} s, mean gap between content frames "
        f"{a['frame_gap_mean_s'] * 1e3:.2f} ms over {a['frames']} frames (rerun: "
        f"{r['tokens_per_s']:.2f} tokens/s, TTFT p50 {r['ttft_p50_s']:.3f} s max "
        f"{r['ttft_max_s']:.3f} s, gap {r['frame_gap_mean_s'] * 1e3:.2f} ms); host CPU "
        f"seconds, server and client thread / engine loop thread: {a['edge_cpu_s']:.3f} / "
        f"{a['loop_cpu_s']:.3f} (rerun {r['edge_cpu_s']:.3f} / {r['loop_cpu_s']:.3f}); phase 5 in "
        f"this call, first run (cold) and rerun: wall {stats['wall_s']:.3f} / "
        f"{stats['rerun_wall_s']:.3f} s, {stats['tokens_per_s']:.2f} / "
        f"{stats['rerun_tokens_per_s']:.2f} tokens/s, TTFT p50 {stats['ttft_p50_s']:.3f} / "
        f"{stats['rerun_ttft_p50_s']:.3f} s, max {stats['ttft_max_s']:.3f} / "
        f"{stats['rerun_ttft_max_s']:.3f} s")
    log("[http] the edge against the engine alone, same engine, same burst, in turns: " +
        "; ".join(
            f"{kind} wall {t['wall_s']:.3f} s, {t['tokens_per_s']:.2f} tokens/s, TTFT p50 "
            f"{t['ttft_p50_s']:.3f} s max {t['ttft_max_s']:.3f} s, gap "
            f"{t['frame_gap_mean_s'] * 1e3:.2f} ms, CPU s asyncio / loop thread "
            f"{t['edge_cpu_s']:.3f} / {t['loop_cpu_s']:.3f}"
            for kind, t in h["turns"]))
    log(f"[http] every stream ended with [DONE]; (a) finished 'length' with "
        f"{MAX_TOKENS} tokens and exact usage, a rerun gave identical text, and "
        f"{sum(h['same_as_phase5'])}/8 texts equal phase 5's tokens decoded; (b) chat "
        f"finishes {h['b_finish']}; (d) stopped at {h['stop']!r} with (c)'s text before it; "
        f"the lone greedy request's HTTP text equals its direct-engine tokens decoded")
    log(f"[http] launches of the HTTP requests alone {h['launches']}, by kernel "
        f"{h['designs']}: {h['per_burst']} in each (a) burst, {h['rest']} in (b), (c), "
        f"(d) and the lone request")
    log(f"[http] host text work: 2 chat requests templated and encoded in "
        f"{h['chat_preprocess_s'] * 1e3:.2f} ms ({h['chat_prompt_tokens']} tokens); "
        f"(a)'s prompts as text, {h['encode_chars']} chars -> {h['encode_tokens']} tokens, "
        f"encoded in {h['encode_s']:.3f} s")
    t7 = time.perf_counter()
    p7 = pressure_burst(torch, np, pkg, tra, smi)
    p7c = pressure_identity_f32(torch, np, pkg, tra, smi)
    log(f"[pressure] phase 7 in {time.perf_counter() - t7:.1f} s")
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    replaces = "dynamo_exp_tpu/ops/ragged_attention.py:123"
    # (kernels-line name, kernel result, source, where its launches are
    # counted: the main path of its dtype, then the other paths).
    rows = [
        ("ragged_paged_attention", "ragged_paged_attention",
         "dynamo_exp_tpu_torch/csrc/ragged_mixed_tc.cu", "mixed_tc_bf16", stats["launches"]),
        ("ragged_decode_attention", "ragged_decode_attention",
         "dynamo_exp_tpu_torch/csrc/ragged_decode_split.cu", "decode_split", stats["launches"]),
        ("ragged_paged_attention_f32", "ragged_paged_attention_f32",
         "dynamo_exp_tpu_torch/csrc/ragged_attention.cu", "mixed_f32", None),
    ]
    kernels = []
    for name, key, source, design, main_launches in rows:
        k = kern[key]
        entry = key.removesuffix("_f32")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (main_launches[entry] if main_launches is not None
                         else p7c["designs"][design]),
            "launches_http": h["designs"][design],
            "launches_kv_pressure": p7["a"]["designs"][design],
            "launches_kv_pressure_f32": p7c["designs"][design],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
