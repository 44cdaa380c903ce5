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
   same requests gives the same tokens.

The last three lines of standard output are the card's name and power
limit, the kernels' JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# llama-8b attention shapes.
H, HKV, D, PS = 32, 8, 128, 16
PROMPT_LENS = (64, 160, 320, 512, 768, 1024, 1536, 2048)
MAX_TOKENS = 32
SEEDED = 5  # index of the request sampled at temperature 0.8
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


def bound(torch, q, k, table, row_of, positions):
    """Least time for the attention function on these inputs: each
    input byte it needs read once (q, the live K/V tokens of every row,
    the live page-table entries and the per-token indices), the output
    written once, against the flops of QK and PV over the live context,
    at the card's bf16 rates. Returns (ms, "bytes" | "operations",
    bytes, flops)."""
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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
    for entry, (case, q_tile, what) in cases.items():
        err32 = case(torch, np, tra, torch.float32)[0]
        err, (err_f32, ratio), (q, k, v, table), call, plain, (rows, pos) = case(
            torch, np, tra, torch.bfloat16)
        reps = 20 if q_tile == 8 else 50
        qd, kd, vd, mask = sdpa_inputs(torch, q, k, v, table, rows, pos)
        ms = timed(torch, call, reps, flush)
        plain_ms = timed(torch, plain, 3 if q_tile == 8 else 5, flush)
        lib_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), reps, flush)
        b_ms, b_by, nbytes, flops = bound(torch, q, k, table, rows, pos)
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
    log(f"[profile] wall {wall:.3f} s traced; device busy {busy / 1e6:.3f} s of "
        f"{span / 1e6:.3f} s kernel span ({100 * busy / max(span, 1):.1f} %), idle "
        f"{100 * (1 - busy / max(span, 1)):.1f} %; kernel time {total / 1e6:.3f} s")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[profile] {100 * us / max(total, 1):5.1f} % {us / 1e3:10.3f} ms "
            f"{n:6d} x  {name[:110]}")


# ------------------------------------------------------------ phase 5
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

    rs = np.random.RandomState(7)
    requests = []
    for i, n in enumerate(PROMPT_LENS):
        so = {"temperature": 0.8, "seed": 1234} if i == SEEDED else {}
        requests.append({
            "token_ids": [int(t) for t in rs.randint(3, mcfg.vocab_size, size=n)],
            "stop_conditions": {"max_tokens": MAX_TOKENS, "ignore_eos": True},
            "sampling_options": so,
        })
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
    stats = dict(
        wall_s=wall, rerun_wall_s=wall2, completion_tokens=total,
        tokens_per_s=total / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
        ttft_max_s=ttfts[-1], launches=launches,
        mixed_dispatches=disp["mixed"], windowed_dispatches=disp["windowed"],
    )
    return stats


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
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    replaces = "dynamo_exp_tpu/ops/ragged_attention.py:123"
    sources = {
        "ragged_paged_attention": "dynamo_exp_tpu_torch/csrc/ragged_mixed_tc.cu",
        "ragged_decode_attention": "dynamo_exp_tpu_torch/csrc/ragged_decode_split.cu",
    }
    kernels = []
    for entry, source in sources.items():
        k = kern[entry]
        kernels.append({
            "name": entry, "route": "cuda", "source": source, "replaces": replaces,
            "launches": stats["launches"][entry], "max_abs_err": k["max_abs_err"],
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
