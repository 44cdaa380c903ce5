"""The port's CUDA kernels on the card (skips without an NVIDIA GPU).

Imports neither JAX nor the JAX package, so it runs where only the port
is installed: ``python -m pytest tests/test_torch_cuda.py`` on a machine
with an H100. The ragged kernels are held against their plain PyTorch
version on the same inputs: float32 at atol=1e-4 (float32 sums in
another order and chunking of the online softmax), bf16 at atol=2e-2
(the kernel rounds unnormalised probabilities to bf16 before PV, the
plain version the normalised ones, and both round the output to bf16).
That bf16 tolerance would pass a kernel that drops a 32-token chunk of a long
row, so bf16 outputs are also held against the plain version on float32
copies of the same inputs, within what bf16 rounding of the probabilities
and the output can move them (``_assert_within_bf16_rounding``).
Long cases make the mixed kernel take multi-tile runs (a 512-query span
at context 1,024) and the decode kernel cross several splits (a row of
2,064 tokens). Seeded draws on the card equal those on the CPU.
"""

import asyncio
from dataclasses import replace

import numpy as np
import pytest
import torch

from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _flat_batch(seed, spans, H, Hkv, D, P, ps, pmax, q_tile, dtype, device):
    rs = np.random.RandomState(seed)
    k = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    v = rs.standard_normal((P, ps, Hkv * D)).astype(np.float32)
    perm = rs.permutation(P)
    table = np.zeros((len(spans) + 1, pmax), np.int32)
    used, row_of, positions = 0, [], []
    for r, (q_len, kv_len) in enumerate(spans):
        n = max(1, -(-max(kv_len, 1) // ps))
        table[r, :n] = perm[used : used + n]
        used += n
        pad = (-q_len) % q_tile
        row_of += [r] * (q_len + pad)
        positions += list(range(kv_len - q_len, kv_len)) + [-1] * pad
    row_of += [len(spans)] * q_tile  # one fully empty tile
    positions += [-1] * q_tile
    q = rs.standard_normal((len(row_of), H, D)).astype(np.float32)

    def f(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return f(q), f(k), f(v), i(table), i(row_of), i(positions)


def _assert_within_bf16_rounding(got, plain, q, k, v):
    """``got`` (a bf16 kernel's output) against ``plain`` on float32
    copies of q, k, v: the kernel rounds each unnormalised probability
    and the output to bf16 (relative error at most 2^-8 each), the rest
    is below 2^-12, so |got - want| <= 2^-8 |want| + (2^-8 + 2^-12) P|v|
    element by element, where P|v| is the plain version with |v|."""
    f32 = (q.float(), k.float(), v.float())
    want = plain(*f32)
    reach = plain(f32[0], f32[1], f32[2].abs())
    limit = 2.0**-8 * want.abs() + (2.0**-8 + 2.0**-12) * reach
    excess = float(((got.float() - want).abs() - limit).max())
    assert excess <= 0, f"beyond bf16 rounding of the float32 plain version by {excess}"


LAYOUTS = [(32, 8, 128), (8, 4, 64), (28, 4, 128)]
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
# (spans, pool pages, table width): short rows, then a 512-query prefill
# chunk at context 1,024 next to decode tokens.
MIXED = {
    "short": ([(1, 17), (40, 40), (9, 200), (1, 1), (16, 32)], 128, 16),
    "long": ([(512, 1024), (1, 17), (64, 64), (1, 2049), (24, 300)], 512, 129),
}


@pytest.mark.parametrize("spans", sorted(MIXED))
@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("H,Hkv,D", LAYOUTS)
def test_mixed_shape_matches_plain(cuda, dtype, atol, H, Hkv, D, spans):
    rows, P, pmax = MIXED[spans]
    args = _flat_batch(0, rows, H, Hkv, D, P, 16, pmax, 8, dtype, cuda)
    tra.reset_launches()
    got = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=Hkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[-8:] == 0).all()  # the empty tile
    if dtype == torch.bfloat16:
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, *args[3:], num_kv_heads=Hkv), *args[:3])
    # bf16 pools go through the tensor-core kernel, float32 pools not.
    design = "mixed_tc_bf16" if dtype == torch.bfloat16 else "mixed_f32"
    assert tra.KERNEL_LAUNCHES[design] == 1, tra.KERNEL_LAUNCHES
    assert sum(tra.KERNEL_LAUNCHES.values()) == 1


@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("q_tile,ps", [(1, 16), (8, 12)])
def test_mixed_shape_other_tiles_and_page_sizes(cuda, dtype, atol, q_tile, ps):
    """q_tile=1 (runs of 8 one-token tiles) and a page size that is not
    a power of two (the kernels' division path for page lookups)."""
    rows = [(1, 17), (40, 40), (9, 200), (1, 1), (300, 333)]
    args = _flat_batch(3, rows, 32, 8, 128, 256, ps, -(-333 // ps), q_tile, dtype, cuda)
    got = tra.ragged_paged_attention(*args, num_kv_heads=8, q_tile=q_tile)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[-q_tile:] == 0).all()  # the empty tile
    if dtype == torch.bfloat16:
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, *args[3:], num_kv_heads=8), *args[:3])
    lens = torch.tensor([17, 0, 333, 1], dtype=torch.int32, device=cuda)
    q, k, v, table = args[0][:4].contiguous(), args[1], args[2], args[3][[0, 1, 4, 3]]
    got = tra.ragged_decode_attention(q, k, v, table.contiguous(), lens, num_kv_heads=8)
    want = tra.ragged_paged_attention_ref(
        q, k, v, table.contiguous(), torch.arange(4, dtype=torch.int32, device=cuda),
        lens - 1, num_kv_heads=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[1] == 0).all()


DECODE = {
    "short": [1, 17, 0, 300, 16, 0, 33, 2],
    "long": [2064, 1, 0, 257, 1040, 31, 2049, 512],
}


@pytest.mark.parametrize("lengths", sorted(DECODE))
@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("H,Hkv,D", LAYOUTS)
@pytest.mark.parametrize("split", [32, 256])
def test_decode_shape_matches_plain_and_zeroes_inactive(
    cuda, dtype, atol, H, Hkv, D, split, lengths
):
    lengths = DECODE[lengths]
    spans = [(1, max(n, 1)) for n in lengths]
    pmax = -(-max(lengths) // 16) + 1
    P = sum(-(-max(n, 1) // 16) for n in lengths) + 4
    q, k, v, table, _, _ = _flat_batch(1, spans, H, Hkv, D, P, 16, pmax, 1, dtype, cuda)
    table = table[: len(lengths)].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    tra.reset_launches()
    got = tra.ragged_decode_attention(
        q[: len(lengths)].contiguous(), k, v, table, lens, num_kv_heads=Hkv, split=split
    )
    want = tra.ragged_paged_attention_ref(
        q[: len(lengths)], k, v, table,
        torch.arange(len(lengths), dtype=torch.int32, device=cuda), lens - 1,
        num_kv_heads=Hkv,
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[lens == 0] == 0).all()
    if dtype == torch.bfloat16:
        rows = torch.arange(len(lengths), dtype=torch.int32, device=cuda)
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, table, rows, lens - 1, num_kv_heads=Hkv),
            q[: len(lengths)], k, v)
    assert tra.KERNEL_LAUNCHES["decode_split"] == 1 and tra.LAUNCHES[
        "ragged_decode_attention"] == 1


def test_seeded_draws_on_the_card_equal_the_cpu(cuda):
    """The threefry bits are equal bit for bit; over a flat distribution
    the token is the argmax of the noise alone, so it is equal too."""
    from dynamo_exp_tpu_torch.ops import prng, sampling

    seeds = torch.tensor([0, 1, 1234, 2**31 - 1] * 4)
    pos = torch.tensor([p for p in (0, 1, 4095, 2**31 - 1) for _ in range(4)])

    def bits(dev):
        key = prng.fold_in(prng.prng_key(seeds.to(dev)), pos.to(dev))
        return prng.random_bits(key, 4099).cpu()

    assert torch.equal(bits(cuda), bits("cpu"))
    B, V = len(seeds), 128256
    args = (
        torch.zeros(B, V), seeds, pos, torch.full((B,), 0.8),
        torch.zeros(B, dtype=torch.int32), torch.ones(B),
    )
    want = sampling.sample_tokens_seeded(*args)
    got = sampling.sample_tokens_seeded(*(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), want)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = _flat_batch(2, [(3, 9)], 8, 4, 64, 8, 16, 4, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="q_tile"):
        tra.ragged_paged_attention(*args, num_kv_heads=4, q_tile=4)
    q, k, v, table, row_of, pos = args
    with pytest.raises(ValueError, match="contiguous"):
        tra.ragged_paged_attention(
            q.transpose(0, 1).contiguous().transpose(0, 1), k, v, table, row_of, pos,
            num_kv_heads=4,
        )
    with pytest.raises(ValueError, match="dtypes"):
        tra.ragged_paged_attention(q.bfloat16(), k, v, table, row_of, pos, num_kv_heads=4)


def test_engine_kernel_matches_reference_greedy(cuda):
    """A float32 TINY engine on the card: the kernel path and the plain
    path emit the same greedy tokens, and both kernel entry points ran."""
    cfg_m = replace(TINY, dtype="float32", head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)

    def run(impl):
        cfg = EngineConfig(
            model=cfg_m, max_decode_slots=4, page_size=16, num_pages=64,
            max_model_len=256, prefill_chunk=32, decode_window=4,
            kv_dtype="float32", attention_impl=impl,
        )
        eng = TorchEngine(cfg, device=cuda, seed=3)

        async def go():
            rs = np.random.RandomState(0)
            reqs = [
                {"token_ids": list(map(int, rs.randint(3, 250, size=n))),
                 "stop_conditions": {"max_tokens": 12, "ignore_eos": True}}
                for n in (5, 70, 17)
            ]
            # Queued before the loop starts, so admitted together.
            streams = [eng.submit(r) for r in reqs]
            eng.start()

            async def collect(s):
                return [t async for item in s for t in item.get("token_ids", [])]

            return await asyncio.gather(*(collect(s) for s in streams))

        try:
            return asyncio.run(asyncio.wait_for(go(), timeout=300))
        finally:
            eng.stop()

    tra.reset_launches()
    got = run("kernel")
    assert min(tra.LAUNCHES.values()) > 0, tra.LAUNCHES
    assert tra.KERNEL_LAUNCHES["mixed_f32"] > 0 and tra.KERNEL_LAUNCHES["decode_split"] > 0
    assert got == run("reference")


@pytest.mark.parametrize("kw", [{"chained_decode": False}, {}, {"spec_mode": "ngram"}],
                         ids=["unchained", "chained", "spec"])
def test_engine_chaining_and_spec_on_the_card(cuda, kw):
    """float32 TINY widths on the card: unchained, chained (every chained
    dispatch under sync debug mode "error") and speculative (verify
    spans of up to 9 tokens, two q tiles, through the float32 mixed
    kernel) engines emit the plain path's greedy tokens."""
    cfg_m = replace(TINY, dtype="float32", head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)
    rs = np.random.RandomState(0)
    block = list(map(int, rs.randint(3, 250, size=6)))
    prompts = [block * 4, list(map(int, rs.randint(3, 250, size=40)))]

    def run(impl, **extra):
        cfg = EngineConfig(
            model=cfg_m, max_decode_slots=4, page_size=16, num_pages=64,
            max_model_len=256, prefill_chunk=32, decode_window=4,
            kv_dtype="float32", attention_impl=impl, **extra,
        )
        eng = TorchEngine(cfg, device=cuda, seed=3)
        dispatch = eng._dispatch_chained

        def guarded(p):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        eng._dispatch_chained = guarded

        async def go():
            streams = [eng.submit({"token_ids": p, "stop_conditions": {
                "max_tokens": 40, "ignore_eos": True}}) for p in prompts]
            eng.start()

            async def collect(s):
                return [t async for item in s for t in item.get("token_ids", [])]

            return await asyncio.gather(*(collect(s) for s in streams))

        try:
            return asyncio.run(asyncio.wait_for(go(), timeout=300)), eng.metrics()
        finally:
            eng.stop()

    want, _ = run("reference", chained_decode=False)
    tra.reset_launches()
    got, m = run("kernel", **kw)
    assert got == want and all(len(t) == 40 for t in got)
    if kw.get("spec_mode"):
        assert m["spec_row_dispatches"] > 0 and tra.KERNEL_LAUNCHES["mixed_f32"] > 0
    else:
        assert (m["dispatches"]["chained"] > 0) == kw.get("chained_decode", True)


def test_http_entry_point_serves_on_the_card(cuda, tmp_path):
    """``run.main_async(in=http out=cuda)`` on the card: a streaming
    completion through the OpenAI service ends with [DONE], finishes
    ``length`` with exact usage, and its attention ran in the bf16
    tensor-core mixed kernel and the split-KV decode kernel."""
    import chip_smoke
    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = replace(TINY, vocab_size=2048, hidden_size=512, num_heads=8, num_kv_heads=4,
                   head_dim=64, max_position_embeddings=512)
    model_dir = chip_smoke.write_model_dir(
        str(tmp_path / "m"), tokmod, mcfg, "the quick brown fox jumps over the lazy dog " * 50)
    opts = run.parse_args([
        "in=http", "out=cuda", "--model-path", model_dir, "--model-name", "m",
        "--random-weights", "--http-host", "127.0.0.1", "--http-port", "0",
        "--max-decode-slots", "4", "--page-size", "16", "--max-model-len", "256",
        "--max-tokens", "12",
    ])

    async def go():
        ready = asyncio.get_running_loop().create_future()
        server = asyncio.ensure_future(run.main_async(opts, ready))
        served = await asyncio.wait_for(ready, 300)
        try:
            tra.reset_launches()
            body = {"model": "m", "prompt": list(range(3, 103)), "max_tokens": 12,
                    "stream": True,
                    "stream_options": {"include_usage": True},
                    "nvext": {"ignore_eos": True}}
            frames = [f async for f in client.sse_frames(
                f"http://127.0.0.1:{served.port}/v1/completions", body)]
            torch.cuda.synchronize()
            return frames, dict(tra.KERNEL_LAUNCHES)
        finally:
            server.cancel()
            with pytest.raises(asyncio.CancelledError):
                await server

    frames, designs = asyncio.run(asyncio.wait_for(go(), timeout=600))
    assert frames[-1].data == "[DONE]"
    usage = frames[-2].data["usage"]
    assert usage == {"prompt_tokens": 100, "completion_tokens": 12, "total_tokens": 112}
    assert any(c.get("finish_reason") == "length" for f in frames[:-1] for c in f.data["choices"])
    assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
    assert designs["mixed_f32"] == 0


def test_copy_stream_round_trip_on_the_card(cuda):
    """Device -> pinned host -> device through the copy stream's side
    streams: a gathered bf16 batch comes back bit-equal, and both legs
    are timed by their CUDA events."""
    from dynamo_exp_tpu_torch.engine.offload import CopyStream, HostKvPool

    L, n, ps, w = 3, 5, 16, 256
    pool = HostKvPool(8, (L, ps, w), torch.bfloat16, pin_memory=True)
    stream = CopyStream(pool, device=cuda)
    try:
        cache = torch.randn(L, 16, ps, w, device=cuda).to(torch.bfloat16)
        idx = torch.tensor([3, 9, 0, 14, 7], device=cuda)
        k_b = cache.index_select(1, idx)
        ready = torch.cuda.Event()
        ready.record()
        cache.zero_()  # later compute-stream work must not reach the copy
        assert stream.offload_batch(list(range(n)), k_b, k_b * 2, ready=ready)
        stream.drain()
        assert stream.error is None
        fetched = [pool.fetch(h) for h in range(n)]
        k_h = torch.stack([f[0] for f in fetched], 1).pin_memory()
        v_h = torch.stack([f[1] for f in fetched], 1).pin_memory()
        k_dev, v_dev = stream.upload(k_h, v_h)
        torch.cuda.current_stream().synchronize()
        assert torch.equal(k_dev, k_b) and torch.equal(v_dev, k_b * 2)
        s = stream.stats()
        assert s["d2h_pages"] == s["h2d_pages"] == n and s["d2h_s"] > 0 and s["h2d_s"] > 0
    finally:
        stream.stop()


@pytest.mark.parametrize("host_pages", [0, 64])
def test_engine_under_kv_pressure_on_the_card(cuda, host_pages):
    """Two requests whose KV outgrows a 6-page pool, on the card: with a
    host tier a row is swapped out and back, without one a row is
    preempted; both streams equal their solo runs and no page leaks."""
    cfg_m = replace(TINY, dtype="float32", head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)
    cfg = EngineConfig(
        model=cfg_m, max_decode_slots=4, page_size=16, num_pages=6, max_model_len=96,
        prefill_chunk=32, decode_window=4, kv_dtype="float32", eos_token_ids=[],
        host_cache_pages=host_pages, preempt_stall_grace_s=0.05 if not host_pages else 0.5,
    )
    eng = TorchEngine(cfg, device=cuda, seed=3)
    reqs = [{"token_ids": p, "stop_conditions": {"max_tokens": 40, "ignore_eos": True}}
            for p in ([5, 9, 17, 23, 4, 31, 8, 2] * 2, [7, 3, 19, 28, 41, 13, 6, 11] * 2)]

    async def burst(rs):
        streams = [await eng.generate(r) for r in rs]

        async def collect(s):
            return [t async for item in s for t in item.get("token_ids", [])]

        return await asyncio.gather(*(collect(s) for s in streams))

    try:
        got = asyncio.run(asyncio.wait_for(burst(reqs), timeout=300))
        m = eng.metrics()
        assert (m["swapped_out"] > 0) if host_pages else (m["preempted"] > 0), m
        solo = [asyncio.run(asyncio.wait_for(burst([r]), timeout=300))[0] for r in reqs]
        assert got == solo
    finally:
        eng.stop()
    audit = eng.kv_audit()
    assert audit["ok"] and audit["counts"]["active"] == 0, audit
