"""The port's CUDA kernels on the card (skips without an NVIDIA GPU).

Imports neither JAX nor the JAX package, so it runs where only the port
is installed: ``python -m pytest tests/test_torch_cuda.py`` on a machine
with an H100. The ragged kernels are held against their plain PyTorch
version on the same inputs: float32 at atol=1e-4 (3xTF32 products,
within about 2^-21 of float32 ones, float32 sums in another order and
chunking of the online softmax), bf16 at atol=2e-2
(the kernel rounds unnormalised probabilities to bf16 before PV, the
plain version the normalised ones, and both round the output to bf16).
That bf16 tolerance would pass a kernel that drops a 32-token chunk of a long
row, so bf16 outputs are also held against the plain version on float32
copies of the same inputs, within what bf16 rounding of the probabilities
and the output can move them (``_assert_within_bf16_rounding``).
Long cases make the mixed kernel take multi-tile runs (a 512-query span
at context 1,024) and the decode kernel cross several splits (a row of
2,064 tokens), and rows of 4,096 tokens. The float32 mixed kernel is
batch-invariant bit for bit: each row alone gives what it gives in a
batch. Sliding windows, softcaps and explicit scales (mistral, gemma,
gemma2) at head dims 128 and 256 go through all three designs on rows
longer than the window, held the same way. Seeded draws on the card
equal those on the CPU.
"""

import asyncio
from dataclasses import replace

import numpy as np
import pytest
import torch

from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import launches as tlaunches
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _flat_batch(seed, spans, H, Hkv, D, P, ps, pmax, q_tile, dtype, device, pad_to=0):
    """A q_tile-aligned flat stream, one empty tile (owned by the scratch
    row ``len(spans)``) at its end, then, up to ``pad_to`` tokens, more
    such tiles: the engine's stream padded to its token bucket."""
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
    tail = max(q_tile, pad_to - len(row_of))  # one fully empty tile, or the padding
    row_of += [len(spans)] * tail
    positions += [-1] * tail
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
    tlaunches.reset()
    got = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=Hkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[-8:] == 0).all()  # the empty tile
    if dtype == torch.bfloat16:
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, *args[3:], num_kv_heads=Hkv), *args[:3])
    # bf16 pools go through the bf16 design, float32 pools the 3xTF32 one.
    design = "mixed_tc_bf16" if dtype == torch.bfloat16 else "mixed_f32"
    assert tra.KERNEL_LAUNCHES[design] == 1, tra.KERNEL_LAUNCHES
    assert sum(tra.KERNEL_LAUNCHES.values()) == 1


def _row_alone(args, r, q_tile):
    """Row ``r`` of a flat batch as a stream of its own: its tokens,
    positions and page-table row, the same pools."""
    q, k, v, table, row_of, pos = args
    idx = (row_of == r).nonzero()[:, 0]
    assert len(idx) % q_tile == 0 and int(idx[-1] - idx[0]) + 1 == len(idx)
    zeros = torch.zeros(len(idx), dtype=torch.int32, device=q.device)
    return idx, (q[idx].contiguous(), k, v, table[r : r + 1].contiguous(), zeros,
                 pos[idx].contiguous())


@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("H,Hkv,D", LAYOUTS[:2])
def test_mixed_shape_on_a_bucket_padded_stream(cuda, dtype, atol, H, Hkv, D):
    """The engine's padded stream: the "long" spans (624 slots with the
    empty tile) padded to the 1,024 bucket, a run of 50 tiles owned by
    the scratch row at position -1. Equal to the plain version, exact
    zeros at every padding token, one launch."""
    rows, P, pmax = MIXED["long"]
    args = _flat_batch(0, rows, H, Hkv, D, P, 16, pmax, 8, dtype, cuda, pad_to=1024)
    assert args[0].shape[0] == 1024 and int((args[4] == len(rows)).sum()) == 1024 - 616
    tlaunches.reset()
    got = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=Hkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[args[5] < 0] == 0).all()
    design = "mixed_tc_bf16" if dtype == torch.bfloat16 else "mixed_f32"
    assert tra.KERNEL_LAUNCHES[design] == 1 and sum(tra.KERNEL_LAUNCHES.values()) == 1


@pytest.mark.parametrize("H,Hkv,D", LAYOUTS)
def test_mixed_f32_rows_alone_equal_rows_in_the_batch(cuda, H, Hkv, D):
    """Batch invariance of the float32 kernel, bit for bit: each row of
    the "long" span set run alone gives what it gives in the batch (other
    runs, warps and horizons), and each such call is one launch of the
    float32 design."""
    rows, P, pmax = MIXED["long"]
    args = _flat_batch(0, rows, H, Hkv, D, P, 16, pmax, 8, torch.float32, cuda)
    batch = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8)
    for r in range(len(rows)):
        idx, alone = _row_alone(args, r, 8)
        tlaunches.reset()
        got = tra.ragged_paged_attention(*alone, num_kv_heads=Hkv, q_tile=8)
        torch.cuda.synchronize()
        assert torch.equal(got, batch[idx]), f"row {rows[r]} alone differs from the batch"
        assert tra.KERNEL_LAUNCHES == {"mixed_tc_bf16": 0, "mixed_f32": 1, "decode_split": 0}


@pytest.mark.parametrize("dtype,atol", TOLS)
def test_mixed_shape_rows_of_4096_tokens(cuda, dtype, atol):
    """Rows of 4,096 tokens (64 chunks of the float32 ring): a 64-query
    span at its end and a lone token at the last position."""
    rows = [(64, 4096), (1, 4096), (9, 2120)]
    args = _flat_batch(5, rows, 32, 8, 128, 2 * 256 + 136, 16, 256, 8, dtype, cuda)
    tlaunches.reset()
    got = tra.ragged_paged_attention(*args, num_kv_heads=8, q_tile=8)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[args[5] < 0] == 0).all()  # padding slots and the empty tile
    design = "mixed_tc_bf16" if dtype == torch.bfloat16 else "mixed_f32"
    assert tra.KERNEL_LAUNCHES[design] == 1 and sum(tra.KERNEL_LAUNCHES.values()) == 1


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
    tlaunches.reset()
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


# Windowed and softcapped attention: (H, Hkv, D, window, softcap,
# sm_scale) of gemma2-9b (both layer kinds), gemma-2b (one kv head),
# mistral-7b and a window shorter than a chunk. Rows run past the window
# and stay inside it; a 512-query chunk straddles the window's start.
WINDOWED = {
    "gemma2_sliding": (16, 8, 256, 300, 50.0, 256**-0.5),
    "gemma2_global": (16, 8, 256, None, 50.0, 224**-0.5),
    "gemma_2b": (8, 1, 256, None, None, None),
    "mistral": (32, 8, 128, 300, None, None),
    "window_17": (8, 4, 64, 17, 30.0, None),
}
WINDOW_SPANS = ([(512, 1024), (1, 17), (64, 700), (1, 2049), (9, 301), (24, 300)], 600, 129)


def _attn_kw(case):
    H, Hkv, D, window, softcap, scale = WINDOWED[case]
    return (H, Hkv, D), dict(window=window, softcap=softcap, sm_scale=scale)


@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("case", sorted(WINDOWED))
def test_mixed_shape_windows_and_softcaps_match_plain(cuda, dtype, atol, case):
    (H, Hkv, D), kw = _attn_kw(case)
    rows, P, pmax = WINDOW_SPANS
    args = _flat_batch(6, rows, H, Hkv, D, P, 16, pmax, 8, dtype, cuda)
    tlaunches.reset()
    got = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8, **kw)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=Hkv, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[args[5] < 0] == 0).all()
    if dtype == torch.bfloat16:
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, *args[3:], num_kv_heads=Hkv, **kw), *args[:3])
    design = "mixed_tc_bf16" if dtype == torch.bfloat16 else "mixed_f32"
    assert tra.KERNEL_LAUNCHES[design] == 1 and sum(tra.KERNEL_LAUNCHES.values()) == 1


@pytest.mark.parametrize("case", ["gemma2_sliding", "mistral", "gemma_2b"])
def test_mixed_f32_windowed_rows_alone_equal_rows_in_the_batch(cuda, case):
    """Batch invariance holds with a window and at D = 256: the walk
    starts at the run's earliest visible key, and steps before a row's
    window are exact no-ops for it."""
    (H, Hkv, D), kw = _attn_kw(case)
    rows, P, pmax = WINDOW_SPANS
    args = _flat_batch(6, rows, H, Hkv, D, P, 16, pmax, 8, torch.float32, cuda)
    batch = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8, **kw)
    for r in range(len(rows)):
        idx, alone = _row_alone(args, r, 8)
        got = tra.ragged_paged_attention(*alone, num_kv_heads=Hkv, q_tile=8, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, batch[idx]), f"row {rows[r]} alone differs from the batch"


@pytest.mark.parametrize("dtype,atol", TOLS)
@pytest.mark.parametrize("case", sorted(WINDOWED))
@pytest.mark.parametrize("split", [32, 64])
def test_decode_shape_windows_and_softcaps_match_plain(cuda, dtype, atol, case, split):
    """Rows past the window (their leading splits are skipped and the
    combine starts at the window's split), inside it and inactive."""
    (H, Hkv, D), kw = _attn_kw(case)
    lengths = [2064, 1, 0, 301, 1040, 17, 2049, 300]
    spans = [(1, max(n, 1)) for n in lengths]
    pmax = -(-max(lengths) // 16) + 1
    P = sum(-(-max(n, 1) // 16) for n in lengths) + 4
    q, k, v, table, _, _ = _flat_batch(7, spans, H, Hkv, D, P, 16, pmax, 1, dtype, cuda)
    q, table = q[: len(lengths)].contiguous(), table[: len(lengths)].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    rows = torch.arange(len(lengths), dtype=torch.int32, device=cuda)
    tlaunches.reset()
    got = tra.ragged_decode_attention(q, k, v, table, lens, num_kv_heads=Hkv, split=split,
                                      **kw)
    want = tra.ragged_paged_attention_ref(q, k, v, table, rows, lens - 1, num_kv_heads=Hkv,
                                          **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[lens == 0] == 0).all()
    if dtype == torch.bfloat16:
        _assert_within_bf16_rounding(
            got, lambda q, k, v: tra.ragged_paged_attention_ref(
                q, k, v, table, rows, lens - 1, num_kv_heads=Hkv, **kw), q, k, v)
    assert tra.KERNEL_LAUNCHES == {"mixed_tc_bf16": 0, "mixed_f32": 0, "decode_split": 1}


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
    with pytest.raises(ValueError, match="window"):
        tra.ragged_paged_attention(*args, num_kv_heads=4, window=0)
    with pytest.raises(ValueError, match="softcap"):
        tra.ragged_paged_attention(*args, num_kv_heads=4, softcap=-1.0)
    lens = torch.tensor([9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="window"):
        tra.ragged_decode_attention(q[:1].contiguous(), k, v, table[:1].contiguous(), lens,
                                    num_kv_heads=4, window=0)
    # Head dims other than 64, 128 and 256, and more than 64 query rows
    # a tile (q heads per kv head x q_tile), stay refused.
    for H, Hkv, D in ((8, 4, 96), (72, 1, 64), (16, 2, 512)):
        bad = _flat_batch(2, [(3, 9)], H, Hkv, D, 8, 16, 4, 8, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="unsupported layout"):
            tra.ragged_paged_attention(*bad, num_kv_heads=Hkv)


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

    tlaunches.reset()
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
    tlaunches.reset()
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
            tlaunches.reset()
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_windows_equal_eager_windows(cuda, dtype):
    """The same burst (greedy, seeded and penalized rows with logprobs,
    chained) through CUDA graphs of the decode window and eagerly: the
    same tokens bit for bit and the same launch counts, and a prewarmed
    engine's traffic captures nothing."""
    from dynamo_exp_tpu_torch.aot import prewarm_engine

    cfg_m = replace(TINY, dtype=dtype, head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)
    sampling = [{}, {"temperature": 0.8, "seed": 21, "top_k": 30},
                {"temperature": 0.7, "seed": 5, "frequency_penalty": 0.5, "logprobs": 2}]
    rs = np.random.RandomState(0)
    prompts = [list(map(int, rs.randint(3, 250, size=n))) for n in (5, 70, 17)]

    def run(graphs, prewarm=False):
        cfg = EngineConfig(
            model=cfg_m, max_decode_slots=4, page_size=16, num_pages=64,
            max_model_len=256, prefill_chunk=32, decode_window=4, kv_dtype=dtype,
            cuda_graphs=graphs,
        )
        eng = TorchEngine(cfg, device=cuda, seed=3)
        if prewarm:
            prewarm_engine(eng)
        captured = eng.metrics()["graphs_captured"]
        tlaunches.reset()

        async def go():
            streams = [eng.submit({"token_ids": p, "sampling_options": so,
                                   "stop_conditions": {"max_tokens": 30, "ignore_eos": True}})
                       for p, so in zip(prompts, sampling)]
            eng.start()

            async def collect(s):
                return [t async for item in s for t in item.get("token_ids", [])]

            return await asyncio.gather(*(collect(s) for s in streams))

        try:
            out = asyncio.run(asyncio.wait_for(go(), timeout=300))
        finally:
            eng.stop()
        m = eng.metrics()
        return out, dict(tra.KERNEL_LAUNCHES), m, m["graphs_captured"] - captured

    eager, eager_launches, em, _ = run(False)
    graphed, launches, gm, _ = run(True)
    assert graphed == eager and all(len(t) == 30 for t in eager)
    assert launches == eager_launches and launches["decode_split"] > 0
    disp = gm["dispatches"]
    assert em["graph_replays"] == 0 and disp["windowed"] > 0 and disp["mixed"] > 0
    assert gm["graph_replays"] == disp["windowed"] + disp["mixed"]
    assert gm["graphs"]["mixed"]["replays"] == disp["mixed"]
    warm, warm_launches, wm, new = run(True, prewarm=True)
    assert warm == eager and warm_launches == eager_launches
    report = wm["prewarm"]
    assert new == 0 and report["graphs"] == report["variants"] > 0
    assert report["mixed_graphs"] == report["mixed_variants"] > 0
    assert report["pool_bytes"] > 0


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "unchained"])
def test_graphed_and_eager_runs_record_the_same_telemetry_on_the_card(cuda, chained):
    """Telemetry hooks run on the host around each replay, never inside a
    captured graph: real CUDA graphs and eager dispatches give the same
    flight events (the wall stamp aside) and the same counter and
    histogram-sample deltas; ``dynamo_compile_seconds`` counts one
    sample per graph captured, by kind."""
    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    cfg_m = replace(TINY, dtype="bfloat16", head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)
    rs = np.random.RandomState(1)
    prompts = [list(map(int, rs.randint(3, 250, size=n))) for n in (5, 70, 17)]
    sampling = [{}, {} if chained else {"temperature": 0.8, "seed": 21}, {}]

    def counts():
        out = {}
        for line in get_telemetry().render().decode().splitlines():
            if line.startswith("#") or ("_bucket" in line or "_sum" in line):
                continue
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
        return out

    def run(graphs):
        cfg = EngineConfig(model=cfg_m, max_decode_slots=4, page_size=16, num_pages=64,
                           max_model_len=256, prefill_chunk=32, decode_window=4,
                           kv_dtype="bfloat16", cuda_graphs=graphs, chained_decode=chained)
        eng = TorchEngine(cfg, device=cuda, seed=3)
        before = counts()

        async def go():
            streams = [eng.submit({"token_ids": p, "sampling_options": so,
                                   "stop_conditions": {"max_tokens": 30, "ignore_eos": True}},
                                  AsyncEngineContext(f"r{i}"))
                       for i, (p, so) in enumerate(zip(prompts, sampling))]
            eng.start()

            async def collect(s):
                return [t async for item in s for t in item.get("token_ids", [])]

            return await asyncio.gather(*(collect(s) for s in streams))

        try:
            out = asyncio.run(asyncio.wait_for(go(), timeout=300))
        finally:
            eng.stop()
        after = counts()
        timing = ("dynamo_dispatch_seconds", "dynamo_host_gap_seconds",
                  "dynamo_compile_seconds", "dynamo_compile_cache_misses",
                  "dynamo_engine_", "dynamo_stage_duration", "dynamo_kv_",
                  "dynamo_request_seconds")
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v != before.get(k, 0.0) and not k.startswith(timing)}
        events = [{k: v for k, v in e.items() if k != "t"} for e in eng.flight.snapshot()]
        return out, events, delta, {k: v - before.get(k, 0.0) for k, v in after.items()
                                    if k.startswith("dynamo_compile_seconds_count")}, eng

    eager, e_events, e_delta, _, _ = run(False)
    graphed, g_events, g_delta, g_compile, eng = run(True)
    assert graphed == eager and g_events == e_events and g_delta == e_delta
    m = eng.metrics()
    for kind in ("window", "mixed"):
        assert g_compile[f'dynamo_compile_seconds_count{{kind="{kind}"}}'] == (
            m["graphs"][kind]["captured"]) > 0
    assert (m["dispatches"]["chained"] > 0) == chained


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_key_replay_equals_its_eager_dispatch(cuda, dtype):
    """One mixed key with the full sampler, verify spans and logprobs: a
    prefill chunk, a decode row and a verify span of 4 drafts in a
    stream padded to 64 slots. The key's graph replay gives its eager
    dispatch's outputs and penalty counts bit for bit, with the same
    kernel launches."""
    from dynamo_exp_tpu_torch.aot import MixedKey

    cfg_m = replace(TINY, dtype=dtype, head_dim=64, num_heads=4, num_kv_heads=2,
                    hidden_size=256)
    cfg = EngineConfig(model=cfg_m, max_decode_slots=4, page_size=16, num_pages=64,
                       max_model_len=256, prefill_chunk=32, decode_window=4, kv_dtype=dtype,
                       spec_mode="ngram", spec_max_draft=4)
    eng = TorchEngine(cfg, device=cuda, seed=3)
    key = MixedKey(64, None, True, True, True)
    host = eng._mixed_host(key)
    rs = np.random.RandomState(1)
    B1, T_s = 5, 5
    # (first slot, fed tokens, first position, pages) of rows 0-2.
    for r, (qs, n, p0, pages) in enumerate([(0, 20, 0, [0, 1]), (24, 1, 30, [2, 3]),
                                            (32, 5, 40, [4, 5, 6])]):
        host["tokens"][qs : qs + n] = rs.randint(3, 250, size=n)
        host["positions"][qs : qs + n] = np.arange(p0, p0 + n)
        host["row_of"][qs : qs + -(-n // 8) * 8] = r
        host["table"][r, : len(pages)] = pages
        host["out_idx"][r] = qs + n - 1
        host["seeds"][r], host["temp"][r], host["freq"][r] = 11 + r, 0.8, 0.3
    host["pos0"][:2], host["is_decode"][1], host["slot"][1:3] = (19, 30), True, (1, 2)
    host["out_idx"][B1 + 2 * T_s : B1 + 3 * T_s] = np.arange(32, 37)
    host["drafts"][2], host["n_drafts"][2] = rs.randint(3, 250, size=4), 4
    host["spec_pos"][2] = np.arange(40, 45)
    eng._counts[1:3, 7] = 2
    before = eng._counts.clone()
    tlaunches.reset()
    eager = [t.clone() for t in eng._mixed_body(key, dict(zip(host, eng._upload(*host.values()))))]
    eager_launches, counts = dict(tra.KERNEL_LAUNCHES), eng._counts.clone()
    eng._counts.copy_(before)
    g = eng.graphs.get(key)
    eng._upload_into(g.in_buf, list(host.values()), g.offs)
    tlaunches.reset()
    eng.graphs.replay(g)
    torch.cuda.synchronize()
    assert len(g.outputs) == len(eager) == 9
    for i, (a, b) in enumerate(zip(eager, g.outputs)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    assert torch.equal(eng._counts, counts) and not torch.equal(counts, before)
    assert dict(tra.KERNEL_LAUNCHES) == eager_launches
    assert sum(eager_launches.values()) == cfg_m.num_layers


def test_loader_round_trip_on_the_card(cuda, tmp_path):
    """Weights written with ``save_safetensors`` (two shards, bf16) come
    back bit-equal on the card through ``load_params``."""
    import json

    from dynamo_exp_tpu_torch.models import init_params
    from dynamo_exp_tpu_torch.models.loader import hf_tensor_names, load_params, save_safetensors

    cfg_m = replace(TINY, dtype="bfloat16", model_type="qwen3", qk_norm=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    want = init_params(cfg_m, gen, cuda)
    names = hf_tensor_names(cfg_m)
    tensors = {n: getattr(want if li is None else want.layers[li], a) for n, (li, a) in names.items()}
    keys = sorted(tensors)
    save_safetensors(str(tmp_path / "a.safetensors"), {k: tensors[k] for k in keys[::2]})
    save_safetensors(str(tmp_path / "b.safetensors"), {k: tensors[k] for k in keys[1::2]})
    conf = {"model_type": "qwen3", "vocab_size": cfg_m.vocab_size,
            "hidden_size": cfg_m.hidden_size, "num_hidden_layers": cfg_m.num_layers,
            "num_attention_heads": cfg_m.num_heads, "num_key_value_heads": cfg_m.num_kv_heads,
            "intermediate_size": cfg_m.intermediate_size, "head_dim": cfg_m.head_dim_,
            "max_position_embeddings": cfg_m.max_position_embeddings,
            "rms_norm_eps": cfg_m.rms_norm_eps, "rope_theta": cfg_m.rope_theta,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    (tmp_path / "config.json").write_text(json.dumps(conf))
    got, _ = load_params(str(tmp_path), device=cuda)
    mine = dict(got.named_parameters())
    for name, p in want.named_parameters():
        assert mine[name].device.type == "cuda" and torch.equal(mine[name], p), name


@pytest.mark.parametrize("E,K,N", [(8, 2, 37), (16, 8, 5), (6, 3, 1)])
def test_moe_ffn_grouped_products_match_the_plain_loop_without_a_sync(cuda, monkeypatch, E, K, N):
    """The MoE FFN on the card (``torch._grouped_mm`` with the groups'
    ends on the device) equals the per-expert loop (the same bf16
    products; the replicas summed in float32 alike) within two bf16 ulps
    of the output's scale, runs under sync debug "error" and counts
    three grouped products."""
    from dynamo_exp_tpu_torch.ops import moe as tmoe

    D, I = 256, 512
    gen = torch.Generator(device=cuda)
    gen.manual_seed(E * 100 + K)

    def w(*shape, fan):
        return (torch.randn(shape, generator=gen, device=cuda) * fan**-0.5).to(torch.bfloat16)

    x = w(N, D, fan=1)
    args = (w(E, D, fan=D), w(E, I, D, fan=D), w(E, I, D, fan=D), w(E, D, I, fan=I), K)
    tlaunches.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tmoe.moe_ffn(x, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tmoe.LAUNCHES["grouped_mm"] == 3
    monkeypatch.setattr(tmoe, "grouped_linear",
                        lambda xs, wt, counts, ends: tmoe.grouped_linear_ref(xs, wt, counts))
    want = tmoe.moe_ffn(x, *args)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * 2**-8 * scale


def test_moe_ffn_refuses_float32_on_the_card(cuda):
    """In float32 ``torch._grouped_mm`` copies the groups' ends to the
    host (a sync a CUDA graph capture refuses), so the card's MoE FFN
    raises, naming the reason, and launches nothing."""
    from dynamo_exp_tpu_torch.ops import moe as tmoe

    E, K, D, I = 8, 2, 64, 128
    gen = torch.Generator(device=cuda)
    gen.manual_seed(15)
    x = torch.randn(5, D, generator=gen, device=cuda)
    args = [torch.randn(s, generator=gen, device=cuda)
            for s in ((E, D), (E, I, D), (E, I, D), (E, D, I))]
    tlaunches.reset()
    with pytest.raises(NotImplementedError, match="bf16 only"):
        tmoe.moe_ffn(x, *args, K)
    assert tmoe.LAUNCHES["grouped_mm"] == 0
