"""The port's CUDA kernel on the card (skips without an NVIDIA GPU).

Imports neither JAX nor the JAX package, so it runs where only the port
is installed: ``python -m pytest tests/test_torch_cuda.py`` on a machine
with an H100. The ragged kernel is held against its plain PyTorch
version on the same inputs: float32 at atol=1e-4 (float32 sums in
another order and chunking of the online softmax), bf16 at atol=2e-2
(the kernel rounds unnormalised probabilities to bf16 before PV, the
plain version the normalised ones, and both round the output to bf16).
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (8, 4, 64), (28, 4, 128)])
def test_mixed_shape_matches_plain(cuda, dtype, atol, H, Hkv, D):
    spans = [(1, 17), (40, 40), (9, 200), (1, 1), (16, 32)]
    args = _flat_batch(0, spans, H, Hkv, D, 128, 16, 16, 8, dtype, cuda)
    got = tra.ragged_paged_attention(*args, num_kv_heads=Hkv, q_tile=8)
    want = tra.ragged_paged_attention_ref(*args, num_kv_heads=Hkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[-8:] == 0).all()  # the empty tile


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_decode_shape_matches_plain_and_zeroes_inactive(cuda, dtype, atol):
    lengths = [1, 17, 0, 300, 16, 0, 33, 2]
    spans = [(1, max(n, 1)) for n in lengths]
    q, k, v, table, _, _ = _flat_batch(1, spans, 32, 8, 128, 256, 16, 32, 1, dtype, cuda)
    table = table[: len(lengths)].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = tra.ragged_decode_attention(q[: len(lengths)].contiguous(), k, v, table, lens)
    want = tra.ragged_paged_attention_ref(
        q[: len(lengths)], k, v, table,
        torch.arange(len(lengths), dtype=torch.int32, device=cuda), lens - 1,
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[lens == 0] == 0).all()


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
    assert got == run("reference")
