"""The port's G2 host tier on the CPU: ``HostKvPool`` and ``CopyStream``
(the units of the JAX package's ``tests/test_kv_offload.py`` and
``tests/test_kv_tiering.py``, on torch tensors), and the engine paths
through them: an evicted prefix comes back from the host tier with the
same tokens, and a waiting prompt's prefix is restored ahead of its
admission (prefetch).
"""

import asyncio
import time
from dataclasses import replace

import numpy as np
import torch

from dynamo_exp_tpu.engine.offload import HostKvPool as JHostKvPool
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.offload import CopyStream, HostKvPool
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.tokens import compute_block_hashes_for_seq

PS = 8
CFG = replace(TINY, dtype="float32")


def _page(value, shape=(1, 4, 2)):
    return torch.full(shape, float(value))


# ---------------------------------------------------------------- HostKvPool
def test_host_pool_store_fetch_lru():
    pool = HostKvPool(2, page_shape=(1, 4, 2), dtype=torch.float32)
    pool.store(100, _page(1), _page(2))
    got = pool.fetch(100)
    assert torch.equal(got[0], _page(1)) and torch.equal(got[1], _page(2))
    # The fetched copy survives its slot being recycled.
    pool.store(200, _page(3), _page(3))
    pool.store(300, _page(4), _page(4))  # evicts the LRU page
    assert torch.equal(got[0], _page(1))
    assert 100 not in pool and 200 in pool and 300 in pool
    assert pool.resident == 2 and pool.evictions == 1


def test_host_pool_store_idempotent_per_hash():
    pool = HostKvPool(2, page_shape=(1, 4, 2), dtype=torch.float32)
    pool.store(7, _page(1), _page(1))
    pool.store(7, _page(5), _page(5))  # refresh, not duplicate
    assert pool.resident == 1
    assert torch.equal(pool.fetch(7)[0], _page(5))


def test_match_chain_is_prefix_only_and_fetch_into_out():
    pool = HostKvPool(4, page_shape=(1, 4, 2), dtype=torch.float32)
    pool.store(1, _page(1), _page(2))
    pool.store(3, _page(3), _page(4))
    assert pool.match_chain([1, 2, 3]) == [1]
    assert pool.match_chain([1, 3]) == [1, 3]
    assert pool.match_chain([2]) == []
    out = (torch.zeros(1, 4, 2), torch.zeros(1, 4, 2))
    assert pool.fetch(3, out=out) is out and torch.equal(out[1], _page(4))
    assert pool.fetch(2, out=out) is None


def test_host_pool_equals_jax_pool_under_random_traffic():
    """Same stores and fetches on both pools: same residents, hits,
    evictions and bytes."""
    rs = np.random.RandomState(0)
    shape = (2, 4, 3)
    tp = HostKvPool(5, shape, torch.float32)
    jp = JHostKvPool(5, shape, np.float32)
    for _ in range(400):
        h = int(rs.randint(0, 12))
        if rs.rand() < 0.5:
            k, v = rs.standard_normal((2,) + shape).astype(np.float32)
            tp.store(h, torch.from_numpy(k), torch.from_numpy(v))
            jp.store(h, k, v)
        else:
            t, j = tp.fetch(h), jp.fetch(h)
            assert (t is None) == (j is None)
            if t is not None:
                assert np.array_equal(t[0].numpy(), j[0]) and np.array_equal(t[1].numpy(), j[1])
        chain = [int(x) for x in rs.randint(0, 12, size=4)]
        assert tp.match_chain(chain) == jp.match_chain(chain)
    assert (tp.resident, tp.hits, tp.evictions, tp.stores) == (
        jp.resident, jp.hits, jp.evictions, jp.stores)


# ---------------------------------------------------------------- CopyStream
def test_copy_stream_offload_and_fetch_directions_drain_and_stop():
    pool = HostKvPool(4, page_shape=(1, 4, 2), dtype=torch.float32)
    stream = CopyStream(pool)
    stored = []
    # One batch [L, n, ps, HkvD] of two pages, committed page by page.
    k_b = torch.stack([_page(1), _page(3)], dim=1)
    v_b = torch.stack([_page(2), _page(4)], dim=1)
    assert stream.offload_batch([1, 2], k_b, v_b, on_stored=lambda: stored.append(1))
    stream.drain()
    assert stored == [1] and stream.pending == 0
    assert torch.equal(pool.fetch(2)[1], _page(4))
    results = []
    assert stream.fetch_batch([1, 2, 99], {"tag": "job"},
                              lambda ctx, fetched: results.append((ctx, fetched)))
    stream.drain()  # drain covers the fetch direction
    ctx, fetched = results[0]
    assert ctx == {"tag": "job"}
    assert [h for h, _, _ in fetched] == [1, 2]  # stops at the first miss
    assert torch.equal(fetched[0][1], _page(1)) and torch.equal(fetched[1][2], _page(4))
    s = stream.stats()
    assert s["d2h_pages"] == 2 and s["d2h_bytes"] == 2 * k_b.numel() * 4
    # stop() stays bounded with both directions queued.
    stream.fetch_batch([1], None, lambda *a: None)
    stream.offload_batch([5], k_b[:, :1], v_b[:, :1])
    t0 = time.monotonic()
    stream.stop()
    assert time.monotonic() - t0 < 10.0 and stream.error is None


def test_copy_stream_reports_saturation():
    pool = HostKvPool(2, page_shape=(1, 4, 2), dtype=torch.float32)
    stream = CopyStream(pool, max_inflight=1)
    stream.stop()  # worker gone: nothing drains the queue any more
    k = _page(1)[:, None]
    assert stream.offload_batch([1], k, k) is True  # fills the queue
    assert stream.offload_batch([2], k, k) is False  # saturated: shed
    assert stream.fetch_batch([2], None, lambda *a: None) is False
    assert stream.dropped == 2


def test_copy_stream_error_stops_the_stream():
    """A failed item is never passed over: the stream stops and keeps
    the error for the engine loop to raise."""
    pool = HostKvPool(2, page_shape=(1, 4, 2), dtype=torch.float32)
    stream = CopyStream(pool)
    bad = torch.zeros(1, 1, 3, 3)  # wrong page shape
    stream.offload_batch([1], bad, bad)
    stream.drain()
    assert stream.error is not None and 1 not in pool
    stream.stop()


def test_upload_is_a_plain_copy_on_the_cpu():
    pool = HostKvPool(2, page_shape=(1, 4, 2), dtype=torch.float32)
    stream = CopyStream(pool)
    k, v = torch.stack([_page(1)], 1), torch.stack([_page(2)], 1)
    k_dev, v_dev = stream.upload(k, v)
    assert torch.equal(k_dev, k) and torch.equal(v_dev, v)
    assert stream.stats()["h2d_pages"] == 1
    stream.stop()


# ------------------------------------------------------------------ engine
def _engine(num_pages, host_pages, slots=2, max_model_len=128, **kw):
    cfg = EngineConfig(
        model=CFG, max_decode_slots=slots, page_size=PS, num_pages=num_pages,
        max_model_len=max_model_len, prefill_chunk=16, decode_window=4,
        kv_dtype="float32", eos_token_ids=[], host_cache_pages=host_pages, **kw,
    )
    return TorchEngine(cfg, device="cpu", seed=0)


async def _collect(eng, prompt, n):
    stream = await eng.generate(
        {"token_ids": list(prompt), "stop_conditions": {"max_tokens": n, "ignore_eos": True}}
    )
    return [t async for item in stream for t in item.get("token_ids", [])]


def _run(coro):
    """Run ``coro`` to its end, failing after 300 s instead of hanging."""
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


def _audit_clean(eng):
    with eng.hold_admission():
        audit = eng.kv_audit()
    assert audit["ok"], audit["violations"]


def test_g2_round_trip_restores_an_evicted_prefix():
    """8-page pool: A takes 4 pages (3 full), B needs 6 and evicts A's
    parked pages to the host tier; A again restores its prefix from
    there and decodes the same tokens."""
    eng = _engine(num_pages=8, host_pages=32)
    try:
        rs = np.random.RandomState(0)
        prompt_a = [int(t) for t in rs.randint(3, 200, size=3 * PS + 2)]
        prompt_b = [int(t) for t in rs.randint(3, 200, size=5 * PS + 2)]
        first = _run(_collect(eng, prompt_a, 6))
        _run(_collect(eng, prompt_b, 6))
        eng.copy_stream.drain()
        assert eng.host_pool.stores > 0  # eviction wrote back
        hashes = compute_block_hashes_for_seq(prompt_a, PS)
        assert eng.kv.match_resident_hashes(hashes) == []
        restorable = len(eng.host_pool.match_chain(hashes))
        assert restorable >= 1
        hits = eng.kv.offload_hits
        assert _run(_collect(eng, prompt_a, 6)) == first
        assert eng.kv.offload_hits == hits + restorable  # the prefix came from G2
        m = eng.metrics()
        assert m["kv_host_pages"] > 0 and m["offload_hits"] > 0
        _audit_clean(eng)
    finally:
        eng.stop()
    assert eng.copy_stream is None and eng.copy_stats()["h2d_pages"] >= restorable


def test_offload_disabled_by_default():
    eng = _engine(num_pages=10, host_pages=0)
    assert eng.host_pool is None and eng.copy_stream is None
    try:
        assert len(_run(_collect(eng, [5, 6, 7, 8], 4))) == 4
        assert "host_cache_resident" not in eng.metrics()
        assert eng.copy_stream is None
    finally:
        eng.stop()


def test_prefetch_restores_a_waiting_prompt_ahead_of_admission():
    """A prompt whose pages were evicted to the host tier arrives while
    both slots are busy: its prefix is restored ahead of its admission,
    which then hits it in G1, and it decodes the same tokens."""
    rs = np.random.RandomState(3)
    pool = 24
    eng = _engine(num_pages=pool, host_pages=64, max_model_len=pool * PS,
                  prefetch_reserve_pages=2)
    try:
        pa = [int(x) for x in rs.randint(3, 200, size=3 * PS + 2)]
        a_tokens = _run(_collect(eng, pa, 6))
        # B takes the whole pool: A's parked pages go to the host tier.
        _run(_collect(eng, [int(x) for x in rs.randint(3, 200, size=pool * PS - 6)], 2))
        assert eng.kv.match_resident_hashes(compute_block_hashes_for_seq(pa, PS)) == []

        async def scenario():
            longs = [
                asyncio.ensure_future(
                    _collect(eng, [int(x) for x in rs.randint(3, 200, size=PS)], 40))
                for _ in range(2)
            ]
            steps0 = eng.steps
            while eng.steps < steps0 + eng.cfg.decode_window:
                await asyncio.sleep(0.002)
            late = asyncio.ensure_future(_collect(eng, pa, 6))
            return await asyncio.gather(*longs, late)

        *_, a2 = _run(scenario())
        assert a2 == a_tokens
        m = eng.metrics()
        assert m["prefetched_pages"] >= 3 and m["prefetch_hits"] >= 3, m
        _audit_clean(eng)
    finally:
        eng.stop()


def test_smoke_kv_pressure_phase_on_cpu():
    """``chip_smoke.py``'s phase 7 rehearsed at TINY widths on the CPU:
    the pressured burst finishes (a), the G2 round trip restores bit-
    equal bytes and tokens (b), and the float32 burst equals the solo
    runs (c)."""
    import chip_smoke as cs
    import dynamo_exp_tpu_torch as pkg
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    small = replace(TINY, vocab_size=2048, max_position_embeddings=512)
    lens, max_tokens = (8, 20, 40, 33, 64, 17, 50, 70), 24
    need = cs.pages_needed(lens, max_tokens)
    sh = cs.Pressure(device="cpu", prompt_lens=lens, max_tokens=max_tokens,
                     num_pages=int(need * 0.89), host_pages=128, hit_tokens=6)
    out = cs.pressure_burst(torch, np, pkg, tra, "cpu", mcfg=small, sh=sh)
    assert out["b_hits"] == 70 // cs.PS
    assert out["b_copies"]["h2d_pages"] >= out["b_hits"]
    c = cs.pressure_identity_f32(torch, np, pkg, tra, "cpu",
                                 mcfg=replace(small, dtype="float32"), sh=sh)
    assert c["swapped_out"] + c["preempted"] > 0
