"""Prefix sharing of pages still being filled, and partial tails with
copy-on-write: the port's ``KvPageManager`` call for call against the
JAX package's (``tests/test_prefix_sharing.py:143-198``), and the
port's engine with sharing on against sharing off (the private-copy
baseline), after ``tests/test_prefix_sharing.py:376-402``.

Each manager scenario runs the same calls on both packages' managers
(the same pool, the same free-list order) and compares every result:
page ids, cached lengths, pages waiting on a fill, the shared tail,
fill states, copy-on-write targets and counters. The engine tests run
float32 TINY on the CPU: a prompt ending inside a block another
request registered attaches it as a shared tail, copies it before its
first write, and emits the tokens the private baseline emits; a burst
of one prompt admitted together shares the first request's pages
while they are still being filled.
"""

import asyncio
from dataclasses import replace

import numpy as np
import pytest

from dynamo_exp_tpu.engine import KvPageManager as JKvPageManager
from dynamo_exp_tpu.kv import PrefixIndex as JPrefixIndex
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.kv_manager import KvPageManager as TKvPageManager
from dynamo_exp_tpu_torch.kv import PrefixIndex as TPrefixIndex
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.telemetry import get_telemetry
from dynamo_exp_tpu_torch.tokens import compute_block_hashes_for_seq

PS = 8


def _register_chain(kv, tokens):
    hashes = compute_block_hashes_for_seq(tokens, kv.page_size)
    alloc = kv.allocate_sequence(tokens, max_pages=64, request_id="seed")
    parent = None
    for i, h in enumerate(hashes):
        kv.register_full_page(
            alloc.page_ids[i], h, parent_hash=parent,
            tokens=tokens[i * kv.page_size : (i + 1) * kv.page_size],
        )
        parent = h
    return alloc, hashes


def _alloc(a):
    return (list(a.page_ids), a.cached_len, a.cached_pages, sorted(a.wait_fill), a.shared_tail)


def _matched(kv, tokens):
    return kv._match_hashes(compute_block_hashes_for_seq(tokens, kv.page_size))[0]


def scenario_concurrent_same_prompt(kv):
    prompt = list(range(1, 14))  # 3 full blocks + 1 tail token
    a = kv.allocate_sequence(prompt, max_pages=8, request_id="a")
    used = kv.active_pages
    b = kv.allocate_sequence(prompt, max_pages=8, request_id="b")
    assert b.page_ids[:3] == a.page_ids[:3] and b.cached_len == 12
    assert set(b.wait_fill) == set(a.page_ids[:3])
    assert kv.active_pages == used + 1 and kv.live_shared == 3
    states = [kv.fill_state(a.page_ids[0])]
    kv.mark_filled(a.page_ids[:3])
    states += [kv.fill_state(p) for p in b.page_ids[:3]]
    assert states == ["pending"] + ["filled"] * 3
    return [_alloc(a), _alloc(b), states, dict(kv.prefix_hits)]


def scenario_orphaned_fill(kv):
    prompt = list(range(1, 10))  # 2 full blocks + tail
    a = kv.allocate_sequence(prompt, max_pages=8, request_id="a")
    b = kv.allocate_sequence(prompt, max_pages=8, request_id="b")
    kv.abort_fills("a", a.page_ids)
    kv.release_sequence(a.page_ids)
    states = [kv.fill_state(b.page_ids[0])]
    kv.claim_fill(b.page_ids[0], "b")
    states.append(kv.fill_state(b.page_ids[0]))
    assert states == ["orphaned", "pending"]
    # An unfilled registered page whose last reference drops
    # unregisters instead of parking as matchable.
    kv.abort_fills("b", b.page_ids)
    kv.release_sequence(b.page_ids)
    assert _matched(kv, prompt) == []
    return [_alloc(a), _alloc(b), states, kv.free_pages]


def scenario_full_cover(kv):
    prompt = list(range(1, 9))  # exactly 2 blocks
    a, _ = _register_chain(kv, prompt)
    kv.mark_filled(a.page_ids)
    kv.release_sequence(a.page_ids)
    b = kv.allocate_sequence(prompt, max_pages=8, request_id="b")
    assert b.page_ids == a.page_ids and b.cached_len == len(prompt) - 1
    assert b.shared_tail is None
    return [_alloc(a), _alloc(b)]


def scenario_partial_tail_cow(kv):
    owner = list(range(1, 9))  # 2 registered blocks
    a, hashes = _register_chain(kv, owner)
    kv.mark_filled(a.page_ids)
    b = kv.allocate_sequence(owner[:6], max_pages=8, request_id="b")
    assert b.shared_tail == (a.page_ids[1], 2) and b.cached_len == 5
    assert b.page_ids == a.page_ids
    new_pid = kv.make_private(a.page_ids[1])
    assert new_pid not in (None, a.page_ids[1]) and kv.cow_copies == 1
    # Sole holder: unregistered in place, no copy.
    kv.release_sequence([new_pid])
    kv.release_sequence(a.page_ids)
    pid = b.page_ids[0]
    assert kv.make_private(pid) == pid
    assert _matched(kv, owner) == [] and kv.cow_copies == 1
    return [_alloc(a), _alloc(b), new_pid, kv.cow_copies]


def scenario_sharing_off(kv):
    prompt = list(range(1, 9))
    a, _ = _register_chain(kv, prompt)
    b = kv.allocate_sequence(prompt, max_pages=8, request_id="b")
    assert set(a.page_ids).isdisjoint(b.page_ids)
    assert b.cached_len == 0 and b.wait_fill == [] and kv.prefix_hits["shared"] == 0
    return [_alloc(a), _alloc(b)]


def scenario_pending_tail_orphaned(kv):
    """A sharer attached a partial tail whose filler dies first: the
    tail page is orphaned, and the sharer's gate swaps it for a fresh
    page (no claim: other holders may still need the original)."""
    owner = list(range(1, 17))  # 2 blocks of 8, pending
    a = kv.allocate_sequence(owner, max_pages=8, request_id="a")
    b = kv.allocate_sequence(owner[:12], max_pages=8, request_id="b")
    assert b.shared_tail == (a.page_ids[1], 4) and sorted(b.wait_fill) == a.page_ids[:2]
    kv.abort_fills("a", a.page_ids)
    return [_alloc(a), _alloc(b), [kv.fill_state(p) for p in b.page_ids]]


SCENARIOS = {
    "concurrent_same_prompt": (scenario_concurrent_same_prompt, 16, 4, True),
    "orphaned_fill": (scenario_orphaned_fill, 16, 4, True),
    "full_cover": (scenario_full_cover, 16, 4, True),
    "partial_tail_cow": (scenario_partial_tail_cow, 16, 4, True),
    "sharing_off": (scenario_sharing_off, 16, 4, False),
    "pending_tail_orphaned": (scenario_pending_tail_orphaned, 16, 8, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_call_for_call_like_the_jax_manager(name):
    fn, pages, ps, sharing = SCENARIOS[name]
    want = fn(JKvPageManager(num_pages=pages, page_size=ps, sharing=sharing))
    got = fn(TKvPageManager(num_pages=pages, page_size=ps, sharing=sharing))
    assert got == want


@pytest.mark.parametrize("cls", [JPrefixIndex, TPrefixIndex], ids=["jax", "port"])
def test_index_partial_match_needs_tokens(cls):
    idx = cls()
    toks = list(range(10, 22))  # 3 blocks of 4
    hashes = compute_block_hashes_for_seq(toks, 4)
    idx.insert(None, hashes[0], tokens=toks[:4])
    idx.insert(hashes[0], hashes[1], tokens=toks[4:8])
    assert idx.partial_match(hashes[0], toks[4:6]) == (hashes[1], 2)
    assert idx.partial_match(hashes[0], [99]) is None
    assert idx.partial_match(hashes[0], []) is None
    assert idx.partial_match(12345, toks[4:6]) is None
    assert idx.partial_match(None, toks[:3]) == (hashes[0], 3)
    # A split run keeps each block's tokens.
    idx.insert(hashes[0], compute_block_hashes_for_seq(toks[:4] + [1, 2, 3, 4], 4)[1],
               tokens=[1, 2, 3, 4])
    assert idx.partial_match(hashes[0], toks[4:5]) == (hashes[1], 1)
    assert idx.partial_match(hashes[0], [1, 2]) is not None
    idx2 = cls()
    idx2.insert(None, hashes[0])
    assert idx2.partial_match(None, toks[:2]) is None


# ------------------------------------------------------------------ engine
CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(max_decode_slots=4, page_size=PS, num_pages=64, max_model_len=128,
                 prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[])


def _engine(sharing):
    return TorchEngine(EngineConfig(model=CFG, prefix_sharing=sharing, **ENGINE_KW),
                       device="cpu", seed=3)


async def _req(eng, prompt, n):
    stream = await eng.generate({"token_ids": list(prompt),
                                 "stop_conditions": {"max_tokens": n, "ignore_eos": True},
                                 "sampling_options": {}})
    toks = []
    async for item in stream:
        toks.extend(item.get("token_ids", []))
    return toks


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=300))


def test_partial_tail_cow_engine_identity():
    """B's prompt ends inside a block A registered while A still
    decodes: B attaches A's page as its shared tail, copies it before
    its first write, and emits exactly the private baseline's tokens;
    A's stream is unchanged too."""
    rs = np.random.RandomState(19)
    base = rs.randint(3, 200, size=2 * PS).tolist()
    short = base[: PS + 4]  # ends inside A's second block

    async def shared():
        eng = _engine(True)
        eng.start()
        try:
            want_a = asyncio.ensure_future(_req(eng, base, 24))
            while not eng.kv.match_resident_hashes(
                    compute_block_hashes_for_seq(base, PS), require_filled=True):
                await asyncio.sleep(0.005)
            got_b = await _req(eng, short, 5)
            got_a = await want_a
            return got_a, got_b, eng.metrics(), eng.flight.snapshot()
        finally:
            eng.stop()

    async def private():
        eng = _engine(False)
        eng.start()
        try:
            return await _req(eng, base, 24), await _req(eng, short, 5)
        finally:
            eng.stop()

    copies0 = get_telemetry().kv_cow_copies._only().get()
    got_a, got_b, m, events = _run(shared())
    want_a, want_b = _run(private())
    assert (got_a, got_b) == (want_a, want_b)
    assert m["kv_cow_copies"] >= 1 and m["kv_prefix_hits"]["shared"] >= 2
    assert sum(e["kind"] == "cow" for e in events) == m["kv_cow_copies"]
    assert get_telemetry().kv_cow_copies._only().get() - copies0 == m["kv_cow_copies"]


def test_burst_of_one_prompt_shares_pending_pages():
    """Four requests of one 3-page prompt admitted together: the later
    three attach the first one's pages while they are still being
    filled, wait for the fill, and emit the private baseline's tokens;
    a fifth ending inside the prompt's last block copies its tail."""
    rs = np.random.RandomState(23)
    prompt = rs.randint(3, 200, size=3 * PS + 5).tolist()
    prompts = [prompt] * 4 + [prompt[: 2 * PS + 3]]

    def burst(sharing):
        async def go():
            eng = _engine(sharing)
            eng.start()
            try:
                with eng.hold_admission():
                    jobs = [asyncio.ensure_future(_req(eng, p, 6)) for p in prompts]
                    await asyncio.sleep(0.05)
                return await asyncio.gather(*jobs), eng.metrics()
            finally:
                eng.stop()
        return _run(go())

    got, m_on = burst(True)
    want, m_off = burst(False)
    assert got == want
    assert m_on["kv_prefix_hits"]["shared"] >= 9 and m_off["kv_prefix_hits"]["shared"] == 0
    assert m_on["prefill_tokens_computed"] < m_off["prefill_tokens_computed"]
    assert m_on["kv_cow_copies"] == 1 and m_off["kv_cow_copies"] == 0


def test_page_aligned_full_match_copies_its_last_page_while_shared():
    """B's prompt is A's first block exactly: its last token's prefill
    lands in A's page, so B copies that page first while A still holds
    it, and both streams are the private baseline's. C, the same prompt
    after both finished, holds the parked page alone and writes it in
    place: no second copy, and the block stays matchable."""
    rs = np.random.RandomState(29)
    base = rs.randint(3, 200, size=2 * PS).tolist()
    aligned = base[:PS]

    async def shared():
        eng = _engine(True)
        eng.start()
        try:
            want_a = asyncio.ensure_future(_req(eng, base, 48))
            while not eng.kv.match_resident_hashes(
                    compute_block_hashes_for_seq(base, PS), require_filled=True):
                await asyncio.sleep(0.005)
            got_b = await _req(eng, aligned, 5)
            got_a = await want_a
            copies = eng.metrics()["kv_cow_copies"]
            got_c = await _req(eng, aligned, 5)
            return got_a, got_b, got_c, copies, eng.metrics()
        finally:
            eng.stop()

    async def private():
        eng = _engine(False)
        eng.start()
        try:
            return await _req(eng, base, 48), await _req(eng, aligned, 5)
        finally:
            eng.stop()

    got_a, got_b, got_c, copies, m = _run(shared())
    want_a, want_b = _run(private())
    assert (got_a, got_b, got_c) == (want_a, want_b, want_b)
    assert copies == 1 and m["kv_cow_copies"] == 1
    assert m["kv_prefix_hits"]["shared"] >= 2
