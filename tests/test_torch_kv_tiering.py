"""The port's KV tiering and preemption policy against the JAX package's,
on the CPU.

- The pure functions of ``engine/tiering.py`` (``footprint_pages``,
  ``swap_tail_key``, ``select_packed_index``, ``plan_swap_entries``) and
  ``scheduler.select_preemption_victim`` give the JAX functions' results
  on the same seeded inputs.
- ``Scheduler.preempt``'s surgery leaves the same continuation as the
  JAX scheduler's (the fields ``tests/test_overload.py`` checks).
- Footprint-packed admission (``Scheduler._pick_admission``) admits what
  the JAX scheduler admits, with its priority and starvation guards.
"""

import time

import numpy as np
import pytest

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import tiering as jtiering
from dynamo_exp_tpu.engine.kv_manager import KvPageManager as JKvPageManager
from dynamo_exp_tpu.engine.scheduler import Scheduler as JScheduler
from dynamo_exp_tpu.engine.scheduler import Sequence as JSequence
from dynamo_exp_tpu.engine.scheduler import SeqState as JSeqState
from dynamo_exp_tpu.engine.scheduler import select_preemption_victim as jvictim
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.protocols.common import BackendInput as JBackendInput
from dynamo_exp_tpu_torch.engine import EngineConfig, KvPageManager, Scheduler
from dynamo_exp_tpu_torch.engine import tiering
from dynamo_exp_tpu_torch.engine.scheduler import Sequence, SeqState, select_preemption_victim
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.protocols.common import BackendInput
from dynamo_exp_tpu_torch.tokens import compute_block_hashes_for_seq

PS = 8


# ------------------------------------------------------------- pure units
def test_footprint_pages_equals_jax():
    rs = np.random.RandomState(0)
    for _ in range(500):
        args = (int(rs.randint(0, 300)), int(rs.randint(-2, 300)), int(rs.choice([1, 8, 16])))
        mml = None if rs.rand() < 0.3 else int(rs.randint(1, 400))
        assert tiering.footprint_pages(*args, mml) == jtiering.footprint_pages(*args, mml)
    assert tiering.footprint_pages(16, 17, 8) == 4
    assert tiering.footprint_pages(8, 1000, 8, max_model_len=64) == 8


def test_swap_tail_key_equals_jax():
    rs = np.random.RandomState(1)
    for _ in range(200):
        parent = None if rs.rand() < 0.3 else int(rs.randint(0, 2**62))
        toks = [int(t) for t in rs.randint(0, 50000, size=rs.randint(0, 2 * PS))]
        assert tiering.swap_tail_key(parent, toks) == jtiering.swap_tail_key(parent, toks)
    block = list(range(PS))
    assert tiering.swap_tail_key(None, block) != compute_block_hashes_for_seq(block, PS)[0]


def test_select_packed_index_equals_jax():
    rs = np.random.RandomState(2)
    for _ in range(2000):
        n = int(rs.randint(0, 8))
        entries = [
            (bool(rs.rand() < 0.4), int(rs.randint(0, 3)), int(rs.randint(0, 5)))
            for _ in range(n)
        ]
        md = int(rs.randint(1, 5))
        assert tiering.select_packed_index(entries, md) == jtiering.select_packed_index(
            entries, md
        ), (entries, md)
    # The guards, spelled out.
    assert tiering.select_packed_index([(False, 1, 0), (True, 1, 0)], 64) == 1
    assert tiering.select_packed_index([(False, 2, 0), (True, 1, 0)], 64) is None
    assert tiering.select_packed_index([(False, 1, 3), (True, 1, 0)], 3) is None


def test_plan_swap_entries_equals_jax():
    rs = np.random.RandomState(3)
    for _ in range(300):
        n_tok = int(rs.randint(1, 6 * PS))
        tokens = [int(t) for t in rs.randint(0, 300, size=n_tok)]
        n_pages = (n_tok + PS - 1) // PS + int(rs.randint(0, 2))
        pids = [int(p) for p in rs.permutation(64)[:n_pages]]
        refs = {p: int(rs.choice([1, 1, 1, 2])) for p in pids}
        hashes = {p: int(rs.randint(0, 2**62)) for p in pids if rs.rand() < 0.4}
        tail = int(rs.choice(pids)) if rs.rand() < 0.2 else -1
        args = (pids, tokens, PS, refs.__getitem__, hashes.get)
        assert tiering.plan_swap_entries(*args, shared_tail_pid=tail) == (
            jtiering.plan_swap_entries(*args, shared_tail_pid=tail)
        )


def test_plan_swap_entries_classification():
    tokens = list(range(3 * PS + 3))  # written = len - 1 = 26
    refs = {10: 2, 11: 1, 12: 1, 13: 1, 14: 1}
    entries, off_pids, off_keys, park, drop = tiering.plan_swap_entries(
        [10, 11, 12, 13, 14], tokens, PS, refs.__getitem__, {11: 999}.get
    )
    assert [k for k, _ in entries] == ["kept", "hash", "host", "host"]
    assert entries[0] == ("kept", 10) and entries[1] == ("hash", 999) and park == [11]
    chain = compute_block_hashes_for_seq(tokens[: 3 * PS], PS)
    assert off_pids == [12, 13]
    assert off_keys == [chain[2], tiering.swap_tail_key(chain[2], tokens[3 * PS : 26])]
    assert drop == [14]


# --------------------------------------------------------- victim choice
def _pair_seqs(rs, n):
    """n JAX sequences and n port sequences with equal policy fields."""
    js, ts = [], []
    states = [(JSeqState.ACTIVE, SeqState.ACTIVE), (JSeqState.PREFILL, SeqState.PREFILL)]
    for i in range(n):
        jstate, tstate = states[int(rs.rand() < 0.2)]
        kw = dict(
            priority=int(rs.randint(0, 3)),
            submitted_at=float(rs.randint(0, 5)),
            preemptions=int(rs.randint(0, 3)),
        )
        common = dict(request_id=f"r{i}", prompt=[1], emit=None, is_cancelled=None)
        js.append(JSequence(stop=JBackendInput(token_ids=[1]), state=jstate, **common, **kw))
        ts.append(Sequence(stop=BackendInput(token_ids=[1]), state=tstate, **common, **kw))
    return js, ts


def test_select_preemption_victim_equals_jax():
    rs = np.random.RandomState(4)
    for _ in range(300):
        n = int(rs.randint(0, 6))
        js, ts = _pair_seqs(rs, n)
        slots_j = js + [None]
        slots_t = ts + [None]
        bound = int(rs.randint(1, 4))
        jv, tv = jvictim(slots_j, bound), select_preemption_victim(slots_t, bound)
        assert (jv is None) == (tv is None)
        if jv is not None:
            assert js.index(jv) == ts.index(tv)


# ------------------------------------------------------- preempt surgery
def _schedulers(num_pages=32, **kw):
    common = dict(max_decode_slots=4, page_size=PS, num_pages=num_pages,
                  max_model_len=128, eos_token_ids=[], **kw)
    js = JScheduler(JEngineConfig(model=JTINY, **common), JKvPageManager(num_pages, PS))
    ts = Scheduler(EngineConfig(model=TINY, **common), KvPageManager(num_pages, PS))
    return js, ts


def _mk(cls, bcls, prompt, rid, **kw):
    return cls(request_id=rid, prompt=list(prompt), stop=bcls(token_ids=list(prompt)),
               emit=lambda *a: None, is_cancelled=lambda: False, **kw)


def _surgery(sched, seq_cls, bi_cls, state_cls):
    """tests/test_overload.py's preempt scenario on one scheduler;
    returns the continuation's fields after each of two preemptions."""
    seq = _mk(seq_cls, bi_cls, range(1, 11), "a", sample_seed=42)
    seq.stop.stop_conditions.max_tokens = 20
    seq.stop.stop_conditions.min_tokens = 8
    sched.submit(seq)
    assert sched.admit_next() is seq
    seq.state = state_cls.ACTIVE
    seq.tokens = list(range(1, 11)) + [91, 92, 93]
    seq.generated = 3
    other = _mk(seq_cls, bi_cls, [5, 6], "b")
    sched.submit(other)
    sched.preempt(seq)

    def fields():
        sc = seq.stop.stop_conditions
        return dict(
            state=seq.state.value, prompt=seq.prompt, token_ids=seq.stop.token_ids,
            resume_offset=seq.stop.resume_offset, max_tokens=sc.max_tokens,
            min_tokens=sc.min_tokens, seed=seq.sample_seed, preemptions=seq.preemptions,
            generated=seq.generated, page_ids=seq.page_ids,
            waiting=[s.request_id for s in sched.waiting], active=sched.active_count,
            slots=[s is None for s in sched.slots], pages=sched.kv.active_pages,
            swap=seq.swap, forecast=seq.forecast_hashes, defers=seq.packing_defers,
        )

    first = fields()
    assert sched.admit_next() is other
    sched.waiting.clear()
    seq.state = state_cls.ACTIVE
    seq.slot = 1
    sched.slots[1] = seq
    sched.active_count += 1
    seq.tokens = seq.prompt + [94, 95]
    seq.generated = 2
    sched.preempt(seq)
    return first, fields()


def test_preempt_surgery_equals_jax():
    js, ts = _schedulers()
    want = _surgery(js, JSequence, JBackendInput, JSeqState)
    got = _surgery(ts, Sequence, BackendInput, SeqState)
    assert got == want
    first, second = got
    assert first["prompt"] == list(range(1, 11)) + [91, 92, 93]
    assert first["resume_offset"] == 3 and first["max_tokens"] == 17
    assert first["min_tokens"] == 5 and first["waiting"] == ["b", "a"]
    assert second["resume_offset"] == 5 and second["max_tokens"] == 15


# ----------------------------------------------------- packed admission
def _mk_packed(sched_pair, rid, prompt_len, max_tokens, priority=1):
    out = []
    for cls, bcls in ((JSequence, JBackendInput), (Sequence, BackendInput)):
        s = _mk(cls, bcls, range(1, prompt_len + 1), rid, priority=priority,
                submitted_at=time.time())
        s.stop.stop_conditions.max_tokens = max_tokens
        out.append(s)
    for sched, s in zip(sched_pair, out):
        sched.submit(s)
    return out


@pytest.mark.parametrize(
    "num_pages,kv_packing,queue,first",
    [
        # An oversize head defers behind a smaller fit.
        (8, True, [("big", 24, 400, 1), ("small", 8, 8, 1)], "small"),
        # First-fit without packing admits the head.
        (8, False, [("big", 24, 400, 1), ("small", 8, 8, 1)], "big"),
        # A lower class never bypasses a higher-priority head.
        (8, True, [("big", 24, 400, 2), ("small", 8, 8, 0)], "big"),
        # FIFO when everything fits.
        (64, True, [("a", 8, 8, 1), ("b", 8, 8, 1)], "a"),
        # Three deep: the mid-size one fits after the small one.
        (10, True, [("big", 40, 400, 1), ("mid", 16, 20, 1), ("small", 8, 8, 1)], "mid"),
    ],
)
def test_packed_admission_equals_jax(num_pages, kv_packing, queue, first):
    pair = _schedulers(num_pages=num_pages, kv_packing=kv_packing)
    seqs = {rid: _mk_packed(pair, rid, n, mt, pr) for rid, n, mt, pr in queue}
    orders = []
    for sched in pair:
        order = []
        while (s := sched.admit_next()) is not None:
            order.append(s.request_id)
        orders.append(order)
    assert orders[1] == orders[0] and orders[1][0] == first, orders
    for rid, (js, ts) in seqs.items():
        assert js.packing_defers == ts.packing_defers, rid
        assert js.state.value == ts.state.value, rid


def test_forecast_credits_the_resident_prefix():
    _, sched = _schedulers(num_pages=8)
    first = _mk(Sequence, BackendInput, range(1, 3 * PS + 1), "first")
    first.stop.stop_conditions.max_tokens = 2
    sched.submit(first)
    assert sched.admit_next() is first
    first.tokens = list(first.prompt) + [7]
    sched.register_full_pages(first)
    again = _mk(Sequence, BackendInput, range(1, 3 * PS + 1), "again")
    again.stop.stop_conditions.max_tokens = 2
    fc = sched.forecast.forecast(again)
    assert fc.resident_pages == 3 and fc.fresh_pages == fc.total_pages - 3
