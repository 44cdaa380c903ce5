"""Request deadlines in the port against the JAX package, on the CPU.

- ``AsyncEngineContext``'s deadline (``start_timeout``,
  ``time_remaining``, ``deadline_expired``, ``check_deadline``) behaves
  as the JAX one: the same error type and message, the same stage on
  ``dynamo_deadline_exceeded_total``.
- ``Scheduler.reap_waiting`` and admission drop cancelled and expired
  waiting sequences as the JAX scheduler does, given the same queue.
- ``TorchEngine`` and ``TPUEngine`` (float32 TINY, the same weights)
  given the same burst, one request of which expires while it waits,
  reap it at ``engine_admission`` and give the other its same tokens.
- A bound row whose deadline passes mid-decode finishes with ``error``
  (``decode`` stage), chained or not; its tokens are the start of the
  same request's tokens without a deadline; the chain breaks at the
  deadline; the page audit is clean.
"""

import asyncio
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.engine.kv_manager import KvPageManager as JKvPageManager
from dynamo_exp_tpu.engine.scheduler import Scheduler as JScheduler
from dynamo_exp_tpu.engine.scheduler import Sequence as JSequence
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu.protocols.common import BackendInput as JBackendInput
from dynamo_exp_tpu.runtime.engine import AsyncEngineContext as JContext
from dynamo_exp_tpu.runtime.engine import DeadlineExceededError as JDeadlineExceededError
from dynamo_exp_tpu.telemetry import get_telemetry as jget_telemetry
from dynamo_exp_tpu_torch.engine import EngineConfig, KvPageManager, Scheduler, TorchEngine
from dynamo_exp_tpu_torch.engine.scheduler import Sequence
from dynamo_exp_tpu_torch.models import TINY, params_from_jax
from dynamo_exp_tpu_torch.protocols.common import BackendInput, FinishReason
from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext, DeadlineExceededError
from dynamo_exp_tpu_torch.telemetry import get_telemetry

CFG = replace(JTINY, dtype="float32")
ENGINE_KW = dict(max_decode_slots=2, page_size=8, num_pages=64, max_model_len=128,
                 prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[])
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11]
P3 = [12, 60, 3, 3, 90, 21]


def deadline_counts(text: str) -> dict:
    return {
        s.labels["stage"]: s.value
        for fam in text_string_to_metric_families(text)
        for s in fam.samples if s.name == "dynamo_deadline_exceeded_total"
    }


class Counts:
    """``dynamo_deadline_exceeded_total`` by stage, moved since made, on
    both packages' registries."""

    def __init__(self):
        self.j0 = deadline_counts(jget_telemetry().render().decode())
        self.t0 = deadline_counts(get_telemetry().render().decode())

    @staticmethod
    def _delta(now, then):
        return {k: v - then.get(k, 0.0) for k, v in now.items() if v != then.get(k, 0.0)}

    def jax(self):
        return self._delta(deadline_counts(jget_telemetry().render().decode()), self.j0)

    def port(self):
        return self._delta(deadline_counts(get_telemetry().render().decode()), self.t0)


# ---------------------------------------------------------------- context
def test_context_deadline_matches_jax():
    counts = Counts()
    for ctx_t in (AsyncEngineContext, JContext):
        ctx = ctx_t("r1")
        assert ctx.deadline is None and ctx.time_remaining() is None
        ctx.start_timeout(None)
        assert ctx.deadline is None and not ctx.deadline_expired
        ctx.check_deadline("router")  # no deadline: no-op
        ctx.start_timeout(30)
        assert 29 < ctx.time_remaining() <= 30 and not ctx.deadline_expired
        ctx.check_deadline("router")
        ctx.deadline = time.time() - 1
        assert ctx.deadline_expired and ctx.time_remaining() < 0
    for ctx_t, err in ((AsyncEngineContext, DeadlineExceededError),
                       (JContext, JDeadlineExceededError)):
        ctx = ctx_t("r2", deadline=time.time() - 0.01)
        with pytest.raises(err, match=r"request r2 deadline exceeded at stage 'prefill_queue'"):
            ctx.check_deadline("prefill_queue")
        assert issubclass(err, TimeoutError)
    assert counts.port() == counts.jax() == {"prefill_queue": 1.0}


# -------------------------------------------------------------- scheduler
def _queue(seq_t, binput_t, now, emitted):
    """Sequences: alive, cancelled, expired, alive with a far deadline,
    expired, alive (in that order)."""
    plan = [("a", False, 0.0), ("b", True, 0.0), ("c", False, now - 1), ("d", False, now + 60),
            ("e", False, now - 0.5), ("f", False, 0.0)]
    out = []
    for rid, cancelled, deadline in plan:
        out.append(seq_t(
            request_id=rid, prompt=[1, 2, 3], stop=binput_t(token_ids=[1, 2, 3]),
            emit=lambda toks, reason, lp=None, rid=rid: emitted.append((rid, reason.value)),
            is_cancelled=lambda c=cancelled: c, deadline_unix=deadline,
        ))
    return out


def test_reap_and_admission_drop_what_the_jax_scheduler_drops():
    common = dict(max_decode_slots=2, page_size=8, max_model_len=64)
    now = time.time()
    counts = Counts()
    results = []
    for sched, seq_t, binput_t in (
        (JScheduler(JEngineConfig(model=JTINY, **common), JKvPageManager(32, 8)), JSequence,
         JBackendInput),
        (Scheduler(EngineConfig(model=TINY, **common), KvPageManager(32, 8)), Sequence,
         BackendInput),
    ):
        emitted = []
        for s in _queue(seq_t, binput_t, now, emitted):
            sched.submit(s)
        reaped = sched.reap_waiting(now=now)
        left = [s.request_id for s in sched.waiting]
        # Admission: the head expires after the reap and is dropped there.
        sched.waiting[0].deadline_unix = time.time() - 0.001
        admitted = [sched.admit_next(), sched.admit_next()]
        results.append((reaped, left, [s and s.request_id for s in admitted], emitted,
                        [s.state.value for s in sched.slots if s is not None]))
    assert results[1] == results[0]
    assert results[0][:3] == (3, ["a", "d", "f"], ["d", "f"])
    assert counts.port() == counts.jax() == {"engine_admission": 3.0}


# ----------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), CFG))


def _port_engine(np_params, **kw):
    return TorchEngine(EngineConfig(model=CFG, **{**ENGINE_KW, **kw}),
                       model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")


async def _collect(stream):
    toks, finish = [], None
    async for item in stream:
        toks += item.get("token_ids", [])
        finish = item.get("finish_reason", finish)
    return toks, finish


def _request(prompt, n):
    return {"token_ids": list(prompt), "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


async def _expiring_burst(eng, ctx_t):
    """P1 and P2 fill both slots; P3 waits behind them with a deadline
    that passes before the loop's first iteration. All queued before
    the loop starts (``generate`` starts no loop while ``_running`` is
    set)."""
    eng._running = True
    ctxs = [ctx_t("p1"), ctx_t("p2"), ctx_t("p3", deadline=time.time() + 0.05)]
    jobs = [asyncio.ensure_future(_collect(await eng.generate(_request(p, 12), c)))
            for p, c in zip((P1, P2, P3), ctxs)]
    await asyncio.sleep(0.1)
    eng._running = False
    eng.start()
    return await asyncio.gather(*jobs)


def test_waiting_request_expires_as_in_tpu_engine(np_params):
    counts = Counts()
    jeng = TPUEngine(JEngineConfig(model=CFG, attention_impl="xla", **ENGINE_KW),
                     params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh())
    try:
        want = asyncio.run(asyncio.wait_for(_expiring_burst(jeng, JContext), 300))
    finally:
        jeng.stop()
    eng = _port_engine(np_params)
    try:
        got = asyncio.run(asyncio.wait_for(_expiring_burst(eng, AsyncEngineContext), 300))
    finally:
        eng.stop()
    assert got == want
    assert [f for _, f in got] == ["length", "length", "error"] and got[2][0] == []
    assert counts.port() == counts.jax() == {"engine_admission": 1.0}
    kinds = [e["kind"] for e in eng.flight.snapshot()]
    assert kinds.count("admit") == 2 and kinds.count("finish") == 2


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "unchained"])
def test_bound_row_finishes_at_its_deadline(np_params, chained):
    """Each window's consume is slowed to 20 ms, so a 60-token request
    with a 0.25 s deadline expires mid-decode. The deadline is armed
    inside the first slowed consume, once the row is bound and has
    tokens, so however long prefill takes on the host, the expiry falls
    in decode; the wall is timed from that arming."""
    n = 60

    def slowed(eng, arm=None):
        consume = eng._consume_windowed

        def slow(pending):
            time.sleep(0.02)
            out = consume(pending)
            if arm is not None:
                arm(eng)
            return out

        eng._consume_windowed = slow
        return eng

    def arming(ctx, deadline_s, armed):
        # Runs on the loop thread, the only writer of a bound row.
        def arm(eng):
            if armed:
                return
            ctx.start_timeout(deadline_s)
            for s in eng.sched.slots:
                if s is not None and s.request_id == ctx.id:
                    s.deadline_unix = ctx.deadline
            armed.append(time.time())

        return arm

    async def run(eng, ctx, armed):
        stream = eng.submit(_request(P1, n), ctx)
        eng.start()
        toks, finish = await _collect(stream)
        return toks, finish, time.time() - (armed[0] if armed else 0.0)

    want_eng = slowed(_port_engine(np_params, chained_decode=chained))
    try:
        want, wfinish, _ = asyncio.run(
            asyncio.wait_for(run(want_eng, AsyncEngineContext("row"), []), 300))
    finally:
        want_eng.stop()
    assert wfinish == "length" and len(want) == n
    counts = Counts()
    ctx, armed = AsyncEngineContext("row"), []
    eng = slowed(_port_engine(np_params, chained_decode=chained), arming(ctx, 0.25, armed))
    try:
        got, finish, wall = asyncio.run(asyncio.wait_for(run(eng, ctx, armed), 300))
        with eng.hold_admission():
            audit = eng.kv_audit()
    finally:
        eng.stop()
    assert finish == "error" and 0 < len(got) < n and got == want[: len(got)]
    assert wall < 2.0
    assert counts.port() == {"decode": 1.0}
    assert audit["ok"], audit
    events = eng.flight.snapshot()
    finish_at = next(i for i, e in enumerate(events) if e["kind"] == "finish")
    assert events[finish_at]["reason"] == "error"
    # Nothing was dispatched for the row after its finish, and a chained
    # run broke its chain to enforce the deadline.
    assert not any(e["kind"] == "dispatch" for e in events[finish_at:])
    assert ("chain_break" in [e["kind"] for e in events]) == chained
    assert (eng.metrics()["dispatches"]["chained"] > 0) == chained
