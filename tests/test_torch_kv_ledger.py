"""The port's KV conservation auditor against the JAX package's, mirroring
``tests/test_kv_ledger.py``: the page ledger conserves across
preemption, prefix sharing with seeded sampling, speculation and both
lease exits; an injected double release is detected within one loop
cycle, counts once per episode and dumps a flight snapshot that
``llmctl audit`` renders (the port's CLI, and the JAX CLI on the same
dump); an orphaned lease and a leaking sequence are named; the unit
ledger answers as the JAX page manager's; and the in-loop check adds
zero host syncs (the same burst makes the same tensor-to-host reads
with the check on and off). Tolerance: none; counts compare exactly.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import replace

import pytest
import torch

from dynamo_exp_tpu.engine.kv_manager import KvPageManager as JKvPageManager
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.engine.kv_manager import KvPageManager
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.protocols.common import BackendInput, SamplingOptions

SEEDS = (7, 21, 1337)
PS = 4


def _engine(num_pages=8, grace=0.05, **kw):
    cfg = EngineConfig(
        model=replace(TINY, dtype="float32"), max_decode_slots=4, page_size=PS,
        num_pages=num_pages, max_model_len=128, eos_token_ids=[], kv_dtype="float32",
        preempt_stall_grace_s=grace, kv_lease_ttl_s=kw.pop("kv_lease_ttl_s", 0.2), **kw,
    )
    return TorchEngine(cfg, device="cpu")


async def _gen(eng, prompt, max_tokens=16, **sampling):
    b = BackendInput(token_ids=list(prompt))
    b.stop_conditions.max_tokens = max_tokens
    b.stop_conditions.ignore_eos = True
    if sampling:
        b.sampling_options = SamplingOptions(**sampling)
    tokens = []
    async for item in await eng.generate(b.to_dict()):
        tokens.extend(item.get("token_ids", []))
    return tokens


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


def _conserved(eng):
    assert eng.kv.ledger_check() == []
    audit = eng.kv_audit()
    assert audit["ok"], audit["violations"]
    assert eng.kv_ledger_violations == 0
    return audit


def _wait(pred, timeout=3.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return pred()


# ------------------------------------------------- conserved state machines
@pytest.mark.parametrize("seed", SEEDS)
def test_preemption_pressure_conserves(seed):
    eng = _engine(num_pages=8)
    eng.start()
    try:
        prompts = [[3 + seed % 50 + i, 9, 17, 23, 4, 31, 8, 2] for i in range(3)]

        async def burst():
            await asyncio.gather(*[_gen(eng, p, 24) for p in prompts])

        _run(burst())
        _conserved(eng)
    finally:
        eng.stop()
    assert eng.kv.ledger_check() == []


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_sharing_and_seeded_sampling_conserve(seed):
    eng = _engine(num_pages=24)
    eng.start()
    try:
        shared = [11, 7, 5, 3, 2, 13, 17, 19]

        async def burst():
            await asyncio.gather(*[_gen(eng, shared + [40 + i], 12, seed=seed + i,
                                        temperature=0.8) for i in range(3)])

        _run(burst())
        _conserved(eng)
    finally:
        eng.stop()


def test_spec_on_decode_conserves():
    eng = _engine(num_pages=24, spec_mode="ngram")
    eng.start()
    try:
        _run(_gen(eng, [5, 6, 7, 5, 6, 7, 5, 6], 20))
        _conserved(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("confirm", [True, False])
def test_disagg_lease_confirm_and_reap_conserve(confirm):
    eng = _engine(num_pages=16, kv_lease_ttl_s=0.15)
    eng.start()
    try:
        b = BackendInput(token_ids=list(range(3, 13)))
        _first, pages, lease_id = _run(eng.prefill_extract(b.to_dict()))
        assert pages and lease_id and eng.kv.active_leases == 1
        if confirm:
            eng.confirm_kv_lease(lease_id)
        assert _wait(lambda: eng.kv.active_leases == 0)
        if not confirm:
            assert _wait(lambda: eng.kv.lease_reclaimed_pages > 0)
        _conserved(eng)
    finally:
        eng.stop()


# ------------------------------------------------------- injected leaks
def test_injected_double_release_detected_within_one_cycle():
    eng = _engine(num_pages=8)
    eng.start()
    try:
        _run(_gen(eng, [3, 1, 4, 1, 5, 9, 2, 6], 8))
        assert eng.kv_ledger_violations == 0
        free_pages = list(eng.kv._free)[:2]
        assert free_pages
        eng.kv.release_sequence(free_pages)  # the double release
        assert _wait(lambda: eng.kv_ledger_violations > 0)
        assert eng.kv.ledger_check() != []
        audit = eng.kv_audit()
        assert not audit["ok"]
        assert {v["kind"] for v in audit["violations"]} & {"double_release", "counter"}
        assert eng.metrics()["kv_ledger_violations"] == eng.kv_ledger_violations
    finally:
        eng.stop()


def test_persistent_violation_does_not_melt_the_counter():
    from dynamo_exp_tpu_torch.engine.engine import LEDGER_VIOLATIONS

    eng = _engine(num_pages=16)
    before = len(LEDGER_VIOLATIONS)
    eng.start()
    try:
        _run(_gen(eng, [3, 1, 4, 1, 5, 9, 2, 6], 8))
        eng.kv.release_sequence(list(eng.kv._free)[:1])
        assert _wait(lambda: eng.kv_ledger_violations > 0)
        first = eng.kv_ledger_violations
        _run(_gen(eng, [9, 8, 7, 6, 5, 4, 3, 2], 8))
        time.sleep(0.3)
        assert eng.kv_ledger_violations <= first + 1
        assert len(LEDGER_VIOLATIONS) - before < 50
    finally:
        eng.stop()


def test_orphaned_lease_leak_is_named():
    eng = _engine(num_pages=16, kv_lease_ttl_s=60.0)
    eng.start()
    try:
        b = BackendInput(token_ids=list(range(3, 13)))
        _ft, _pages, lease_id = _run(eng.prefill_extract(b.to_dict()))
        lease = eng.kv._leases[lease_id]
        eng.kv.release_sequence(lease.page_ids)  # steal the lease's pins
        assert _wait(lambda: eng.kv_ledger_violations > 0)
        with eng.hold_admission():
            audit = eng.kv_audit()
        assert not audit["ok"]
        named = [v for v in audit["violations"] if f"lease:{lease_id}" in v["holders"]]
        assert named and named[0]["kind"] == "lost_ref"
    finally:
        eng.stop()


def test_violation_dumps_flight_snapshot_llmctl_audit_renders(tmp_path, capsys):
    from dynamo_exp_tpu.llmctl import main as jllmctl
    from dynamo_exp_tpu_torch.llmctl import main as llmctl

    dump = str(tmp_path / "flight.jsonl")
    eng = _engine(num_pages=8, flight_dump_path=dump)
    eng.start()
    try:
        _run(_gen(eng, [3, 1, 4, 1, 5, 9, 2, 6], 8))
        eng.kv.release_sequence(list(eng.kv._free)[:1])
        assert _wait(lambda: os.path.exists(dump))
    finally:
        eng.stop()
    assert llmctl(["audit", dump]) == 1
    out = capsys.readouterr().out
    assert "VIOLATION" in out and "kv audit" in out
    assert jllmctl(["audit", dump]) == 1
    assert capsys.readouterr().out == out
    from dynamo_exp_tpu_torch.telemetry import load_dumps

    kinds = [e.get("kind") for d in load_dumps(dump) for e in d["events"]]
    assert "ledger_violation" in kinds

    dump2 = str(tmp_path / "flight_ok.jsonl")
    eng2 = _engine(num_pages=8, flight_dump_path=dump2)
    eng2.start()
    try:
        _run(_gen(eng2, [3, 1, 4, 1, 5, 9, 2, 6], 8))
        eng2._dump_flight("test")
    finally:
        eng2.stop()
    assert llmctl(["audit", dump2]) == 0
    assert "CONSERVED" in capsys.readouterr().out


# ----------------------------------------------------- unit-level ledger
def test_ledger_check_is_pure_counter_arithmetic():
    """The same attach / share / lease / release / confirm sequence on
    both page managers: both ledgers stay empty, and a forced drift
    breaks both audits."""
    outs = []
    for kv, kw in ((KvPageManager(num_pages=8, page_size=4), {}),
                   (JKvPageManager(num_pages=8, page_size=4), {"request_id": "a"})):
        a = kv.allocate_sequence(list(range(10)), max_pages=8, **kw)
        b = kv.allocate_sequence(list(range(10)), max_pages=8, **kw)
        steps = [kv.ledger_check()]
        lease = kv.grant_lease(a.page_ids[:2], ttl_s=60)
        steps.append(kv.ledger_check())
        kv.release_sequence(a.page_ids)
        kv.release_sequence(b.page_ids)
        steps.append(kv.ledger_check())
        kv.confirm_lease(lease)
        steps.append(kv.ledger_check())
        audit = kv.audit()
        outs.append((steps, audit["ok"], audit["counts"]))
    assert outs[0][:2] == outs[1][:2] == ([[], [], [], []], True)
    kv2 = KvPageManager(num_pages=4, page_size=4)
    a = kv2.allocate_sequence(list(range(4)), max_pages=4)
    kv2._records[a.page_ids[0]].ref_count = 0
    assert kv2.audit({"seq:x": a.page_ids})["ok"] is False


def test_audit_names_the_leaking_sequence():
    kv = KvPageManager(num_pages=8, page_size=4)
    alloc = kv.allocate_sequence(list(range(8)), max_pages=8)
    kv.release_sequence(alloc.page_ids)
    report = kv.audit({"seq:r1": alloc.page_ids})
    assert not report["ok"]
    assert any("seq:r1" in v["holders"] and v["kind"] == "lost_ref"
               for v in report["violations"])


# ------------------------------------------------------- sync-spy proof
def test_ledger_check_adds_zero_host_syncs(monkeypatch):
    """The same burst with the check on and off: equal steps and an equal
    count of tensor-to-host reads (``item`` / ``tolist`` / ``cpu`` /
    ``numpy``), the points where the loop waits on the device."""

    def run_counted(check_on: bool) -> tuple[int, int, int]:
        eng = _engine(num_pages=16, kv_ledger_check=check_on)
        count = [0]
        for name in ("item", "tolist", "cpu", "numpy"):
            real = getattr(torch.Tensor, name)

            def spy(self, *a, _real=real, **k):
                count[0] += 1
                return _real(self, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, spy)
        eng.start()
        try:
            _run(_gen(eng, list(range(40, 56)), 12))
        finally:
            eng.stop()
            monkeypatch.undo()
        return count[0], eng.steps, eng.kv_ledger_violations

    on, off = run_counted(True), run_counted(False)
    assert on == off, (on, off)
    assert on[0] > 0 and on[2] == 0
