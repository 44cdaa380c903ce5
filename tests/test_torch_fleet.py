"""The port's fleet plane (``dynamo_exp_tpu_torch/telemetry/fleet.py``)
against the JAX package's, on the CPU.

- ``TransferLedger``: for the same observations, the same link stats,
  EWMA bandwidths, estimates (the cold-start prior included, and its
  ``DYN_KV_DEFAULT_BW_BPS`` override) and ``dynamo_kv_link_*`` series;
  floats compared exactly.
- ``parse_prometheus_text`` (the lenient parser alone) on the port's
  own ``/metrics`` text gives what the JAX function gives (through
  ``prometheus_client``'s parser) on the same text; both skip the same
  garbage lines.
- ``FleetView`` / ``FleetAggregator`` / ``render_top``: the same rollup,
  missing members and dashboard text for the same snapshots, dead and
  garbage members included.
"""

import asyncio

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu.telemetry import fingerprint as jfingerprint
from dynamo_exp_tpu.telemetry import fleet as jfleet
from dynamo_exp_tpu_torch.telemetry import fingerprint, fleet
from dynamo_exp_tpu_torch.telemetry.spans import Telemetry

NAMES = st.sampled_from(["a", "b", "host:1", "host:2"])
OBS = st.lists(st.tuples(NAMES, NAMES, st.integers(0, 1 << 30),
                         st.sampled_from([0.0, 1e-4, 0.003, 0.5, 2.0])), max_size=25)


@settings(max_examples=60, deadline=None)
@given(OBS, st.integers(0, 1 << 32))
def test_transfer_ledger_matches_jax(obs, n_bytes):
    t, j = fleet.TransferLedger(), jfleet.TransferLedger()
    for src, dst, b, d in obs:
        t.record(src, dst, b, d)
        j.record(src, dst, b, d)
        assert t.snapshot() == j.snapshot()
    for src in ("a", "b", "host:1", "nowhere"):
        for dst in ("a", "host:2", "nowhere"):
            assert t.bandwidth_bps(src, dst) == j.bandwidth_bps(src, dst)
            assert t.estimate_transfer_s(src, dst, n_bytes) == j.estimate_transfer_s(
                src, dst, n_bytes)


def test_cold_start_prior_and_its_override(monkeypatch):
    assert fleet.TransferLedger().estimate_transfer_s("x", "y", 100e6) == 1.0
    monkeypatch.setenv("DYN_KV_DEFAULT_BW_BPS", "2e9")
    t, j = fleet.TransferLedger(), jfleet.TransferLedger()
    assert t.default_bandwidth_bps == j.default_bandwidth_bps == 2e9
    monkeypatch.setenv("DYN_KV_DEFAULT_BW_BPS", "garbage")
    assert fleet.TransferLedger().default_bandwidth_bps == fleet.DEFAULT_LINK_BANDWIDTH_BPS
    assert fleet.TransferLedger(0).estimate_transfer_s("x", "y", 10) is None
    assert jfleet.TransferLedger(0).estimate_transfer_s("x", "y", 10) is None
    assert fingerprint.DRIFT_ALERT_THRESHOLD == jfingerprint.DRIFT_ALERT_THRESHOLD


def test_ledger_feeds_the_link_families():
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    before = fleet.parse_prometheus_text(tel.render().decode())
    led = fleet.TransferLedger()
    led.record("src-x", "dst-y", 1000, 0.5)
    led.record("src-x", "dst-y", 3000, 0.5)
    after = fleet.parse_prometheus_text(tel.render().decode())

    def moved(name):
        return after.get(name, 0.0) - before.get(name, 0.0)

    assert moved("dynamo_kv_link_bytes_total") == 4000
    assert moved("dynamo_kv_link_transfers_total") == 2
    text = tel.render().decode()
    line = next(ln for ln in text.splitlines() if ln.startswith(
        'dynamo_kv_link_bandwidth_bytes_per_s{dst="dst-y",src="src-x"}'))
    assert float(line.split()[-1]) == led.bandwidth_bps("src-x", "dst-y") == 0.7 * 2000 + 0.3 * 6000


def _fed_telemetry(seed: int) -> Telemetry:
    """A port telemetry hub with every family fed seeded values."""
    from dynamo_exp_tpu_torch.telemetry import prom

    tel = Telemetry()
    rs = np.random.RandomState(seed)
    for attr, m in vars(tel).items():
        if attr == "engine_gauges":
            for g in m.values():
                g.set(float(rs.rand()))
            continue
        if not isinstance(m, (prom.Counter, prom.Gauge, prom.Histogram)):
            continue
        for _ in range(2):
            values = [rs.choice(['v0', 'a"b', "c}d", "e\\f"]) for _ in m.labelnames]
            x = float(rs.choice([0.0003, 0.02, 3.0, 70.0]))
            child = m.labels(*values) if m.labelnames else m
            method = {prom.Counter: "inc", prom.Gauge: "set", prom.Histogram: "observe"}
            getattr(child, method[type(m)])(x)
    tel.set_build_info(manifest_hash="abc", jax_version="torch-x", prefix_sharing=True,
                       spec="off")
    return tel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_prometheus_text_of_the_port_metrics_matches_jax(seed):
    text = _fed_telemetry(seed).render().decode()
    got = fleet.parse_prometheus_text(text)
    assert got == jfleet.parse_prometheus_text(text)  # prometheus_client's parser
    assert got == jfleet._parse_prometheus_lenient(text)
    assert got["build_info"]["manifest_hash"] == "abc"
    assert "dynamo_kv_transfers_total" in text and "dynamo_reclaim_triage_seconds_sum" in got
    # Garbage lines are skipped alike.
    bad = text + "\nnot a metric line\n}{ 3\nx_total NaNish\n"
    assert fleet.parse_prometheus_text(bad) == jfleet.parse_prometheus_text(bad)


def test_exposition_timestamps_and_braces():
    text = ('a_total{x="1}"} 3 1700000000000\n'
            'dynamo_build_info{manifest_hash="m",spec="off"} 1\n'
            'b 2.5\n')
    assert fleet.parse_prometheus_text(text) == jfleet.parse_prometheus_text(text) == {
        "a_total": 3.0, "b": 2.5, "build_info": {"manifest_hash": "m", "spec": "off"}}


def _snapshots(rs) -> dict:
    out = {}
    for i in range(int(rs.randint(1, 6))):
        kind = rs.randint(5)
        name = f"worker/{i}"
        if kind == 0:
            out[name] = RuntimeError("connection refused")
        elif kind == 1:
            out[name] = b"\x00garbage"
        else:
            out[name] = {
                "num_requests_running": int(rs.randint(8)),
                "num_requests_waiting": int(rs.randint(8)),
                "gpu_cache_usage_perc": float(rs.rand()),
                "request_active_slots": int(rs.randint(8)),
                "request_total_slots": 8,
                "preemptions": int(rs.randint(3)),
                "kv_host_pages": int(rs.randint(100)),
                "workload_drift_score": float(rs.rand()),
                "draining": bool(rs.randint(2)),
                "build_info": {"manifest_hash": f"h{rs.randint(2)}", "spec": "off"},
                "kv_links": [{"src": name, "dst": "worker/0", "transfers": int(rs.randint(5)),
                              "bytes": int(rs.randint(1 << 20)),
                              "duration_s": float(rs.rand())}],
            }
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fleet_view_rollup_and_dashboard_match_jax(seed):
    snaps = _snapshots(np.random.RandomState(seed))
    t, j = fleet.FleetView.from_snapshots(snaps), jfleet.FleetView.from_snapshots(snaps)
    assert t.missing == j.missing
    assert t.rollup() == j.rollup()
    assert fleet.render_top(t) == jfleet.render_top(j)


def test_aggregator_tags_dead_and_wedged_members():
    async def wedged():
        await asyncio.sleep(10)

    def dead():
        raise ConnectionError("gone")

    async def alive():
        return {"num_requests_running": 2}

    async def scrape(mod):
        agg = mod.FleetAggregator({"a": alive, "b": dead, "c": wedged,
                                   "d": lambda: {"num_requests_waiting": 1}}, timeout_s=0.05)
        return await agg.scrape()

    t = asyncio.run(scrape(fleet))
    j = asyncio.run(scrape(jfleet))
    assert sorted(t.missing) == sorted(j.missing) == ["b", "c"]
    assert t.rollup() == j.rollup()
