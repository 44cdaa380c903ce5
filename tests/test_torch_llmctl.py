"""The port's ``llmctl`` against the JAX package's.

- Offline, byte for byte: ``trace`` (the listing, a timeline, ``--why``),
  ``slow`` (``-n``, ``--by``, ``--why``), ``fingerprint`` (text,
  ``--json``, ``--ref``, ``--out``, ``--replay-out``), ``flight``
  (``--list``, a block, ``--why``), ``audit`` (a dump of the port's
  engine, and a dump naming a leaked page) and ``bench compare`` over
  the repository's ``BENCH_r01..r05.json`` give the JAX CLI's stdout and
  exit code.
- Live, against the port's coordinator in this process: ``http add |
  list | remove``, ``disagg set | get``, ``drain`` and ``reclaim`` (the
  served instance's metadata flips), with the same output as the JAX
  CLI on the same control plane; ``top --json`` and live ``slow`` over a
  stand-in runtime print what the JAX CLI prints.
- ``lint`` runs dynlint over the port's tree as the JAX CLI's does over
  its own: no plane of the JAX CLI is refused.
"""

import asyncio
import contextlib
import io
import json
import os
from dataclasses import replace

import pytest

from dynamo_exp_tpu import llmctl as jctl
from dynamo_exp_tpu_torch import llmctl as tctl
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "anatomy_trace.jsonl")
BENCH = [os.path.join(ROOT, f"BENCH_r0{i}.json") for i in range(1, 6)]


async def acli(mod, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = await mod.run(mod.build_parser().parse_args(argv))
    return rc, out.getvalue(), err.getvalue()


def cli(mod, argv) -> tuple[int, str, str]:
    return asyncio.run(acli(mod, argv))


def same(argv) -> tuple[int, str]:
    """Run both CLIs; their exit codes and stdout must be equal."""
    want, got = cli(jctl, argv), cli(tctl, argv)
    assert got[:2] == want[:2], (argv, got, want)
    return got[:2]


OFFLINE = [
    ["trace", "--trace-file", FIXTURE],
    ["trace", "aaaa1111", "--trace-file", FIXTURE],
    ["trace", "aaaa1111", "--trace-file", FIXTURE, "--why"],
    ["trace", "req-fixture-2", "--trace-file", FIXTURE, "--why"],
    ["trace", "nope", "--trace-file", FIXTURE],
    ["slow", "--trace-file", FIXTURE],
    ["slow", "--trace-file", FIXTURE, "-n", "2"],
    ["slow", "--trace-file", FIXTURE, "--by", "ttft", "--why"],
    ["slow", "--trace-file", FIXTURE, "--by", "itl", "-n", "1", "--why"],
    ["fingerprint", FIXTURE],
    ["fingerprint", FIXTURE, "--json"],
    ["fingerprint", FIXTURE, "--kind", "spans"],
]


@pytest.mark.parametrize("argv", OFFLINE, ids=lambda a: "-".join(x for x in a if x != FIXTURE))
def test_offline_span_commands_print_what_jax_prints(argv):
    rc, out = same(argv)
    assert out or rc


BENCH_PAIRS = [(BENCH[i], BENCH[i + 1]) for i in range(4)] + [(BENCH[0], BENCH[4])]


@pytest.mark.parametrize("old,new", BENCH_PAIRS, ids=lambda p: os.path.basename(p))
def test_bench_compare_over_the_trajectory_prints_what_jax_prints(old, new):
    rc, out = same(["bench", "compare", old, new])
    assert out.startswith(f"bench compare: {old} -> {new}")
    same(["bench", "compare", old, new, "--threshold", "0.01"])


def test_bench_compare_judges_anatomy_fields_as_jax(tmp_path):
    old = tmp_path / "old.jsonl"
    new = tmp_path / "new.jsonl"
    old.write_text(json.dumps({"metric": "m", "unit": "tok/s", "value": 100.0, "ttft_p50_s": 1.0,
                               "anatomy": {"decode_compute": 1.0, "queue_wait": 0.1}}) + "\n")
    new.write_text(json.dumps({"metric": "m", "unit": "tok/s", "value": 80.0, "ttft_p50_s": 0.5,
                               "anatomy": {"decode_compute": 1.5, "queue_wait": 0.1}}) + "\n")
    rc, out = same(["bench", "compare", str(old), str(new)])
    assert rc == 1 and "REGRESSION: m anatomy.decode_compute" in out
    rc, out = same(["bench", "compare", str(new), str(old)])
    assert rc == 1 and "improvement" in out


def test_fingerprint_ref_out_and_replay_equal_jax(tmp_path):
    refs = {}
    for name, mod in (("jax", jctl), ("torch", tctl)):
        ref, replay = str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.trace.jsonl")
        rc, _, _ = cli(mod, ["fingerprint", FIXTURE, "--out", ref, "--replay-out", replay,
                             "--requests", "40", "--seed", "3"])
        assert rc == 0
        refs[name] = (open(ref).read(), open(replay).read())
    assert refs["torch"] == refs["jax"]
    ref = str(tmp_path / "jax.json")
    rc, out = same(["fingerprint", FIXTURE, "--ref", ref])
    assert rc == 0 and "drift vs" in out and "0.0000" in out
    for argv in (["fingerprint", ref], ["fingerprint", str(tmp_path / "jax.trace.jsonl")],
                 ["fingerprint", BENCH[0], "--kind", "bench"]):
        same(argv)


def _write_dump(path, events, snapshot=None):
    lines = [{"type": "flight_header", "reason": "test", "capacity": 16, "dumped_at": 0.0,
              "pid": 1}]
    lines += [{"type": "flight_event", **e} for e in events]
    if snapshot is not None:
        lines.append({"type": "flight_snapshot", "t": 2.5, **snapshot})
    with open(path, "a") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")


def test_flight_and_audit_of_a_synthetic_dump_print_what_jax_prints(tmp_path):
    dump = str(tmp_path / "flight.jsonl")
    _write_dump(dump, [
        {"seq": 0, "t": 1.0, "kind": "admit", "req": "rq", "slot": 0, "prompt": 16,
         "cached": 0, "priority": 1},
        {"seq": 1, "t": 1.4, "kind": "first_token", "req": "rq"},
        {"seq": 2, "t": 1.6, "kind": "stall_start", "req": "rq"},
        {"seq": 3, "t": 1.7, "kind": "stall_end", "req": "rq"},
        {"seq": 4, "t": 2.0, "kind": "finish", "req": "rq", "generated": 6, "pages": 2,
         "priority": 1},
    ], snapshot={"kv_audit": {
        "pool": 8, "leases": 1, "counts": {"free": 5, "active": 2, "leased": 1},
        "held_pages": 3, "ref_total": 3,
        "violations": [{"page": 4, "kind": "leak", "detail": "no holder",
                        "holders": ["lease:abc"]}]}})
    for argv in (["flight", dump], ["flight", dump, "--list"], ["flight", dump, "--why"],
                 ["flight", dump, "--why", "--req", "nope"], ["flight", dump, "--index", "3"],
                 ["audit", dump], ["audit", dump, "--index", "5"],
                 ["flight", str(tmp_path / "missing.jsonl")]):
        same(argv)
    rc, out = same(["flight", dump, "--why"])
    assert rc == 0 and "request rq" in out and "swap_stall" in out
    rc, out = same(["audit", dump])
    assert rc == 1 and "VIOLATION" in out


def test_flight_and_audit_of_the_port_engines_dump_print_what_jax_prints(tmp_path):
    dump = str(tmp_path / "engine_flight.jsonl")
    cfg = EngineConfig(model=replace(TINY, dtype="float32"), max_decode_slots=2, page_size=8,
                       num_pages=32, max_model_len=128, kv_dtype="float32", eos_token_ids=[],
                       flight_dump_path=dump)
    eng = TorchEngine(cfg, device="cpu")

    async def burst():
        async def one(i):
            stream = await eng.generate({"token_ids": list(range(3, 12 + i)),
                                         "stop_conditions": {"max_tokens": 5,
                                                             "ignore_eos": True}})
            async for _ in stream:
                pass

        await asyncio.gather(*(one(i) for i in range(3)))

    try:
        asyncio.run(asyncio.wait_for(burst(), 120))
        with eng.hold_admission():
            eng._dump_flight("test")
    finally:
        eng.stop()
    for argv in (["flight", dump], ["flight", dump, "--why"], ["audit", dump]):
        same(argv)
    rc, out = same(["flight", dump, "--why"])
    assert rc == 0 and out.count("request ") == 3
    rc, out = same(["audit", dump])
    assert rc == 0 and "CONSERVED" in out


@pytest.mark.parametrize("plane", ["lint"])
def test_unported_planes_exit_naming_their_roadmap_item(plane):
    """The last refused plane, ``lint``, now runs: dynlint over the
    port's tree exits 0 (every finding waived), as the JAX CLI's does
    over its own, and nothing is refused any more."""
    assert not hasattr(tctl, "NOT_PORTED")
    rc, out, err = cli(tctl, [plane, "--root", ROOT])
    assert (rc, out) == (0, "") and "0 unwaived finding(s)" in err
    assert cli(jctl, [plane, "--root", ROOT])[:2] == (0, "")


def test_live_commands_need_a_coordinator():
    for argv in (["http", "list"], ["drain", "3"], ["top", "--json"]):
        assert cli(tctl, argv)[:2] == cli(jctl, argv)[:2] == (2, "")


async def _wait(pred, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.05)


async def test_control_plane_commands_against_the_port_coordinator(tmp_path):
    from tests.fixtures import build_tiny_model_dir

    server = CoordinatorServer()
    await server.start()
    addr = server.address
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    try:
        async def handler(req, ctx):
            yield {"ok": True}

        ep = drt.namespace("dynamo").component("w").endpoint("gen")
        served = [await ep.serve_endpoint(handler) for _ in range(2)]
        base = ["--coordinator", addr]

        async def both(argv):
            want = await acli(jctl, base + argv)
            got = await acli(tctl, base + argv)
            assert got[:2] == want[:2], (argv, got, want)
            return got

        rc, out, _ = await acli(tctl, base + ["http", "add", "chat-model", "foo/v1", "w.gen"])
        assert rc == 0 and out == "added chat model foo/v1 -> dyn://dynamo.w.gen\n"
        model_dir = build_tiny_model_dir(str(tmp_path / "m"))
        rc, out, _ = await acli(tctl, base + ["http", "add", "model", "bar", "ns.w.gen",
                                              "--model-path", model_dir])
        assert rc == 0
        assert await drt.object_store.get("mdc", "bar") is not None
        for argv in (["http", "list"], ["http", "list", "--json"], ["http", "list", "chat-model"]):
            rc, out, _ = await both(argv)
            assert rc == 0 and "foo/v1" in out
        rc, out, _ = await acli(tctl, base + ["http", "remove", "chat-model", "foo/v1"])
        assert rc == 0 and out == "removed 1 registration(s) for foo/v1\n"
        rc, _, err = await acli(tctl, base + ["http", "remove", "chat-model", "foo/v1"])
        assert rc == 1 and "no chat-model registration" in err
        await both(["http", "list"])

        await both(["disagg", "set", "llama", "--max-local-prefill-length", "512"])
        rc, out, _ = await both(["disagg", "get", "llama"])
        assert json.loads(out)["max_local_prefill_length"] == 512

        rc, _, err = await acli(tctl, base + ["drain", "999999"])
        assert rc == 1 and "is not live" in err
        victim, other = served
        rc, out, _ = await acli(tctl, base + ["drain", str(other.info.instance_id)])
        assert rc == 0 and out.startswith(f"drain requested for instance {other.info.instance_id}")
        rc, out, _ = await acli(tctl, base + ["reclaim", str(victim.info.instance_id),
                                              "--grace-s", "7"])
        assert rc == 0 and "(grace 7s)" in out
        await _wait(lambda: victim.info.metadata.get("reclaiming")
                    and other.info.metadata.get("draining"))
        rc, out, _ = await acli(tctl, base + ["top", "--json"])
        doc = json.loads(out)
        assert rc == 0 and sorted(doc["instances"]) == sorted(
            f"w/{s.info.instance_id}" for s in served)
    finally:
        await drt.close()
        await server.close()


class _Addr:
    component = "TorchWorker"


class _Info:
    def __init__(self, iid):
        self.address = _Addr()
        self.instance_id = iid
        self.metadata = {}


class _FakeDrt:
    """A stand-in runtime: two instances, one of them dead."""

    class discovery:
        @staticmethod
        async def list_instances(_prefix):
            return [_Info(1), _Info(2)]

    class request_plane:
        @staticmethod
        async def scrape_stats(info):
            if info.instance_id == 2:
                raise ConnectionError("gone")
            slow = {"request_id": "rq-1", "components": {"queue_wait": 0.5,
                                                         "decode_compute": 1.5},
                    "edge_latency_s": 2.0, "ttft_s": 0.6, "generated_tokens": 9}
            return {"num_requests_running": 2, "workload_drift_score": 0.31,
                    "anatomy_slow": [slow]}


@pytest.mark.parametrize("argv", [["top", "--json"], ["top", "--once"],
                                  ["--coordinator", "x:1", "slow", "--why"],
                                  ["--coordinator", "x:1", "slow", "--by", "ttft"]])
def test_top_and_live_slow_over_a_stand_in_runtime_print_what_jax_prints(argv):
    args = {}
    for name, mod in (("jax", jctl), ("torch", tctl)):
        a = mod.build_parser().parse_args(argv)
        run = mod.run_top if a.plane == "top" else mod.run_slow_live
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = asyncio.run(run(_FakeDrt(), a))
        args[name] = (rc, out.getvalue())
    assert args["torch"] == args["jax"]
    assert args["torch"][0] == 0 and args["torch"][1]
