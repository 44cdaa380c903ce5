"""dynlint of the port (``dynamo_exp_tpu_torch/analysis/``): the cases of
``tests/test_analysis.py`` in torch terms, the full-tree gate over the
port's package, and parity with the JAX linter.

- host-sync: each torch sync planted in a hot-path fixture is flagged
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``torch.cuda.synchronize()``, an event's ``.synchronize()``, casts and
  truthiness of a device tensor, the data-dependent-shape ops), and
  ``.numpy()`` of a pinned host buffer is not;
- determinism: the JAX rules plus torch's global generator;
- thread-ownership and lock manifests, the CUDA graph-key rule, the
  waiver grammar, the baseline flow, ``--json``, ``llmctl lint``'s exit
  codes;
- the tier-1 gate: zero unwaived findings on the port's tree, every
  waiver with a reason documented in the package docstring, the
  documented engine sync points in the allowlist, and a planted
  ``.item()`` in the engine failing the gate;
- parity: both linters over the same rule-neutral fixtures (waiver
  grammar, stdlib clocks and ``random``, baselines) give the same
  (file, line, rule) findings and exit codes.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import textwrap

import pytest

from dynamo_exp_tpu.analysis import lint_tree as jlint_tree
from dynamo_exp_tpu.analysis.runner import main as jlint_main
from dynamo_exp_tpu_torch import analysis
from dynamo_exp_tpu_torch.analysis import (
    RULES,
    WAIVER_TOKENS,
    DeterminismChecker,
    HostSyncChecker,
    LockManifest,
    RecompileHazardChecker,
    ThreadManifest,
    ThreadOwnershipChecker,
    VariantSiteManifest,
    Zone,
    lint_tree,
    parse_waivers,
)
from dynamo_exp_tpu_torch.analysis.core import apply_waivers
from dynamo_exp_tpu_torch.analysis.runner import main as lint_main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = "dynamo_exp_tpu_torch"
HOT = Zone("fix/hot.py")
DET = Zone("fix/seeded.py")


def run_checker(checker, path, src):
    """checker + waiver parse + waiver application (what lint_tree does
    per file), on dedented fixture source."""
    src = textwrap.dedent(src)
    findings = checker.check_source(path, src)
    waivers, waiver_findings = parse_waivers(path, src, WAIVER_TOKENS)
    apply_waivers(findings, waivers)
    return findings, waiver_findings


def unwaived(findings):
    return [f for f in findings if not f.waived]


def hot(src):
    return run_checker(HostSyncChecker(zones=(HOT,)), "fix/hot.py", src)


# ------------------------------------------------------------- host-sync
SYNCS = {
    "item": "x.item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.numpy()",
    "to_cpu": 'x.to("cpu")',
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "done.synchronize()",
    "int": "int(x)",
    "float": "float(x.sum())",
    "bool": "bool(x.any())",
    "nonzero": "x.nonzero()",
    "where_one_arg": "torch.where(x > 0)",
    "mask_index": "x[x > 0]",
    "masked_select": "x.masked_select(x > 0)",
    "unique": "torch.unique(x)",
    "repeat_interleave": "x.repeat_interleave(x)",
}


@pytest.mark.parametrize("name", sorted(SYNCS))
def test_host_sync_flags_each_torch_sync_in_a_hot_zone(name):
    src = f"""
    import torch

    def step(n, done):
        x = torch.zeros(n, device="cuda")
        return {SYNCS[name]}
    """
    findings, _ = hot(src)
    assert [f.rule for f in findings] == ["host-sync"], findings
    assert findings[0].line == 6


def test_host_sync_silent_on_pinned_numpy_and_host_code():
    """``.numpy()`` of a pinned host buffer is bookkeeping (the wait is
    the event's, waived on its own line); so are numpy-backed tensors,
    shape-keeping ``torch.where`` and ``repeat_interleave`` given
    ``output_size``."""
    src = """
    import numpy as np
    import torch

    def consume(pending, n, dev):
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        pending.ready.synchronize()  # dynlint: sync-point(test consume)
        out = [y.numpy() for y in pending.ys]
        idx = torch.from_numpy(np.arange(n)).tolist()
        x = torch.ones(n, device=dev)
        w = torch.where(x > 0, x, 0)
        z = x.repeat_interleave(x.long(), output_size=2 * n)
        tokens = np.zeros((n, 4), np.int32)
        return buf, out, idx, w, z, int(tokens.shape[0])
    """
    findings, wf = hot(src)
    assert wf == [] and len(findings) == 1 and findings[0].waived, findings


def test_host_sync_device_roots_and_attributes():
    """Device roots: a factory given ``device=``, ``.to(device)``,
    ``.cuda()`` and the engine's device attributes; a dtype cast keeps
    its receiver's side."""
    src = """
    import torch

    class Eng:
        def probe(self, slot, pending, a, dev):
            if self._counts[slot] > 0:
                return int(pending.tokens_dev[0])
            b = a.to(dev)
            c = a.cuda().to(torch.float32)
            d = torch.tensor([1, 2]).to(torch.float32)
            return b.item(), float(c), d.tolist()
    """
    findings, _ = hot(src)
    lines = sorted(f.line for f in findings)
    # d is neither proven host nor device: .tolist() is flagged
    # conservatively; its int()/float() casts would not be.
    assert lines == [6, 7, 11, 11, 11], findings


def test_host_sync_truthiness_comparisons_and_propagation():
    src = """
    import torch

    def wait(n):
        m = torch.ones(n, device="cuda")
        if m.any():
            return 1
        while 0 < m.sum() and m.sum() < 9:
            n = n - 1
        assert m
        return [i for i in range(3) if m.all()], 1 if m.any() else 2
    """
    findings, _ = hot(src)
    assert len(findings) == 6, findings
    assert all("device tensor" in f.message for f in findings)


def test_host_sync_self_copy_rebind_still_flagged_and_lambdas_checked():
    src = """
    import torch

    def consume(n):
        ys = torch.zeros(n, device="cuda")
        ys = ys.cpu()
        return ys

    def install(dev_t):
        return lambda: dev_t.item()
    """
    findings, _ = hot(src)
    assert sorted(f.line for f in findings) == [6, 10], findings


def test_host_sync_waived_multiline_and_outside_zone():
    src = """
    import torch

    def consume(x):
        return x.to(  # dynlint: sync-point(spans lines)
            "cpu"
        )
    """
    findings, _ = hot(src)
    assert len(findings) == 1 and findings[0].waived
    assert HostSyncChecker(zones=(HOT,)).check_source("fix/cold.py", "x.item()\n") == []


def test_is_none_identity_check_and_zone_exclude():
    zone = Zone("fix/hot.py", exclude=("Eng.generate",))
    src = """
    class Eng:
        def ensure(self):
            if self.k_cache is None:
                return 1

        def generate(self, pending):
            return pending.x.item()  # excluded submission path

        def _loop(self, pending):
            def generate():
                return pending.x.item()  # NOT exempt

            return generate()
    """
    findings, _ = run_checker(HostSyncChecker(zones=(zone,)), "fix/hot.py", src)
    assert [f.line for f in findings] == [12], findings


# ----------------------------------------------------------- determinism
def _det(src, path="fix/seeded.py"):
    return run_checker(DeterminismChecker(zones=(DET,)), path, src)


def test_determinism_torch_global_generator():
    src = """
    import torch

    def good(seed, n):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return torch.randn(n, generator=gen), torch.randint(0, 9, (n,), generator=gen)

    def bad(n):
        torch.manual_seed(0)
        a = torch.rand(n) + torch.randn(n) + torch.normal(0.0, 1.0, (n,))
        b = torch.randperm(n), torch.randint(0, 9, (n,))
        c = torch.bernoulli(a), torch.multinomial(a.abs(), 1)
        return a, b, c
    """
    findings, _ = _det(src)
    assert sorted(f.line for f in findings) == [10, 11, 11, 11, 12, 12, 13, 13], findings
    assert all("generator" in f.message for f in findings)


def test_determinism_stdlib_rules_as_in_jax():
    src = """
    import random
    import time
    import numpy as np
    from time import time as now
    from datetime import datetime as dt

    def good(seed):
        return random.Random(seed).random() + np.random.default_rng(seed=seed).random()

    def bad():
        return (random.random(), np.random.randint(3), hash("x"), now(), dt.now(),
                random.Random(), time.perf_counter())
    """
    findings, _ = _det(src)
    assert len(findings) == 7 and all(f.line >= 12 for f in findings), findings


def test_flight_payload_taint_flagged_outside_zones():
    src = """
    import time
    import uuid

    class Eng:
        def finish(self, seq):
            self.flight.record("finish", req=seq.rid, t_wall=time.time())

        def grant(self, pages):
            self.flight.record("lease_grant", lease=uuid.uuid4().hex)

        def stall(self, seq):
            now = time.perf_counter()
            self.flight.record("stall_start", req=seq.rid, at=now)

        def clean(self, seq):
            self.flight.record("finish", req=seq.rid, generated=seq.n)
    """
    findings, _ = _det(src, f"{PKG}/engine/fix.py")
    assert {f.line for f in findings} == {7, 10, 14}
    assert all("flight-recorder payload" in f.message for f in findings)


# ------------------------------------------------------ thread-ownership
_FIX_MANIFEST = ThreadManifest(
    path="fix/eng.py", cls="Eng", loop_entries=("_loop",),
    external_entries=("stop", "submit"),
    loop_owned=frozenset({"_inflight", "_pending"}), handoff=frozenset({"_q"}),
)


def _own(src):
    return run_checker(ThreadOwnershipChecker(manifests=(_FIX_MANIFEST,), locks=()),
                       "fix/eng.py", src)


def test_ownership_external_writes_transitive_paths_and_waivers():
    src = """
    class Eng:
        def _loop(self):
            self._inflight = 1  # loop thread: fine

        def stop(self):
            self._inflight = None  # dynlint: thread-ownership(loop joined)
            self._loop()

        def submit(self, x):
            self._q.put(x)  # handoff surface: fine
            self._bump()

        def _bump(self):
            self._pending.append(1)
    """
    findings, _ = _own(src)
    assert [(f.line, f.waived) for f in findings] == [(7, True), (15, False)], findings
    assert ".append()" in findings[1].message and "submit" in findings[1].message


def test_lock_guarded_access_outside_lock_flagged():
    lm = LockManifest(path="fix/pool.py", cls="Pool", lock="_lock",
                      guarded=frozenset({"_data"}))
    src = """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._data = {}

        def good(self, k):
            with self._lock:
                return self._data.get(k)

        def bad(self, k):
            return self._data.get(k)
    """
    findings, _ = run_checker(ThreadOwnershipChecker(manifests=(), locks=(lm,)),
                              "fix/pool.py", src)
    assert [f.line for f in findings] == [14]


def test_ownership_manifest_names_the_port_engine():
    """The manifest is read from the port's engine, not copied blind:
    every entry point is a method of ``TorchEngine`` and every named
    attribute is one the engine sets."""
    import ast

    from dynamo_exp_tpu_torch.analysis.zones import OWNERSHIP_MANIFESTS

    (m,) = OWNERSHIP_MANIFESTS
    tree = ast.parse(open(os.path.join(REPO, m.path)).read())
    cls = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef) and n.name == m.cls)
    methods = {n.name for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert set(m.loop_entries) | set(m.external_entries) <= methods
    attrs = {n.attr for n in ast.walk(cls) if isinstance(n, ast.Attribute)
             and isinstance(n.value, ast.Name) and n.value.id == "self"}
    assert (m.loop_owned | m.handoff) <= attrs, (m.loop_owned | m.handoff) - attrs


# ------------------------------------------------------- CUDA graph keys
_FIX_SITES = VariantSiteManifest(path="fix/eng.py", sites={
    "graphs.get": ((0, "key"),),
    "_launch": ((0, "key"),),
    "WindowKey": ((0, "rows"), (1, "pages")),
})


def _keys(src):
    return run_checker(RecompileHazardChecker(manifests=(_FIX_SITES,)), "fix/eng.py", src)


def test_graph_keys_from_the_lattice_pass():
    src = """
    class Eng:
        def dispatch(self, part, cfg, manifest):
            key = resolve_window_key(cfg, len(part), 4, False, False)
            g = self.graphs.get(key)
            rows = rows_bucket_for(cfg, len(part))
            k2 = WindowKey(rows, cfg.max_pages_per_seq, True, False)
            for k3 in manifest.windows:
                self.graphs.get(k3)
            return self._launch(key), g, k2

        def _launch(self, key):
            return self.graphs.get(key)  # the callers are checked
    """
    findings, _ = _keys(src)
    assert findings == [], findings


def test_graph_key_from_a_raw_int_is_a_finding():
    src = """
    class Eng:
        def dispatch(self, part, cfg):
            key = WindowKey(len(part), page_bucket_for(cfg, 4), False, False)
            rows = rows_bucket_for(cfg, len(part))
            rows = len(part)
            k2 = WindowKey(rows=rows, pages=1, full_sampler=len(part), want_lp=False)
            g = self.graphs.get(key)
            return self._launch(len(part)), g, k2
    """
    findings, _ = _keys(src)
    # The raw key is flagged where it is built (4) and where it is used (8).
    assert sorted(f.line for f in findings) == [4, 7, 8, 9], findings
    assert any("keyword 'rows'" in f.message for f in findings)
    assert all("resolve_*_key" in f.message for f in findings)


def test_graph_key_use_before_rebind_and_nested_defs_and_waivers():
    src = """
    class Eng:
        def dispatch(self, part, cfg):
            key = len(part)
            g = self.graphs.get(key)
            key = resolve_window_key(cfg, len(part), 4, False, False)

            def helper():
                key = resolve_window_key(cfg, 8, 4, False, False)
                return key

            return g, self._launch(key)

        def chained(self, pending):
            return self.graphs.get(pending.key)  # dynlint: recompile-hazard(carried key)
    """
    findings, _ = _keys(src)
    assert [(f.line, f.waived) for f in findings] == [(5, False), (15, True)], findings


# --------------------------------------------------------- waiver grammar
def test_waiver_grammar():
    src = """
    import torch

    def consume(x):
        return x.item()  # dynlint: sync-point
    """
    findings, wf = hot(src)
    assert unwaived(findings) and "requires a reason" in wf[0].message
    _, wf = hot("x = 1  # dynlint: bogus(whatever)\n")
    assert "unknown dynlint waiver token" in wf[0].message
    waivers, wf = parse_waivers(
        "fix/hot.py", 'def f():\n    """Use # dynlint: sync-point(reason)."""\n', WAIVER_TOKENS)
    assert waivers == {} and wf == []
    assert set(WAIVER_TOKENS) == {"sync-point", "determinism", "thread-ownership",
                                  "recompile-hazard"}


def _tree(tmp_path, pkg, rel, src):
    path = tmp_path / pkg / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return str(tmp_path)


def test_waiver_spans_statements_but_not_if_bodies_and_unused_waivers(tmp_path):
    root = _tree(tmp_path, PKG, "engine/offload.py", """
        import torch

        def consume(pending, n):
            out = torch.clamp(  # dynlint: sync-point(fixture waiver)
                pending.x.cpu(),
                0,
                9,
            )
            m = torch.ones(n, device="cuda")
            if m.any():
                toks = pending.y.cpu()  # dynlint: sync-point(inner waiver)
                return toks
            return out  # dynlint: sync-point(stale entry)
        """)
    findings = lint_tree(root)
    bad = sorted((f.line, f.rule) for f in unwaived(findings))
    assert bad == [(11, "host-sync"), (14, "waiver-syntax")], findings
    assert not unwaived(lint_tree(root, rules=["determinism"]))


# ------------------------------------------------------- full-tree gate
@pytest.fixture(scope="module")
def tree_findings():
    return lint_tree(REPO)


def test_full_tree_zero_unwaived_findings(tree_findings):
    """THE tier-1 gate: the port's tree is clean — every finding of
    every rule is inline-waived with a reason."""
    findings = tree_findings
    bad = unwaived(findings)
    assert not bad, "unwaived dynlint findings:\n" + "\n".join(
        f"{f.file}:{f.line}: {f.rule}: {f.message}" for f in bad)
    assert findings and all(f.reason for f in findings)
    assert {f.file.split("/")[0] for f in findings} == {PKG}


def test_gate_fails_on_a_planted_item_in_the_engine(tmp_path):
    """A ``.item()`` planted in ``TorchEngine``'s loop side of a copy of
    the engine fails the gate; the same call in ``generate`` (excluded:
    the submission side) does not."""
    src = open(os.path.join(REPO, PKG, "engine", "engine.py")).read()
    planted = src.replace(
        "    def _consume_ragged(self, pending: _PendingRagged) -> None:\n",
        "    def _consume_ragged(self, pending: _PendingRagged) -> None:\n"
        "        self.k_cache.sum().item()\n", 1)
    assert planted != src
    root = _tree(tmp_path, PKG, "engine/engine.py", planted)
    bad = unwaived(lint_tree(root))
    assert [(f.rule, "item" in f.message) for f in bad] == [("host-sync", True)], bad
    assert lint_main(["--root", root]) == 1


def test_documented_engine_sync_points_are_the_allowlist(tree_findings):
    """The engine's documented sync points (the ragged consume's event
    wait, the extract gather, the copy-thread transfer) are entries of
    the host-sync allowlist, with reasons."""
    waived = [f for f in tree_findings if f.waived and f.rule == "host-sync"]
    reasons = {f.reason for f in waived}
    assert {"ragged consume", "extract gather consume",
            "offload copy-thread transfer"} <= reasons, reasons
    files = {f.file for f in waived}
    assert {f"{PKG}/engine/engine.py", f"{PKG}/engine/offload.py"} <= files


def test_every_rule_and_waiver_reason_is_documented(tree_findings):
    doc = analysis.__doc__
    assert all(f"``{r}``" in doc for r in RULES)
    assert all(f"``{t}``" in doc for t in WAIVER_TOKENS)
    reasons = {f.reason for f in tree_findings if f.waived}
    assert not sorted(r for r in reasons if f"``{r}``" not in doc)


# ------------------------------------------------------------------ CLI
def test_cli_json_clean_tree_and_explicit_paths(capsys):
    assert lint_main(["--json", "--root", REPO]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["counts"]["unwaived"] == 0 and out["counts"]["waived"] > 0
    assert all(f["rule"] in RULES and f["reason"] for f in out["waived"])
    target = f"{PKG}/engine/offload.py"
    for spec in (target, "./" + target, os.path.join(REPO, target)):
        assert lint_main(["--json", "--root", REPO, spec]) == 0
        assert json.loads(capsys.readouterr().out)["counts"]["waived"] >= 3, spec


def test_python_m_analysis_runs_without_torch(tmp_path):
    """``python -m dynamo_exp_tpu_torch.analysis`` is pure stdlib: with
    torch made unimportable it lints the tree and exits 0."""
    block = tmp_path / "torch"
    block.mkdir()
    (block / "__init__.py").write_text("raise ImportError('no torch here')\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"}
    r = subprocess.run([sys.executable, "-c",
                        "import runpy, sys; sys.argv = ['dynlint', '--root', %r];"
                        "runpy.run_module('dynamo_exp_tpu_torch.analysis.__main__',"
                        " run_name='__main__')" % REPO],
                       env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "0 unwaived finding(s)" in r.stderr


def test_llmctl_lint_exit_codes(tmp_path):
    from dynamo_exp_tpu_torch.llmctl import build_parser, run

    args = build_parser().parse_args(["lint", "--json", "--root", REPO])
    assert args.plane == "lint" and asyncio.run(run(args)) == 0
    root = _tree(tmp_path, PKG, "sim/bad.py", "import time\n\n\ndef f():\n    return time.time()\n")
    assert asyncio.run(run(build_parser().parse_args(["lint", "--root", root]))) == 1
    args = build_parser().parse_args(["lint", "--root", root, "--rule", "host-sync"])
    assert asyncio.run(run(args)) == 0
    assert asyncio.run(run(build_parser().parse_args(["lint", "--update-baseline",
                                                      "--root", root]))) == 2


# ------------------------------------------------------ parity with JAX
NEUTRAL = {
    "sim/clock.py": """
        import random
        import time
        import uuid
        from time import monotonic as mono

        def stamp(ev, seed):
            ev["t"] = time.time()  # dynlint: determinism(fixture wall stamp)
            ev["u"] = uuid.uuid4().hex
            rng = random.Random(seed)
            return random.random() + rng.random() + mono() + hash("x") + id(ev)
        """,
    "sim/waivers.py": """
        def f():
            a = 1  # dynlint: sync-point
            b = 2  # dynlint: bogus(whatever)
            c = 3  # dynlint: determinism(stale entry)
            return a + b + c  # dynlint: determinism()
        """,
    "engine/payload.py": """
        import time

        class Eng:
            def stall(self, seq):
                now = time.perf_counter()
                self.flight.record("stall_start", req=seq.rid, at=now)
        """,
}


def _both_trees(tmp_path):
    roots = {}
    for pkg in ("dynamo_exp_tpu", PKG):
        for rel, src in NEUTRAL.items():
            roots[pkg] = _tree(tmp_path / pkg.replace("_", ""), pkg, rel, src)
    return roots["dynamo_exp_tpu"], roots[PKG]


def _keyed(findings):
    return sorted((f.file.split("/", 1)[1], f.line, f.rule, f.waived) for f in findings)


def test_parity_with_the_jax_linter_on_rule_neutral_fixtures(tmp_path, capsys):
    jroot, troot = _both_trees(tmp_path)
    want, got = jlint_tree(jroot), lint_tree(troot)
    assert _keyed(got) == _keyed(want) and len(got) >= 10, (got, want)
    # The CLI and the baseline flow agree too: snapshot, clean, then a
    # new finding beyond the multiset fails both.
    for main, root in ((jlint_main, jroot), (lint_main, troot)):
        bl = os.path.join(root, "bl.json")
        assert main(["--root", root]) == 1
        assert main(["--root", root, "--baseline", bl, "--update-baseline"]) == 0
        assert main(["--root", root, "--baseline", bl]) == 0
        pkg = "dynamo_exp_tpu" if main is jlint_main else PKG
        p = os.path.join(root, pkg, "sim", "clock.py")
        with open(p, "a") as f:
            f.write("\n\ndef again():\n    return time.time()\n")
        assert main(["--root", root, "--baseline", bl]) == 1
        assert main(["--root", root, "--update-baseline"]) == 2
    capsys.readouterr()
