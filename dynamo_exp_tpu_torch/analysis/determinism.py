"""determinism checker: no nondeterminism sources in seeded zones.

Counterpart of ``dynamo_exp_tpu/analysis/determinism.py``, with torch's
global generator added. Two parts:

1. **Zone scan** — inside declared seed-deterministic zones (``sim/``,
   ``spec/``, the chaos schedules, ``FlightRecorder``), forbid:
   wall clocks (``time.time``/``monotonic``/``perf_counter``,
   ``datetime.now``...), module-level ``random.*`` draws (seeded
   ``random.Random(seed)`` instances are the sanctioned source),
   ``uuid.*``, ``os.urandom``, the unseeded ``np.random.*`` globals
   (``np.random.default_rng(seed)`` is fine), ``id()``/``hash()``
   (``hash()`` of a str is salted per process — PYTHONHASHSEED), and
   torch's global generator: ``torch.rand`` / ``randn`` / ``randint``
   / ``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial``
   without ``generator=``, and ``torch.manual_seed`` (which reseeds
   every caller's draws). The port's rule is an explicit
   ``torch.Generator`` passed to each draw.

2. **Payload-sink scan** — *everywhere* in the tree, arguments of
   ``*.flight.record(...)`` calls must be free of the same sources.
   This is the PR 8 gotcha as a rule: flight-ring payloads are
   compared bit-for-bit across same-seed runs, so a wall time or a
   run-global id in a payload breaks the chaos bit-identity test the
   day somebody adds one. The recorder stamps ``t`` itself; events
   carry pages/request/slot, never uuids.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    ScopeIndex,
    Zone,
    attr_chain,
    dataflow_units,
    own_nodes,
    zone_for,
)

RULE = "determinism"

_TIME_FNS = {
    "time",
    "time_ns",
    "monotonic",
    "monotonic_ns",
    "perf_counter",
    "perf_counter_ns",
    "localtime",
    "gmtime",
    "strftime",
    "ctime",
}
_DATETIME_FNS = {"now", "utcnow", "today", "fromtimestamp"}
_RANDOM_FNS = {
    "random",
    "randint",
    "randrange",
    "randbytes",
    "choice",
    "choices",
    "shuffle",
    "sample",
    "uniform",
    "gauss",
    "normalvariate",
    "expovariate",
    "betavariate",
    "getrandbits",
    "seed",
}

# torch's draws from its global generator unless given ``generator=``.
_TORCH_DRAWS = {
    "rand",
    "randn",
    "randint",
    "randperm",
    "normal",
    "bernoulli",
    "multinomial",
}


class _ImportTable:
    """Resolves names through the file's imports so `from time import
    time` / `import time as tm` are as visible as `time.time`."""

    def __init__(self, tree: ast.Module):
        # local name -> full dotted path it stands for (as a tuple).
        self.aliases: dict[str, tuple[str, ...]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.module and not node.level:
                    mod = tuple(node.module.split("."))
                    for a in node.names:
                        self.aliases[a.asname or a.name] = mod + (a.name,)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    path = tuple(a.name.split("."))
                    if a.asname:
                        self.aliases[a.asname] = path
                    else:
                        self.aliases.setdefault(path[0], (path[0],))

    def resolve(self, func: ast.AST) -> tuple[str, ...]:
        if isinstance(func, ast.Name):
            return self.aliases.get(func.id, ())
        chain = attr_chain(func)
        if chain:
            prefix = self.aliases.get(chain[0], (chain[0],))
            return prefix + chain[1:]
        return ()


def _forbidden_call(node: ast.Call, imports: _ImportTable) -> str | None:
    """A human-readable reason when this call is a nondeterminism
    source, else None."""
    if isinstance(node.func, ast.Name) and node.func.id in ("id", "hash"):
        return (
            f"{node.func.id}() is process-local "
            f"(run-global identity / salted hash)"
        )
    chain = imports.resolve(node.func)
    if not chain:
        return None
    root, leaf = chain[0], chain[-1]
    if root == "time" and leaf in _TIME_FNS:
        return f"wall clock: {'.'.join(chain)}()"
    if root == "datetime" and leaf in _DATETIME_FNS:
        return f"wall clock: {'.'.join(chain)}()"
    if root == "os" and leaf == "urandom":
        return "os.urandom() is unseedable"
    if root == "uuid" and leaf.startswith("uuid"):
        return f"{'.'.join(chain)}() is a run-global id"
    if root == "random" and leaf in _RANDOM_FNS:
        return (
            f"module-level {'.'.join(chain)}() — use a seeded "
            f"random.Random(seed) instance"
        )
    if (
        root == "random"
        and leaf == "Random"
        and not node.args
        and not node.keywords
    ):
        return "unseeded random.Random() — pass an explicit seed"
    if root == "torch" and len(chain) == 2 and leaf in _TORCH_DRAWS:
        if any(kw.arg == "generator" for kw in node.keywords):
            return None  # an explicit torch.Generator: sanctioned
        return (
            f"torch.{leaf}() draws from torch's global generator — pass "
            f"generator=<a seeded torch.Generator>"
        )
    if root == "torch" and leaf == "manual_seed" and len(chain) == 2:
        return (
            "torch.manual_seed() reseeds the global generator every "
            "caller shares — seed a torch.Generator instead"
        )
    if len(chain) >= 3 and root in ("np", "numpy") and chain[1] == "random":
        if leaf == "default_rng" and (node.args or node.keywords):
            return None  # seeded generator (positional or seed=): sanctioned
        return (
            f"unseeded {'.'.join(chain)}() — use "
            f"np.random.default_rng(seed)"
        )
    return None


def _payload_sink(node: ast.Call) -> bool:
    """True for ``<anything>.flight.record(...)`` / ``flight.record(...)``:
    a flight-recorder payload construction site."""
    chain = attr_chain(node.func)
    return len(chain) >= 2 and chain[-2:] == ("flight", "record")


class DeterminismChecker:
    """Flags nondeterminism sources in seeded zones and in flight-
    recorder payloads anywhere."""

    rule = RULE

    def __init__(self, zones: tuple[Zone, ...] | None = None):
        if zones is None:
            from .zones import DETERMINISM_ZONES

            zones = DETERMINISM_ZONES
        self.zones = zones

    def check(
        self, rel_path: str, tree: ast.Module, source: str
    ) -> list[Finding]:
        findings: list[Finding] = []
        zone = zone_for(self.zones, rel_path)
        scopes = ScopeIndex(tree) if zone is not None else None
        imports = _ImportTable(tree)
        # Nodes already reported via a payload sink (sink findings carry
        # the better message; don't double-report inside det zones).
        sunk: set[ast.AST] = set()
        for unit in dataflow_units(tree):
            # Names bound (anywhere in this unit) from a forbidden call:
            # `now = time.time(); flight.record(..., at=now)` is the
            # same payload hazard as the inline spelling.
            tainted: dict[str, str] = {}
            for node in own_nodes(unit):
                if not isinstance(node, ast.Assign):
                    continue
                why = next(
                    (
                        w
                        for sub in ast.walk(node.value)
                        if isinstance(sub, ast.Call)
                        and (w := _forbidden_call(sub, imports)) is not None
                    ),
                    None,
                )
                if why is None:
                    continue
                # Direct name bindings only: `seq.stalled_since =
                # time.time()` stores into a field — it must not taint
                # the whole object `seq` (field-level taint is out of
                # scope; the inline spelling in a payload is caught).
                def name_targets(t: ast.AST):
                    if isinstance(t, ast.Name):
                        yield t.id
                    elif isinstance(t, ast.Tuple):
                        for e in t.elts:
                            yield from name_targets(e)

                for t in node.targets:
                    for name in name_targets(t):
                        tainted[name] = why
            for node in own_nodes(unit):
                if not isinstance(node, ast.Call) or not _payload_sink(node):
                    continue
                for sub in ast.walk(node):
                    if sub is node:
                        continue
                    why = None
                    if isinstance(sub, ast.Call):
                        why = _forbidden_call(sub, imports)
                    elif isinstance(sub, ast.Name) and sub.id in tainted:
                        why = f"{tainted[sub.id]} (via local {sub.id!r})"
                    if why is not None:
                        sunk.add(sub)
                        findings.append(
                            Finding(
                                rule=RULE,
                                file=rel_path,
                                line=sub.lineno,
                                col=sub.col_offset,
                                end_line=sub.end_lineno or sub.lineno,
                                message=(
                                    f"flight-recorder payloads must stay "
                                    f"bit-identical across same-seed runs; "
                                    f"{why}"
                                ),
                            )
                        )
        if zone is not None:
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or node in sunk:
                    continue
                if not scopes.in_scope(node, zone):
                    continue
                why = _forbidden_call(node, imports)
                if why is not None:
                    findings.append(
                        Finding(
                            rule=RULE,
                            file=rel_path,
                            line=node.lineno,
                            col=node.col_offset,
                            end_line=node.end_lineno or node.lineno,
                            message=f"seed-deterministic zone: {why}",
                        )
                    )
        return findings

    def check_source(self, rel_path: str, source: str) -> list[Finding]:
        return self.check(rel_path, ast.parse(source), source)
