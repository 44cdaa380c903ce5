"""recompile-hazard checker: CUDA graph keys must come from the lattice.

Counterpart of ``dynamo_exp_tpu/analysis/recompile.py``. Where the JAX
engine keys compiled XLA variants, the port keys CUDA graphs: one graph
per ``WindowKey`` / ``MixedKey`` (``aot/lattice.py``), captured at the
key's first dispatch (``engine/graphs.py`` ``DispatchGraphs.get``). The
set of graphs stays O(log) *only* because every shape-carrying key
component comes from the lattice (``resolve_window_key``,
``resolve_mixed_key``, the ``*_bucket_for`` helpers). One raw dynamic
int in a key (``WindowKey(len(part), ...)``) captures a fresh graph per
distinct value under real load: a capture storm, each capture a stall
of the loop.

A ``VariantSiteManifest`` names the callables whose arguments become
graph keys, by position and keyword name. An argument is accepted when
it traces (through per-function dataflow) to:

- a call to ``resolve_window_key`` / ``resolve_mixed_key`` or to any
  ``*bucket_for`` helper,
- an int, bool or None constant, ``min``/``max`` over accepted values,
  or a conditional between two,
- static config (an attribute path through ``cfg``) or a graph
  manifest (an attribute path through ``manifest``: the lattice
  enumerated, or read back from an artifact), or a loop over one,
- the key parameter of another site (its callers are checked in turn).

Anything else is flagged; a deliberate carry gets an inline
``# dynlint: recompile-hazard(reason)``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .core import Finding, attr_chain, dataflow_units, own_nodes

RULE = "recompile-hazard"

_BUCKET_SUFFIX = "bucket_for"
_RESOLVERS = {"resolve_window_key", "resolve_mixed_key"}
_STATIC_ROOTS = ("cfg", "manifest")


@dataclass(frozen=True)
class VariantSiteManifest:
    # A repo-relative file, or a directory prefix ending in "/".
    path: str
    # callee (a Name, or the dotted tail after ``self.``, e.g.
    # "graphs.get") -> its key-carrying arguments as (position, name).
    sites: dict[str, tuple[tuple[int, str], ...]]

    def covers_file(self, rel_path: str) -> bool:
        if self.path.endswith("/"):
            return rel_path.startswith(self.path)
        return rel_path == self.path


def _callee_name(func: ast.AST) -> str | None:
    """``WindowKey`` -> "WindowKey"; ``self.graphs.get`` ->
    "graphs.get"; ``graphs.get`` -> "graphs.get"."""
    chain = attr_chain(func)
    if not chain:
        return None
    if chain[0] == "self":
        chain = chain[1:]
    return ".".join(chain) if chain else None


def _matches(callee: str, site: str) -> bool:
    return callee == site or callee.endswith("." + site)


class _BucketFlow:
    """Per-function, per-line classification of names holding key
    components from the lattice.

    Bindings are processed in source order and each one records whether
    the name was accepted *after* it, so a rebind to anything not
    provably bucketed KILLS the name from that point on (`rows =
    rows_bucket_for(...)` then `rows = len(part)` can't launder the raw
    int), and an accepted rebind *after* a raw use can't retroactively
    whitewash the earlier dispatch (use sites consult the last binding
    at or before their own line). ``trusted`` names (a site's own key
    parameters) are accepted until rebound."""

    def __init__(self, fn: ast.AST, trusted: set[str] = frozenset()):
        # name -> [(bind line, accepted after this bind)], line-ordered.
        self._history: dict[str, list[tuple[int, bool]]] = {
            name: [(0, True)] for name in trusted
        }
        binds: list[tuple[int, int, str, ast.AST | None, bool]] = []
        for node in own_nodes(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    binds.append(
                        (node.lineno, node.col_offset, t.id, node.value, False)
                    )
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(node.target, ast.Name):
                    binds.append(
                        (node.lineno, node.col_offset, node.target.id, None, False)
                    )
            elif isinstance(node, (ast.For, ast.comprehension)) and isinstance(
                node.target, ast.Name
            ):
                # A loop over an accepted iterable (the manifest's keys)
                # yields accepted items.
                line = getattr(node, "lineno", None) or node.iter.lineno
                binds.append((line, 0, node.target.id, node.iter, True))
        for line, _, name, value, loop in sorted(binds, key=lambda b: b[:2]):
            ok = value is not None and (
                self._iterable_ok(value, line) if loop else self.ok(value, line)
            )
            self._history.setdefault(name, []).append((line, ok))

    def _iterable_ok(self, node: ast.AST, line: int) -> bool:
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            return bool(chain) and any(r in chain[:-1] for r in _STATIC_ROOTS)
        return self.ok(node, line)

    def ok(self, node: ast.AST, line: int) -> bool:
        if isinstance(node, ast.Constant):
            return node.value is None or isinstance(node.value, (int, bool))
        if isinstance(node, ast.Name):
            state = False
            for bind_line, accepted in self._history.get(node.id, ()):
                if bind_line > line:
                    break
                state = accepted
            return state
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            return bool(chain) and any(r in chain[:-1] for r in _STATIC_ROOTS)
        if isinstance(node, ast.IfExp):
            return self.ok(node.body, line) and self.ok(node.orelse, line)
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and (
                chain[-1].endswith(_BUCKET_SUFFIX) or chain[-1] in _RESOLVERS
            ):
                return True
            if chain and chain[-1] in ("min", "max") and node.args:
                return all(self.ok(a, line) for a in node.args)
        return False


class RecompileHazardChecker:
    rule = RULE

    def __init__(
        self, manifests: tuple[VariantSiteManifest, ...] | None = None
    ):
        if manifests is None:
            from .zones import VARIANT_SITE_MANIFESTS

            manifests = VARIANT_SITE_MANIFESTS
        self.manifests = manifests

    def check(
        self, rel_path: str, tree: ast.Module, source: str
    ) -> list[Finding]:
        sites: dict[str, tuple[tuple[int, str], ...]] = {}
        for m in self.manifests:
            if m.covers_file(rel_path):
                sites.update(m.sites)
        # A file that never spells a site's name holds no site (the
        # package-wide key manifests would otherwise walk every file).
        sites = {s: v for s, v in sites.items() if s in source}
        if not sites:
            return []
        findings: list[Finding] = []
        for fn in dataflow_units(tree):
            flow = _BucketFlow(fn, self._trusted(fn, sites))
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = _callee_name(node.func)
                site = next((s for s in sites if callee and _matches(callee, s)), None)
                if site is None:
                    continue
                suspect: list[tuple[str, ast.AST]] = []
                names = {name for _, name in sites[site]}
                for pos, _ in sites[site]:
                    if pos < len(node.args):
                        suspect.append((f"arg {pos}", node.args[pos]))
                for kw in node.keywords:
                    if kw.arg in names:
                        suspect.append((f"keyword {kw.arg!r}", kw.value))
                for label, value in suspect:
                    if not flow.ok(value, node.lineno):
                        arg_src = ast.unparse(value)
                        findings.append(
                            Finding(
                                rule=RULE,
                                file=rel_path,
                                line=node.lineno,
                                col=node.col_offset,
                                end_line=node.end_lineno or node.lineno,
                                message=(
                                    f"CUDA graph key {label} of {callee}(...) "
                                    f"is not lattice-derived: {arg_src!r} — "
                                    f"route it through resolve_*_key or a "
                                    f"*_bucket_for helper"
                                ),
                            )
                        )
        return findings

    @staticmethod
    def _trusted(fn: ast.AST, sites) -> set[str]:
        """A site function's own key parameters (``_launch_mixed``'s
        ``key``): its callers are held to the rule instead."""
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return set()
        spec = sites.get(fn.name)
        return {name for _, name in spec} if spec else set()

    def check_source(self, rel_path: str, source: str) -> list[Finding]:
        return self.check(rel_path, ast.parse(source), source)
