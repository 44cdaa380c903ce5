"""thread-ownership checker: loop-owned state and lock-guarded state.

Counterpart of ``dynamo_exp_tpu/analysis/ownership.py``, unchanged in
logic; the manifests (``zones.py``) name the port's classes.

Part 1 — **ownership manifest** (``ThreadManifest``): a class declares
its loop-thread entry points, its non-loop entry points (asyncio
ingress, watchdog, metrics scrapes, lifecycle), the attributes only the
loop thread may mutate, and the sanctioned cross-thread handoff
surfaces. The checker builds the class's ``self.method()`` call graph,
computes which methods are reachable from non-loop entries, and flags
every mutation of a loop-owned attribute on such a path:
assignments (``self.x = …``, ``self.x += …``, ``self.x[i] = …``,
tuple-unpack targets) and known mutating method calls
(``self.x.append(…)``, ``.pop()``, ``.clear()``, …). Attributes in
neither set are ignored — the manifest is a contract about the named
state, not a typo detector.

Part 2 — **lock manifest** (``LockManifest``): within the declaring
class, every access (read or write) to a guarded attribute must sit
inside ``with self.<lock>:``. ``__init__`` is exempt in both parts —
construction precedes every thread.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .core import Finding

RULE = "thread-ownership"

_MUTATORS = {
    "append",
    "appendleft",
    "extend",
    "insert",
    "remove",
    "pop",
    "popleft",
    "popitem",
    "clear",
    "add",
    "discard",
    "update",
    "setdefault",
    "sort",
    "reverse",
}


@dataclass(frozen=True)
class ThreadManifest:
    path: str
    cls: str
    loop_entries: tuple[str, ...]
    external_entries: tuple[str, ...]
    loop_owned: frozenset[str]
    handoff: frozenset[str]


@dataclass(frozen=True)
class LockManifest:
    path: str
    cls: str
    lock: str
    guarded: frozenset[str]


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` → ``X`` (direct attribute of ``self`` only)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _find_class(tree: ast.Module, name: str) -> ast.ClassDef | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _methods(cls: ast.ClassDef) -> dict[str, ast.AST]:
    return {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


class ThreadOwnershipChecker:
    rule = RULE

    def __init__(
        self,
        manifests: tuple[ThreadManifest, ...] | None = None,
        locks: tuple[LockManifest, ...] | None = None,
    ):
        if manifests is None or locks is None:
            from .zones import LOCK_MANIFESTS, OWNERSHIP_MANIFESTS

            manifests = OWNERSHIP_MANIFESTS if manifests is None else manifests
            locks = LOCK_MANIFESTS if locks is None else locks
        self.manifests = manifests
        self.locks = locks

    # ----------------------------------------------------------- interface
    def check(
        self, rel_path: str, tree: ast.Module, source: str
    ) -> list[Finding]:
        findings: list[Finding] = []
        for m in self.manifests:
            if m.path == rel_path:
                findings.extend(self._check_ownership(rel_path, tree, m))
        for lm in self.locks:
            if lm.path == rel_path:
                findings.extend(self._check_locks(rel_path, tree, lm))
        return findings

    def check_source(self, rel_path: str, source: str) -> list[Finding]:
        return self.check(rel_path, ast.parse(source), source)

    # ----------------------------------------------------------- ownership
    def _check_ownership(
        self, rel_path: str, tree: ast.Module, m: ThreadManifest
    ) -> list[Finding]:
        cls = _find_class(tree, m.cls)
        if cls is None:
            return []
        methods = _methods(cls)
        # self.method() call edges (nested closures included: they run
        # on the caller's thread).
        edges: dict[str, set[str]] = {}
        for name, fn in methods.items():
            called: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    attr = _self_attr(node.func)
                    if attr in methods:
                        called.add(attr)
            edges[name] = called
        # For each method: the external entry points that reach it.
        reached_by: dict[str, set[str]] = {name: set() for name in methods}
        for entry in m.external_entries:
            if entry not in methods:
                continue
            stack, seen = [entry], {entry}
            while stack:
                cur = stack.pop()
                reached_by[cur].add(entry)
                for nxt in edges.get(cur, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append(nxt)
        findings: list[Finding] = []
        for name, fn in methods.items():
            # __init__ precedes every thread; loop-entry bodies ARE the
            # loop context — their writes are the sanctioned mutations,
            # whoever's call graph happens to reach them.
            if name == "__init__" or name in m.loop_entries:
                continue
            if not reached_by[name]:
                continue
            entries = ", ".join(sorted(reached_by[name]))
            for node, attr, how in self._mutations(fn):
                if attr not in m.loop_owned:
                    continue
                findings.append(
                    Finding(
                        rule=RULE,
                        file=rel_path,
                        line=node.lineno,
                        col=node.col_offset,
                        end_line=getattr(node, "end_lineno", node.lineno)
                        or node.lineno,
                        message=(
                            f"{how} of engine-loop-owned "
                            f"'{m.cls}.{attr}' in '{name}', reachable "
                            f"from non-loop entry point(s): {entries}"
                        ),
                    )
                )
        return findings

    @staticmethod
    def _mutations(fn: ast.AST):
        """Yield (node, self-attr, description) for every mutation of a
        ``self.X`` attribute in the method body."""

        def targets_of(t: ast.AST):
            if isinstance(t, ast.Tuple):
                for e in t.elts:
                    yield from targets_of(e)
                return
            attr = _self_attr(t)
            if attr is not None:
                yield t, attr, "write"
            elif isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    yield t, attr, "element write"

        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    yield from targets_of(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                yield from targets_of(node.target)
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in _MUTATORS:
                    attr = _self_attr(node.func.value)
                    if attr is not None:
                        yield (
                            node,
                            attr,
                            f"mutating call .{node.func.attr}()",
                        )

    # --------------------------------------------------------------- locks
    def _check_locks(
        self, rel_path: str, tree: ast.Module, lm: LockManifest
    ) -> list[Finding]:
        cls = _find_class(tree, lm.cls)
        if cls is None:
            return []
        findings: list[Finding] = []
        for name, fn in _methods(cls).items():
            if name == "__init__":
                continue
            self._walk_locked(rel_path, fn, lm, False, findings)
        return findings

    def _walk_locked(
        self,
        rel_path: str,
        node: ast.AST,
        lm: LockManifest,
        locked: bool,
        findings: list[Finding],
    ) -> None:
        if isinstance(node, ast.With):
            holds = any(
                _self_attr(item.context_expr) == lm.lock
                for item in node.items
            )
            for child in ast.iter_child_nodes(node):
                self._walk_locked(
                    rel_path, child, lm, locked or holds, findings
                )
            return
        attr = _self_attr(node)
        if attr in lm.guarded and not locked:
            findings.append(
                Finding(
                    rule=RULE,
                    file=rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    end_line=getattr(node, "end_lineno", node.lineno)
                    or node.lineno,
                    message=(
                        f"access to lock-guarded '{lm.cls}.{attr}' "
                        f"outside `with self.{lm.lock}:`"
                    ),
                )
            )
        for child in ast.iter_child_nodes(node):
            self._walk_locked(rel_path, child, lm, locked, findings)
