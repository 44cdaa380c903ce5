"""dynlint plumbing: findings, zones, inline waivers, AST helpers.

Counterpart of ``dynamo_exp_tpu/analysis/core.py``, unchanged in logic,
so a waiver reads the same in both trees. The waiver grammar is the one
reviewable escape hatch every rule shares:

    # dynlint: sync-point(ragged consume)
    # dynlint: determinism(host-only wall-clock report field)

One comment may carry several waivers (space-separated). A waiver
applies to findings of its rule anywhere on the smallest enclosing
*statement* (compound statements count only their header lines), so
multi-line call sites annotate naturally without a body comment ever
covering the header's findings. A bare token without a reason — or an
unknown token — is itself a finding (rule ``waiver-syntax``): the
allowlist only works if every entry says *why*.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass


@dataclass
class Finding:
    """One structured lint finding (rule, location, reason)."""

    rule: str
    file: str
    line: int
    col: int
    message: str
    end_line: int = 0
    waived: bool = False
    reason: str = ""

    def __post_init__(self) -> None:
        if not self.end_line:
            self.end_line = self.line

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "waived": self.waived,
            "reason": self.reason,
        }

    def fingerprint(self, source_lines: list[str]) -> str:
        """Line-number-free identity for ``--baseline`` (survives edits
        elsewhere in the file): rule + file + the flagged line's text."""
        text = ""
        if 1 <= self.line <= len(source_lines):
            text = source_lines[self.line - 1].strip()
        return f"{self.rule}::{self.file}::{text}"


@dataclass(frozen=True)
class Zone:
    """One declared checker zone: a repo-relative file (or directory
    prefix ending in ``/``), optionally narrowed to — or carved around —
    named top-level scopes (functions *or* classes, matched against
    every enclosing scope of the flagged node)."""

    path: str
    include: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()

    def covers_file(self, rel_path: str) -> bool:
        if self.path.endswith("/"):
            return rel_path.startswith(self.path)
        return rel_path == self.path


def zone_for(zones: tuple[Zone, ...], rel_path: str) -> Zone | None:
    for z in zones:
        if z.covers_file(rel_path):
            return z
    return None


class ScopeIndex:
    """Maps a node to its enclosing defs/classes, so zones can
    include/exclude by scope name without re-walking the tree.

    Zone entries match either a scope's full dotted path
    (``TorchEngine.generate``) or — for top-level scopes only — its bare
    name. A nested helper that happens to reuse an excluded method's
    name (``TorchEngine._loop.<a local 'generate'>``) matches neither, so
    a name collision can never silently exempt hot-path code."""

    def __init__(self, tree: ast.Module):
        # (dotted path, bare name, is_top_level, lo, hi)
        self._spans: list[tuple[str, str, bool, int, int]] = []

        def walk(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    dotted = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    self._spans.append(
                        (
                            dotted,
                            child.name,
                            not prefix,
                            child.lineno,
                            child.end_lineno or child.lineno,
                        )
                    )
                    walk(child, dotted)
                else:
                    walk(child, prefix)

        walk(tree, "")

    def enclosing(self, node: ast.AST) -> set[str]:
        """The match keys of every scope containing the node: dotted
        paths always, bare names for top-level scopes."""
        line = getattr(node, "lineno", 0)
        keys: set[str] = set()
        for dotted, bare, top, lo, hi in self._spans:
            if lo <= line <= hi:
                keys.add(dotted)
                if top:
                    keys.add(bare)
        return keys

    def in_scope(self, node: ast.AST, zone: Zone) -> bool:
        names = self.enclosing(node)
        if zone.include and not names & set(zone.include):
            return False
        if zone.exclude and names & set(zone.exclude):
            return False
        return True


def attr_chain(node: ast.AST) -> tuple[str, ...]:
    """``self.flight.record`` → ("self", "flight", "record"); () when
    the expression is not a pure Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def dataflow_units(tree: ast.Module) -> list[ast.AST]:
    """The module plus every function and lambda — the per-scope units
    checkers run local dataflow over (pair with :func:`own_nodes`)."""
    units: list[ast.AST] = [tree]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            units.append(node)
    return units


def own_nodes(unit: ast.AST):
    """The unit's nodes, stopping at nested function boundaries —
    nested defs/lambdas are their own dataflow units and must never be
    evaluated under an enclosing function's name classification."""
    stack = list(ast.iter_child_nodes(unit))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(n))


def base_name(node: ast.AST) -> str | None:
    """The root Name of a Name/Attribute/Subscript chain (``tgt[i]`` →
    ``tgt``; ``seq.prompt[-k:]`` → ``seq``), or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


# --------------------------------------------------------------- waivers
# One comment carries one or more `token(reason)` items; the reason is
# mandatory. Only real COMMENT tokens count — a docstring describing
# the syntax is not a waiver.
_WAIVER_COMMENT = re.compile(r"#\s*dynlint:\s*(.*)$")
_WAIVER_ITEM = re.compile(r"\s*,?\s*([a-z][a-z0-9-]*)(\(([^()]*)\))?")


def _iter_comments(source: str):
    """(lineno, col, text) for every comment token in the file."""
    import io
    import tokenize

    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return  # runner already reports unparseable files


def parse_waivers(
    rel_path: str, source: str, known_tokens: dict[str, str]
) -> tuple[dict[int, dict[str, str]], list[Finding]]:
    """Scan a file's ``# dynlint:`` comments.

    Returns ``({line: {rule: reason}}, waiver-syntax findings)`` where
    ``known_tokens`` maps waiver token → rule name. A token without a
    non-empty reason, or an unknown token, produces a ``waiver-syntax``
    finding and waives nothing.
    """
    waivers: dict[int, dict[str, str]] = {}
    findings: list[Finding] = []

    def bad(lineno: int, col: int, message: str) -> None:
        findings.append(
            Finding(
                rule="waiver-syntax",
                file=rel_path,
                line=lineno,
                col=col,
                message=message,
            )
        )

    for lineno, col, text in _iter_comments(source):
        m = _WAIVER_COMMENT.search(text)
        if not m:
            continue
        body = m.group(1).strip()
        if not body:
            bad(lineno, col, "empty dynlint comment")
            continue
        pos = 0
        while pos < len(body):
            item = _WAIVER_ITEM.match(body, pos)
            if item is None or item.end() == pos:
                bad(
                    lineno,
                    col,
                    f"malformed dynlint waiver near {body[pos:]!r}",
                )
                break
            pos = item.end()
            name, reason = item.group(1), (item.group(3) or "").strip()
            rule = known_tokens.get(name)
            if rule is None:
                bad(lineno, col, f"unknown dynlint waiver token {name!r}")
                continue
            if item.group(2) is None or not reason:
                bad(
                    lineno,
                    col,
                    f"waiver {name!r} requires a reason: "
                    f"# dynlint: {name}(<why this is safe>)",
                )
                continue
            waivers.setdefault(lineno, {})[rule] = reason
    return waivers, findings


def statement_spans(tree: ast.Module) -> list[tuple[int, int]]:
    """(lineno, end_lineno) of every statement — the waiver-coverage
    unit the docs promise ("any line of a multi-line statement").

    Compound statements (if/while/for/with/def/...) clamp to their
    HEADER lines only: a finding on an ``if`` test must not be waivable
    by a comment somewhere inside the block's body — the body's own
    statements are their own (smaller) spans."""
    spans: list[tuple[int, int]] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.stmt):
            continue
        lo, hi = n.lineno, n.end_lineno or n.lineno
        body = getattr(n, "body", None)
        if isinstance(body, list) and body and hasattr(body[0], "lineno"):
            hi = min(hi, max(lo, body[0].lineno - 1))
        spans.append((lo, hi))
    return spans


def apply_waivers(
    findings: list[Finding],
    waivers: dict[int, dict[str, str]],
    spans: list[tuple[int, int]] | None = None,
) -> set[tuple[int, str]]:
    """Mark findings waived in place: a waiver of the finding's rule
    anywhere on the smallest statement enclosing the flagged node
    covers it. Returns the consumed ``(line, rule)`` waiver entries so
    the runner can report stale waivers that match nothing."""
    consumed: set[tuple[int, str]] = set()
    for f in findings:
        lo, hi = f.line, f.end_line
        if spans:
            best = None
            for slo, shi in spans:
                if slo <= lo and hi <= shi:
                    if best is None or shi - slo < best[1] - best[0]:
                        best = (slo, shi)
            if best is not None:
                lo, hi = best
        for line in range(lo, hi + 1):
            reason = waivers.get(line, {}).get(f.rule)
            if reason is not None:
                f.waived = True
                f.reason = reason
                consumed.add((line, f.rule))
                break
    return consumed
