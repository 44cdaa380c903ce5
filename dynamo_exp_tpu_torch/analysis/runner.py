"""dynlint runner: walk the tree, run the checkers, report findings.

Counterpart of ``dynamo_exp_tpu/analysis/runner.py``, over the port's
package. Entry points: ``llmctl lint`` (``dynamo_exp_tpu_torch/llmctl.py``),
``python -m dynamo_exp_tpu_torch.analysis`` (pure stdlib: it runs with
no torch installed) and the tier-1 gate in tests/test_torch_analysis.py
(zero unwaived findings on the full tree).

``--baseline`` exists for incremental adoption during large refactors:
``--update-baseline`` snapshots today's unwaived findings
(line-number-free fingerprints), and later runs with ``--baseline``
report only *new* ones, so the floor can only ratchet down.
"""

from __future__ import annotations

import ast
import json
import os
import sys

from .core import Finding, apply_waivers, parse_waivers, statement_spans
from .determinism import DeterminismChecker
from .host_sync import HostSyncChecker
from .ownership import ThreadOwnershipChecker
from .recompile import RecompileHazardChecker

# Rule name -> one-line description. The doc-sync test walks this
# registry: every name must appear in the package docstring
# (``analysis/__init__.py``).
RULES: dict[str, str] = {
    "host-sync": (
        "no implicit device→host syncs in hot-path zones outside the "
        "inline-waived allowlist"
    ),
    "determinism": (
        "no wall clocks / unseeded RNGs / run-global ids in "
        "seed-deterministic zones or flight-recorder payloads"
    ),
    "thread-ownership": (
        "no mutation of engine-loop-owned state from non-loop call "
        "paths; lock-guarded state only under its lock"
    ),
    "recompile-hazard": (
        "CUDA graph keys must derive from resolve_*_key or *_bucket_for "
        "helpers, never raw dynamic ints"
    ),
    "waiver-syntax": (
        "every # dynlint: waiver needs a known token and a non-empty "
        "reason"
    ),
}

# Inline waiver token -> the rule it waives.
WAIVER_TOKENS: dict[str, str] = {
    "sync-point": "host-sync",
    "determinism": "determinism",
    "thread-ownership": "thread-ownership",
    "recompile-hazard": "recompile-hazard",
}

_SKIP_DIRS = {"__pycache__", ".git"}


def default_root() -> str:
    """The repo root: the parent of the port's package directory."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


PACKAGE = "dynamo_exp_tpu_torch"


def iter_source_files(root: str) -> list[str]:
    """Repo-relative posix paths of every package .py file under
    ``<root>/dynamo_exp_tpu_torch``. tests/ and chip_smoke.py are not
    zone members; scanning only the package keeps fixtures and harness
    code out of the gate."""
    pkg_dir = os.path.join(root, PACKAGE)
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                full = os.path.join(dirpath, fname)
                out.append(os.path.relpath(full, root).replace(os.sep, "/"))
    return sorted(out)


def default_checkers() -> list:
    return [
        HostSyncChecker(),
        DeterminismChecker(),
        ThreadOwnershipChecker(),
        RecompileHazardChecker(),
    ]


def lint_tree(
    root: str | None = None,
    rules: list[str] | None = None,
    files: list[str] | None = None,
    checkers: list | None = None,
) -> list[Finding]:
    """Run the suite over the tree; returns ALL findings (waived ones
    marked, so callers can audit the allowlist too). ``rules`` filters
    the reported rule set (``waiver-syntax`` always runs: a broken
    waiver must never silently pass a filtered run)."""
    root = root or default_root()
    if files is None:
        files = iter_source_files(root)
    else:
        # Normalize operator-supplied paths (absolute, ./-prefixed, OS
        # separators) to the repo-relative posix form zones and
        # manifests are declared in — otherwise every checker silently
        # skips the file and its waivers all look stale.
        files = [
            os.path.relpath(
                p if os.path.isabs(p) else os.path.join(root, p), root
            ).replace(os.sep, "/")
            for p in files
        ]
    checkers = checkers if checkers is not None else default_checkers()
    findings: list[Finding] = []
    for rel in files:
        path = os.path.join(root, rel)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, SyntaxError) as e:
            findings.append(
                Finding(
                    rule="waiver-syntax",
                    file=rel,
                    line=getattr(e, "lineno", 1) or 1,
                    col=0,
                    message=f"unparseable file: {e}",
                )
            )
            continue
        waivers, waiver_findings = parse_waivers(rel, source, WAIVER_TOKENS)
        file_findings: list[Finding] = []
        for checker in checkers:
            if rules and checker.rule not in rules:
                continue
            file_findings.extend(checker.check(rel, tree, source))
        consumed = apply_waivers(
            file_findings, waivers, statement_spans(tree)
        )
        if not rules:
            # Stale-waiver guard (full runs only — under --rule a
            # waiver for an unselected rule is legitimately unmatched):
            # a waiver that no longer covers any finding means the
            # allowlist has drifted from the code.
            for line, by_rule in waivers.items():
                for rule in by_rule:
                    if (line, rule) not in consumed:
                        waiver_findings.append(
                            Finding(
                                rule="waiver-syntax",
                                file=rel,
                                line=line,
                                col=0,
                                message=(
                                    f"unused waiver: no {rule} finding "
                                    f"on this statement — remove the "
                                    f"stale # dynlint comment"
                                ),
                            )
                        )
        findings.extend(file_findings)
        findings.extend(waiver_findings)
    if rules:
        findings = [
            f for f in findings if f.rule in rules or f.rule == "waiver-syntax"
        ]
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


# ------------------------------------------------------------- baselines
def load_baseline(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return set(data.get("fingerprints", []))


def save_baseline(path: str, fingerprints: list[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {"fingerprints": sorted(set(fingerprints))}, f, indent=2
        )
        f.write("\n")


def _fingerprints(root: str, findings: list[Finding]) -> dict[int, str]:
    """id(finding) -> fingerprint (reads each file once). Textually
    identical findings get an ordinal suffix (#0, #1, …) in report
    order, so the baseline is a *multiset*: baselining one occurrence
    of a line cannot suppress a second, NEW occurrence of the same
    text elsewhere in the file."""
    lines_by_file: dict[str, list[str]] = {}
    seen: dict[str, int] = {}
    out: dict[int, str] = {}
    for f in findings:
        if f.file not in lines_by_file:
            try:
                with open(
                    os.path.join(root, f.file), encoding="utf-8"
                ) as fh:
                    lines_by_file[f.file] = fh.read().splitlines()
            except OSError:
                lines_by_file[f.file] = []
        base = f.fingerprint(lines_by_file[f.file])
        n = seen.get(base, 0)
        seen[base] = n + 1
        out[id(f)] = f"{base}#{n}"
    return out


# ------------------------------------------------------------------- CLI
def add_lint_args(parser) -> None:
    parser.add_argument(
        "paths", nargs="*",
        help="repo-relative files to lint (default: the whole port package)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument(
        "--rule", action="append", default=None, choices=sorted(RULES),
        help="run only this rule (repeatable); waiver-syntax always runs",
    )
    parser.add_argument(
        "--root", default=None, help="repo root (default: auto-detected)"
    )
    parser.add_argument(
        "--baseline", default=None,
        help="suppress findings fingerprinted in this baseline file",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="write the current unwaived findings to --baseline and exit 0",
    )
    parser.add_argument(
        "--show-waived", action="store_true",
        help="also print the waived (allowlisted) findings",
    )


def run_cli(args) -> int:
    root = args.root or default_root()
    if args.update_baseline and not args.baseline:
        print(
            "--update-baseline requires --baseline <file> to write to",
            file=sys.stderr,
        )
        return 2
    files = list(args.paths) or None
    findings = lint_tree(root, rules=args.rule, files=files)
    unwaived = [f for f in findings if not f.waived]
    if args.baseline:
        fps = _fingerprints(root, unwaived)
        if args.update_baseline:
            save_baseline(args.baseline, [fps[id(f)] for f in unwaived])
            print(
                f"baseline: {len(unwaived)} finding(s) -> {args.baseline}",
                file=sys.stderr,
            )
            return 0
        if os.path.exists(args.baseline):
            known = load_baseline(args.baseline)
            unwaived = [f for f in unwaived if fps[id(f)] not in known]
    waived = [f for f in findings if f.waived]
    if args.as_json:
        print(
            json.dumps(
                {
                    "findings": [f.to_dict() for f in unwaived],
                    "waived": [f.to_dict() for f in waived],
                    "counts": {
                        "unwaived": len(unwaived),
                        "waived": len(waived),
                    },
                },
                indent=2,
            )
        )
    else:
        shown = unwaived + (waived if args.show_waived else [])
        shown.sort(key=lambda f: (f.file, f.line, f.rule))
        for f in shown:
            tag = f" [waived: {f.reason}]" if f.waived else ""
            print(
                f"{f.file}:{f.line}:{f.col}: {f.rule}: {f.message}{tag}"
            )
        print(
            f"dynlint: {len(unwaived)} unwaived finding(s), "
            f"{len(waived)} waived (allowlisted)",
            file=sys.stderr,
        )
    return 1 if unwaived else 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="dynlint",
        description="AST invariant checks of dynamo_exp_tpu_torch",
    )
    add_lint_args(parser)
    return run_cli(parser.parse_args(argv))
