"""Offline trace reconstruction from recorder JSONL (``llmctl trace``).

Counterpart of ``dynamo_exp_tpu/telemetry/timeline.py``. Spans land in
the recorder as ``{"ts": ..., "event": {"type": "span", ...}}`` lines,
interleaved across stages, processes and file rotations. This module
loads them back, groups them by ``trace_id``, rebuilds the parent/child
tree and renders an ASCII timeline; the text is the JAX package's.
"""

from __future__ import annotations

import glob
import os
import re

from ..recorder import Recorder
from .spans import Span


def load_spans(paths: list[str]) -> list[Span]:
    """Read every span event from the given JSONL files.

    For each path, recorder siblings are read too: rotated generations
    (``path.N``), per-process recordings of a shared ``DYN_TRACE_FILE``
    (``path.pid<pid>``) and their rotations (``path.pid<pid>.N``).
    Unrelated siblings (``path.1.bak``) are skipped. Order across files
    does not matter: spans carry absolute timestamps.
    """
    gen_re = re.compile(r"^(\.pid\d+)?(\.\d+)*$")

    def _is_generation(cand: str, base: str) -> bool:
        suffix = cand[len(base):]
        return bool(suffix) and gen_re.fullmatch(suffix) is not None

    spans: list[Span] = []
    seen: set[str] = set()
    expanded: list[str] = []
    for p in paths:
        siblings = sorted(c for c in glob.glob(p + ".*") if _is_generation(c, p))
        for cand in siblings + [p]:
            if cand not in seen and os.path.exists(cand):
                seen.add(cand)
                expanded.append(cand)
    for path in expanded:
        for _ts, event in Recorder.replay(path):
            if isinstance(event, dict) and event.get("type") == "span":
                spans.append(Span.from_event(event))
    return spans


def find_trace(spans: list[Span], needle: str) -> list[Span]:
    """Spans of the trace identified by ``needle``: a full or prefix
    trace_id, or a request id recorded in any span's attrs."""
    by_trace: dict[str, list[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    if needle in by_trace:
        return by_trace[needle]
    for tid, group in by_trace.items():
        if tid.startswith(needle):
            return group
    for tid, group in by_trace.items():
        if any(s.attrs.get("request_id") == needle for s in group):
            return group
    return []


def _order_tree(spans: list[Span]) -> list[tuple[Span, int]]:
    """(span, depth) in tree order: children under parents, siblings by
    start time. Orphans (the parent's file lost) surface at the root."""
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list[Span]] = {}
    roots: list[Span] = []
    for s in spans:
        if s.parent_span_id and s.parent_span_id in by_id:
            children.setdefault(s.parent_span_id, []).append(s)
        else:
            roots.append(s)
    out: list[tuple[Span, int]] = []

    def walk(span: Span, depth: int) -> None:
        out.append((span, depth))
        for c in sorted(children.get(span.span_id, []), key=lambda x: x.start):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x.start):
        walk(r, 0)
    return out


def render_timeline(spans: list[Span], width: int = 40) -> str:
    """Span tree with offset / duration bars. A trace whose spans come
    from more than one instance shows each span's instance in a column
    and sums up its KV transfer hops after the tree."""
    if not spans:
        return "no spans"
    t0 = min(s.start for s in spans)
    t1 = max(s.end for s in spans)
    total = max(t1 - t0, 1e-9)
    ordered = _order_tree(spans)
    name_w = max(len("  " * d + s.stage) for s, d in ordered)
    req = next((s.attrs["request_id"] for s, _ in ordered if "request_id" in s.attrs), None)
    instances = sorted({str(s.attrs["instance"]) for s in spans if s.attrs.get("instance")})
    multi = len(instances) > 1
    inst_w = max((len(i) for i in instances), default=0) if multi else 0
    head = f"trace {spans[0].trace_id} — {len(spans)} spans, {total * 1e3:.1f}ms"
    if req:
        head += f" (request {req})"
    if multi:
        head += f" across {len(instances)} instances"
    lines = [head]
    for s, depth in ordered:
        off = s.start - t0
        left = int(round((off / total) * width))
        fill = max(int(round((s.duration_s / total) * width)), 1)
        fill = min(fill, width - min(left, width - 1))
        bar = " " * min(left, width - 1) + "#" * fill
        bar = bar[:width].ljust(width)
        label = ("  " * depth + s.stage).ljust(name_w)
        inst = f" [{str(s.attrs.get('instance', '?')):<{inst_w}}]" if multi else ""
        lines.append(f"{label}{inst}  {off * 1e3:8.1f}ms {s.duration_s * 1e3:9.1f}ms |{bar}|")
        extra = {k: v for k, v in s.attrs.items() if k not in ("request_id", "instance")}
        if extra:
            kv = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
            lines.append(" " * (name_w + 2) + f"  {kv}")
    hops = transfer_hops(spans)
    if hops:
        lines.append("transfer hops:")
        for h in hops:
            mbs = (f", {h['bytes'] / max(h['duration_s'], 1e-9) / (1 << 20):.1f} MB/s"
                   if h["bytes"] else "")
            lines.append(f"  {h['stage']}: {h['src']} -> {h['dst']}  "
                         f"{h['duration_s'] * 1e3:.1f}ms, {h['bytes']} bytes{mbs}")
    return "\n".join(lines)


def transfer_hops(spans: list[Span]) -> list[dict]:
    """The trace's KV transfer hops (send / recv spans with their link
    endpoints), in start order."""
    hops = []
    for s in sorted(spans, key=lambda x: x.start):
        if s.stage not in ("kv_transfer_send", "kv_transfer_recv"):
            continue
        hops.append({
            "stage": s.stage,
            "src": str(s.attrs.get("src", s.attrs.get("instance", "?"))),
            "dst": str(s.attrs.get("dst", "?")),
            "bytes": int(s.attrs.get("bytes", 0) or 0),
            "duration_s": s.duration_s,
        })
    return hops


def list_traces(spans: list[Span]) -> list[tuple[str, int, float, str]]:
    """(trace_id, span count, duration_s, root stage) per trace, by start
    time: the ``llmctl trace`` listing."""
    by_trace: dict[str, list[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    rows = []
    for tid, group in by_trace.items():
        t0 = min(s.start for s in group)
        t1 = max(s.end for s in group)
        root = min(group, key=lambda s: s.start)
        rows.append((tid, len(group), t1 - t0, root.stage, t0))
    rows.sort(key=lambda r: r[-1])
    return [(tid, n, dur, stage) for tid, n, dur, stage, _t0 in rows]
