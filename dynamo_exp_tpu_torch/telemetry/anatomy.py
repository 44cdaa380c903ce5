"""Per-request latency and cost anatomy.

Counterpart of ``dynamo_exp_tpu/telemetry/anatomy.py``, whole: one
request's wall time split into named components (queue wait, prefill
and decode compute, host gap, compile stall, KV transfer, swap stall,
preemption, recovery, other) plus the cost it consumed (chip-seconds,
KV-page-seconds), from the signals the port already emits:

- offline, from spans (:func:`anatomy_from_spans`): the trace's spans
  are swept into non-overlapping claims (a preemption span takes its
  instants from the decode span it interrupts), then the carve-outs the
  spans carry (``compile_s`` on ``prefill``, ``swap_stall_s`` and the
  dispatch profiler's host-gap share on ``decode``) move time between
  components. The sum equals the root span's duration by construction;
- offline, from a flight dump (:func:`anatomy_from_flight`): the ring's
  ``admit`` / ``first_token`` / ``preempt`` / ``stall_start`` /
  ``stall_end`` / ``finish`` events replayed per request;
- live, in the engine (:func:`anatomy_from_timing`): the loop's
  per-sequence accumulators (host clock stamps only, no device sync),
  with the worst-N exemplars in an :class:`AnatomyRing`
  (``metrics()["anatomy_slow"]``, ``llmctl slow``).

Every function is pure arithmetic over its inputs (no clock reads, no
ids), so the same inputs decompose identically in both packages.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .slo import PRIORITY_NAMES

# The closed component set: the prometheus label space
# (``dynamo_request_seconds{component}``), the metrics() mirror, the
# bench per-line summary and the simulator's rollup all key on these
# names, in this display order. ``other`` is edge/routing overhead the
# engine never sees (preprocess, HTTP, scheduling gaps) — it exists so
# the component sum matches the edge-measured latency exactly.
COMPONENTS = (
    "queue_wait",
    "prefill_compute",
    "decode_compute",
    "host_gap",
    "compile_stall",
    "kv_transfer",
    "swap_stall",
    "preemption",
    "recovery",
    "other",
)

# Span stage -> (component, claim priority). Higher priority claims win
# an instant when spans overlap: a preemption or KV-transfer span
# happening *inside* the decode window must take those instants away
# from decode, not double-count them.
_STAGE_CLAIMS = {
    "kv_transfer_send": ("kv_transfer", 5),
    "kv_transfer_recv": ("kv_transfer", 5),
    "preemption": ("preemption", 4),
    "recovery": ("recovery", 4),
    "queue_wait": ("queue_wait", 3),
    "prefill": ("prefill_compute", 2),
    "decode": ("decode_compute", 2),
    # The decode side's local view of a remote prefill hop: lowest
    # priority, so the remote instance's own prefill / transfer spans
    # refine it wherever they overlap.
    "remote_prefill": ("prefill_compute", 1),
}


@dataclass
class RequestAnatomy:
    """One request's full latency/cost decomposition."""

    request_id: str = ""
    trace_id: str = ""
    # Every COMPONENTS key present, seconds, rounded to 6dp.
    components: dict[str, float] = field(default_factory=dict)
    # The latency the decomposition explains: root-span (edge) duration
    # offline, submit->finish for engine-side assembly.
    edge_latency_s: float = 0.0
    ttft_s: float | None = None
    itl_s: float | None = None
    # Cost: wall time the request held device compute (slot-resident,
    # not swapped/preempted) and its page-residency integral.
    chip_seconds: float = 0.0
    kv_page_seconds: float = 0.0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    priority: int = 1
    instances: tuple = ()

    @property
    def total_s(self) -> float:
        return sum(self.components.values())

    @property
    def dominant(self) -> str:
        """The component that cost the most time (ties break in
        COMPONENTS display order, deterministically)."""
        if not self.components:
            return "other"
        return max(
            COMPONENTS,
            key=lambda c: (self.components.get(c, 0.0), -COMPONENTS.index(c)),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "RequestAnatomy":
        """Inverse of :meth:`to_dict` (tolerant: unknown keys ignored,
        missing keys default) — `llmctl slow` rebuilds exemplars from
        scraped ``metrics()["anatomy_slow"]`` entries with this."""
        a = cls(
            request_id=str(d.get("request_id", "")),
            trace_id=str(d.get("trace_id", "")),
            components={
                k: float(v)
                for k, v in (d.get("components") or {}).items()
                if k in COMPONENTS
            },
            edge_latency_s=float(d.get("edge_latency_s", 0.0)),
            chip_seconds=float(d.get("chip_seconds", 0.0)),
            kv_page_seconds=float(d.get("kv_page_seconds", 0.0)),
            prompt_tokens=int(d.get("prompt_tokens", 0)),
            generated_tokens=int(d.get("generated_tokens", 0)),
            priority=int(d.get("priority", 1)),
            instances=tuple(d.get("instances") or ()),
        )
        if d.get("ttft_s") is not None:
            a.ttft_s = float(d["ttft_s"])
        if d.get("itl_s") is not None:
            a.itl_s = float(d["itl_s"])
        return a

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "components": {k: round(v, 6) for k, v in self.components.items()},
            "edge_latency_s": round(self.edge_latency_s, 6),
            "ttft_s": round(self.ttft_s, 6) if self.ttft_s is not None else None,
            "itl_s": round(self.itl_s, 6) if self.itl_s is not None else None,
            "chip_seconds": round(self.chip_seconds, 6),
            "kv_page_seconds": round(self.kv_page_seconds, 6),
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "priority": self.priority,
            "dominant": self.dominant,
            "instances": list(self.instances),
        }


def _empty_components() -> dict[str, float]:
    return dict.fromkeys(COMPONENTS, 0.0)


def _sweep_claims(
    t0: float, t1: float, claims: list[tuple[float, float, str, int]]
) -> dict[str, float]:
    """Assign every instant of [t0, t1] to the highest-priority claim
    covering it (seconds per component; unclaimed time is dropped —
    the caller books it as ``other``). Pure and deterministic: ties on
    priority break by claim insertion order."""
    comp = _empty_components()
    points = sorted(
        {t0, t1}
        | {max(min(s, t1), t0) for s, _e, _c, _p in claims}
        | {max(min(e, t1), t0) for _s, e, _c, _p in claims}
    )
    for a, b in zip(points, points[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2.0
        best = None
        for s, e, c, p in claims:
            if s <= mid < e and (best is None or p > best[1]):
                best = (c, p)
        if best is not None:
            comp[best[0]] += b - a
    return comp


def anatomy_from_spans(spans) -> RequestAnatomy | None:
    """Decompose one trace's spans (``telemetry.timeline.find_trace``
    output) into a :class:`RequestAnatomy`.

    The root interval is the ``http_request`` span when present (edge
    latency), else the trace's overall extent. Component sum equals the
    root duration exactly: the sweep partitions it, carve-outs
    (host gap / compile stall / swap stall) move time *between*
    components, and the unclaimed remainder books as ``other``."""
    if not spans:
        return None
    root = next((s for s in spans if s.stage == "http_request"), None)
    t0 = root.start if root is not None else min(s.start for s in spans)
    t1 = root.end if root is not None else max(s.end for s in spans)
    edge = max(t1 - t0, 0.0)

    claims: list[tuple[float, float, str, int]] = []
    prefill_spans, decode_spans = [], []
    for s in spans:
        claim = _STAGE_CLAIMS.get(s.stage)
        if claim is not None:
            claims.append((s.start, s.end, claim[0], claim[1]))
        if s.stage == "prefill":
            prefill_spans.append(s)
        elif s.stage == "decode":
            decode_spans.append(s)

    comp = _sweep_claims(t0, t1, claims)
    comp["other"] = max(edge - sum(comp.values()), 0.0)

    # Carve-outs: analytic splits *within* a swept component, so the
    # total is preserved by construction.
    compile_s = sum(
        float(s.attrs.get("compile_s", 0.0) or 0.0) for s in prefill_spans
    )
    compile_s = min(compile_s, comp["prefill_compute"])
    comp["prefill_compute"] -= compile_s
    comp["compile_stall"] += compile_s

    swap_s = sum(
        float(s.attrs.get("swap_stall_s", 0.0) or 0.0) for s in decode_spans
    )
    swap_s = min(swap_s, comp["decode_compute"])
    comp["decode_compute"] -= swap_s
    comp["swap_stall"] += swap_s

    # Host gap: the dispatch profiler's median per-dispatch gap vs
    # in-flight split, applied as a fraction of the remaining decode
    # compute (gap and in-flight time partition a decode window's
    # wall time, telemetry/dispatch.py).
    gap_frac = 0.0
    for s in decode_spans:
        d = float(s.attrs.get("dispatch_p50_s", 0.0) or 0.0)
        g = float(s.attrs.get("host_gap_p50_s", 0.0) or 0.0)
        if d + g > 0:
            gap_frac = g / (d + g)
            break
    gap_s = comp["decode_compute"] * gap_frac
    comp["decode_compute"] -= gap_s
    comp["host_gap"] += gap_s

    a = RequestAnatomy(
        components={k: round(v, 6) for k, v in comp.items()},
        edge_latency_s=round(edge, 6),
    )
    if root is not None:
        a.request_id = str(root.attrs.get("request_id", ""))
        for key, attr in (("ttft_s", "ttft_s"), ("itl_s", "itl_s")):
            v = root.attrs.get(attr)
            if v is not None:
                setattr(a, key, float(v))
    a.trace_id = spans[0].trace_id
    if a.ttft_s is None and prefill_spans and root is not None:
        a.ttft_s = round(
            max(max(s.end for s in prefill_spans) - t0, 0.0), 6
        )
    for s in prefill_spans:
        a.prompt_tokens = max(a.prompt_tokens, int(s.attrs.get("prompt_tokens", 0) or 0))
    pages = 0
    for s in decode_spans:
        a.generated_tokens += int(s.attrs.get("generated_tokens", 0) or 0)
        pages = max(pages, int(s.attrs.get("pages", 0) or 0))
        if "priority" in s.attrs:
            a.priority = int(s.attrs["priority"])
    a.instances = tuple(
        sorted({str(s.attrs["instance"]) for s in spans if s.attrs.get("instance")})
    )
    compute = (
        comp["prefill_compute"] + comp["compile_stall"]
        + comp["decode_compute"] + comp["host_gap"]
    )
    a.chip_seconds = round(compute, 6)
    a.kv_page_seconds = round(pages * compute, 6)
    return a


def anatomy_from_timing(
    request_id: str,
    *,
    queue_s: float,
    prefill_s: float,
    decode_s: float,
    compile_s: float,
    swap_s: float,
    preempt_s: float,
    gap_frac: float,
    edge_latency_s: float,
    ttft_s: float | None = None,
    itl_s: float | None = None,
    prompt_tokens: int = 0,
    generated_tokens: int = 0,
    priority: int = 1,
    page_seconds: float = 0.0,
) -> RequestAnatomy:
    """Engine-side assembly from the loop's per-sequence accumulators
    (pure arithmetic; the caller stamps all times). ``gap_frac`` is the
    profiler's host-gap share of a decode dispatch interval;
    ``compile_s`` / ``swap_s`` are clamped into their parent
    components so the sum stays exact."""
    comp = _empty_components()
    comp["queue_wait"] = max(queue_s, 0.0)
    compile_c = min(max(compile_s, 0.0), max(prefill_s, 0.0))
    comp["compile_stall"] = compile_c
    comp["prefill_compute"] = max(prefill_s, 0.0) - compile_c
    swap_c = min(max(swap_s, 0.0), max(decode_s, 0.0))
    comp["swap_stall"] = swap_c
    decode_c = max(decode_s, 0.0) - swap_c
    gap = decode_c * min(max(gap_frac, 0.0), 1.0)
    comp["host_gap"] = gap
    comp["decode_compute"] = decode_c - gap
    comp["preemption"] = max(preempt_s, 0.0)
    comp["other"] = max(edge_latency_s - sum(comp.values()), 0.0)
    compute = (
        comp["prefill_compute"] + comp["compile_stall"]
        + comp["decode_compute"] + comp["host_gap"]
    )
    return RequestAnatomy(
        request_id=request_id,
        components={k: round(v, 6) for k, v in comp.items()},
        edge_latency_s=round(max(edge_latency_s, 0.0), 6),
        ttft_s=ttft_s,
        itl_s=itl_s,
        chip_seconds=round(compute, 6),
        kv_page_seconds=round(page_seconds, 6),
        prompt_tokens=prompt_tokens,
        generated_tokens=generated_tokens,
        priority=priority,
    )


def anatomy_from_flight(block: dict, request_id: str | None = None) -> list[RequestAnatomy]:
    """Reconstruct per-request anatomies from one flight-dump block
    (``telemetry.flight.load_dumps`` output) — the engine's ring alone,
    no span file needed. The ``admit`` / ``first_token`` / ``preempt``
    / ``stall_start`` / ``stall_end`` / ``finish`` events replay
    through a per-request state machine; requests whose admit or finish
    fell off the ring are skipped (a bounded ring can only explain what
    it still holds)."""
    events = sorted(block.get("events") or [], key=lambda e: (e.get("t", 0.0), e.get("seq", 0)))
    state: dict[str, dict] = {}
    out: list[RequestAnatomy] = []
    for ev in events:
        req = ev.get("req")
        if req is None or (request_id is not None and req != request_id):
            continue
        kind = ev.get("kind")
        t = float(ev.get("t", 0.0))
        st = state.get(req)
        if kind == "admit":
            if st is None:
                st = state[req] = {
                    "t_admit": t, "queue": 0.0, "prefill": 0.0,
                    "decode": 0.0, "stall": 0.0, "preempt": 0.0,
                    "t_mark": t, "phase": "prefill", "stall_since": 0.0,
                    "prompt": int(ev.get("prompt", 0) or 0),
                    "cached": int(ev.get("cached", 0) or 0),
                    "priority": int(ev.get("priority", 1) or 1),
                }
            else:  # re-admission after preemption
                st["preempt"] += max(t - st["t_mark"], 0.0)
                st["t_mark"] = t
                st["phase"] = "prefill"
        elif st is None:
            continue
        elif kind == "first_token":
            st["prefill"] += max(t - st["t_mark"], 0.0)
            st["t_mark"] = t
            st["phase"] = "decode"
        elif kind == "preempt":
            st[st["phase"]] += max(t - st["t_mark"], 0.0)
            st["t_mark"] = t
            st["phase"] = "preempt"
        elif kind == "stall_start":
            st["stall_since"] = t
        elif kind == "stall_end":
            if st["stall_since"]:
                st["stall"] += max(t - st["stall_since"], 0.0)
                st["stall_since"] = 0.0
        elif kind == "finish":
            st[st["phase"]] += max(t - st["t_mark"], 0.0)
            edge = max(t - st["t_admit"], 0.0)
            a = anatomy_from_timing(
                str(req),
                queue_s=0.0,  # submission isn't a ring event
                prefill_s=st["prefill"],
                decode_s=st["decode"],
                compile_s=0.0,
                swap_s=min(st["stall"], st["decode"]),
                preempt_s=st["preempt"],
                gap_frac=0.0,
                edge_latency_s=edge,
                prompt_tokens=st["prompt"],
                generated_tokens=int(ev.get("generated", 0) or 0),
                priority=int(ev.get("priority", st["priority"]) or 1),
                page_seconds=float(ev.get("pages", 0) or 0) * edge,
            )
            out.append(a)
            state.pop(req, None)
    return out


class AnatomyRing:
    """Bounded worst-N exemplar ring: the slowest requests (by edge
    latency) retain their full anatomy, so the p99 offenders are
    explainable after the fact without a span file. Thread-safe —
    ``offer`` runs on the engine loop while ``metrics()`` snapshots
    from serving threads."""

    def __init__(self, capacity: int = 16):
        self.capacity = max(capacity, 1)
        self._lock = threading.Lock()
        self._worst: list[RequestAnatomy] = []

    def offer(self, anatomy: RequestAnatomy) -> None:
        with self._lock:
            self._worst.append(anatomy)
            self._worst.sort(key=lambda a: -a.edge_latency_s)
            del self._worst[self.capacity:]

    def snapshot(self) -> list[dict]:
        """Worst-first compact dicts (the ``anatomy_slow`` mirror)."""
        with self._lock:
            return [a.to_dict() for a in self._worst]


# ---------------------------------------------------------------- rendering
def _fmt_priority(p) -> str:
    return PRIORITY_NAMES.get(p, str(p))


def render_anatomy(a: RequestAnatomy, width: int = 30) -> str:
    """The ``--why`` waterfall: every component with its share bar, the
    dominant one named up top, cost footer below."""
    total = max(a.edge_latency_s, a.total_s, 1e-9)
    head = (
        f"request {a.request_id or a.trace_id or '?'} — "
        f"{a.edge_latency_s * 1e3:.1f}ms edge latency, dominant: "
        f"{a.dominant} "
        f"({a.components.get(a.dominant, 0.0) / total:.0%})"
    )
    if len(a.instances) > 1:
        head += f" [across {len(a.instances)} instances]"
    lines = [head]
    for c in COMPONENTS:
        v = a.components.get(c, 0.0)
        frac = v / total
        bar = "#" * max(int(round(frac * width)), 1 if v > 0 else 0)
        lines.append(
            f"  {c:<16} {v * 1e3:9.1f}ms {frac:5.0%} |{bar:<{width}}|"
        )
    foot = (
        f"  chip-seconds {a.chip_seconds:.3f}, kv-page-seconds "
        f"{a.kv_page_seconds:.3f}, prompt {a.prompt_tokens}, generated "
        f"{a.generated_tokens}, priority {_fmt_priority(a.priority)}"
    )
    if a.ttft_s is not None:
        foot += f", ttft {a.ttft_s * 1e3:.1f}ms"
    if a.itl_s is not None:
        foot += f", itl {a.itl_s * 1e3:.2f}ms"
    lines.append(foot)
    return "\n".join(lines)


def render_slow(anatomies: list[RequestAnatomy], n: int = 10, by: str = "edge") -> str:
    """The ``llmctl slow`` listing: worst-N offenders by edge latency,
    TTFT, or ITL, one line each with the dominant component named."""
    keys = {
        "edge": lambda a: a.edge_latency_s,
        "ttft": lambda a: a.ttft_s or 0.0,
        "itl": lambda a: a.itl_s or 0.0,
    }
    key = keys.get(by, keys["edge"])
    rows = sorted(anatomies, key=lambda a: -key(a))[:n]
    if not rows:
        return "no requests with anatomy"
    lines = [
        f"slowest {len(rows)} request(s) by {by}:",
        f"  {'request':<28} {'edge':>9} {'ttft':>9} {'itl':>9}  dominant",
    ]
    for a in rows:
        ttft = f"{a.ttft_s * 1e3:.1f}ms" if a.ttft_s is not None else "-"
        itl = f"{a.itl_s * 1e3:.2f}ms" if a.itl_s is not None else "-"
        lines.append(
            f"  {(a.request_id or a.trace_id or '?')[:28]:<28} "
            f"{a.edge_latency_s * 1e3:8.1f}ms {ttft:>9} {itl:>9}  "
            f"{a.dominant}"
        )
    return "\n".join(lines)
