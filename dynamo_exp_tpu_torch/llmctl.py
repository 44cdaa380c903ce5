"""llmctl: the operator's CLI of the port.

Counterpart of ``dynamo_exp_tpu/llmctl.py``, with its parser and its
output, over the port's planes:

- the live control plane (``--coordinator HOST:PORT``): model
  registrations (``http add|list|remove``), the disaggregation router's
  config (``disagg get|set``), ``drain`` and ``reclaim`` notices, the
  fleet dashboard (``top``) and the live exemplar rings (``slow``);
- offline files: a span file's traces (``trace [--why]``), its slowest
  requests (``slow --trace-file``), a workload fingerprint (``fingerprint``,
  ``--json``, ``--ref``, ``--replay-out``), a flight dump (``flight
  [--why]``) and its KV audit (``audit``), and two bench captures
  (``bench compare``).

    python -m dynamo_exp_tpu_torch.llmctl --coordinator HOST:PORT http list
    python -m dynamo_exp_tpu_torch.llmctl trace <id> --trace-file spans.jsonl --why

``lint``, ``sim``, ``aot`` and ``tune`` exit non-zero naming the ROADMAP
item that ports them, as ``run.py`` refuses what it lacks. Entries
added by ``http add`` are not lease-scoped: they stand for the
operator's intent and stay until removed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys

from .local_model import MDC_BUCKET, MODELS_PREFIX, ModelEntry

_TYPES = {"chat-model": "chat", "completion-model": "completion", "model": "both"}
# Subcommands of the JAX CLI whose modules the port lacks, by the ROADMAP
# item that brings them.
NOT_PORTED = {
    "lint": "ROADMAP Queue 1 entry 8 (analysis/, dynlint)",
    "sim": "ROADMAP Queue 1 entry 8 (sim/, the cluster simulator)",
    "aot": "ROADMAP Queue 1 entry 8 (the rest of llmctl: aot compile|list|warm|smoke)",
    "tune": "ROADMAP Queue 1 entry 8 (tune/, the autotuner)",
}


def _slug(name: str) -> str:
    return name.replace("/", "--")


async def add_model(drt, args) -> int:
    entry = ModelEntry(
        name=args.model_name,
        endpoint=_qualify(args.endpoint_name, args.namespace),
        model_type=_TYPES[args.model_type],
        mdc_key=_slug(args.model_name),
    )
    if args.model_path:
        from .model_card import ModelDeploymentCard

        mdc = ModelDeploymentCard.from_local_path(
            args.model_path, args.model_name
        )
        await drt.object_store.put(
            MDC_BUCKET, entry.mdc_key, mdc.to_json().encode()
        )
    # Key carries the model type so chat + completion registrations of
    # one name coexist (and remove stays type-scoped).
    key = (
        f"{MODELS_PREFIX}{_slug(args.model_name)}/llmctl-{entry.model_type}"
    )
    await drt.discovery.kv_put(key, entry.to_bytes())
    print(f"added {entry.model_type} model {entry.name} -> {entry.endpoint}")
    return 0


async def list_models(drt, args) -> int:
    entries = await drt.discovery.kv_get_prefix(MODELS_PREFIX)
    want = _TYPES.get(args.model_type or "model", "both")
    rows = []
    for key, raw in sorted(entries.items()):
        try:
            e = ModelEntry.from_bytes(raw)
        except (ValueError, TypeError, KeyError):
            continue
        if want != "both" and e.model_type not in (want, "both"):
            continue
        rows.append((e.name, e.model_type, e.endpoint, key.rsplit("/", 1)[-1]))
    if args.json:
        print(json.dumps([
            {"name": n, "type": t, "endpoint": ep, "owner": o}
            for n, t, ep, o in rows
        ]))
        return 0
    if not rows:
        print("no models registered")
        return 0
    width = max(len(r[0]) for r in rows)
    for name, mtype, ep, owner in rows:
        print(f"{name:<{width}}  {mtype:<10}  {ep}  ({owner})")
    return 0


async def remove_model(drt, args) -> int:
    """Remove registrations of the given type only — a model registered
    as both chat and completion under one name keeps the other entry
    (type-scoped, as in the JAX package's llmctl)."""
    want = _TYPES.get(args.model_type or "model", "both")
    prefix = f"{MODELS_PREFIX}{_slug(args.model_name)}/"
    entries = await drt.discovery.kv_get_prefix(prefix)
    removed = 0
    for key, raw in entries.items():
        try:
            e = ModelEntry.from_bytes(raw)
        except (ValueError, TypeError, KeyError):
            # Undecodable entries are unreachable by type-scoped remove;
            # the untyped 'model' remove is the escape hatch that clears
            # them (otherwise garbage keys would be undeletable forever).
            if want == "both":
                await drt.discovery.kv_delete(key)
                removed += 1
            continue
        if want != "both" and e.model_type not in (want, "both"):
            continue
        await drt.discovery.kv_delete(key)
        removed += 1
    if not removed:
        print(f"no {args.model_type} registration for {args.model_name}",
              file=sys.stderr)
        return 1
    print(f"removed {removed} registration(s) for {args.model_name}")
    return 0


def _qualify(endpoint: str, namespace: str) -> str:
    """component.endpoint or namespace.component.endpoint → dyn:// URL."""
    if endpoint.startswith("dyn://"):
        endpoint = endpoint[len("dyn://") :]
    parts = endpoint.split(".")
    if len(parts) == 2:
        parts = [namespace, *parts]
    if len(parts) != 3:
        raise SystemExit(
            f"endpoint must be [ns.]component.endpoint, got {endpoint!r}"
        )
    return "dyn://" + ".".join(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llmctl", description=__doc__)
    # Required for the control-plane planes; ``trace`` works offline
    # from recorder files (validated in run()).
    p.add_argument("--coordinator", default="", help="control plane host:port")
    p.add_argument("-n", "--namespace", default="dynamo")
    sub = p.add_subparsers(dest="plane", required=True)
    http = sub.add_parser("http", help="HTTP-served model registrations")
    hsub = http.add_subparsers(dest="command", required=True)

    add = hsub.add_parser("add")
    add.add_argument("model_type", choices=sorted(_TYPES))
    add.add_argument("model_name")
    add.add_argument("endpoint_name")
    add.add_argument("--model-path", default="", help="publish an MDC too")

    lst = hsub.add_parser("list")
    lst.add_argument("model_type", nargs="?", choices=sorted(_TYPES))
    lst.add_argument("--json", action="store_true")

    rm = hsub.add_parser("remove")
    rm.add_argument("model_type", choices=sorted(_TYPES))
    rm.add_argument("model_name")

    # Live disagg-router reconfiguration (disagg/config.py: the config
    # key every decode worker watches). ``set`` takes effect on running
    # decode workers within one watch push — no restarts.
    disagg = sub.add_parser(
        "disagg", help="conditional disagg-router config (live-watched)"
    )
    dsub = disagg.add_subparsers(dest="command", required=True)
    dget = dsub.add_parser("get")
    dget.add_argument("model_name")
    dset = dsub.add_parser("set")
    dset.add_argument("model_name")
    dset.add_argument("--max-local-prefill-length", type=int, required=True)
    dset.add_argument("--max-prefill-queue-size", type=int, default=2)

    # Graceful drain: publish drain intent for an instance. The serving
    # process watches the drain prefix, republishes itself with
    # ``draining`` metadata (routers stop sending new work on their next
    # discovery snapshot), and finishes in-flight requests.
    drain = sub.add_parser(
        "drain", help="gracefully drain a worker instance (stop new work)"
    )
    drain.add_argument("instance_id", type=int)

    # Spot-reclamation notice: like drain, but with a hard deadline the
    # worker's ReclaimController triages under — live KV migration for
    # what fits, journal failover for the rest
    # (docs/fault_tolerance.md "Spot reclamation & live migration").
    reclaim = sub.add_parser(
        "reclaim",
        help="send a reclaim notice (deadline-bounded drain + live KV "
        "migration) to a worker instance",
    )
    reclaim.add_argument("instance_id", type=int)
    reclaim.add_argument(
        "--grace-s",
        type=float,
        default=30.0,
        help="grace window in seconds before the instance is killed "
        "(default 30)",
    )

    # Offline trace reconstruction from the telemetry recorder JSONL
    # (``DYN_TRACE_FILE``): no argument lists recorded traces; with a
    # trace_id (full/prefix) or request id, pretty-prints its span tree.
    trace = sub.add_parser(
        "trace", help="reconstruct a request's span timeline from recorder JSONL"
    )
    trace.add_argument(
        "trace_id", nargs="?", default="",
        help="trace id (full or prefix) or request id; omit to list traces",
    )
    trace.add_argument(
        "--trace-file", action="append", default=None,
        help="recorder JSONL path(s); defaults to $DYN_TRACE_FILE "
             "(rotated generations are read automatically)",
    )
    trace.add_argument(
        "--why", action="store_true",
        help="decompose the trace into latency components (request "
             "anatomy waterfall) instead of the raw span timeline",
    )

    # Worst-N request listing (docs/observability.md "Request
    # anatomy"): offline over a recorder span file, or live from every
    # instance's bounded exemplar ring via the coordinator.
    slow = sub.add_parser(
        "slow", help="list the slowest requests with their dominant "
                     "latency component",
    )
    slow.add_argument(
        "--trace-file", action="append", default=None,
        help="recorder JSONL path(s) for offline mode; defaults to "
             "$DYN_TRACE_FILE; omit (and pass --coordinator) to scrape "
             "the live fleet's exemplar rings",
    )
    slow.add_argument("-n", "--count", type=int, default=10)
    slow.add_argument(
        "--by", choices=("edge", "ttft", "itl"), default="edge",
        help="sort key (default: edge latency)",
    )
    slow.add_argument(
        "--why", action="store_true",
        help="print the full anatomy waterfall per request, not just "
             "the one-line summary",
    )

    # Workload fingerprint (docs/observability.md "Workload
    # fingerprint"): characterize a recorded workload — span file, sim
    # trace, or bench capture — as a deterministic hashable digest,
    # optionally diffing against a pinned reference or replaying it
    # into a sim workload trace.
    fprint = sub.add_parser(
        "fingerprint", help="characterize a workload from spans / trace "
                            "/ bench files (offline)",
    )
    fprint.add_argument(
        "path", help="span JSONL, sim workload trace, bench capture, or "
                     "a saved fingerprint JSON",
    )
    fprint.add_argument(
        "--kind", choices=("auto", "spans", "trace", "bench", "ref"),
        default="auto",
        help="input format (default: sniff from content)",
    )
    fprint.add_argument("--json", action="store_true",
                        help="print the full fingerprint as JSON")
    fprint.add_argument(
        "--out", default="",
        help="also write the fingerprint JSON here (pin it via "
             "DYN_WORKLOAD_REF for the live drift watch)",
    )
    fprint.add_argument(
        "--ref", default="",
        help="reference fingerprint JSON to score drift against",
    )
    fprint.add_argument(
        "--replay-out", default="",
        help="write a sim workload trace drawn from the fingerprint "
             "(the fingerprint->sim bridge; replay with "
             "`llmctl sim users --trace-in FILE`)",
    )
    fprint.add_argument("--seed", type=int, default=0,
                        help="seed for --replay-out draws")
    fprint.add_argument(
        "--requests", type=int, default=None,
        help="request count for --replay-out (default: the "
             "fingerprint's own n)",
    )

    # Offline flight-dump rendering (docs/observability.md "Engine
    # flight recorder & watchdog"): a dump file holds one block per
    # dump (watchdog stall / SIGUSR1 / crash); render a block as a
    # per-slot timeline the way `trace` renders spans.
    flight = sub.add_parser(
        "flight", help="render an engine flight-recorder dump (offline)"
    )
    flight.add_argument("dump_file", help="flight dump JSONL path")
    flight.add_argument(
        "--index", type=int, default=-1,
        help="which dump block to render (default: the last)",
    )
    flight.add_argument(
        "--list", action="store_true",
        help="list the file's dump blocks instead of rendering one",
    )
    flight.add_argument(
        "--why", action="store_true",
        help="reconstruct per-request latency anatomy from the dump's "
             "admit/first_token/preempt/stall/finish events",
    )
    flight.add_argument(
        "--req", default="",
        help="with --why: only the given request id",
    )

    # Live fleet dashboard (docs/observability.md "Fleet plane"):
    # scrape every discovered instance's stats plane into one rolled-up
    # view — per-instance occupancy, queue depth, shed/preempt rates,
    # per-link transfer MB/s — tolerant of dead/draining members.
    top = sub.add_parser(
        "top", help="live fleet dashboard (per-instance + per-link rollup)"
    )
    top.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh interval in seconds",
    )
    top.add_argument(
        "--once", action="store_true",
        help="print one snapshot and exit (no refresh loop)",
    )
    top.add_argument(
        "--json", action="store_true",
        help="print one machine-readable snapshot (rollup + per-"
             "instance views) and exit; implies --once",
    )

    # Offline KV conservation audit rendering (docs/observability.md
    # "KV conservation auditor"): flight dumps carry the full named
    # audit (every page classified, refcounts cross-checked against
    # live sequences/leases); render the verdict and name the leaker.
    audit = sub.add_parser(
        "audit", help="render the KV conservation audit from a flight dump"
    )
    audit.add_argument("dump_file", help="flight dump JSONL path")
    audit.add_argument(
        "--index", type=int, default=-1,
        help="which dump block to audit (default: the last)",
    )

    # Offline bench regression comparator (docs/observability.md "Fleet
    # plane"): compare two bench captures (raw bench.py JSONL or the
    # checked-in BENCH_r*.json wrappers) and flag >threshold tok/s or
    # TTFT/ITL regressions per metric, platform-tag aware. The
    # pre-merge CI step runs it over the checked-in trajectory.
    bench = sub.add_parser(
        "bench", help="bench trajectory tools (offline)"
    )
    bsub = bench.add_subparsers(dest="command", required=True)
    bcmp = bsub.add_parser("compare")
    bcmp.add_argument("old_file", help="baseline bench capture")
    bcmp.add_argument("new_file", help="candidate bench capture")
    bcmp.add_argument(
        "--threshold", type=float, default=0.10,
        help="regression threshold as a fraction (default 0.10 = 10%%)",
    )

    # Planes whose modules the port lacks: the subcommand parses
    # anything and run() refuses it, naming the item that ports it.
    for name, item in NOT_PORTED.items():
        refused = sub.add_parser(name, help=f"not ported yet ({item})")
        refused.add_argument("args", nargs=argparse.REMAINDER)
    return p


def run_trace(args) -> int:
    import os

    from .telemetry import find_trace, list_traces, load_spans, render_timeline

    paths = args.trace_file or (
        [os.environ["DYN_TRACE_FILE"]] if os.environ.get("DYN_TRACE_FILE") else []
    )
    if not paths:
        print(
            "no trace files: pass --trace-file or set DYN_TRACE_FILE",
            file=sys.stderr,
        )
        return 2
    spans = load_spans(paths)
    if not spans:
        print("no spans recorded", file=sys.stderr)
        return 1
    if not args.trace_id:
        for tid, n, dur, stage in list_traces(spans):
            print(f"{tid}  {n:3d} spans  {dur * 1e3:9.1f}ms  {stage}")
        return 0
    group = find_trace(spans, args.trace_id)
    if not group:
        print(f"no trace matching {args.trace_id!r}", file=sys.stderr)
        return 1
    if getattr(args, "why", False):
        from .telemetry import anatomy_from_spans, render_anatomy

        anatomy = anatomy_from_spans(group)
        if anatomy is None:
            print("trace has no decomposable spans", file=sys.stderr)
            return 1
        print(render_anatomy(anatomy))
        return 0
    print(render_timeline(group))
    return 0


def _resolve_trace_paths(args) -> list[str]:
    import os

    return args.trace_file or (
        [os.environ["DYN_TRACE_FILE"]]
        if os.environ.get("DYN_TRACE_FILE")
        else []
    )


def run_slow_offline(args) -> int:
    """`llmctl slow` over a recorder span file: decompose every trace
    and list the worst offenders by the chosen latency axis."""
    from .telemetry import (
        anatomy_from_spans,
        load_spans,
        render_anatomy,
        render_slow,
    )

    paths = _resolve_trace_paths(args)
    if not paths:
        print(
            "no trace files: pass --trace-file / set DYN_TRACE_FILE, or "
            "pass --coordinator to scrape the live fleet",
            file=sys.stderr,
        )
        return 2
    spans = load_spans(paths)
    by_trace: dict[str, list] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    anatomies = [
        a
        for tid in sorted(by_trace)
        if (a := anatomy_from_spans(by_trace[tid])) is not None
    ]
    if not anatomies:
        print("no spans recorded", file=sys.stderr)
        return 1
    print(render_slow(anatomies, n=args.count, by=args.by))
    if args.why:
        keys = {"edge": lambda a: a.edge_latency_s,
                "ttft": lambda a: a.ttft_s or 0.0,
                "itl": lambda a: a.itl_s or 0.0}
        worst = sorted(anatomies, key=lambda a: -keys[args.by](a))
        for a in worst[: args.count]:
            print()
            print(render_anatomy(a))
    return 0


async def run_slow_live(drt, args) -> int:
    """`llmctl slow` against a live fleet: collect every instance's
    bounded worst-N exemplar ring (``metrics()["anatomy_slow"]``)."""
    import asyncio

    from .telemetry import RequestAnatomy, render_anatomy, render_slow

    try:
        instances = await drt.discovery.list_instances("")
    except Exception as e:  # noqa: BLE001 - no discovery = nothing to list
        print(f"discovery unavailable: {e}", file=sys.stderr)
        return 1

    async def one(info) -> object:
        try:
            return await asyncio.wait_for(
                drt.request_plane.scrape_stats(info), 5.0
            )
        except Exception as e:  # noqa: BLE001 - dead member, skipped
            return e

    results = await asyncio.gather(*[one(i) for i in instances])
    anatomies: list[RequestAnatomy] = []
    for info, m in zip(instances, results):
        if not isinstance(m, dict):
            continue
        for entry in m.get("anatomy_slow") or []:
            if isinstance(entry, dict):
                a = RequestAnatomy.from_dict(entry)
                if not a.instances:
                    a.instances = (str(info.instance_id),)
                anatomies.append(a)
    if not anatomies:
        print("no request anatomy exemplars in the fleet yet")
        return 0
    print(render_slow(anatomies, n=args.count, by=args.by))
    if args.why:
        for a in sorted(anatomies, key=lambda x: -x.edge_latency_s)[: args.count]:
            print()
            print(render_anatomy(a))
    return 0


def run_fingerprint(args) -> int:
    """`llmctl fingerprint`: characterize a recorded workload. Sniffs
    the input format unless --kind pins it, prints the digest +
    distribution summary, and optionally pins/diffs/replays it."""
    from .telemetry import (
        drift_score,
        fingerprint_from_bench,
        fingerprint_from_spans,
        fingerprint_from_trace,
        load_fingerprint,
        load_spans,
        render_fingerprint,
    )

    kind = args.kind
    if kind == "auto":
        kind = _sniff_fingerprint_kind(args.path)
        if kind is None:
            print(
                f"cannot tell what {args.path!r} is — pass --kind",
                file=sys.stderr,
            )
            return 2
    try:
        if kind == "spans":
            fp = fingerprint_from_spans(load_spans([args.path]))
        elif kind == "trace":
            fp = fingerprint_from_trace(args.path)
        elif kind == "bench":
            fp = fingerprint_from_bench(args.path)
        else:
            fp = load_fingerprint(args.path)
    except OSError as e:
        print(f"cannot read {args.path!r}: {e}", file=sys.stderr)
        return 2
    if fp.n == 0:
        print(f"no requests found in {args.path!r} (kind={kind})",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(fp.to_dict(), indent=2))
    else:
        print(render_fingerprint(fp))
    if args.ref:
        ref = load_fingerprint(args.ref)
        print(f"drift vs {args.ref}: {drift_score(fp, ref):.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(fp.to_dict(), f, indent=2)
        print(f"# fingerprint -> {args.out}", file=sys.stderr)
    if args.replay_out:
        from .sim.workload import save_trace
        from .telemetry import replay_workload

        reqs = replay_workload(fp, seed=args.seed, n=args.requests)
        n = save_trace(args.replay_out, reqs)
        print(f"# {n} replayed requests -> {args.replay_out}",
              file=sys.stderr)
    return 0


def _sniff_fingerprint_kind(path: str) -> str | None:
    """Guess a fingerprint input's format from its first record."""
    head = ""
    try:
        with open(path) as f:
            head = f.read(65536).strip()
    except OSError:
        pass
    if not head:
        # A shared DYN_TRACE_FILE records to per-process/rotated
        # siblings (path.pidN, path.N) that load_spans expands —
        # sniff the first sibling so the operator can point at the
        # configured path verbatim.
        import glob as _glob

        sib_re = re.compile(r"^(\.pid\d+)?(\.\d+)*$")
        for cand in sorted(_glob.glob(path + ".*")):
            if sib_re.fullmatch(cand[len(path):]):
                try:
                    with open(cand) as f:
                        head = f.read(65536).strip()
                except OSError:
                    continue
                if head:
                    break
    if not head:
        return None
    first = head.splitlines()[0].strip()
    try:
        obj = json.loads(first)
    except ValueError:
        # Multi-line JSON document (a saved fingerprint or a bench
        # wrapper written with indent).
        try:
            obj = json.loads(head)
        except ValueError:
            return None
    if not isinstance(obj, dict):
        return None
    if "isl_hist" in obj:
        return "ref"
    # Recorder lines wrap the span event: {"ts": ..., "event": {...}}.
    ev = obj.get("event")
    if isinstance(ev, dict) and ev.get("type") == "span":
        return "spans"
    if "stage" in obj and "trace_id" in obj:
        return "spans"
    if "arrival_s" in obj and "prompt_len" in obj:
        return "trace"
    if "metric" in obj or "tail" in obj or "parsed" in obj:
        return "bench"
    return None


def run_flight(args) -> int:
    import os

    from .telemetry import load_dumps, render_flight

    if not os.path.exists(args.dump_file):
        print(f"no such dump file: {args.dump_file}", file=sys.stderr)
        return 2
    blocks = load_dumps(args.dump_file)
    if not blocks:
        print("no flight dumps in file", file=sys.stderr)
        return 1
    if args.list:
        for i, b in enumerate(blocks):
            h = b["header"]
            print(
                f"{i}  reason={h.get('reason', '?')}  "
                f"{len(b['events'])} events  pid={h.get('pid', '?')}"
            )
        return 0
    try:
        block = blocks[args.index]
    except IndexError:
        print(
            f"dump index {args.index} out of range ({len(blocks)} blocks)",
            file=sys.stderr,
        )
        return 1
    if getattr(args, "why", False):
        from .telemetry import anatomy_from_flight, render_anatomy

        anatomies = anatomy_from_flight(block, args.req or None)
        if not anatomies:
            print(
                "no complete request (admit..finish) in this dump block",
                file=sys.stderr,
            )
            return 1
        for i, a in enumerate(anatomies):
            if i:
                print()
            print(render_anatomy(a))
        return 0
    print(render_flight(block))
    return 0


def run_audit(args) -> int:
    """Render the KV conservation audit carried by a flight dump's
    snapshot: the per-state page counts, the verdict, and — on a
    violation — the leaking page with the holder(s) that still claim
    it (``seq:<request_id>`` / ``lease:<id>``)."""
    import os

    from .telemetry import load_dumps

    if not os.path.exists(args.dump_file):
        print(f"no such dump file: {args.dump_file}", file=sys.stderr)
        return 2
    blocks = load_dumps(args.dump_file)
    if not blocks:
        print("no flight dumps in file", file=sys.stderr)
        return 1
    try:
        block = blocks[args.index]
    except IndexError:
        print(
            f"dump index {args.index} out of range ({len(blocks)} blocks)",
            file=sys.stderr,
        )
        return 1
    header = block.get("header", {})
    audit = (block.get("snapshot") or {}).get("kv_audit")
    if not isinstance(audit, dict):
        print(
            "dump carries no kv_audit snapshot (engine predates the "
            "conservation auditor, or the snapshot failed)",
            file=sys.stderr,
        )
        return 1
    counts = audit.get("counts", {})
    print(
        f"kv audit — reason={header.get('reason', '?')} "
        f"pool={audit.get('pool', '?')} leases={audit.get('leases', 0)}"
    )
    print(
        "  "
        + "  ".join(f"{k}={counts.get(k, 0)}" for k in sorted(counts))
        + f"  held={audit.get('held_pages', '?')}"
        f"  ref_total={audit.get('ref_total', '?')}"
    )
    # G3 persistent tier: present only in a dump of an engine that ran
    # with a store (the JAX engine's; the port has none yet), whose own
    # conservation arithmetic rides in the same snapshot.
    g3 = audit.get("g3")
    g3_violations: list[str] = []
    if isinstance(g3, dict):
        print(
            f"  g3 store: resident={g3.get('resident', 0)} "
            f"adopted={g3.get('adopted', 0)} stores={g3.get('stores', 0)} "
            f"evictions={g3.get('evictions', 0)} "
            f"quarantined={g3.get('quarantined', 0)} "
            f"checksum_failures={g3.get('checksum_failures', 0)} "
            f"degraded={g3.get('degraded', False)}"
        )
        g3_violations = list(g3.get("violations") or [])
    violations = audit.get("violations", [])
    if not violations and not g3_violations:
        print("  CONSERVED: every page accounted for, refcounts balance")
        return 0
    if violations:
        print(f"  {len(violations)} VIOLATION(S):")
        for v in violations:
            page = v.get("page")
            where = f"page {page}" if page is not None else "counters"
            holders = ", ".join(v.get("holders") or []) or "no live holder"
            print(
                f"    {where}: {v.get('kind')} — {v.get('detail')} [{holders}]"
            )
    if g3_violations:
        print(f"  {len(g3_violations)} G3 VIOLATION(S):")
        for s in g3_violations:
            print(f"    {s}")
    return 1


def run_bench_compare(args) -> int:
    import os

    from .telemetry.bench_compare import (
        compare_bench,
        load_bench_lines,
        render_compare,
    )

    for path in (args.old_file, args.new_file):
        if not os.path.exists(path):
            print(f"no such bench file: {path}", file=sys.stderr)
            return 2
    report = compare_bench(
        load_bench_lines(args.old_file),
        load_bench_lines(args.new_file),
        threshold=args.threshold,
    )
    print(render_compare(report, args.old_file, args.new_file))
    return 0 if report.ok else 1


async def run_top(drt, args) -> int:
    """Live fleet dashboard: scrape + render on an interval (`--once`
    prints a single snapshot for scripts and tests; `--json` prints the
    rollup + per-instance views machine-readably for scripting/CI)."""
    from dataclasses import asdict

    from .telemetry.fleet import FleetAggregator, render_top

    while True:
        view = await FleetAggregator.scrape_runtime(drt)
        if getattr(args, "json", False):
            print(
                json.dumps(
                    {
                        "rollup": view.rollup(),
                        "instances": {
                            name: asdict(m)
                            for name, m in sorted(view.members.items())
                        },
                        "missing": dict(view.missing),
                    },
                    indent=2,
                )
            )
            return 0
        body = render_top(view)
        if args.once:
            print(body)
            return 0
        # Cursor-home clear keeps the refresh loop flicker-free on a
        # bare terminal without a curses dependency.
        print("\x1b[2J\x1b[H" + body, flush=True)
        await asyncio.sleep(max(args.interval, 0.2))


async def drain_instance(drt, args) -> int:
    from .runtime.component import DRAIN_PREFIX

    live = {
        i.instance_id
        for i in await drt.discovery.list_instances("")
    }
    if args.instance_id not in live:
        print(f"instance {args.instance_id} is not live", file=sys.stderr)
        return 1
    await drt.discovery.kv_put(f"{DRAIN_PREFIX}{args.instance_id}", b"1")
    print(
        f"drain requested for instance {args.instance_id}; routers stop "
        "sending new work once the worker republishes its metadata"
    )
    return 0


async def reclaim_instance(drt, args) -> int:
    from .runtime.component import RECLAIM_PREFIX

    live = {
        i.instance_id
        for i in await drt.discovery.list_instances("")
    }
    if args.instance_id not in live:
        print(f"instance {args.instance_id} is not live", file=sys.stderr)
        return 1
    payload = json.dumps({"grace_s": args.grace_s}).encode()
    await drt.discovery.kv_put(
        f"{RECLAIM_PREFIX}{args.instance_id}", payload
    )
    print(
        f"reclaim notice sent to instance {args.instance_id} "
        f"(grace {args.grace_s:g}s); in-flight sequences triage into "
        "live migration or journal failover under the deadline"
    )
    return 0


async def get_disagg(drt, args) -> int:
    from .disagg.config import DisaggConfig, disagg_config_key

    raw = await drt.discovery.kv_get(disagg_config_key(args.model_name))
    cfg = DisaggConfig.from_bytes(raw) if raw else DisaggConfig()
    print(json.dumps({"model": args.model_name, **cfg.__dict__}, indent=2))
    return 0


async def set_disagg(drt, args) -> int:
    from .disagg.config import DisaggConfig, disagg_config_key

    cfg = DisaggConfig(
        max_local_prefill_length=args.max_local_prefill_length,
        max_prefill_queue_size=args.max_prefill_queue_size,
    )
    await drt.discovery.kv_put(disagg_config_key(args.model_name), cfg.to_bytes())
    print(f"disagg config for {args.model_name} updated: {cfg}")
    return 0


async def run(args) -> int:
    from .runtime.component import DistributedRuntime
    from .runtime.config import RuntimeConfig

    if args.plane in NOT_PORTED:
        print(f"llmctl {args.plane} is not ported to dynamo_exp_tpu_torch yet; "
              f"see {NOT_PORTED[args.plane]}", file=sys.stderr)
        return 2
    if args.plane == "trace":  # offline: reads recorder files, no cluster
        return run_trace(args)
    if args.plane == "flight":  # offline: reads flight dumps, no cluster
        return run_flight(args)
    if args.plane == "audit":  # offline: reads flight dumps, no cluster
        return run_audit(args)
    if args.plane == "bench":  # offline: reads bench captures, no cluster
        return run_bench_compare(args)
    if args.plane == "fingerprint":  # offline: reads recorded files
        return run_fingerprint(args)
    if args.plane == "slow" and not args.coordinator:
        # Offline over a span file; with --coordinator it scrapes the
        # fleet's exemplar rings below instead.
        return run_slow_offline(args)
    if not args.coordinator:
        print("--coordinator is required for this command", file=sys.stderr)
        return 2
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=args.coordinator))
    try:
        if args.plane == "top":
            return await run_top(drt, args)
        if args.plane == "slow":
            return await run_slow_live(drt, args)
        if args.plane == "drain":
            return await drain_instance(drt, args)
        if args.plane == "reclaim":
            return await reclaim_instance(drt, args)
        if args.plane == "disagg":
            if args.command == "get":
                return await get_disagg(drt, args)
            return await set_disagg(drt, args)
        if args.command == "add":
            return await add_model(drt, args)
        if args.command == "list":
            return await list_models(drt, args)
        return await remove_model(drt, args)
    finally:
        await drt.close()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
