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
  (``bench compare``);
- offline planes: the cluster simulator (``sim``), the autotuner
  (``tune``, with ``--top-k`` live validation on the card), the warm
  boot (``aot compile|list|warm|smoke``: the graph lattice and the
  kernel library) and dynlint over the port's tree (``lint``,
  ``analysis/``).

    python -m dynamo_exp_tpu_torch.llmctl --coordinator HOST:PORT http list
    python -m dynamo_exp_tpu_torch.llmctl trace <id> --trace-file spans.jsonl --why

Entries added by ``http add`` are not lease-scoped: they stand for the
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

    # Offline static analysis: the dynlint AST checkers (host-sync /
    # determinism / thread-ownership / recompile-hazard) over the port's
    # tree; the flags of ``python -m dynamo_exp_tpu_torch.analysis``.
    lint = sub.add_parser(
        "lint", help="dynlint: AST invariant checks (offline)"
    )
    from .analysis.runner import add_lint_args

    add_lint_args(lint)

    # Offline cluster simulation (sim/): replay a seeded workload
    # through the port's admission/routing/preemption/planner policy code
    # against modeled instances and print the SimReport.
    sim = sub.add_parser(
        "sim", help="discrete-event cluster simulation (offline, seeded)"
    )
    sim.add_argument(
        "workload",
        choices=("burst", "ramp", "users", "diurnal"),
        help="burst: the overload_burst chaos scenario; ramp: linear "
        "arrival-rate ramp; users: open-loop synthetic user stream; "
        "diurnal: periodic burst swinging between --rps-start and "
        "--rps-end (the coldstart/provisioning study)",
    )
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--requests", type=int, default=None,
                     help="request count (burst n / users cap)")
    sim.add_argument("--duration-s", type=float, default=300.0)
    sim.add_argument("--rps-start", type=float, default=1.0)
    sim.add_argument("--rps-end", type=float, default=12.0)
    sim.add_argument("--trace-out", default="",
                     help="also save the workload as a JSONL trace file")
    sim.add_argument("--trace-in", default="",
                     help="replay a JSONL trace file instead of generating "
                     "(overrides the workload kind)")
    sim.add_argument("--instances", type=int, default=1)
    sim.add_argument("--slots", type=int, default=8)
    sim.add_argument("--pages", type=int, default=256)
    sim.add_argument("--page-size", type=int, default=16)
    sim.add_argument("--max-inflight", type=int, default=64)
    sim.add_argument("--shed-watermark", type=int, default=None)
    sim.add_argument(
        "--planner", choices=("none", "reactive", "slo"), default="none"
    )
    sim.add_argument("--max-gpu-budget", type=int, default=8,
                     help="the planner's card budget (the JAX CLI's "
                     "--max-tpu-budget)")
    sim.add_argument("--ttft-slo-s", type=float, default=2.0)
    sim.add_argument("--itl-slo-s", type=float, default=0.2)
    sim.add_argument(
        "--fit-spans", action="append", default=[],
        help="telemetry recorder JSONL to fit service times from",
    )
    sim.add_argument(
        "--fit-bench", action="append", default=[],
        help="bench.py JSON (or BENCH_r*.json wrapper) to fit from",
    )
    sim.add_argument("--events", action="store_true",
                     help="print the event log instead of the report")
    sim.add_argument(
        "--prefix-groups", type=int, default=0,
        help="assign arrivals to this many shared-prefix groups "
        "(0 = no shared prefixes)",
    )
    sim.add_argument(
        "--prefix-len", type=int, default=0,
        help="shared prefix length in tokens (default: half the "
        "prompt, capped at the prompt)",
    )
    sim.add_argument(
        "--no-prefix-sharing", action="store_true",
        help="private-copy baseline: prefix groups route by overlap "
        "but every request pays full pages",
    )
    sim.add_argument(
        "--host-pages", type=int, default=0,
        help="modeled G2 host-tier pages per instance (enables proactive "
        "offload under KV pressure; 0 = reactive baseline)",
    )
    sim.add_argument(
        "--g3-pages", type=int, default=0,
        help="modeled durable G3 store pages per instance ("
        "evicted cold blocks demote there and survive --restart-at-s; "
        "0 = G2-only baseline)",
    )
    sim.add_argument(
        "--restart-at-s", type=float, default=None,
        help="restart drill: hard-restart the busiest instance at this "
        "sim time (journal failover for in-flight work; respawns on "
        "the same modeled G3 disk after the provision delay)",
    )
    sim.add_argument(
        "--no-kv-packing", action="store_true",
        help="first-fit admission baseline (disable footprint-packed "
        "admission)",
    )
    sim.add_argument(
        "--period-s", type=float, default=300.0,
        help="diurnal workload: burst period in seconds (rate swings "
        "between --rps-start and --rps-end each period)",
    )
    sim.add_argument(
        "--provision-s", type=float, default=None,
        help="override the worker add -> serving delay (both the "
        "modeled spawn time and the SLO planner's provision_s hint) — "
        "the coldstart-study knob",
    )

    # Warm boot (aot/): list the graph lattice, build the kernel
    # library into a cache directory, and warm-boot engines from it.
    # What the port keeps across processes is the kernel library, not
    # compiled graphs (a CUDA graph belongs to its process).
    aot = sub.add_parser(
        "aot", help="warm boot: graph lattice, kernel library, prewarm"
    )
    aot.add_argument(
        "command", choices=("compile", "list", "warm", "smoke"),
        help="compile: build the kernel library into the cache dir and "
        "write manifest.json; list: print the graph manifest (no "
        "weights, no card); warm: boot an engine via prewarm and report; "
        "smoke: boot twice against a fresh tmp cache dir and fail unless "
        "the second boot builds nothing and nothing is captured under "
        "traffic",
    )
    aot.add_argument("--preset", default="tiny",
                     help="built-in model preset (random weights)")
    aot.add_argument("--compile-cache-dir", default="",
                     help="kernel-library cache directory (default: the "
                     "package's _build/; smoke uses a tmp dir)")
    aot.add_argument("--device", default="cuda",
                     help="cuda (default; no card: exit 2) or cpu, which "
                     "runs the plain version and builds no kernel")
    aot.add_argument("--tp", type=int, default=1)
    aot.add_argument("--max-decode-slots", type=int, default=4)
    aot.add_argument("--page-size", type=int, default=16)
    aot.add_argument("--num-pages", type=int, default=0, help="0 = auto")
    aot.add_argument("--max-model-len", type=int, default=512)
    aot.add_argument("--decode-window", type=int, default=8)
    aot.add_argument("--prefill-chunk", type=int, default=128)
    aot.add_argument("--kv-dtype", default="bfloat16",
                     choices=["bfloat16", "float32"])
    aot.add_argument("--spec", default="off",
                     help="speculative drafter (adds the verify-span "
                     "variants to the lattice)")
    aot.add_argument("--no-lp", action="store_true",
                     help="drop the logprob variants (halves the lattice "
                     "for deployments that never serve logprobs)")

    # Sim-in-the-loop autotuner (tune/): seeded coordinate descent over
    # the declarative knob space, scored in the cluster simulator
    # against a workload target, optionally live-validated on an engine
    # of --preset and --kv-dtype, emitted as a bootable config artifact.
    tune = sub.add_parser(
        "tune", help="autotune engine/planner knobs against a workload "
                     "target (offline, seeded)"
    )
    tgt = tune.add_mutually_exclusive_group(required=True)
    tgt.add_argument(
        "--fingerprint", default="",
        help="target workload fingerprint JSON "
             "(`llmctl fingerprint --out`)",
    )
    tgt.add_argument(
        "--trace", default="",
        help="target a sim workload trace JSONL (tuned via its "
             "fingerprint)",
    )
    tgt.add_argument(
        "--workload", default="",
        choices=("burst", "ramp", "diurnal", "users"),
        help="target a named synthetic workload",
    )
    tune.add_argument("--seed", type=int, default=0)
    tune.add_argument("--budget", type=int, default=64,
                      help="max sim evaluations (rung-0 + rung-1)")
    tune.add_argument("--eval-seeds", type=int, default=2,
                      help="seeds per full evaluation")
    tune.add_argument("--requests", type=int, default=None,
                      help="requests per evaluation (default: the "
                           "fingerprint's own n)")
    tune.add_argument("--rate-rps", type=float, default=None,
                      help="override the target's arrival rate")
    tune.add_argument("--instances", type=int, default=1,
                      help="modeled fleet size the knobs are tuned for")
    tune.add_argument(
        "--planner", action="store_true",
        help="run the SLO planner in every evaluation and include the "
             "planner/SLO knobs in the search space",
    )
    tune.add_argument("--journal", default="",
                      help="JSONL trial journal path (audit + resume)")
    tune.add_argument(
        "--resume", action="store_true",
        help="replay an existing --journal as an evaluation cache "
             "(byte-identical continuation of an interrupted run)",
    )
    tune.add_argument(
        "--top-k", type=int, default=0,
        help="validate this many top candidates on a live engine of "
             "--preset and --kv-dtype (sim-vs-live rank agreement) "
             "before recommending (0 = skip; boots real engines, on "
             "--device)",
    )
    tune.add_argument("--device", default="cuda",
                      help="the validation engines' device: cuda "
                           "(default; no card: exit 2) or cpu")
    tune.add_argument("--validate-passes", type=int, default=1,
                      help="measured passes a candidate's live score "
                           "sums (default 1, the JAX harness's)")
    tune.add_argument("--out", default="",
                      help="write the tuned-config artifact JSON here")
    tune.add_argument("--preset", default="tiny",
                      help="model preset the artifact's engine block, "
                           "graph manifest and live validation use")
    tune.add_argument("--max-model-len", type=int, default=512)
    tune.add_argument("--kv-dtype", default="bfloat16",
                      choices=["bfloat16", "float32"])
    tune.add_argument("--tp", type=int, default=1)
    tune.add_argument(
        "--no-manifest", action="store_true",
        help="skip embedding the graph manifest in the artifact",
    )
    tune.add_argument(
        "--check", action="store_true",
        help="exit nonzero unless the recommendation beats the default "
             "config in-sim",
    )
    tune.add_argument("--json", action="store_true",
                      help="print the result summary as JSON")
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
    # with a store, whose own conservation arithmetic rides in the same
    # snapshot.
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


def run_sim(args) -> int:
    from .planner.planner import PlannerConfig
    from .planner.policy import SloTargets
    from .sim import (
        ClusterSim,
        ServiceTimeModel,
        SimConfig,
        burst_workload,
        diurnal_workload,
        load_trace,
        ramp_workload,
        save_trace,
        synthetic_users,
    )

    if args.trace_in:
        workload = load_trace(args.trace_in)
    elif args.workload == "burst":
        workload = burst_workload(args.seed, n=args.requests or 8)
    elif args.workload == "ramp":
        workload = ramp_workload(
            args.seed,
            duration_s=args.duration_s,
            rps_start=args.rps_start,
            rps_end=args.rps_end,
        )
    elif args.workload == "diurnal":
        workload = diurnal_workload(
            args.seed,
            duration_s=args.duration_s,
            rps_base=args.rps_start,
            rps_peak=args.rps_end,
            period_s=args.period_s,
        )
    else:
        workload = synthetic_users(
            args.seed,
            users=args.requests or 100_000,
            duration_s=args.duration_s,
        )
    if args.prefix_groups > 0:
        # Shared-prefix fleet mix: arrivals draw a group seeded
        # independently of the arrival process, so adding groups never
        # perturbs arrival times.
        import random as _random
        from dataclasses import replace as _replace

        grng = _random.Random(args.seed ^ 0x9EF1)
        workload = [
            _replace(
                r,
                prefix_group=grng.randrange(args.prefix_groups),
                prefix_len=min(
                    args.prefix_len or max(r.prompt_len // 2, 1),
                    r.prompt_len,
                ),
            )
            for r in workload
        ]
    if args.trace_out:
        workload = list(workload)
        n = save_trace(args.trace_out, workload)
        print(f"# {n} requests -> {args.trace_out}", file=sys.stderr)
    service = (
        ServiceTimeModel.from_telemetry(
            span_paths=args.fit_spans, bench_paths=args.fit_bench
        )
        if (args.fit_spans or args.fit_bench)
        else ServiceTimeModel.default()
    )
    cfg = SimConfig(
        seed=args.seed,
        slots_per_instance=args.slots,
        pages_per_instance=args.pages,
        page_size=args.page_size,
        max_inflight=args.max_inflight,
        shed_watermark=args.shed_watermark,
        admission_per_instance=args.planner != "none",
        initial_instances=args.instances,
        provision_s=args.provision_s,
        planner=None if args.planner == "none" else args.planner,
        planner_cfg=PlannerConfig(
            max_gpu_budget=args.max_gpu_budget, min_endpoint=1
        ),
        slo=SloTargets(
            ttft_p99_slo_s=args.ttft_slo_s,
            itl_p99_slo_s=args.itl_slo_s,
            # Fitted-service hint: scale for where the trend will be
            # when a new worker actually lands (the --provision-s study
            # knob, else the fitted one).
            provision_s=(
                args.provision_s
                if args.provision_s is not None
                else service.planner_hints()["provision_s"]
            ),
        ),
        service=service,
        record_events=args.events,
        prefix_sharing=not args.no_prefix_sharing,
        host_pages_per_instance=args.host_pages,
        kv_packing=not args.no_kv_packing,
        g3_pages_per_instance=args.g3_pages,
        restart_at_s=args.restart_at_s,
    )
    sim = ClusterSim(cfg, workload)
    report = sim.run()
    if args.events:
        # Event lines own stdout (a grep/diff-able stream); the report
        # rides stderr so it's still visible without corrupting either.
        for line in sim.event_log:
            print(line)
        print(report.to_json(indent=2), file=sys.stderr)
    else:
        print(report.to_json(indent=2))
    return 0


def _card_or_refuse(device: str, what: str):
    """The device a card-bound command runs on, or None (with the reason
    on stderr) where a card was asked for and there is none: it never
    carries on on the CPU unless ``--device cpu`` asked for it."""
    from .device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(f"llmctl {what}: {e}", file=sys.stderr)
        return None


def _aot_config(args):
    from .engine import EngineConfig
    from .models import PRESETS

    mcfg = PRESETS[args.preset]
    max_len = min(args.max_model_len, mcfg.max_position_embeddings)
    return EngineConfig(
        model=mcfg,
        max_decode_slots=args.max_decode_slots,
        page_size=args.page_size,
        num_pages=args.num_pages
        or (args.max_decode_slots * (max_len // args.page_size + 1) + 64),
        max_model_len=max_len,
        tp=args.tp,
        eos_token_ids=[],
        kv_dtype=args.kv_dtype,
        decode_window=args.decode_window,
        prefill_chunk=args.prefill_chunk,
        spec_mode=args.spec,
    )


def _aot_manifest(cfg, attn_impl: str, include_lp: bool):
    """The config's graph lattice; without ``include_lp`` the logprob
    variants are dropped (a request asking for logprobs then captures
    its key at first use)."""
    from .aot import build_manifest

    manifest = build_manifest(cfg, attn_impl)
    if not include_lp:
        manifest.windows = [k for k in manifest.windows if not k.want_lp]
        manifest.mixed = [k for k in manifest.mixed if not k.want_lp]
    return manifest


async def run_aot(args) -> int:
    """The warm-boot plane: list the graph lattice, build the kernel
    library into a cache directory, warm-boot engines from it. ``list``
    needs no weights and no card; the other commands run on
    ``--device`` (a card unless ``--device cpu``) with random weights."""
    import tempfile
    import time

    import torch

    from .aot import build_kernel_library, prewarm_engine
    from .engine import TorchEngine, resolve_attn_impl

    cfg = _aot_config(args)
    include_lp = not args.no_lp

    if args.command == "list":
        impl = resolve_attn_impl(cfg, torch.device(args.device))
        manifest = _aot_manifest(cfg, impl, include_lp)
        print(json.dumps(manifest.to_dict(), indent=2, sort_keys=True))
        print(
            f"# {len(manifest.windows)} window keys, {len(manifest.mixed)} "
            f"mixed keys, hash {manifest.hash()}",
            file=sys.stderr,
        )
        return 0

    device = _card_or_refuse(args.device, f"aot {args.command}")
    if device is None:
        return 2
    impl = resolve_attn_impl(cfg, device)
    manifest = _aot_manifest(cfg, impl, include_lp)
    kernel = impl == "kernel" and device.type == "cuda"

    if args.command == "compile":
        t0 = time.perf_counter()
        cache_dir = args.compile_cache_dir
        builds = build_kernel_library(cache_dir, manifest if cache_dir else None, kernel)
        print(json.dumps({
            "cache_dir": cache_dir or None,
            "manifest_hash": manifest.hash(),
            "window_keys": len(manifest.windows),
            "mixed_keys": len(manifest.mixed),
            "kernel_library": kernel,
            "builds": builds,
            "seconds": round(time.perf_counter() - t0, 3),
        }, indent=2))
        return 0

    async def traffic(engine, n: int = 2, prompt_len: int = 24) -> None:
        """A small mixed probe burst (greedy + seeded rows)."""

        async def one(i: int):
            req = {
                "token_ids": list(range(3 + i, 3 + i + prompt_len)),
                "stop_conditions": {"max_tokens": 8, "ignore_eos": True},
            }
            if i % 2:
                req["sampling_options"] = {"seed": i, "temperature": 0.8}
            stream = await engine.generate(req)
            async for _ in stream:
                pass

        await asyncio.gather(*[one(i) for i in range(n)])

    async def boot(cache_dir: str) -> dict:
        engine = TorchEngine(cfg, device=device, seed=0)
        report = prewarm_engine(engine, manifest, cache_dir=cache_dir)
        engine.start()
        try:
            await traffic(engine)
            m = engine.metrics()
        finally:
            engine.stop()
        return {
            "manifest_hash": report.manifest_hash,
            "prewarmed_variants": report.variants,
            "prewarmed_mixed_variants": report.mixed_variants,
            "graphs": report.graphs + report.mixed_graphs,
            "builds": report.builds,
            "prewarm_seconds": round(report.seconds, 3),
            # First-use captures under traffic, by kind (0 when warm).
            "captures_after_prewarm": {
                kind: m["dispatch"][kind]["compile_misses"]
                for kind in ("window", "mixed")
            },
        }

    if args.command == "warm":
        print(json.dumps(await boot(args.compile_cache_dir), indent=2))
        return 0

    # smoke: two warm boots against one FRESH tmp dir (never a shared
    # cache: the first boot must populate it); the second must build
    # nothing and neither may capture under traffic.
    cache_dir = tempfile.mkdtemp(prefix="dynamo_aot_smoke_")
    b1 = await boot(cache_dir)
    b2 = await boot(cache_dir)
    verdict = {
        "cache_dir": cache_dir,
        "kernel_library": kernel,
        "boot1": b1,
        "boot2": b2,
        "ok": b2["builds"] == 0
        and not any(b1["captures_after_prewarm"].values())
        and not any(b2["captures_after_prewarm"].values()),
    }
    print(json.dumps(verdict, indent=2))
    if not verdict["ok"]:
        print("aot smoke FAILED: the second boot built, or traffic captured",
              file=sys.stderr)
        return 1
    return 0


async def run_tune(args) -> int:
    """The autotuner plane: search in the simulator, optionally validate
    the top K on live engines of ``--preset`` and ``--kv-dtype`` (one set
    of random weights for every candidate), emit the bootable config
    artifact."""
    from .tune import artifact as tune_artifact
    from .tune import search as tune_search
    from .tune import validate as tune_validate

    device = None
    if args.top_k > 0:
        device = _card_or_refuse(args.device, "tune --top-k")
        if device is None:
            return 2

    fp = None
    if args.fingerprint:
        from .telemetry.fingerprint import load_fingerprint

        fp = load_fingerprint(args.fingerprint)
        target = tune_search.target_from_fingerprint(
            fp, requests=args.requests, rate_rps=args.rate_rps
        )
    elif args.trace:
        target = tune_search.target_from_trace(
            args.trace, requests=args.requests, rate_rps=args.rate_rps
        )
        fp = target.fingerprint
    else:
        target = tune_search.TuneTarget(
            kind="synthetic",
            name=args.workload,
            requests=args.requests or 64,
            rate_rps=args.rate_rps,
        )

    settings = tune_search.SearchSettings(
        seed=args.seed,
        budget=args.budget,
        eval_seeds=args.eval_seeds,
        planner=args.planner,
        base_sim={"initial_instances": args.instances},
    )
    result = tune_search.run_search(
        target,
        settings,
        journal_path=args.journal or None,
        resume=args.resume,
    )
    summary = {
        "target": result.target_digest,
        "seed": result.seed,
        "trials": result.trials,
        "best_overrides": result.best_overrides,
        "best_score": result.best_score,
        "default_score": result.default_score,
        "improvement": result.improvement,
    }

    from .models import PRESETS

    mcfg = PRESETS[args.preset]
    validation = None
    if args.top_k > 0:
        import torch

        from .models import init_params

        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        llama = init_params(mcfg, gen, device)
        candidates = tune_search.top_candidates(result, args.top_k)
        report = await tune_validate.validate_candidates(
            candidates, target, seed=args.seed, device=device, model=mcfg,
            kv_dtype=args.kv_dtype, llama=llama, passes=args.validate_passes,
        )
        del llama
        validation = {
            "kendall_tau": report["kendall_tau"],
            "top1_agreement": report["top1_agreement"],
            "agreed": report["agreed"],
            "sim_scores": report["sim_scores"],
            "live_scores": report["live_scores"],
            # What ran live, candidate by candidate (port only).
            "candidates": [
                {"overrides": row["overrides"], "live": row["live"]}
                for row in report["candidates"]
            ],
        }
        summary["validation"] = validation

    if args.out:
        max_len = min(args.max_model_len, mcfg.max_position_embeddings)
        shape = {
            "max_model_len": max_len,
            "kv_dtype": args.kv_dtype,
            "tp": args.tp,
        }
        manifest = None
        if not args.no_manifest:
            import torch

            from .aot import build_manifest
            from .engine import EngineConfig, resolve_attn_impl

            cfg = EngineConfig(
                model=mcfg,
                eos_token_ids=[],
                **shape,
                **tune_artifact.resolved_live_knobs(result.best_overrides),
            )
            # The lattice of the device the artifact boots on (no card
            # is touched: the kernel's layout check is arithmetic).
            manifest = build_manifest(
                cfg, resolve_attn_impl(cfg, torch.device(args.device))
            )
        art = tune_artifact.build_artifact(
            result,
            preset=args.preset,
            shape=shape,
            manifest=manifest,
            fingerprint=fp,
            validation=validation,
        )
        tune_artifact.write_artifact(art, args.out)
        summary["artifact"] = args.out
        summary["config_hash"] = art["config_hash"]

    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(
            f"target {summary['target']}  trials {summary['trials']}  "
            f"score {summary['best_score']} vs default "
            f"{summary['default_score']} "
            f"({summary['improvement']:+.1%})"
        )
        for k, v in sorted(result.best_overrides.items()):
            print(f"  {k} = {v}")
        if validation is not None:
            print(
                f"validation: kendall_tau {validation['kendall_tau']}, "
                f"top-1 {'agrees' if validation['top1_agreement'] else 'DISAGREES'}"
            )
        if args.out:
            print(f"artifact -> {args.out}")

    if validation is not None and not validation["agreed"]:
        print(
            "tune: sim-vs-live validation DISAGREES; recommendation "
            f"not trustworthy (sim scores {validation['sim_scores']}, live "
            f"{validation['live_scores']})",
            file=sys.stderr,
        )
        return 1
    if args.check and result.best_score <= result.default_score:
        print(
            "tune --check: recommendation does not beat the default "
            "config in-sim",
            file=sys.stderr,
        )
        return 1
    return 0


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

    if args.plane == "lint":  # offline: AST checks, no cluster
        from .analysis.runner import run_cli

        return run_cli(args)
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
    if args.plane == "sim":  # offline: modeled fleet, no cluster
        return run_sim(args)
    if args.plane == "aot":  # offline: graph lattice and kernel library
        return await run_aot(args)
    if args.plane == "tune":  # offline: sim search (+ live validation)
        return await run_tune(args)
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
