"""``dynamo-run`` for the port: one CLI for every node shape it serves.

Counterpart of ``dynamo_exp_tpu/run.py``:

    python -m dynamo_exp_tpu_torch.run in=<INPUT> out=<OUTPUT> [flags]

INPUT:  http | batch:<prompts.jsonl> | dyn://ns.comp.ep
OUTPUT: cuda | echo_core | echo_full | dyn://ns.comp.ep

- ``in=http out=cuda``: an OpenAI server (``http/service.py``) in front
  of ``TorchEngine`` on the card; it prints ``listening on
  http://host:port``. ``--device cpu`` runs the engine on the CPU (the
  JAX package picks its device through ``JAX_PLATFORMS``; this is the
  port's way of asking for the CPU).
- ``in=dyn://ns.comp.ep out=cuda|echo_core --coordinator H:P``: a
  worker. The engine serves on a discoverable endpoint (the TCP request
  plane), answers the stats scrape with its load, publishes its KV
  events and, with ``--model-path``, its model card (``local_model.py``);
  it prints ``worker serving dyn://… (instance N)``. It publishes its
  topology coordinate (``DYN_TOPOLOGY``) and, when its engine shares
  prefixes, a ``migrate_addr`` where a ``MigrationSink`` takes live KV
  migrations into its prefix cache. SIGTERM is a spot-reclaim notice
  (``runtime/reclaim.py``): the instance flips to ``reclaiming``, its
  ``ReclaimController`` migrates the in-flight streams' KV to the
  nearest survivor within ``DYN_RECLAIM_GRACE_S``, and then it drains:
  it leaves discovery, finishes what is in flight, then exits.
- ``in=http out=dyn://ns.comp.ep --coordinator H:P``: an ingress that
  routes to such workers (``--router-mode random|round-robin|kv``).
  With ``--model-path`` it serves that card; without, models appear and
  leave as workers register and die (``http/discovery.py``).
  ``python -m dynamo_exp_tpu_torch.runtime.transports.coordinator``
  runs the coordinator; ``--coordinator`` defaults to
  ``DYN_COORDINATOR``. Workers and ingresses of this package and of the
  JAX package share the wire and serve each other.
- ``in=batch:<file>``: every JSONL line's ``text`` (or ``prompt``) as a
  concurrent streaming chat request; prints one JSON stats line.
- ``--model-path <dir>`` serves the directory's safetensors weights
  (``models/loader.py``); ``--random-weights`` serves seeded random
  ones instead.
- ``--host-cache-pages N`` keeps a pinned G2 host KV tier of N pages;
  ``DYN_KV_STORE=<dir>`` (with a host tier) arms the G3 persistent tier
  under it (``kv/persistent.py``): demoted pages land in ``<dir>`` as
  checksummed files, a later process over the same directory adopts
  them at boot, and a normal shutdown drains the warm host set into it.
  An unknown ``DYN_KV_*`` name or a malformed value exits naming the
  accepted spellings.
- ``--spec ngram`` (``--spec-draft-len``, ``--spec-max-draft``,
  ``--spec-ngram``): speculative decoding, as in the JAX CLI.
- ``--prewarm`` and ``--compile-cache-dir`` (``aot/``): warm boot, as in
  the JAX CLI (CUDA graphs of every decode-window and mixed variant,
  and the kernel library kept in the cache directory).
- ``--max-inflight`` / ``--shed-watermark`` (admission control at the
  HTTP edge: 429 / 503 with ``Retry-After``), ``--slo-ttft-ms`` /
  ``--slo-itl-ms`` (SLO attribution on ``/metrics``) and
  ``--trace-file`` (request spans as JSONL; ``DYN_TRACE_FILE=<path>``
  records each process to ``<path>.pid<pid>``), as in the JAX CLI.
  ``DYN_WORKLOAD_REF`` pins the engine's reference fingerprint for the
  drift gauge. ``--profiler-port N`` serves on-demand ``torch.profiler``
  captures (``runtime/profiler.py``: ``GET /capture?duration_ms=M`` on
  that port), where the JAX CLI serves ``jax.profiler``. Logging
  follows ``DYN_LOG`` / ``DYN_LOGGING_JSONL``; SIGUSR1 dumps every
  engine's flight recorder (``telemetry/flight.py``).

The JAX CLI's other inputs, outputs and flags are refused with the
ROADMAP item that brings them, never silently ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os
import signal
import sys
import time
from dataclasses import dataclass

logger = logging.getLogger("dynamo_exp_tpu_torch.run")

OUTPUTS = ("cuda", "echo_core", "echo_full")
ROUTER_MODES = {"random": "RANDOM", "round-robin": "ROUND_ROBIN", "kv": "KV"}
_ITEM9 = "ROADMAP Queue 1 item 9"
# Inputs/outputs and flags of the JAX CLI the port does not serve yet.
NOT_PORTED_IO = {
    "text": f"{_ITEM9}(d)",
    "stdin": f"{_ITEM9}(d)",
    "tpu": "the port's device output is out=cuda",
}
NOT_PORTED_FLAGS = {
    "--tensor-parallel-size": "ROADMAP Queue 1 item 7",
    "--tp": "ROADMAP Queue 1 item 7",
    "--num-nodes": "ROADMAP Queue 1 item 7",
    "--node-rank": "ROADMAP Queue 1 item 7",
    "--dist-leader": "ROADMAP Queue 1 item 7",
    "--dist-port": "ROADMAP Queue 1 item 7",
    "--deployment": "ROADMAP Queue 1 item 7",
    "--request-template": f"{_ITEM9}(c)",
    "--echo-token-delay-ms": f"{_ITEM9}(i)",
}


# ----------------------------------------------------------------- arguments
def _refuse(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to dynamo_exp_tpu_torch yet; see {item}")


def parse_args(argv: list[str]):
    io = {"in": "http", "out": "echo_full"}
    rest = []
    for a in argv:
        if a.startswith(("in=", "out=")):
            k, _, v = a.partition("=")
            io[k] = v
        else:
            flag = a.split("=", 1)[0]
            if flag in NOT_PORTED_FLAGS:
                raise _refuse(flag, NOT_PORTED_FLAGS[flag])
            rest.append(a)
    p = argparse.ArgumentParser(prog="dynamo_exp_tpu_torch.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default="", help="HF-style model directory")
    p.add_argument("--model-name", default="", help="served model name")
    p.add_argument("--preset", default="", help="built-in model preset (random weights)")
    p.add_argument("--random-weights", action="store_true",
                   help="random-init from a seed instead of loading safetensors")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080, help="0 = any free port")
    p.add_argument("--coordinator", default=os.environ.get("DYN_COORDINATOR", ""),
                   help="control-plane address host:port (enables dyn:// endpoints)")
    p.add_argument("--router-mode", default="random", choices=list(ROUTER_MODES),
                   help="how an out=dyn:// ingress picks a worker")
    p.add_argument("--max-decode-slots", type=int, default=16)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=0, help="0 = auto")
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--host-cache-pages", type=int, default=0,
                   help="G2 host KV tier in pages (pinned memory; 0 = off)")
    # Speculative decoding: a deterministic draft/verify pass; streams
    # stay token-identical to the run without it.
    p.add_argument("--spec", default="off",
                   help="speculative decoding drafter: off | ngram (prompt lookup, "
                   "no second model) | any registered drafter name")
    p.add_argument("--spec-draft-len", type=int, default=4,
                   help="initial draft length per row (adapted per row from the "
                   "rolling acceptance rate)")
    p.add_argument("--spec-max-draft", type=int, default=8,
                   help="upper bound the adaptive controller may grow a draft to")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="widest trailing n-gram the prompt-lookup drafter matches")
    p.add_argument("--max-tokens", type=int, default=256,
                   help="completion cap of in=batch requests that set none (an HTTP "
                   "request without max_tokens gets the rest of the context, as in "
                   "the JAX CLI)")
    p.add_argument("--prewarm", action="store_true",
                   help="warm boot: run (on the card: capture as CUDA graphs) every "
                   "decode-window and mixed (prefill, verify) variant before serving")
    p.add_argument("--compile-cache-dir", default="",
                   help="directory the kernel library is built into and kept in, with "
                   "manifest.json (a second boot against it runs no nvcc)")
    # Overload protection at the HTTP edge: bounded in-flight work,
    # priority-aware shedding (429 + Retry-After), hard-cap 503.
    p.add_argument("--max-inflight", type=int, default=0,
                   help="hard cap on concurrently admitted HTTP requests "
                   "(503 above it); 0 disables admission control")
    p.add_argument("--shed-watermark", type=int, default=0,
                   help="in-flight level where low-priority requests start "
                   "shedding with 429 (default: 3/4 of --max-inflight)")
    # SLO attribution: per-request TTFT/ITL at the HTTP edge against these
    # targets -> dynamo_slo_violations_total / dynamo_goodput_requests_total.
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="time-to-first-token SLO target in ms (0 = not an SLO)")
    p.add_argument("--slo-itl-ms", type=float, default=0.0,
                   help="inter-token-latency SLO target in ms (0 = not an SLO)")
    p.add_argument("--profiler-port", type=int, default=0,
                   help="serve torch.profiler captures on this port (GET "
                   "/capture?duration_ms=N writes a Chrome trace); 0 = off")
    p.add_argument("--trace-file", default="",
                   help="record request span telemetry to this JSONL file")
    p.add_argument("--device", default="cuda",
                   help="device of out=cuda's engine (cpu for CPU runs)")
    opts = p.parse_args(rest)
    from .engine.config import env_overrides

    try:
        opts.engine_env = env_overrides()
    except ValueError as e:
        raise SystemExit(str(e)) from None
    for key, value in io.items():
        for prefix, item in NOT_PORTED_IO.items():
            if value == prefix or (prefix.endswith("//") and value.startswith(prefix)):
                raise _refuse(f"{key}={value}", item)
    if io["in"] != "http" and not io["in"].startswith(("batch:", "dyn://")):
        raise SystemExit(f"unknown in={io['in']!r} (http | batch:<file> | dyn://ns.comp.ep)")
    if io["out"] not in OUTPUTS and not io["out"].startswith("dyn://"):
        raise SystemExit(f"unknown out={io['out']!r} ({' | '.join(OUTPUTS)} | dyn://ns.comp.ep)")
    opts.input, opts.output = io["in"], io["out"]
    return opts


def router_mode(opts):
    from .runtime.push_router import RouterMode

    return RouterMode[ROUTER_MODES[opts.router_mode]]


# ------------------------------------------------------------------- engines
def build_cuda_engine(opts):
    """``TorchEngine`` and the card of ``--model-path`` (None with
    ``--preset``): the directory's safetensors weights, or seeded random
    weights with ``--random-weights`` or ``--preset``."""
    from .engine import EngineConfig, TorchEngine
    from .model_card import ModelDeploymentCard
    from .models import PRESETS, ModelConfig

    mdc = model = None
    if opts.model_path:
        mcfg = ModelConfig.from_pretrained(opts.model_path)
        mdc = ModelDeploymentCard.from_local_path(opts.model_path, opts.model_name or None)
        has_weights = any(f.endswith(".safetensors") for f in os.listdir(opts.model_path))
        if not opts.random_weights:
            # Never serve random weights under a real model's name.
            if not has_weights:
                raise SystemExit(
                    f"no .safetensors weights in {opts.model_path}; pass "
                    "--random-weights to serve a random-initialized model"
                )
            from .models.loader import load_params

            t0 = time.monotonic()
            model, mcfg = load_params(opts.model_path, mcfg, device=opts.device)
            logger.info("loaded %s in %.2fs", opts.model_path, time.monotonic() - t0)
    elif opts.preset:
        mcfg = PRESETS[opts.preset]
    else:
        raise SystemExit("out=cuda needs --model-path or --preset")
    max_len = min(opts.max_model_len, mcfg.max_position_embeddings)
    num_pages = opts.num_pages or (
        opts.max_decode_slots * (max_len // opts.page_size + 1) + 64
    )
    ecfg = EngineConfig(
        model=mcfg,
        max_decode_slots=opts.max_decode_slots,
        page_size=opts.page_size,
        num_pages=num_pages,
        max_model_len=max_len,
        eos_token_ids=list(mdc.eos_token_ids) if mdc else [],
        kv_dtype=opts.kv_dtype,
        default_max_tokens=opts.max_tokens,
        host_cache_pages=opts.host_cache_pages,
        spec_mode=opts.spec,
        spec_draft_len=opts.spec_draft_len,
        spec_max_draft=opts.spec_max_draft,
        spec_ngram=opts.spec_ngram,
        **opts.engine_env,
    )
    engine = TorchEngine(ecfg, model=model, device=opts.device)
    if opts.prewarm:
        # Warm boot: every window and mixed variant runs (and, on the
        # card, is captured as a CUDA graph) now, not under first traffic.
        from .aot import prewarm_engine

        report = prewarm_engine(engine, cache_dir=opts.compile_cache_dir)
        logger.info(
            "prewarmed %d window variants (%d graphs) and %d mixed variants (%d graphs), "
            "%d kernel builds, in %.2fs (manifest %s)", report.variants, report.graphs,
            report.mixed_variants, report.mixed_graphs, report.builds, report.seconds,
            report.manifest_hash[:12],
        )
    elif opts.compile_cache_dir:
        from .aot import ensure_kernel_library

        ensure_kernel_library(engine, opts.compile_cache_dir)
    return engine, mdc


@dataclass
class Served:
    """What ``main_async`` hands its ``ready`` future: the OpenAI-level
    engine (the core engine, for a worker), the ``TorchEngine`` behind it
    (``out=cuda``), the model card, with ``in=http`` the bound port and
    the service, with ``in=dyn://`` the served instance, its reclaim
    controller and its migration sink."""

    engine: object
    torch_engine: object | None
    mdc: object | None
    port: int | None = None
    service: object | None = None  # the HttpService (in=http)
    instance: object | None = None  # the ServedInstance (in=dyn://)
    reclaim: object | None = None  # runtime.reclaim.ReclaimController
    migrate_sink: object | None = None  # runtime.reclaim.MigrationSink


def build_output(opts):
    """``out=…`` as (core_engine, full_engine, mdc, torch_engine);
    ``out=dyn://…`` is resolved by the input (all None here)."""
    from .engines.echo import EchoEngineCore, EchoEngineFull

    if opts.output == "echo_core":
        return EchoEngineCore(), None, None, None
    if opts.output == "echo_full":
        return None, EchoEngineFull(), None, None
    if opts.output.startswith("dyn://"):
        return None, None, None, None
    engine, mdc = build_cuda_engine(opts)
    return engine, None, mdc, engine


async def remote_core(opts, drt, block_size: int):
    """``out=dyn://…``: a core engine over the request plane, routed by
    ``--router-mode``. Returns (engine, kv_router or None); the caller
    stops the router."""
    from .kv_router.router import build_routed_core
    from .runtime.transports.base import EndpointAddress

    addr = EndpointAddress.from_url(opts.output)
    ep = drt.namespace(addr.namespace).component(addr.component).endpoint(addr.name)
    return await build_routed_core(ep, router_mode(opts), block_size)


def require_mdc(opts):
    from .model_card import ModelDeploymentCard

    if not opts.model_path:
        raise SystemExit(f"in={opts.input} with out={opts.output} needs --model-path "
                         "(tokenizer, template)")
    mdc = ModelDeploymentCard.from_local_path(opts.model_path, opts.model_name or None)
    mdc.kv_cache_block_size = opts.page_size
    return mdc


async def resolve_openai_engine(opts, drt, core, full, mdc):
    """The OpenAI-level engine: core engines (local, or remote through
    ``out=dyn://``) get the preprocessor and backend of the model card.
    Returns (engine, mdc, kv_router or None); the caller stops the
    router."""
    from .http import build_pipeline_engine

    kv_router = None
    if opts.output.startswith("dyn://"):
        mdc = require_mdc(opts)
        core, kv_router = await remote_core(opts, drt, mdc.kv_cache_block_size)
    if core is None:
        return full, mdc, kv_router
    if mdc is None:
        mdc = require_mdc(opts)
    return build_pipeline_engine(mdc, core), mdc, kv_router


# -------------------------------------------------------------------- inputs
def build_admission(opts):
    """``--max-inflight`` / ``--shed-watermark`` as an admission
    controller (None: admission control off)."""
    if opts.max_inflight <= 0:
        return None
    from .http import AdmissionController

    return AdmissionController(
        max_inflight=opts.max_inflight, shed_watermark=opts.shed_watermark or None
    )


def build_slo(opts):
    """``--slo-ttft-ms`` / ``--slo-itl-ms`` as an SLO attribution on the
    process registry (None: neither set)."""
    if opts.slo_ttft_ms <= 0 and opts.slo_itl_ms <= 0:
        return None
    from .telemetry import SloAttribution, SloConfig, get_telemetry

    return SloAttribution(
        SloConfig(
            ttft_s=opts.slo_ttft_ms / 1e3 if opts.slo_ttft_ms > 0 else None,
            itl_s=opts.slo_itl_ms / 1e3 if opts.slo_itl_ms > 0 else None,
        ),
        get_telemetry(),
    )


async def run_http(opts, drt, core, full, mdc, torch_engine,
                   ready: asyncio.Future | None) -> None:
    """OpenAI ingress until cancelled. With ``out=dyn://`` and no
    ``--model-path``, models come and go with the workers that register
    them."""
    from .http import HttpService
    from .http.discovery import ModelWatcher

    svc = HttpService(host=opts.http_host, port=opts.http_port,
                      admission=build_admission(opts), slo=build_slo(opts))
    watcher = kv_router = engine = None
    if opts.output.startswith("dyn://") and not opts.model_path:
        watcher = ModelWatcher(drt, svc.manager, router_mode(opts))
        await watcher.start()
    else:
        engine, mdc, kv_router = await resolve_openai_engine(opts, drt, core, full, mdc)
        name = (mdc.display_name if mdc else "") or opts.model_name or "default"
        svc.manager.add_chat_model(name, engine)
        svc.manager.add_completion_model(name, engine)
    served = Served(engine=engine, torch_engine=torch_engine, mdc=mdc, service=svc)
    try:
        port = await svc.start()
        print(f"listening on http://{opts.http_host}:{port}", flush=True)
        served.port = port
        if ready is not None and not ready.done():
            ready.set_result(served)
        await drt.runtime.primary_token.cancelled()
    finally:
        if watcher is not None:
            await watcher.close()
        if kv_router is not None:
            await kv_router.stop()
        await svc.stop()


def tokenizer_registrable(model_path: str) -> bool:
    """Can an ingress build a preprocessor chain from this model dir?
    A tokenizer-less dir registered with an ingress would strand it in
    a rebuild loop."""
    if any(os.path.exists(os.path.join(model_path, name))
           for name in ("tokenizer.json", "tokenizer.model")):
        return True
    if all(os.path.exists(os.path.join(model_path, name))
           for name in ("vocab.json", "merges.txt")):
        return True
    from .tokenizer import Tokenizer

    try:
        Tokenizer.from_pretrained(model_path)
        return True
    except Exception:  # noqa: BLE001 - genuinely tokenizer-less
        return False


async def run_worker(opts, drt, core, torch_engine, mdc, ready: asyncio.Future | None) -> None:
    """Worker node: serve the core engine on a discoverable endpoint
    until cancelled, then drain (bounded)."""
    from .kv_router.protocols import ForwardPassMetrics
    from .kv_router.publisher import KvEventPublisher, KvMetricsPublisher
    from .local_model import register_llm
    from .runtime.component import annotated_stream
    from .runtime.transports.base import EndpointAddress
    from .telemetry import get_telemetry

    addr = EndpointAddress.from_url(opts.input)
    ep = drt.namespace(addr.namespace).component(addr.component).endpoint(addr.name)

    async def handler(request: dict, context):
        async for frame in annotated_stream(core, request, context):
            yield frame

    metrics_pub = KvMetricsPublisher()
    # Spot-reclaim plane: advertise what survivors are selected on (this
    # worker's ledger name, its topology coordinate and, when the engine
    # can park migrated prefixes, a live-migration landing address),
    # then arm the triage controller on the served instance.
    from .parallel.multihost import TOPOLOGY_KEY, TopologyCoordinate
    from .runtime.reclaim import (
        MigrationSink,
        ReclaimController,
        install_sigterm_reclaim,
        survivors_from_instances,
    )

    topo = TopologyCoordinate.from_env()
    metadata: dict = {"instance": get_telemetry().instance, TOPOLOGY_KEY: topo.encode()}
    migrate_rx = migrate_sink = None
    if torch_engine is not None and torch_engine.kv.sharing:
        from .disagg.transfer import KvPageReceiver

        migrate_rx = KvPageReceiver()
        await migrate_rx.start()
        migrate_sink = MigrationSink(torch_engine, migrate_rx)
        metadata["migrate_addr"] = migrate_rx.address
    served = await ep.serve_endpoint(handler, stats_handler=metrics_pub.stats_handler,
                                     metadata=metadata)
    reclaim = None
    if torch_engine is not None:

        async def survivors():
            infos = await drt.discovery.list_instances(ep.component.path)
            return survivors_from_instances(infos, served.instance_id)

        reclaim = ReclaimController(torch_engine, topology=topo, survivors_fn=survivors)
        reclaim.attach(served)
        # SIGTERM is the platform's reclaim notice: triage within the
        # grace window, then fall through to the drain this handler
        # displaces (cancelling the main task, as main() does).
        install_sigterm_reclaim(served, then=asyncio.current_task().cancel)
    try:
        if torch_engine is not None:
            # KV events -> the routers' indexes, attributed to this instance.
            kv_pub = KvEventPublisher(drt.event_plane, ep.component.path, served.instance_id,
                                      loop=asyncio.get_running_loop())
            torch_engine.kv.event_cb = kv_pub.engine_callback()

            async def pump_metrics():
                while True:
                    await asyncio.sleep(0.5)
                    metrics_pub.update(ForwardPassMetrics.from_dict(torch_engine.metrics()))

            metrics_pub.update(ForwardPassMetrics.from_dict(torch_engine.metrics()))
            drt.runtime.spawn(pump_metrics())
        if opts.model_path:
            # Off the loop: the probe may load a tokenizer, which must not
            # stall this process's coordinator reads and keepalives.
            registrable = mdc is not None or await asyncio.to_thread(
                tokenizer_registrable, opts.model_path)
            if registrable:
                await register_llm(drt, ep, opts.model_path, opts.model_name or None,
                                   kv_cache_block_size=opts.page_size)
            else:
                logger.warning("not registering %s with ingress: no tokenizer", opts.model_path)
        print(f"worker serving {opts.input} (instance {served.instance_id})", flush=True)
        if ready is not None and not ready.done():
            ready.set_result(Served(engine=core, torch_engine=torch_engine, mdc=mdc,
                                    instance=served, reclaim=reclaim,
                                    migrate_sink=migrate_sink))
        await drt.runtime.primary_token.cancelled()
    finally:
        # Bounded: an unresponsive coordinator must not wedge shutdown
        # (the lease expiring cleans up the registrations anyway).
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(served.close(), 15)
        except asyncio.TimeoutError:
            logger.warning("endpoint close timed out after 15s")
        logger.info("endpoint closed in %.2fs", time.monotonic() - t0)
        if migrate_sink is not None:
            migrate_sink.close()
            await migrate_rx.close()


def _chat_payload(model: str, prompt: str, opts) -> dict:
    return {
        "model": model,
        "messages": [{"role": "user", "content": prompt}],
        "stream": True,
        "max_tokens": opts.max_tokens,
    }


async def _stream_chat(engine, payload):
    """(content chunks, seconds to the first, seconds in all)."""
    from .runtime.engine import AsyncEngineContext

    n_tokens = 0
    first = None
    t0 = time.monotonic()
    stream = await engine.generate(payload, AsyncEngineContext())
    async for item in stream:
        chunk = item if isinstance(item, dict) else item.to_dict()
        for choice in chunk.get("choices", []):
            if (choice.get("delta") or {}).get("content"):
                if first is None:
                    first = time.monotonic() - t0
                n_tokens += 1
    return n_tokens, first, time.monotonic() - t0


async def run_batch(opts, engine, mdc, path: str) -> dict:
    """JSONL prompts, concurrent, tok/s stats (the JAX CLI's line)."""
    name = (mdc.display_name if mdc else "") or "default"
    prompts = []
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                prompts.append(d.get("text") or d.get("prompt") or "")
    t0 = time.monotonic()
    results = await asyncio.gather(
        *[_stream_chat(engine, _chat_payload(name, p, opts)) for p in prompts]
    )
    wall = time.monotonic() - t0
    total = sum(r[0] for r in results)
    ttfts = sorted(r[1] for r in results if r[1] is not None)
    stats = {
        "requests": len(prompts),
        "output_tokens": total,
        "wall_s": round(wall, 3),
        "output_tok_s": round(total / wall, 2) if wall else 0.0,
        "ttft_p50_ms": round(ttfts[len(ttfts) // 2] * 1000, 1) if ttfts else None,
    }
    print(json.dumps(stats), flush=True)
    return stats


# --------------------------------------------------------------------- main
async def main_async(opts, ready: asyncio.Future | None = None) -> None:
    """Build ``out=…``, serve ``in=…``; the engine is stopped and the
    runtime closed on the way out, cancellation included. ``ready``
    (optional) receives a :class:`Served` once the input is up."""
    from .runtime.component import DistributedRuntime
    from .runtime.config import RuntimeConfig

    if opts.trace_file:
        from .telemetry import get_telemetry

        get_telemetry().configure(opts.trace_file)
    if opts.profiler_port:
        from .runtime.profiler import start_profiler_server

        start_profiler_server(opts.profiler_port, device=opts.device)
    needs_cluster = opts.input.startswith("dyn://") or opts.output.startswith("dyn://")
    if needs_cluster and not opts.coordinator:
        raise SystemExit("dyn:// endpoints need --coordinator (or DYN_COORDINATOR)")
    if opts.input.startswith("dyn://") and opts.output not in ("cuda", "echo_core"):
        raise SystemExit("in=dyn:// needs a local core engine (out=cuda|echo_core)")
    cfg = RuntimeConfig.from_settings()
    if opts.coordinator:
        cfg.coordinator_endpoint = opts.coordinator
    drt = DistributedRuntime(config=cfg)
    core, full, mdc, torch_engine = build_output(opts)
    try:
        if opts.input == "http":
            await run_http(opts, drt, core, full, mdc, torch_engine, ready)
        elif opts.input.startswith("dyn://"):
            await run_worker(opts, drt, core, torch_engine, mdc, ready)
        else:
            engine, mdc, kv_router = await resolve_openai_engine(opts, drt, core, full, mdc)
            try:
                if ready is not None:
                    ready.set_result(Served(engine=engine, torch_engine=torch_engine, mdc=mdc))
                await run_batch(opts, engine, mdc, opts.input[len("batch:"):])
            finally:
                if kv_router is not None:
                    await kv_router.stop()
    finally:
        if opts.profiler_port:
            from .runtime.profiler import stop_profiler_server

            stop_profiler_server()
        if torch_engine is not None:
            t0 = time.monotonic()
            torch_engine.stop()
            logger.info("engine stopped in %.2fs", time.monotonic() - t0)
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(drt.close(), 15)
        except asyncio.TimeoutError:
            logger.warning("runtime close timed out after 15s")
        logger.info("runtime closed in %.2fs", time.monotonic() - t0)


def main(argv: list[str] | None = None) -> None:
    from .runtime.logging import configure_logging

    configure_logging()
    opts = parse_args(argv if argv is not None else sys.argv[1:])
    loop = asyncio.new_event_loop()
    main_task = loop.create_task(main_async(opts))
    # SIGINT/SIGTERM -> cancel the main task -> the engine stops.
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError, ValueError):
            loop.add_signal_handler(sig, main_task.cancel)
    # SIGUSR1 -> every live engine's flight recorder ring is dumped.
    from .telemetry import install_sigusr1

    install_sigusr1()
    try:
        loop.run_until_complete(main_task)
    except asyncio.CancelledError:
        pass
    finally:
        loop.close()


if __name__ == "__main__":
    main()
