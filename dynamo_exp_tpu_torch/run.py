"""``dynamo-run`` for the port: one CLI for every node shape it serves.

Counterpart of ``dynamo_exp_tpu/run.py``:

    python -m dynamo_exp_tpu_torch.run in=<INPUT> out=<OUTPUT> [flags]

INPUT:  http | text | stdin | batch:<prompts.jsonl> | dyn://ns.comp.ep
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
- ``in=text``: an interactive chat, one streamed reply a line typed
  after ``> `` (stdin read on a daemon thread); ``in=stdin``: one
  streamed chat a stdin line, each reply on a line of its own. Both
  take every output, as the JAX CLI's do.
- ``--request-template <file>`` (``in=http``): a JSON file of defaults
  (``model``, ``temperature``, ``max_completion_tokens``) filled into
  every request that leaves them unset (``protocols/request_template.py``).
  ``--echo-token-delay-ms`` spaces the echo engines' frames.
- ``in=batch:<file>``: every JSONL line's ``text`` (or ``prompt``) as a
  concurrent streaming chat request; prints one JSON stats line. A line
  with ``token_ids`` instead goes to the core engine as it stands (no
  tokenizer, no template; its ``max_tokens``, ``ignore_eos``,
  ``temperature``, ``seed`` and ``logprobs`` as the request's), all such
  lines admitted together, and prints one JSON line of its output
  (``index``, ``token_ids``, ``finish_reason``, ``logprobs``) before the
  stats line.
- ``--model-path <dir>`` serves the directory's safetensors weights
  (``models/loader.py``), ``--model-path <file>.gguf`` a GGUF's
  (``models/gguf.py``: F32, F16, BF16, Q8_0), with the tokenizer and
  chat template embedded in it or, without them, token ids only;
  ``--random-weights`` serves seeded random ones instead. A hub id
  (``org/name``) is looked up in the local hub cache (``models/hub.py``).
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
- ``--tp N`` (``--tensor-parallel-size``): tensor parallelism, one
  process per rank, the model and the KV pools megatron-sharded over
  them (``engine/tp.py``). This process is rank 0: it spawns the other
  N-1 ranks first (``spawn``, so their interpreters start while this
  one does), builds the kernel library (one build, under a file lock),
  and alone serves ``in=``. ``--dist-backend`` picks the collectives'
  backend (``nccl`` by default on CUDA, ``gloo`` on the CPU or for
  ranks that share one card; ``nccl`` there is refused). With
  ``--num-nodes M`` every node runs this CLI with the same flags and its
  own ``--node-rank``; each runs N/M ranks (global rank = node rank x
  N/M + local rank) and only node 0 serves ``in=``. The ranks meet at
  the leader's ``TCPStore``: ``--dist-leader host:port``, or node 0
  publishes ``<its address>:--dist-port`` through ``--coordinator``
  under ``--deployment``'s key and the others read it there
  (``parallel/multihost.py``). Under ``--tp`` > 1 the G2/G3 tiers, the
  warm boot and CUDA graphs are refused with their ROADMAP items; a
  ``dyn://`` worker serves without live migration. At exit rank 0
  prints one JSON line ``{"tp": ...}``: the backend, and each rank's
  device, dispatches, launch counters, peak memory and collectives.
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

``out=tpu`` is refused, naming ``out=cuda``; every other input, output
and flag of the JAX CLI is served.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import time
from dataclasses import dataclass, field

logger = logging.getLogger("dynamo_exp_tpu_torch.run")

INPUTS = ("http", "text", "stdin")
OUTPUTS = ("cuda", "echo_core", "echo_full")
ROUTER_MODES = {"random": "RANDOM", "round-robin": "ROUND_ROBIN", "kv": "KV"}
# Outputs of the JAX CLI the port answers with its own: out=tpu is
# out=cuda here.
REPLACED_IO = {"tpu": "cuda"}


# ----------------------------------------------------------------- arguments
def parse_args(argv: list[str]):
    io = {"in": "http", "out": "echo_full"}
    rest = []
    for a in argv:
        if a.startswith(("in=", "out=")):
            k, _, v = a.partition("=")
            io[k] = v
        else:
            rest.append(a)
    p = argparse.ArgumentParser(prog="dynamo_exp_tpu_torch.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", default="",
                   help="HF-style model directory, a .gguf, or a hub id in the local cache")
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
    p.add_argument("--echo-token-delay-ms", type=float, default=0.0,
                   help="out=echo_core|echo_full: sleep this long before each frame")
    p.add_argument("--request-template", default="",
                   help="JSON file of request defaults (model / temperature / "
                   "max_completion_tokens) for in=http; explicit client values win")
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
    # Tensor parallelism and the multi-node engine (the JAX CLI's flags):
    # every node runs this CLI with the same flags and its own
    # --node-rank; node 0 leads and serves in=.
    p.add_argument("--tensor-parallel-size", "--tp", dest="tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: the engine serves 1 only (ring "
                   "prefill is models.llama.forward_ring_prefill)")
    p.add_argument("--num-nodes", type=int, default=1,
                   help="nodes the engine's tp ranks are spread over")
    p.add_argument("--node-rank", type=int, default=0, help="this node's rank (0 = leader)")
    p.add_argument("--dist-leader", default="",
                   help="the leader's host:port (its TCPStore); empty = the leader "
                   "derives and publishes it via --coordinator")
    p.add_argument("--dist-port", type=int, default=9911,
                   help="port the leader's TCPStore binds")
    p.add_argument("--deployment", default="default",
                   help="namespaces the published leader address so two multi-node "
                   "graphs on one coordinator don't read each other's")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the ranks' collectives: nccl (default on CUDA; ranks on "
                   "different cards) or gloo (the CPU, or ranks sharing one card)")
    opts = p.parse_args(rest)
    from .engine.config import SP_ONLY_ONE, TP_LATER, env_overrides

    try:
        opts.engine_env = env_overrides()
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if opts.sp != 1:
        raise SystemExit(f"--sp {opts.sp}: {SP_ONLY_ONE}")
    if opts.tp < 1 or opts.num_nodes < 1 or opts.tp % opts.num_nodes:
        raise SystemExit(f"--tp {opts.tp} must be a positive multiple of --num-nodes "
                         f"{opts.num_nodes}")
    if not 0 <= opts.node_rank < opts.num_nodes:
        raise SystemExit(f"--node-rank {opts.node_rank} is outside --num-nodes {opts.num_nodes}")
    if opts.tp > 1:
        for flag, on, item in (
            ("--prewarm", opts.prewarm, "graphs"),
            ("--compile-cache-dir", bool(opts.compile_cache_dir), "graphs"),
            ("--host-cache-pages", opts.host_cache_pages > 0, "tiers"),
            ("DYN_KV_STORE", bool(opts.engine_env.get("kv_store_dir")), "tiers"),
        ):
            if on:
                raise SystemExit(f"{flag} is not served under --tp > 1 yet; see "
                                 f"{TP_LATER[item]}")
    for key, value in io.items():
        if value in REPLACED_IO:
            raise SystemExit(f"{key}={value} is the JAX package's device output; the port "
                             f"serves the card with {key}={REPLACED_IO[value]}: use that")
    if io["in"] not in INPUTS and not io["in"].startswith(("batch:", "dyn://")):
        raise SystemExit(f"unknown in={io['in']!r} (http | text | stdin | batch:<file> | "
                         "dyn://ns.comp.ep)")
    if io["out"] not in OUTPUTS and not io["out"].startswith("dyn://"):
        raise SystemExit(f"unknown out={io['out']!r} ({' | '.join(OUTPUTS)} | dyn://ns.comp.ep)")
    opts.input, opts.output = io["in"], io["out"]
    opts.argv = list(argv)  # what a spawned tp rank parses again
    if opts.tp > 1 and opts.output != "cuda":
        raise SystemExit(f"--tp {opts.tp} shards out=cuda's engine, not out={opts.output}")
    return opts


def router_mode(opts):
    from .runtime.push_router import RouterMode

    return RouterMode[ROUTER_MODES[opts.router_mode]]


# ------------------------------------------------------------------- engines
def build_cuda_engine(opts, comm=None):
    """``TorchEngine`` and the card of ``--model-path`` (None with
    ``--preset``, or for a GGUF without an embedded tokenizer): the
    directory's safetensors weights or the GGUF's, or seeded random
    weights with ``--random-weights`` or ``--preset``. A hub id resolves
    to its snapshot in the local hub cache. With ``comm`` (``--tp`` > 1),
    this rank's shard of it on the rank's device."""
    from .engine import EngineConfig, TorchEngine
    from .model_card import ModelDeploymentCard
    from .models import PRESETS, ModelConfig

    mdc = model = None
    device = comm.device if comm is not None else opts.device
    shard = {"rank": comm.rank, "tp": comm.world} if comm is not None else {}
    if opts.model_path:
        from .models.hub import resolve_model_path

        opts.model_path = resolve_model_path(opts.model_path)
        t0 = time.monotonic()
        if opts.model_path.endswith(".gguf"):
            from .models.gguf import GGUFFile, config_from_gguf, load_params_from_gguf

            gguf = GGUFFile.parse(opts.model_path)  # the metadata, read once
            if opts.random_weights:
                mcfg = config_from_gguf(gguf)
            else:
                model, mcfg = load_params_from_gguf(opts.model_path, gguf=gguf,
                                                    device=device, **shard)
            # A self-contained GGUF carries its tokenizer and chat template;
            # one without serves token ids only.
            if "tokenizer.ggml.tokens" in gguf.metadata:
                mdc = ModelDeploymentCard.from_gguf(opts.model_path, opts.model_name or None,
                                                    gguf=gguf)
            else:
                logger.warning("GGUF has no embedded tokenizer; serving token-level only")
        else:
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

                model, mcfg = load_params(opts.model_path, mcfg, device=device, **shard)
        if model is not None:
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
        tp=opts.tp,
        sp=opts.sp,
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
    engine = TorchEngine(ecfg, model=model, device=device, comm=comm)
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


def build_output(opts, comm=None):
    """``out=…`` as (core_engine, full_engine, mdc, torch_engine);
    ``out=dyn://…`` is resolved by the input (all None here). ``comm``:
    this rank's, under ``--tp`` > 1."""
    from .engines.echo import EchoEngineCore, EchoEngineFull

    if opts.output == "echo_core":
        return EchoEngineCore(opts.echo_token_delay_ms), None, None, None
    if opts.output == "echo_full":
        return None, EchoEngineFull(opts.echo_token_delay_ms), None, None
    if opts.output.startswith("dyn://"):
        return None, None, None, None
    engine, mdc = build_cuda_engine(opts, comm)
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
    from .models.hub import resolve_model_path

    if not opts.model_path:
        raise SystemExit(f"in={opts.input} with out={opts.output} needs --model-path "
                         "(tokenizer, template)")
    opts.model_path = resolve_model_path(opts.model_path)
    if opts.model_path.endswith(".gguf"):
        from .models.gguf import GGUFFile

        gguf = GGUFFile.parse(opts.model_path)
        if "tokenizer.ggml.tokens" not in gguf.metadata:
            raise SystemExit(
                "this node shape needs a tokenizer and chat template, and this GGUF has no "
                "embedded tokenizer (tokenizer.ggml.*): pass a model directory or a "
                "self-contained GGUF"
            )
        mdc = ModelDeploymentCard.from_gguf(opts.model_path, opts.model_name or None,
                                            gguf=gguf)
    else:
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

    template = None
    if opts.request_template:
        from .protocols.request_template import RequestTemplate

        template = RequestTemplate.load(opts.request_template)
    svc = HttpService(host=opts.http_host, port=opts.http_port,
                      admission=build_admission(opts), slo=build_slo(opts),
                      request_template=template)
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
    """Can an ingress build a preprocessor chain from this model: a
    directory with a tokenizer the port loads (``tokenizer.json`` or
    ``tokenizer.model``), or a GGUF with an embedded tokenizer? A
    tokenizer-less model registered with an ingress would strand it in
    a rebuild loop."""
    if model_path.endswith(".gguf"):
        from .models.gguf import GGUFFile

        return "tokenizer.ggml.tokens" in GGUFFile.parse(model_path).metadata
    return any(os.path.isfile(os.path.join(model_path, name))
               for name in ("tokenizer.json", "tokenizer.model"))


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
    # Live migration moves a rank's pages; under --tp > 1 SIGTERM drains
    # without it (ROADMAP Queue 1 item 7(a)).
    reclaimable = torch_engine is not None and torch_engine.cfg.tp == 1
    if torch_engine is not None and not reclaimable:
        from .engine.config import TP_LATER

        logger.warning("--tp %d: no live migration on SIGTERM, only the drain (%s)",
                       torch_engine.cfg.tp, TP_LATER["tiers"])
    if reclaimable and torch_engine.kv.sharing:
        from .disagg.transfer import KvPageReceiver

        migrate_rx = KvPageReceiver()
        await migrate_rx.start()
        migrate_sink = MigrationSink(torch_engine, migrate_rx)
        metadata["migrate_addr"] = migrate_rx.address
    served = await ep.serve_endpoint(handler, stats_handler=metrics_pub.stats_handler,
                                     metadata=metadata)
    reclaim = None
    if reclaimable:

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


async def _stream_chat(engine, payload, out=None):
    """(content chunks, seconds to the first, seconds in all); each
    chunk's text is written to ``out`` as it arrives, when given."""
    from .runtime.engine import AsyncEngineContext

    n_tokens = 0
    first = None
    t0 = time.monotonic()
    stream = await engine.generate(payload, AsyncEngineContext())
    async for item in stream:
        chunk = item if isinstance(item, dict) else item.to_dict()
        for choice in chunk.get("choices", []):
            text = (choice.get("delta") or {}).get("content")
            if text:
                if first is None:
                    first = time.monotonic() - t0
                n_tokens += 1
                if out is not None:
                    out.write(text)
                    out.flush()
    return n_tokens, first, time.monotonic() - t0


async def run_text(opts, engine, mdc) -> None:
    """Interactive chat: each line read after a ``> `` prompt is one
    streamed chat, its reply written to stdout; Ctrl-D ends. stdin is
    read on a daemon thread: a thread of the default executor is joined
    at the interpreter's exit, and one blocked in ``input()`` would keep
    the process alive after Ctrl-C."""
    import threading

    name = (mdc.display_name if mdc else "") or "default"
    loop = asyncio.get_running_loop()
    lines: asyncio.Queue = asyncio.Queue()

    def reader():
        while True:
            try:
                line = input("> ")
            except EOFError:
                loop.call_soon_threadsafe(lines.put_nowait, None)
                return
            loop.call_soon_threadsafe(lines.put_nowait, line)

    threading.Thread(target=reader, name="stdin-reader", daemon=True).start()
    print("Ctrl-D to exit.", flush=True)
    while (prompt := await lines.get()) is not None:
        await _stream_chat(engine, _chat_payload(name, prompt, opts), sys.stdout)
        print(flush=True)


async def run_stdin(opts, engine, mdc) -> None:
    """One streamed chat a non-empty stdin line, each reply written to
    stdout on a line of its own."""
    name = (mdc.display_name if mdc else "") or "default"
    for line in sys.stdin:
        prompt = line.rstrip("\n")
        if prompt:
            await _stream_chat(engine, _chat_payload(name, prompt, opts), sys.stdout)
            print(flush=True)


def _token_request(d: dict, opts) -> dict:
    """A batch line with ``token_ids``, as the core engine's request."""
    so = {k: d[k] for k in ("temperature", "seed", "logprobs") if d.get(k) is not None}
    return {"token_ids": [int(t) for t in d["token_ids"]],
            "stop_conditions": {"max_tokens": int(d.get("max_tokens") or opts.max_tokens),
                                "ignore_eos": bool(d.get("ignore_eos", False))},
            "sampling_options": so}


async def _stream_tokens(stream):
    """(output, token count, seconds to the first, seconds in all) of a
    token-level stream."""
    out = {"token_ids": [], "finish_reason": None, "logprobs": [], "top_logprobs": []}
    first = None
    t0 = time.monotonic()
    async for item in stream:
        item = item if isinstance(item, dict) else item.to_dict()
        if item.get("token_ids"):
            first = first if first is not None else time.monotonic() - t0
            out["token_ids"] += item["token_ids"]
            out["logprobs"] += item.get("logprobs") or []
            out["top_logprobs"] += item.get("top_logprobs") or []
        if item.get("finish_reason"):
            reason = item["finish_reason"]
            out["finish_reason"] = str(getattr(reason, "value", reason))
    return out, len(out["token_ids"]), first, time.monotonic() - t0


async def run_batch(opts, openai, path: str, core=None) -> dict:
    """JSONL prompts, concurrent, tok/s stats (the JAX CLI's line). Text
    lines go to the OpenAI-level engine, which ``await openai()`` builds
    as (engine, mdc) when there are any; lines with ``token_ids`` go to
    ``core`` (the core engine), admitted together on a ``TorchEngine``,
    and their outputs are printed first."""
    prompts, token_lines = [], []
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                if "token_ids" in d:
                    token_lines.append(d)
                else:
                    prompts.append(d.get("text") or d.get("prompt") or "")
    engine, mdc = await openai() if prompts else (None, None)
    name = (mdc.display_name if mdc else "") or "default"
    if token_lines and core is None:
        raise SystemExit("in=batch lines with token_ids need a local core engine "
                         "(out=cuda|echo_core)")
    t0 = time.monotonic()
    reqs = [_token_request(d, opts) for d in token_lines]
    if reqs and hasattr(core, "hold_admission"):
        with core.hold_admission():  # one admission for all of them
            streams = [core.submit(r) for r in reqs]
    else:
        streams = [await core.generate(r) for r in reqs]
    results = await asyncio.gather(
        *[_stream_tokens(st) for st in streams],
        *[_stream_chat(engine, _chat_payload(name, p, opts)) for p in prompts],
    )
    wall = time.monotonic() - t0
    for i, (out, *_) in enumerate(results[: len(streams)]):
        print(json.dumps({"index": i, **out}), flush=True)
    results = [r[-3:] for r in results]
    total = sum(r[0] for r in results)
    ttfts = sorted(r[1] for r in results if r[1] is not None)
    stats = {
        "requests": len(results),
        "output_tokens": total,
        "wall_s": round(wall, 3),
        "output_tok_s": round(total / wall, 2) if wall else 0.0,
        "ttft_p50_ms": round(ttfts[len(ttfts) // 2] * 1000, 1) if ttfts else None,
    }
    print(json.dumps(stats), flush=True)
    return stats


# ------------------------------------------------------- tensor parallelism
@dataclass
class Ranks:
    """This node's share of a ``--tp`` engine: the comm of this process's
    rank, its layout, the processes of the node's other ranks, and the
    seconds from ``main_async``'s start to each step of the boot and the
    stop (``joined_s``, ``built_s``, ``stopped_s``, ``closed_s``: the
    other ranks joined)."""

    comm: object
    layout: object
    procs: list
    timeline: dict = field(default_factory=dict)
    started_at: float = 0.0  # main_async's start, epoch seconds

    def close(self, timeout_s: float = 60.0) -> None:
        """Leave the process group, then join the spawned ranks (killed
        when they outlive ``timeout_s``)."""
        self.comm.close()
        for p in self.procs:
            p.join(timeout=timeout_s)
            if p.is_alive():
                logger.error("tp rank process %s did not exit; killing it", p.name)
                p.kill()
                p.join(timeout=10)


def _rank_placement(opts, rank: int):
    """(layout, backend, device) of global rank ``rank``. Raises before
    any process group exists on a backend the placement cannot take."""
    import torch

    from .parallel import rank_layout, resolve_backend

    layout = rank_layout(tp=opts.tp, rank=rank, num_nodes=opts.num_nodes)
    kind = "cpu" if opts.device == "cpu" else "cuda"
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    backend = resolve_backend(opts.dist_backend, kind, layout.shares_card(kind, cards))
    return layout, backend, layout.device(kind, cards)


def _multinode(opts):
    from .parallel import MultiNodeConfig

    return MultiNodeConfig(num_nodes=opts.num_nodes, node_rank=opts.node_rank,
                           leader_addr=opts.dist_leader or None, dist_port=opts.dist_port,
                           deployment=opts.deployment)


def _follower_main(argv: list, rank: int, leader_addr: str, spawned_at: float) -> None:
    """A spawned rank: parse the CLI as rank 0 did, join the group,
    build this rank's shard of the engine, follow rank 0 until it stops.
    Ctrl-C reaches the whole process group; rank 0 alone decides when
    the ranks stop. Logs its boot's steps in seconds since it was
    spawned."""
    up = time.time() - spawned_at
    from .parallel import initialize_multihost
    from .runtime.logging import configure_logging

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    configure_logging()
    opts = parse_args(argv)
    layout, backend, device = _rank_placement(opts, rank)
    imported = time.time() - spawned_at
    comm = initialize_multihost(_multinode(opts), leader_addr, layout=layout,
                                backend=backend, device=device)
    joined = time.time() - spawned_at
    try:
        engine, _ = build_cuda_engine(opts, comm)
        logger.info("tp rank %d boot, seconds since spawn: interpreter up %.2f, torch "
                    "imported %.2f, group joined %.2f, engine built %.2f", rank, up,
                    imported, joined, time.time() - spawned_at)
        engine.follow()
    finally:
        comm.close()


def _placement(argv: list):
    """The flags that place this node's ranks (``parse_args`` reads them
    again, checked), read without importing torch."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--tensor-parallel-size", "--tp", dest="tp", type=int, default=1)
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--dist-leader", default="")
    return p.parse_known_args(argv)[0]


def spawn_ranks(argv: list, addr: str) -> list:
    """Spawn this node's other ranks (``spawn``: no CUDA state crosses),
    each parsing ``argv`` and dialling the leader's ``TCPStore`` at
    ``addr`` (a client retries until the store is up)."""
    from multiprocessing import get_context

    a = _placement(argv)
    per_node = a.tp // a.num_nodes
    first = a.node_rank * per_node
    ctx = get_context("spawn")
    procs = [ctx.Process(target=_follower_main, args=(argv, first + i, addr, time.time()),
                         name=f"tp-rank-{first + i}", daemon=True)
             for i in range(1, per_node)]
    for p in procs:
        p.start()
    return procs


def early_ranks(argv: list) -> tuple[str, list] | None:
    """(leader address, spawned ranks) when ``argv`` asks for tp > 1 and
    the address is known without the control plane (one node: a free
    local port; several: ``--dist-leader``): spawned first thing, so that
    their interpreters and ``torch`` imports run while this one's do
    (seconds each). Else None: ``start_ranks`` spawns them after
    discovery, and a bad combination is left to ``parse_args``."""
    a = _placement(argv)
    if a.tp <= 1 or a.num_nodes < 1 or a.tp % a.num_nodes or not 0 <= a.node_rank < a.num_nodes:
        return None
    if a.num_nodes == 1:
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
    elif a.dist_leader:
        addr = a.dist_leader
    else:
        return None
    return addr, spawn_ranks(argv, addr)


async def start_ranks(opts, drt, early: tuple | None = None) -> Ranks:
    """Bring up this node's ranks: the leader's address resolved and the
    node's other ranks spawned, unless ``early`` (:func:`early_ranks`)
    did both; node 0's ``TCPStore`` made; the kernel library built
    (under ``build_kernel``'s file lock, so ranks never race in
    ``_build/``); then this process's rank joins the group off the
    event loop (a spawned rank that dies first ends the wait)."""
    import threading

    from .parallel.comm import DIST_TIMEOUT_S
    from .parallel.multihost import initialize_multihost, leader_store, resolve_leader_addr

    cfg = _multinode(opts)
    layout, backend, device = _rank_placement(opts, cfg.node_rank * (opts.tp // opts.num_nodes))
    if early is None:
        addr = await resolve_leader_addr(cfg, drt.discovery if opts.coordinator else None)
        procs = spawn_ranks(opts.argv, addr)
    else:
        addr, procs = early
    store = leader_store(addr, layout.world_size, True, DIST_TIMEOUT_S) if layout.rank == 0 else None
    logger.info("tp=%d over %d node(s): this node runs ranks %d-%d, backend %s, leader %s",
                opts.tp, opts.num_nodes, layout.rank, layout.rank + layout.local_world - 1,
                backend, addr)
    if device.type == "cuda":
        from .ops import ragged_attention as tra

        tra.build_kernel()
    loop = asyncio.get_running_loop()
    joined: asyncio.Future = loop.create_future()

    def join():
        try:
            comm = initialize_multihost(cfg, addr, layout=layout, backend=backend,
                                        device=device, store=store)
            loop.call_soon_threadsafe(lambda: joined.done() or joined.set_result(comm))
        except BaseException as e:  # handed to the awaiting task
            loop.call_soon_threadsafe(lambda: joined.done() or joined.set_exception(e))

    # A daemon thread, not the default executor: a wait that a dead rank
    # abandons must not hold the interpreter's exit.
    threading.Thread(target=join, name="tp-join", daemon=True).start()
    while not joined.done():
        dead = [p for p in procs if p.exitcode not in (None, 0)]
        if dead:
            for p in procs:
                p.kill()
            raise SystemExit(f"tp rank process {dead[0].name} exited with {dead[0].exitcode} "
                             "before the group formed")
        await asyncio.wait([joined], timeout=0.25)
    return Ranks(joined.result(), layout, procs)


def tp_summary(ranks: Ranks, reports: list[dict]) -> dict:
    """The ``{"tp": ...}`` line: the backend, the node's cards and each
    rank's report (``engine/tp.py``)."""
    import torch

    cards = torch.cuda.device_count() if ranks.comm.device.type == "cuda" else 0
    return {"tp": ranks.comm.world, "backend": ranks.comm.backend, "cards": cards,
            "timeline": {k: round(v, 3) for k, v in ranks.timeline.items()},
            "started_at": ranks.started_at,
            "ranks": reports}


# --------------------------------------------------------------------- main
async def main_async(opts, ready: asyncio.Future | None = None,
                     early: tuple[str, list] | None = None) -> None:
    """Build ``out=…``, serve ``in=…``; the engine is stopped and the
    runtime closed on the way out, cancellation included. ``ready``
    (optional) receives a :class:`Served` once the input is up.
    ``early``: the ``--tp`` ranks :func:`early_ranks` spawned."""
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
    ranks = torch_engine = None
    t_main = time.monotonic()
    try:
        if opts.tp > 1:
            ranks = await start_ranks(opts, drt, early)
            ranks.started_at = time.time() - (time.monotonic() - t_main)
            ranks.timeline["joined_s"] = time.monotonic() - t_main
        core, full, mdc, torch_engine = build_output(opts, ranks.comm if ranks else None)
        if ranks is not None:
            ranks.timeline["built_s"] = time.monotonic() - t_main
        if ranks is not None and ranks.layout.rank != 0:
            # Another node's first rank: follow node 0's rank 0 (only it
            # serves in=).
            await asyncio.get_running_loop().run_in_executor(None, torch_engine.follow)
            return
        if ranks is not None:
            # The loop's idle heartbeats keep the other ranks' waits for
            # the next dispatch inside the group's timeout from boot on.
            torch_engine.start()
        if opts.input == "http":
            await run_http(opts, drt, core, full, mdc, torch_engine, ready)
        elif opts.input.startswith("dyn://"):
            await run_worker(opts, drt, core, torch_engine, mdc, ready)
        elif opts.input in ("text", "stdin"):
            engine, mdc, kv_router = await resolve_openai_engine(opts, drt, core, full, mdc)
            try:
                if ready is not None:
                    ready.set_result(Served(engine=engine, torch_engine=torch_engine, mdc=mdc))
                await (run_text if opts.input == "text" else run_stdin)(opts, engine, mdc)
            finally:
                if kv_router is not None:
                    await kv_router.stop()
        else:
            routers = []

            async def openai():
                # Text lines only: the card's tokenizer and template (a
                # --preset engine serves token_ids lines alone).
                engine, card, kv_router = await resolve_openai_engine(opts, drt, core, full, mdc)
                routers.append(kv_router)
                return engine, card

            try:
                if ready is not None:
                    ready.set_result(Served(engine=None, torch_engine=torch_engine, mdc=mdc))
                await run_batch(opts, openai, opts.input[len("batch:"):], core)
            finally:
                for kv_router in routers:
                    if kv_router is not None:
                        await kv_router.stop()
    finally:
        if opts.profiler_port:
            from .runtime.profiler import stop_profiler_server

            stop_profiler_server()
        try:
            if torch_engine is not None:
                t0 = time.monotonic()
                torch_engine.stop()
                logger.info("engine stopped in %.2fs", time.monotonic() - t0)
        finally:
            if ranks is not None:
                ranks.timeline["stopped_s"] = time.monotonic() - t_main
                ranks.close()
                ranks.timeline["closed_s"] = time.monotonic() - t_main
        if torch_engine is not None and torch_engine.tp_reports is not None:
            print(json.dumps(tp_summary(ranks, torch_engine.tp_reports)), flush=True)
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(drt.close(), 15)
        except asyncio.TimeoutError:
            logger.warning("runtime close timed out after 15s")
        logger.info("runtime closed in %.2fs", time.monotonic() - t0)


def main(argv: list[str] | None = None) -> None:
    from .runtime.logging import configure_logging

    configure_logging()
    argv = argv if argv is not None else sys.argv[1:]
    early = early_ranks(argv)  # before parse_args imports torch
    opts = parse_args(argv)
    # SIGUSR1 -> every live engine's flight recorder ring is dumped.
    from .runtime.runtime import run_until_signalled
    from .telemetry import install_sigusr1

    install_sigusr1()
    # SIGINT/SIGTERM -> cancel the main task -> the engine stops.
    run_until_signalled(main_async(opts, early=early))


if __name__ == "__main__":
    main()
