"""``dynamo-run`` for the port: one CLI for the local node shapes.

Counterpart of ``dynamo_exp_tpu/run.py``:

    python -m dynamo_exp_tpu_torch.run in=<INPUT> out=<OUTPUT> [flags]

INPUT:  http | batch:<prompts.jsonl>
OUTPUT: cuda | echo_core | echo_full

- ``in=http out=cuda``: an OpenAI server (``http/service.py``) in front
  of ``TorchEngine`` on the card; it prints ``listening on
  http://host:port``. ``--device cpu`` runs the engine on the CPU (the
  JAX package picks its device through ``JAX_PLATFORMS``; this is the
  port's way of asking for the CPU).
- ``in=batch:<file>``: every JSONL line's ``text`` (or ``prompt``) as a
  concurrent streaming chat request; prints one JSON stats line.
- ``--spec ngram`` (``--spec-draft-len``, ``--spec-max-draft``,
  ``--spec-ngram``): speculative decoding, as in the JAX CLI.

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
_ITEM9 = "ROADMAP Queue 1 item 9"
# Inputs/outputs and flags of the JAX CLI the port does not serve yet.
NOT_PORTED_IO = {
    "text": f"{_ITEM9}(d)",
    "stdin": f"{_ITEM9}(d)",
    "dyn://": f"{_ITEM9}(e)",
    "tpu": "the port's device output is out=cuda",
}
NOT_PORTED_FLAGS = {
    "--coordinator": f"{_ITEM9}(e)",
    "--router-mode": f"{_ITEM9}(e)",
    "--tensor-parallel-size": "ROADMAP Queue 1 item 7",
    "--tp": "ROADMAP Queue 1 item 7",
    "--num-nodes": "ROADMAP Queue 1 item 7",
    "--node-rank": "ROADMAP Queue 1 item 7",
    "--dist-leader": "ROADMAP Queue 1 item 7",
    "--dist-port": "ROADMAP Queue 1 item 7",
    "--deployment": "ROADMAP Queue 1 item 7",
    "--prewarm": "ROADMAP Queue 1 item 6",
    "--compile-cache-dir": "ROADMAP Queue 1 item 6",
    "--request-template": f"{_ITEM9}(c)",
    "--max-inflight": f"{_ITEM9}(b)",
    "--shed-watermark": f"{_ITEM9}(b)",
    "--slo-ttft-ms": f"{_ITEM9}(b)",
    "--slo-itl-ms": f"{_ITEM9}(b)",
    "--profiler-port": "ROADMAP Queue 1, 'also still outside the port' (profiler)",
    "--trace-file": "ROADMAP Queue 1, 'also still outside the port' (telemetry)",
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
    p.add_argument("--device", default="cuda",
                   help="device of out=cuda's engine (cpu for CPU runs)")
    opts = p.parse_args(rest)
    for key, value in io.items():
        for prefix, item in NOT_PORTED_IO.items():
            if value == prefix or (prefix.endswith("//") and value.startswith(prefix)):
                raise _refuse(f"{key}={value}", item)
    if io["in"] != "http" and not io["in"].startswith("batch:"):
        raise SystemExit(f"unknown in={io['in']!r} (http | batch:<file>)")
    if io["out"] not in OUTPUTS:
        raise SystemExit(f"unknown out={io['out']!r} ({' | '.join(OUTPUTS)})")
    opts.input, opts.output = io["in"], io["out"]
    return opts


# ------------------------------------------------------------------- engines
def build_cuda_engine(opts):
    """``TorchEngine`` (seeded random weights) and the card of
    ``--model-path`` (None with ``--preset``)."""
    from .engine import EngineConfig, TorchEngine
    from .model_card import ModelDeploymentCard
    from .models import PRESETS, ModelConfig

    mdc = None
    if opts.model_path:
        mcfg = ModelConfig.from_pretrained(opts.model_path)
        mdc = ModelDeploymentCard.from_local_path(opts.model_path, opts.model_name or None)
        has_weights = any(f.endswith(".safetensors") for f in os.listdir(opts.model_path))
        if not opts.random_weights:
            # Never serve random weights under a real model's name.
            if has_weights:
                raise _refuse(
                    f"loading the .safetensors weights in {opts.model_path}",
                    f"{_ITEM9}(g); pass --random-weights to serve seeded random weights",
                )
            raise SystemExit(
                f"no .safetensors weights in {opts.model_path}; pass "
                "--random-weights to serve a random-initialized model"
            )
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
    )
    return TorchEngine(ecfg, device=opts.device), mdc


@dataclass
class Served:
    """What ``main_async`` hands its ``ready`` future: the OpenAI-level
    engine, the ``TorchEngine`` behind it (``out=cuda``), the model card
    and, with ``in=http``, the bound port."""

    engine: object
    torch_engine: object | None
    mdc: object | None
    port: int | None = None


def build_output(opts):
    """``out=…`` as (core_engine, full_engine, mdc, torch_engine)."""
    from .engines.echo import EchoEngineCore, EchoEngineFull

    if opts.output == "echo_core":
        return EchoEngineCore(), None, None, None
    if opts.output == "echo_full":
        return None, EchoEngineFull(), None, None
    engine, mdc = build_cuda_engine(opts)
    return engine, None, mdc, engine


def resolve_openai_engine(opts, core, full, mdc):
    """The OpenAI-level engine: core engines get the preprocessor and
    backend of the model card (tokenizer and chat template)."""
    from .http import build_pipeline_engine
    from .model_card import ModelDeploymentCard

    if core is None:
        return full, mdc
    if mdc is None:
        if not opts.model_path:
            raise SystemExit(f"out={opts.output} needs --model-path (tokenizer, template)")
        mdc = ModelDeploymentCard.from_local_path(opts.model_path, opts.model_name or None)
    return build_pipeline_engine(mdc, core), mdc


# -------------------------------------------------------------------- inputs
async def run_http(opts, served: Served, ready: asyncio.Future | None) -> None:
    """OpenAI ingress until cancelled."""
    from .http import HttpService

    svc = HttpService(host=opts.http_host, port=opts.http_port)
    name = (served.mdc.display_name if served.mdc else "") or opts.model_name or "default"
    svc.manager.add_chat_model(name, served.engine)
    svc.manager.add_completion_model(name, served.engine)
    port = await svc.start()
    print(f"listening on http://{opts.http_host}:{port}", flush=True)
    served.port = port
    if ready is not None and not ready.done():
        ready.set_result(served)
    try:
        await asyncio.Event().wait()
    finally:
        await svc.stop()


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
    """Build ``out=…``, serve ``in=…``; the engine is stopped on the way
    out, cancellation included. ``ready`` (optional) receives a
    :class:`Served` once the input is up."""
    core, full, mdc, torch_engine = build_output(opts)
    try:
        engine, mdc = resolve_openai_engine(opts, core, full, mdc)
        served = Served(engine=engine, torch_engine=torch_engine, mdc=mdc)
        if opts.input == "http":
            await run_http(opts, served, ready)
        else:
            if ready is not None:
                ready.set_result(served)
            await run_batch(opts, engine, mdc, opts.input[len("batch:"):])
    finally:
        if torch_engine is not None:
            t0 = time.monotonic()
            torch_engine.stop()
            logger.info("engine stopped in %.2fs", time.monotonic() - t0)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=os.environ.get("DYN_LOG", "INFO").upper())
    opts = parse_args(argv if argv is not None else sys.argv[1:])
    loop = asyncio.new_event_loop()
    main_task = loop.create_task(main_async(opts))
    # SIGINT/SIGTERM -> cancel the main task -> the engine stops.
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError, ValueError):
            loop.add_signal_handler(sig, main_task.cancel)
    try:
        loop.run_until_complete(main_task)
    except asyncio.CancelledError:
        pass
    finally:
        loop.close()


if __name__ == "__main__":
    main()
