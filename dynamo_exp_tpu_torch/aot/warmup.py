"""Warm boot: every window and mixed variant before the first request.

Counterpart of ``dynamo_exp_tpu/aot/warmup.py``. :func:`prewarm_engine`
runs on the boot thread before ``TorchEngine.start()`` (it refuses an
engine whose loop runs), in this order:

1. the kernel library is built or loaded (``aot/compile.py``), since
   nvcc cannot run inside a CUDA graph capture;
2. every mixed key of the manifest (``aot/lattice.py``), then every
   window key, runs once with all-padding inputs: every flat token or
   row at position -1, so its K/V writes go to the scratch page past
   the pool, its penalty rows are the scratch row (gathered and written
   back unchanged) and nothing reaches a token. On a card that run is
   the replay of the key's CUDA graph, captured just before
   (``engine/graphs.py``), so the first traffic dispatch of a key
   replays and captures nothing; on the CPU, or with
   ``cuda_graphs=False``, the key runs eagerly;
3. the scratch page is zeroed again, so the KV pools equal a cold
   engine's.

The report (variants and graphs of each kind, seconds of each kind,
kernel builds, seconds and the graph pool's bytes) goes into
``TorchEngine.metrics()["prewarm"]`` and, through
``TorchEngine.record_prewarm``, into ``dynamo_prewarm_seconds``,
``dynamo_prewarm_variants_total{kind}`` and a ``prewarm`` flight event.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass

import torch

from .compile import ensure_kernel_library, manifest_for_engine
from .lattice import GraphManifest

log = logging.getLogger(__name__)


@dataclass
class PrewarmReport:
    """What one warm boot did."""

    manifest_hash: str = ""
    variants: int = 0  # window keys run
    graphs: int = 0  # window graphs captured (0 without graphs)
    window_seconds: float = 0.0  # running (and capturing) the window keys
    mixed_variants: int = 0  # mixed keys run
    mixed_graphs: int = 0  # mixed graphs captured (0 without graphs)
    mixed_seconds: float = 0.0
    builds: int = 0  # nvcc builds of the kernel library
    seconds: float = 0.0
    pool_bytes: int = 0  # device memory of the graphs' shared pool

    def to_dict(self) -> dict:
        return asdict(self)


def _run_padding(engine, key, host: dict, body) -> None:
    """``key`` once on the all-padding arrays ``host``: the replay of its
    graph (captured at its first use) or its body, eagerly."""
    graphs = engine.graphs
    if graphs is None:
        body(key, dict(zip(host, engine._upload(*host.values()))))
        return
    # A key that earlier traffic captured still holds that traffic's
    # last dispatch: padding goes up again before the replay.
    g = graphs.get(key)
    engine._upload_into(g.in_buf, list(host.values()), g.offs)
    graphs.replay(g)


def prewarm_engine(engine, manifest: GraphManifest | None = None, cache_dir: str = "") -> PrewarmReport:
    """Run (and on a card capture) every mixed and window variant of
    ``manifest`` (default: the engine's whole lattice) before the
    engine's loop starts."""
    if engine._running or engine._thread is not None:
        raise RuntimeError("prewarm runs before start(): the engine's loop is running")
    if engine.cfg.tp > 1:
        from ..engine.config import refuse_under_tp

        raise refuse_under_tp("prewarm (the warm boot's graphs)", "graphs")
    t0 = time.perf_counter()  # dynlint: determinism(prewarm wall-clock metric)
    manifest = manifest or manifest_for_engine(engine)
    report = PrewarmReport(manifest_hash=manifest.hash())
    report.builds = ensure_kernel_library(engine, cache_dir, manifest)
    graphs = engine.graphs
    captured = dict(graphs.captured) if graphs is not None else {}
    t = time.perf_counter()  # dynlint: determinism(prewarm wall-clock metric)
    for key in manifest.mixed:
        _run_padding(engine, key, engine._mixed_host(key), engine._mixed_body)
        report.mixed_variants += 1
    report.mixed_seconds = time.perf_counter() - t  # dynlint: determinism(prewarm wall-clock metric)
    t = time.perf_counter()  # dynlint: determinism(prewarm wall-clock metric)
    for key in manifest.windows:
        _run_padding(engine, key, engine._window_host(key), engine._window_body)
        report.variants += 1
    report.window_seconds = time.perf_counter() - t  # dynlint: determinism(prewarm wall-clock metric)
    engine.k_cache[:, engine._drop_page].zero_()
    engine.v_cache[:, engine._drop_page].zero_()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        engine._poll_staged()
    if graphs is not None:
        report.graphs = graphs.captured["window"] - captured["window"]
        report.mixed_graphs = graphs.captured["mixed"] - captured["mixed"]
        report.pool_bytes = graphs.pool_bytes()
    report.seconds = time.perf_counter() - t0  # dynlint: determinism(prewarm wall-clock metric)
    engine.record_prewarm(report, manifest)
    log.info(
        "prewarm: %d window variants (%d graphs, %.2fs), %d mixed variants (%d graphs, "
        "%.2fs), pool %.1f MiB, %d kernel builds in %.2fs (manifest %s)", report.variants,
        report.graphs, report.window_seconds, report.mixed_variants, report.mixed_graphs,
        report.mixed_seconds, report.pool_bytes / 2**20, report.builds, report.seconds,
        report.manifest_hash[:12],
    )
    return report
