"""Warm boot: every decode-window variant before the first request.

Counterpart of ``dynamo_exp_tpu/aot/warmup.py``. :func:`prewarm_engine`
runs on the boot thread before ``TorchEngine.start()`` (it refuses an
engine whose loop runs), in this order:

1. the kernel library is built or loaded (``aot/compile.py``), since
   nvcc cannot run inside a CUDA graph capture;
2. every mixed flat-stream bucket runs one all-padding forward and both
   samplers, eagerly (mixed dispatches are not graphed), which settles
   the GEMM and allocator state of those shapes before any capture;
3. every window key of the manifest (``aot/lattice.py``) runs once
   with an all-padding batch: every row at position -1, so its K/V
   writes go to the scratch page past the pool, its penalty rows are
   the scratch row (gathered and written back unchanged) and nothing
   reaches a token. On a card that run is the replay of the key's CUDA
   graph, captured just before (``engine/graphs.py``), so the first
   traffic dispatch of a key replays and captures nothing; on the CPU
   the window runs eagerly;
4. the scratch page is zeroed again, so the KV pools equal a cold
   engine's.

The report (variants, graphs captured, kernel builds, seconds and the
graph pool's bytes) goes into ``TorchEngine.metrics()["prewarm"]``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..models.llama import forward_ragged
from ..ops.sampling import sample_tokens_seeded
from .compile import ensure_kernel_library, manifest_for_engine
from .lattice import WindowManifest

log = logging.getLogger(__name__)


@dataclass
class PrewarmReport:
    """What one warm boot did."""

    manifest_hash: str = ""
    variants: int = 0  # window keys run
    graphs: int = 0  # CUDA graphs captured (0 on the CPU)
    mixed_buckets: int = 0  # mixed flat-stream sizes run
    builds: int = 0  # nvcc builds of the kernel library
    seconds: float = 0.0
    pool_bytes: int = 0  # device memory of the graphs' shared pool

    def to_dict(self) -> dict:
        return asdict(self)


def _mixed_padding(engine, n: int) -> None:
    """One all-padding mixed forward of ``n`` flat tokens (all owned by
    the scratch row, writes dropped) and both samplers on its logits."""
    cfg = engine.cfg
    B1 = cfg.max_decode_slots + 1
    host = (
        np.zeros(n, np.int64), np.full(n, -1, np.int32), np.full(n, B1 - 1, np.int32),
        np.zeros((B1, cfg.max_pages_per_seq), np.int32), np.zeros(B1, np.int64),
        *engine._sampler_arrays(B1),
    )
    tokens, positions, row_of, table, out_idx, seeds, temp, top_k, top_p, *_ = engine._upload(*host)
    logits, _, _ = forward_ragged(
        engine.model, cfg.model, tokens, positions, row_of, table, engine.k_cache,
        engine.v_cache, out_idx, attn_pages=1, attn_impl=engine.attn_impl,
        q_tile=engine._ragged_align(), drop_page=engine._drop_page,
    )
    torch.argmax(logits, dim=-1)
    sample_tokens_seeded(logits, seeds, out_idx, temp, top_k, top_p)


def prewarm_engine(engine, manifest: WindowManifest | None = None, cache_dir: str = "") -> PrewarmReport:
    """Run (and on a card capture) every window variant of ``manifest``
    (default: the engine's whole lattice) and every mixed bucket, before
    the engine's loop starts."""
    if engine._running or engine._thread is not None:
        raise RuntimeError("prewarm runs before start(): the engine's loop is running")
    t0 = time.perf_counter()
    manifest = manifest or manifest_for_engine(engine)
    report = PrewarmReport(manifest_hash=manifest.hash())
    report.builds = ensure_kernel_library(engine, cache_dir, manifest)
    # Mixed buckets first: eager GEMMs of every kind the model runs
    # settle cuBLAS on this thread before any capture.
    for n in manifest.mixed_buckets:
        _mixed_padding(engine, n)
        report.mixed_buckets += 1
    graphs = engine.graphs
    captured = graphs.captured if graphs is not None else 0
    for key in manifest.windows:
        host = engine._window_host(key)  # all padding
        if graphs is not None:
            # Captured from all-padding inputs at its first use; a key
            # that earlier traffic captured still holds that traffic's
            # last window, so padding goes up again before the replay.
            g = graphs.get(key)
            engine._upload_into(g.in_buf, list(host.values()), g.offs)
            graphs.replay(g)
        else:
            engine._window_body(key, dict(zip(host, engine._upload(*host.values()))))
        report.variants += 1
    engine.k_cache[:, engine._drop_page].zero_()
    engine.v_cache[:, engine._drop_page].zero_()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        engine._poll_staged()
    if graphs is not None:
        report.graphs = graphs.captured - captured
        report.pool_bytes = graphs.pool_bytes()
    report.seconds = time.perf_counter() - t0
    engine.prewarm_report = report
    log.info(
        "prewarm: %d window variants (%d graphs, pool %.1f MiB), %d mixed buckets, "
        "%d kernel builds in %.2fs (manifest %s)", report.variants, report.graphs,
        report.pool_bytes / 2**20, report.mixed_buckets, report.builds, report.seconds,
        report.manifest_hash[:12],
    )
    return report
