"""What a warm boot keeps across processes: ``--compile-cache-dir``.

Counterpart of ``dynamo_exp_tpu/aot/compile.py``. The JAX package keeps
its compiled XLA programs in JAX's persistent compilation cache, so a
new process deserialises them instead of compiling. What a port process
compiles is the kernel library (``nvcc``, ``ops/ragged_attention.py``),
so the cache directory holds that library, built there by
``ops.ragged_attention.build_kernel`` (whose stamp beside the library
decides whether it is stale), and ``manifest.json``: the graph
lattice's hash (``aot/lattice.py``) and the SHA-256 of every kernel
source and header and of the nvcc flags. A boot against a directory
whose library was built from the checkout's sources runs no ``nvcc``
(``builds: 0`` in its :class:`~.warmup.PrewarmReport`).

CUDA graphs cannot be kept: a graph belongs to the process (and the
memory) it was captured in, so every boot captures them again
(``aot/warmup.py``).
"""

from __future__ import annotations

import json
import os

from ..ops import ragged_attention as tra
from .lattice import GraphManifest, build_manifest

MANIFEST_FILENAME = "manifest.json"
LIB_NAME = "libragged_attention.so"


def manifest_for_engine(engine) -> GraphManifest:
    """The graph lattice of a live engine (its resolved attention)."""
    return build_manifest(engine.cfg, engine.attn_impl)


def read_manifest(cache_dir: str) -> dict | None:
    path = os.path.join(cache_dir, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_manifest(cache_dir: str, manifest: GraphManifest) -> str:
    path = os.path.join(cache_dir, MANIFEST_FILENAME)
    record = {
        "manifest_hash": manifest.hash(),
        "manifest": manifest.to_dict(),
        "kernels": tra.source_hashes(),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(record, f, sort_keys=True, indent=2)
        f.write("\n")
    return path


def ensure_kernel_library(engine, cache_dir: str = "", manifest: GraphManifest | None = None) -> int:
    """Build or load the kernel library before anything is captured
    (nvcc cannot run inside a capture): into and from ``cache_dir``
    when given, else ``_build/``. With ``cache_dir``, ``manifest.json``
    is rewritten. Returns the nvcc builds this ran (0 or 1). An engine
    that runs no kernel (the plain version on the CPU) needs no
    library."""
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    builds = 0
    if engine.attn_impl == "kernel" and engine.device.type == "cuda":
        before = tra.build_count()
        tra.load_kernel(os.path.join(cache_dir, LIB_NAME) if cache_dir else None)
        builds = tra.build_count() - before
    if cache_dir:
        write_manifest(cache_dir, manifest or manifest_for_engine(engine))
    return builds
