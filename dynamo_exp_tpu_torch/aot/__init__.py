"""Warm boot for the port (counterpart of ``dynamo_exp_tpu/aot/``):
the lattice of decode-window and mixed keys (``lattice.py``), its
prewarm with CUDA graph capture (``warmup.py``) and the kernel-library
cache (``compile.py``)."""

from .compile import ensure_kernel_library, manifest_for_engine, read_manifest
from .lattice import (
    GraphManifest,
    MixedKey,
    WindowKey,
    build_manifest,
    resolve_mixed_key,
    resolve_window_key,
)
from .warmup import PrewarmReport, prewarm_engine

__all__ = [
    "GraphManifest",
    "MixedKey",
    "PrewarmReport",
    "WindowKey",
    "build_manifest",
    "ensure_kernel_library",
    "manifest_for_engine",
    "prewarm_engine",
    "read_manifest",
    "resolve_mixed_key",
    "resolve_window_key",
]
