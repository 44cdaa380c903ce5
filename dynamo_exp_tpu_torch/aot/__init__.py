"""Warm boot for the port (counterpart of ``dynamo_exp_tpu/aot/``):
the decode-window lattice (``lattice.py``), its prewarm with CUDA graph
capture (``warmup.py``) and the kernel-library cache
(``compile.py``)."""

from .compile import ensure_kernel_library, manifest_for_engine, read_manifest
from .lattice import WindowKey, WindowManifest, build_manifest, resolve_window_key
from .warmup import PrewarmReport, prewarm_engine

__all__ = [
    "PrewarmReport",
    "WindowKey",
    "WindowManifest",
    "build_manifest",
    "ensure_kernel_library",
    "manifest_for_engine",
    "prewarm_engine",
    "read_manifest",
    "resolve_window_key",
]
