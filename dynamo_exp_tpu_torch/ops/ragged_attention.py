"""Ragged paged attention: one kernel for mixed prefill + decode.

Counterpart of ``dynamo_exp_tpu/ops/ragged_attention.py``. Queries come
as a flat token stream ``q[N, H, D]`` with per-token ``positions[N]``
(absolute context position, -1 = padding) and ``row_of[N]`` (the batch
row owning the token). Rows own KV pages through
``page_table[R, Pmax]``; a token at position ``p`` attends causally to
its row's kv positions ``<= p``.

- :func:`ragged_paged_attention_ref` is the plain PyTorch version: each
  flat token becomes a T=1 row of :func:`ops.attention.paged_attention`.
- :func:`ragged_paged_attention` and :func:`ragged_decode_attention`
  are the kernel wrappers. On a CUDA tensor they launch the hand-written
  Hopper kernel in ``csrc/ragged_attention.cu`` (built with ``nvcc`` for
  ``sm_90a`` into ``_build/`` at first use, loaded with ``ctypes``) or
  raise; on a CPU tensor they compute the plain version. There is no
  fallback from one to the other.

Every padding token (position -1) comes back as zeros from both
versions: the kernel writes zeros for a query with nothing to attend,
and the plain version zeroes the same slots.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from .attention import paged_attention

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG, "csrc", "ragged_attention.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libragged_attention.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# The kernel's instantiations (csrc/ragged_attention.cu).
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_Q_TILES = (1, 8)
MAX_ROWS_PER_BLOCK = 64  # qpk * q_tile: 4 warps x 16 rows

# Kernel launches per entry point: +1 where each wrapper launches the
# CUDA kernel, nowhere else (the CPU path does not count).
LAUNCHES = {"ragged_paged_attention": 0, "ragged_decode_attention": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_kernel(force: bool = False) -> str:
    """Compile ``csrc/ragged_attention.cu`` into ``_build/`` unless an
    up-to-date library is there. Builds into a temporary file and
    renames it, so concurrent builds never load a half-written
    library. Returns the library path; raises on a compile error with
    nvcc's output."""
    if (
        not force
        and os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(KERNEL_SOURCE)
    ):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


def load_kernel():
    """The kernel library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernel())
            fn = lib.dx_ragged_attention
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 7
                + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            _lib = lib
        return _lib


def ragged_supported(
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    kv_dtype: torch.dtype,
    num_heads: int | None = None,
    q_tile: int = 8,
) -> bool:
    """Whether the Hopper kernel takes this KV layout: head dim 64 or
    128, a bf16 or float32 pool, q_tile 1 or 8, and at most
    ``MAX_ROWS_PER_BLOCK`` query rows (q heads per kv head x q_tile) in
    one block. Any page size works (pages are read token by token)."""
    qpk = (num_heads // num_kv_heads) if num_heads else 1
    return (
        page_size >= 1
        and head_dim in SUPPORTED_HEAD_DIMS
        and kv_dtype in (torch.bfloat16, torch.float32)
        and q_tile in SUPPORTED_Q_TILES
        and qpk * q_tile <= MAX_ROWS_PER_BLOCK
    )


# --------------------------------------------------------------- reference
def ragged_paged_attention_ref(
    q: torch.Tensor,  # [N, H, D] flat query stream
    k_cache: torch.Tensor,  # [P, ps, Hkv*D]
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [R, PB] int
    row_of: torch.Tensor,  # [N] int owning row per query token
    positions: torch.Tensor,  # [N] int absolute position, -1 = padding
    num_kv_heads: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain ragged paged attention. Returns [N, H, D] in q's dtype,
    zeros at padding tokens. Each flat token is its own T=1 row of
    :func:`paged_attention` with its row's page table, as in the JAX
    reference; the tokens go through in slices so the per-token page
    gather stays within about 1 GiB at full model widths."""
    N = q.shape[0]
    pb, ps, fused = page_table.shape[1], k_cache.shape[1], k_cache.shape[2]
    per_token = max(pb * ps * fused * 4 * 2, 1)
    step = max(1, (1 << 30) // per_token)
    out = torch.empty_like(q)
    for s in range(0, N, step):
        sl = slice(s, min(s + step, N))
        out[sl] = paged_attention(
            q[sl, None],
            k_cache,
            v_cache,
            page_table[row_of[sl].long()],
            positions[sl, None],
            sm_scale=sm_scale,
        )[:, 0]
    return torch.where((positions >= 0)[:, None, None], out, torch.zeros_like(out))


# ------------------------------------------------------------------ kernel
def _launch(
    q, k_cache, v_cache, page_table, row_of, positions, num_kv_heads, q_tile,
    sm_scale,
) -> torch.Tensor:
    """Check the inputs, launch the kernel on the current stream, and
    raise if the launch failed."""
    tensors = {
        "q": q, "k_cache": k_cache, "v_cache": v_cache,
        "page_table": page_table, "row_of": row_of, "positions": positions,
    }
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("page_table", "row_of", "positions"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    for name in ("k_cache", "v_cache"):  # read with 16-byte loads
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(
            f"q/k/v dtypes must match: {q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    if k_cache.shape != v_cache.shape or k_cache.dim() != 3:
        raise ValueError(f"bad pool shapes {k_cache.shape} / {v_cache.shape}")
    N, H, D = q.shape
    _, ps, fused = k_cache.shape
    Hkv = num_kv_heads if num_kv_heads is not None else fused // D
    if Hkv * D != fused or H % Hkv:
        raise ValueError(f"pool lane dim {fused} != Hkv*D = {Hkv}*{D}")
    if not ragged_supported(ps, Hkv, D, k_cache.dtype, H, q_tile):
        raise ValueError(
            f"unsupported layout for the ragged kernel: D={D}, H={H}, "
            f"Hkv={Hkv}, q_tile={q_tile}, dtype={k_cache.dtype}"
        )
    if N % q_tile or row_of.shape != (N,) or positions.shape != (N,):
        raise ValueError(f"flat stream of {N} tokens is not q_tile={q_tile} aligned")
    out = torch.empty_like(q)
    if N == 0:
        return out
    scale = sm_scale if sm_scale is not None else D**-0.5
    lib = load_kernel()
    err = lib.dx_ragged_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), row_of.data_ptr(), positions.data_ptr(),
        out.data_ptr(), N, H, Hkv, D, ps, page_table.shape[1], q_tile,
        float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: cudaError {err}")
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # [N, H, D] flat query stream (N % q_tile == 0)
    k_cache: torch.Tensor,  # [P, ps, Hkv*D]
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [R, Pmax] int32
    row_of: torch.Tensor,  # [N] int32 owning row per query token
    positions: torch.Tensor,  # [N] int32 absolute position, -1 = padding
    num_kv_heads: int | None = None,
    q_tile: int = 8,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Ragged paged attention over a flat query stream. The caller
    aligns each row's query span to ``q_tile`` slots (padding tokens
    carry position -1), so every tile belongs to one row. Returns
    [N, H, D] in q's dtype, zeros at padding tokens."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_cache, v_cache, page_table, row_of, positions,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale,
        )
    out = _launch(
        q, k_cache, v_cache, page_table, row_of, positions, num_kv_heads,
        q_tile, sm_scale,
    )
    LAUNCHES["ragged_paged_attention"] += 1
    return out


def ragged_decode_attention(
    q: torch.Tensor,  # [B, H, D] one query per row
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int32
    lengths: torch.Tensor,  # [B] int32 tokens to attend over (0 = inactive)
    num_kv_heads: int | None = None,
) -> torch.Tensor:
    """The pure-decode shape: one query per row at ``q_tile=1``; row b
    attends its own ``lengths[b]`` tokens, rows with length 0 return
    zeros."""
    B = q.shape[0]
    row_of = torch.arange(B, dtype=torch.int32, device=q.device)
    positions = (lengths - 1).to(torch.int32)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_cache, v_cache, page_table, row_of, positions,
            num_kv_heads=num_kv_heads,
        )
    out = _launch(
        q, k_cache, v_cache, page_table, row_of, positions, num_kv_heads, 1,
        None,
    )
    LAUNCHES["ragged_decode_attention"] += 1
    return out
