"""Ragged paged attention: mixed prefill + decode, and pure decode.

Counterpart of ``dynamo_exp_tpu/ops/ragged_attention.py``. Queries come
as a flat token stream ``q[N, H, D]`` with per-token ``positions[N]``
(absolute context position, -1 = padding) and ``row_of[N]`` (the batch
row owning the token). Rows own KV pages through
``page_table[R, Pmax]``; a token at position ``p`` attends causally to
its row's kv positions ``<= p``, and with a sliding ``window`` only to
those ``> p - window`` (mistral, gemma2's even layers, gemma3's local
layers). Scores are ``sm_scale * q.k`` (default ``D ** -0.5``), capped
to ``softcap * tanh(s / softcap)`` when a softcap is set (gemma2). The
window and the softcap are the JAX package's ``paged_attention``
arguments; its Pallas kernel takes neither, and the JAX package sends
those families to XLA. Here every kernel takes both.

- :func:`ragged_paged_attention_ref` is the plain PyTorch version: each
  flat token becomes a T=1 row of :func:`ops.attention.paged_attention`.
- :func:`ragged_paged_attention` and :func:`ragged_decode_attention`
  are the kernel wrappers. On a CUDA tensor they launch a hand-written
  Hopper kernel from ``csrc/`` (all sources built with ``nvcc`` for
  ``sm_90a`` into one library in ``_build/`` at first use, loaded with
  ``ctypes``) or raise; on a CPU tensor they compute the plain version.
  There is no fallback from one to the other. The kernel is chosen by
  the pool dtype: the mixed shape runs the bf16 tensor-core kernel
  (``ragged_mixed_tc.cu``) on bf16 pools and the 3xTF32 tensor-core
  kernel (``ragged_attention.cu``) on float32 pools; the decode shape
  runs the split-KV pair (``ragged_decode_split.cu``) on both.

Every padding token (position -1) comes back as zeros from both
versions: the kernel writes zeros for a query with nothing to attend,
and the plain version zeroes the same slots.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from . import launches
from .attention import paged_attention

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
KERNEL_SOURCES = tuple(
    os.path.join(_CSRC, f)
    for f in ("ragged_attention.cu", "ragged_decode_split.cu", "ragged_mixed_tc.cu")
)
_HEADERS = (os.path.join(_CSRC, "common.cuh"),)
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libragged_attention.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# The kernels' instantiations (csrc/).
SUPPORTED_HEAD_DIMS = (64, 128, 256)
# Every q_tile of the tuning registry's ragged_q_tile grid (tune/space.py).
SUPPORTED_Q_TILES = (1, 4, 8, 16)
MAX_ROWS_PER_BLOCK = 64  # qpk * q_tile of one tile
# kv tokens per block of the split-KV decode kernel: on an H100 64 ran
# faster than 128 and 256 in each of five interleaved rounds of
# tools/torch_kernel_probe.py at the smoke's decode rows.
DECODE_SPLIT = 64
# The window the kernels read as "none" (the JAX package passes the same
# for its full-attention layers).
NO_WINDOW = 1 << 30

# Launches (ops/launches.py): +1 where a wrapper launches its kernel,
# nowhere else. LAUNCHES counts calls of each entry point,
# KERNEL_LAUNCHES which design served them.
LAUNCHES = launches.counter("attention_entries", ("ragged_paged_attention", "ragged_decode_attention"))
KERNEL_LAUNCHES = launches.counter("attention_kernels", ("mixed_tc_bf16", "mixed_f32", "decode_split"))

_lib = None
_lib_path = None
_lib_lock = threading.Lock()
_build_log = ""
_builds = 0


def _count(entry: str, design: str) -> None:
    """One launch of ``entry`` through ``design``."""
    launches.count("attention_entries", entry)
    launches.count("attention_kernels", design)


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


def build_log() -> str:
    """What nvcc and ptxas printed in the last build (registers, shared
    memory and spills of every kernel)."""
    return _build_log


def source_hashes(sources: tuple[str, ...] | None = None) -> dict[str, str]:
    """SHA-256 of each of ``sources`` (default ``KERNEL_SOURCES``) and
    of every header, by file name, and of the nvcc flags: what a
    library's bytes depend on."""
    out = {}
    for path in (sources or KERNEL_SOURCES) + _HEADERS:
        with open(path, "rb") as f:
            out[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
    out["nvcc_flags"] = hashlib.sha256(" ".join(NVCC_FLAGS).encode()).hexdigest()
    return out


def _stamp_path(lib_path: str) -> str:
    return lib_path + ".sources.json"


def _read_stamp(lib_path: str) -> dict | None:
    try:
        with open(_stamp_path(lib_path), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_kernel(
    force: bool = False, sources: tuple[str, ...] | None = None, lib_path: str | None = None
) -> str:
    """Compile ``sources`` (default ``KERNEL_SOURCES``) into one library
    at ``lib_path`` (default ``_build/libragged_attention.so``) unless
    the library is there and the stamp beside it
    (``<lib_path>.sources.json``, :func:`source_hashes` at its build)
    equals the sources' hashes now. The rule holds for any directory,
    also one that outlives a checkout (``--compile-cache-dir``). Sources
    find ``csrc/`` headers wherever they lie. One ``nvcc`` per source,
    all started together, then one link. Builds into a temporary
    directory and renames the library, then its stamp, into place, so
    concurrent builds never load a half-written one, and under a file
    lock in the library's directory, so that processes starting
    together (tensor-parallel ranks) run one build and the others find
    it done. Returns the library path; raises on a compile error with
    nvcc's output."""
    sources = sources or KERNEL_SOURCES
    lib_path = lib_path or _LIB_PATH
    hashes = source_hashes(sources)

    def fresh() -> bool:
        return not force and os.path.exists(lib_path) and _read_stamp(lib_path) == hashes

    if fresh():
        return lib_path
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not fresh():
            _compile(sources, lib_path, hashes, out_dir)
    return lib_path


def _compile(sources: tuple[str, ...], lib_path: str, hashes: dict, out_dir: str) -> None:
    global _build_log, _builds
    nvcc = _nvcc()
    _builds += 1
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-Xptxas=-v", "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        _build_log = "".join(logs)
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {os.path.basename(src)} ({proc.returncode}):\n{log}"
                )
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(lib, lib_path)
        stamp = os.path.join(tmp, "stamp.json")
        with open(stamp, "w", encoding="utf-8") as f:
            json.dump(hashes, f, sort_keys=True)
        os.replace(stamp, _stamp_path(lib_path))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each exported launcher's arguments (csrc/); every one returns a cudaError_t.
_SIGNATURES = {
    "dx_ragged_attention": [_PTR] * 7 + [_I32] * 7 + [_F32, _I32, _F32, _PTR],
    "dx_ragged_mixed_tc": [_PTR] * 7 + [_I32] * 7 + [_F32, _I32, _F32, _PTR],
    "dx_ragged_decode_split": [_PTR] * 8 + [_I32] * 7 + [_F32, _I32, _F32, _I32, _PTR],
}


def open_library(path: str, names: tuple[str, ...] = tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Load a library built by :func:`build_kernel` and declare the
    launchers ``names`` (all of them by default)."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_count() -> int:
    """How many times :func:`build_kernel` has run nvcc in this process."""
    return _builds


def load_kernel(lib_path: str | None = None):
    """The kernel library, built at first use. With ``lib_path`` (the
    warm boot's ``--compile-cache-dir``), the library there is built if
    stale and launched from from now on; a library loaded before stays
    mapped, so graphs captured with it stay valid."""
    global _lib, _lib_path
    with _lib_lock:
        if _lib is None or (lib_path is not None and lib_path != _lib_path):
            _lib_path = lib_path or _LIB_PATH
            _lib = open_library(build_kernel(lib_path=_lib_path))
        return _lib


def ragged_supported(
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    kv_dtype: torch.dtype,
    num_heads: int | None = None,
    q_tile: int = 8,
) -> bool:
    """Whether the Hopper kernel takes this KV layout: head dim 64,
    128 or 256, a bf16 or float32 pool, q_tile 1, 4, 8 or 16, and at most
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
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Plain ragged paged attention. Returns [N, H, D] in q's dtype,
    zeros at padding tokens. Each flat token is its own T=1 row of
    :func:`paged_attention` with its row's page table, as in the JAX
    reference; the tokens go through in slices so the per-token page
    gather stays within about 1 GiB at full model widths. ``window``
    (None or ``NO_WINDOW``: full attention) and ``softcap`` go to
    :func:`paged_attention` as the JAX reference passes them."""
    window = _window(window)
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
            window=None if window == NO_WINDOW else window,
            softcap=softcap,
        )[:, 0]
    return torch.where((positions >= 0)[:, None, None], out, torch.zeros_like(out))


def _window(window: int | None) -> int:
    """A layer's window as the kernels take it: ``NO_WINDOW`` for None
    (full attention) or anything at least as wide."""
    if window is None:
        return NO_WINDOW
    if int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return min(int(window), NO_WINDOW)


def _softcap(softcap: float | None) -> float:
    """A softcap as the kernels take it: 0.0 for none."""
    if softcap is None:
        return 0.0
    if not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return float(softcap)


# ------------------------------------------------------------------ kernel
def _check(q, k_cache, v_cache, tensors, num_kv_heads, q_tile):
    """Check what every kernel needs of its inputs; returns (N, H, D,
    ps, Hkv)."""
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache, **tensors}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in tensors.keys() - {"q", "k_cache", "v_cache"}:
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    for name in ("q", "k_cache", "v_cache"):  # read with 16-byte loads
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
    return N, H, D, ps, Hkv


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


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
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Ragged paged attention over a flat query stream. The caller
    aligns each row's query span to ``q_tile`` slots (padding tokens
    carry position -1), so every tile belongs to one row. Returns
    [N, H, D] in q's dtype, zeros at padding tokens. ``window`` and
    ``softcap``: see the module docstring."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_cache, v_cache, page_table, row_of, positions,
            num_kv_heads=num_kv_heads, sm_scale=sm_scale, window=window, softcap=softcap,
        )
    N, H, D, ps, Hkv = _check(
        q, k_cache, v_cache,
        {"page_table": page_table, "row_of": row_of, "positions": positions},
        num_kv_heads, q_tile,
    )
    if N % q_tile or row_of.shape != (N,) or positions.shape != (N,):
        raise ValueError(f"flat stream of {N} tokens is not q_tile={q_tile} aligned")
    out = torch.empty_like(q)
    if N == 0:
        return out
    scale = sm_scale if sm_scale is not None else D**-0.5
    lib = load_kernel()
    tc = q.dtype == torch.bfloat16
    fn = lib.dx_ragged_mixed_tc if tc else lib.dx_ragged_attention
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), row_of.data_ptr(), positions.data_ptr(),
        out.data_ptr(), N, H, Hkv, D, ps, page_table.shape[1], q_tile,
        float(scale), _window(window), _softcap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "ragged mixed attention")
    _count("ragged_paged_attention", "mixed_tc_bf16" if tc else "mixed_f32")
    return out


def ragged_decode_attention(
    q: torch.Tensor,  # [B, H, D] one query per row
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int32
    lengths: torch.Tensor,  # [B] int32 tokens to attend over (0 = inactive)
    num_kv_heads: int | None = None,
    split: int = DECODE_SPLIT,
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """The pure-decode shape: one query per row; row b attends its own
    ``lengths[b]`` tokens (the last ``window`` of them under a window),
    rows with length 0 return zeros. On the card each row's context is
    cut into blocks of ``split`` tokens (a multiple of 32) whose partial
    softmaxes a second pass combines; blocks wholly before the window
    are not read. ``sm_scale``, ``window`` and ``softcap``: see the
    module docstring."""
    if q.device.type == "cpu":
        B = q.shape[0]
        return ragged_paged_attention_ref(
            q, k_cache, v_cache, page_table,
            torch.arange(B, dtype=torch.int32), (lengths - 1).to(torch.int32),
            num_kv_heads=num_kv_heads, sm_scale=sm_scale, window=window, softcap=softcap,
        )
    B, H, D, ps, Hkv = _check(
        q, k_cache, v_cache, {"page_table": page_table, "lengths": lengths},
        num_kv_heads, 1,
    )
    if lengths.shape != (B,) or page_table.shape[0] != B:
        raise ValueError(f"lengths {tuple(lengths.shape)} / page table rows "
                         f"{page_table.shape[0]} do not match {B} queries")
    if split < 32 or split % 32:
        raise ValueError(f"split must be a positive multiple of 32, got {split}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    pmax = page_table.shape[1]
    n_splits = -(-(pmax * ps) // split)
    part_ml = torch.empty(B * H * n_splits * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(B * H * n_splits * D, dtype=torch.float32, device=q.device)
    err = load_kernel().dx_ragged_decode_split(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, H, Hkv, D, ps, pmax, split,
        float(sm_scale if sm_scale is not None else D**-0.5), _window(window),
        _softcap(softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "ragged decode attention")
    _count("ragged_decode_attention", "decode_split")
    return out
