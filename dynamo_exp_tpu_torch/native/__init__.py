"""Host C++ tier: the block hash, built on demand with the host's ``g++``
and loaded with ``ctypes`` (counterpart of ``dynamo_exp_tpu/native/``).

``blockhash.cpp`` is compiled with ``g++ -O3 -shared -fPIC`` at the first
hash call (not at import: worker processes importing ``tokens.py`` must
not each stall on a compile at start-up) into the git-ignored
``dynamo_exp_tpu_torch/_build/``, under a name carrying the source's
SHA-256, so an edited source is never served by an older library. The
build goes to a temporary file that ``os.replace`` moves into place, so
processes that build at once do not tear each other's library.

The JAX loader falls back to Python when the build fails; this one
raises with the compiler's stderr. Hashes cross process boundaries
(router against worker, the G3 store's page keys against a later boot),
so a host without the library is a fault to see, not to hide. The
Python mirror in ``tokens.py`` (``py_compute_block_hash``,
``py_chain_hash``, ``py_block_hashes_for_seq``) is the plain version the
tests hold this library to, bit for bit, and to the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "blockhash.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_M = (1 << 64) - 1
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


class NativeLibraryError(RuntimeError):
    """``g++`` could not build or load ``blockhash.cpp``."""


def library_path() -> str:
    """Where the library for the current source lives (built or not)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libblockhash-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise NativeLibraryError(f"g++ failed on {_SRC} (rc {r.returncode}):\n{r.stderr}")
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeLibraryError(f"g++ could not build {_SRC}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeLibraryError(f"cannot load {path}: {e}") from e
    lib.dx_block_hash.restype = ctypes.c_uint64
    lib.dx_block_hash.argtypes = [_U32P, ctypes.c_uint64, ctypes.c_uint64]
    lib.dx_chain_hash.restype = ctypes.c_uint64
    lib.dx_chain_hash.argtypes = [ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
                                  ctypes.c_uint64]
    lib.dx_seq_hashes.restype = ctypes.c_uint64
    lib.dx_seq_hashes.argtypes = [_U32P, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                                  ctypes.c_int, ctypes.c_uint64, _U64P]
    return lib


_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
CALLS = {"block_hash": 0, "chain_hash": 0, "seq_hashes": 0}


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded (raises if it cannot
    be)."""
    return _get_lib() is not None


def block_hash(tokens, seed: int) -> int:
    lib = _get_lib()
    arr = np.ascontiguousarray(tokens, dtype=np.uint32)
    CALLS["block_hash"] += 1
    return int(lib.dx_block_hash(arr.ctypes.data_as(_U32P), len(arr), seed & _M))


def chain_hash(parent: int | None, local: int, seed: int) -> int:
    lib = _get_lib()
    CALLS["chain_hash"] += 1
    return int(lib.dx_chain_hash(0 if parent is None else parent & _M,
                                 0 if parent is None else 1, local & _M, seed & _M))


def seq_hashes(tokens, block_size: int, seed: int, parent: int | None = None) -> list[int]:
    """Sequence hashes of every complete block: one call for the whole
    prompt."""
    lib = _get_lib()
    arr = np.ascontiguousarray(tokens, dtype=np.uint32)
    nb = len(arr) // block_size
    if nb == 0:
        return []
    out = np.empty(nb, dtype=np.uint64)
    CALLS["seq_hashes"] += 1
    n = lib.dx_seq_hashes(arr.ctypes.data_as(_U32P), len(arr), block_size, seed & _M,
                          0 if parent is None else 1, 0 if parent is None else parent & _M,
                          out.ctypes.data_as(_U64P))
    return [int(h) for h in out[:n]]
