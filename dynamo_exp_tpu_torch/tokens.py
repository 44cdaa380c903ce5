"""Chained block hashing over fixed-size token blocks.

Counterpart of ``dynamo_exp_tpu/tokens.py``: a splitmix64 chain whose
block hashes equal the JAX package's bit for bit, so both packages'
prefix indexes, KV events and G3 page keys agree. Each block gets a
*local* hash over its tokens and a *sequence* hash chaining it to its
prefix; equal sequence hashes imply equal full prefixes. The public
functions run the host C++ library (``native/blockhash.cpp``); the
``py_*`` functions are its pure-Python mirror, the plain version the
tests hold it to.
"""

from __future__ import annotations

from typing import Sequence

from . import native as _native

# Version tag of the block-hash algorithm (v2 = the splitmix64 chain),
# mixed into the default seed exactly as the JAX package does.
HASH_ALGO_VERSION = 2
DEFAULT_HASH_SEED = 1337 ^ (HASH_ALGO_VERSION << 32)

_M = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_LOCAL_TAG = 0x00B10C4A54AA17E5
_CHAIN_TAG = 0x00C4A18A54BB28F6
_NO_PARENT_TAG = 0x006E6F5061726E74


def _mix64(x: int) -> int:
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M
    x ^= x >> 31
    return x


def py_compute_block_hash(tokens: Sequence[int], seed: int = DEFAULT_HASH_SEED) -> int:
    """Hash one block's tokens (local hash, not chained)."""
    h = _mix64((seed & _M) ^ _LOCAL_TAG)
    for t in tokens:
        h = _mix64(h ^ ((int(t) + _GOLDEN) & _M))
    return _mix64(h ^ len(tokens))


def py_chain_hash(parent: int | None, local: int, seed: int = DEFAULT_HASH_SEED) -> int:
    """Chain a block's local hash onto its prefix's sequence hash."""
    h = _mix64((seed & _M) ^ _CHAIN_TAG)
    h = _mix64(h ^ (_NO_PARENT_TAG if parent is None else parent & _M))
    return _mix64(h ^ (local & _M))


def py_block_hashes_for_seq(
    tokens: Sequence[int], block_size: int, seed: int = DEFAULT_HASH_SEED
) -> list[int]:
    """Sequence hashes for every *complete* block of ``tokens``."""
    out: list[int] = []
    parent = None
    for start in range(0, len(tokens) - block_size + 1, block_size):
        parent = py_chain_hash(
            parent, py_compute_block_hash(tokens[start : start + block_size], seed), seed
        )
        out.append(parent)
    return out


def compute_block_hash(tokens: Sequence[int], seed: int = DEFAULT_HASH_SEED) -> int:
    """Hash one block's tokens (local hash, not chained)."""
    return _native.block_hash(tokens, seed)


def chain_hash(parent: int | None, local: int, seed: int = DEFAULT_HASH_SEED) -> int:
    """Chain a block's local hash onto its prefix's sequence hash."""
    return _native.chain_hash(parent, local, seed)


def compute_block_hashes_for_seq(
    tokens: Sequence[int], block_size: int, seed: int = DEFAULT_HASH_SEED
) -> list[int]:
    """Sequence hashes for every *complete* block of ``tokens``: what the
    router hashes a prompt with, in one native call."""
    return _native.seq_hashes(tokens, block_size, seed)
