"""``jax.random``'s threefry generator, written in torch.

The JAX package draws every seeded token with
``jax.random.categorical(jax.random.fold_in(jax.random.PRNGKey(seed),
pos), logits)``. This module reproduces those draws bit for bit, so a
seeded stream is the same whichever engine runs it. Counterparts in
jax 0.9.0 (with ``jax_threefry_partitionable=True``, its default):

- ``jax/_src/prng.py``: ``threefry_2x32`` (1092) and its lowering,
  ``_threefry_seed`` (817), ``_threefry_fold_in`` (1168),
  ``_threefry_random_bits_partitionable`` (1184);
- ``jax/_src/random.py``: ``_uniform`` (435), ``_gumbel`` (1723, mode
  "low") and ``categorical`` (1739).

Values are uint32 held in int64 tensors and masked to 32 bits after
every operation that can carry out of them: CUDA torch has no full
uint32 arithmetic. Every function works on whole tensors on any device,
with no host sync.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000  # float32 1.0
_F32_MANTISSA = 23


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds: key ``(k0, k1)``, counter
    ``(x0, x1)``, all int64 tensors of uint32 values that broadcast
    together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``PRNGKey(seed)`` for seeds of at most 32 bits: ``(seed >> 32,
    seed & 0xFFFFFFFF)``, and the high word is 0 (a logical shift of a
    32-bit seed by 32)."""
    seed = seed.to(torch.int64)
    return torch.zeros_like(seed), seed & _M32


def fold_in(
    key: tuple[torch.Tensor, torch.Tensor], data: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(key, data)``: the threefry hash of the counter
    ``(0, data)`` (``_threefry_seed`` of a uint32 is ``(0, data)``)."""
    data = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` indices under each key, as
    ``jax.random.bits(key, (n,))``: index i hashes the counter
    ``(0, i)`` and takes ``x0 ^ x1``. ``key`` words of shape [B] give
    [B, n]."""
    k0, k1 = key[0][..., None], key[1][..., None]
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return x0 ^ x1


def uniform(
    key: tuple[torch.Tensor, torch.Tensor], n: int, minval: float = 0.0
) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, 1) and floored at minval. Returns float32 [..., n]."""
    bits = random_bits(key, n)
    f = ((bits >> (32 - _F32_MANTISSA)) | _F32_ONE_BITS).to(torch.int32)
    f = f.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (1.0 - lo) + lo)


def gumbel(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in mode "low":
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, minval=tiny)))


def categorical(
    key: tuple[torch.Tensor, torch.Tensor], logits: torch.Tensor
) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one
    key per row: the argmax of Gumbel noise plus the logits."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
