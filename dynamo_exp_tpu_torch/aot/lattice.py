"""The decode-window lattice, enumerated offline.

Counterpart of ``dynamo_exp_tpu/aot/lattice.py``. In the JAX package a
decode window is one compiled XLA program per variant key; in the port
it is one CUDA graph per key (``engine/graphs.py``). The key of a
windowed dispatch is

    (rows bucket, page-bound bucket, full sampler?, logprobs?)

- rows: the window's rows padded to a power of two, capped at
  ``max_decode_slots`` (the JAX ``windowed_token_buckets``);
- page bound: the table columns the window reads, a power of two from
  ``PAGE_FLOOR_TOKENS`` of pages up to ``max_pages_per_seq``. Unlike
  the TPU key (``resolve_ragged_key``, whose Pallas kernel reads true
  lengths and drops the bound), it stays: the split-KV decode kernel's
  grid is sized from ``pages * page_size`` (``ops/ragged_attention.py``).

One source of truth: :func:`resolve_window_key` keys every live
windowed dispatch of ``TorchEngine`` and every entry of
:func:`build_manifest`, so the manifest holds every key the engine can
dispatch. Mixed dispatches (prefill chunks, verify spans) are not
graphed; the manifest lists their flat-stream token buckets, which a
warm boot runs once eagerly.

Everything here is pure: config in, manifest out, no clock and no
environment, so the manifest's hash is the same in every process.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field

# The smallest page bound, in tokens: one block of the split-KV decode
# kernel (``ops.ragged_attention.DECODE_SPLIT``). Below it a smaller
# grid saves nothing and only adds graphs.
PAGE_FLOOR_TOKENS = 64


def pow2_bucket(n: int, floor: int, cap: int | None = None) -> int:
    """Next power of two >= n, starting at ``floor``, optionally capped
    (the JAX ``EngineConfig._pow2_bucket``)."""
    b = floor
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _pow2_candidates(cap: int) -> list[int]:
    """1, 2, 4, ... up to and including ``cap``: probe points that hit
    every output of a :func:`pow2_bucket` helper capped at ``cap``."""
    out, n = [], 1
    while n < cap:
        out.append(n)
        n *= 2
    out.append(max(cap, 1))
    return out


def rows_bucket_for(cfg, n: int) -> int:
    return pow2_bucket(n, 1, cfg.max_decode_slots)


def page_bucket_for(cfg, n_pages: int) -> int:
    floor = min(cfg.max_pages_per_seq, -(-PAGE_FLOOR_TOKENS // cfg.page_size))
    return pow2_bucket(max(n_pages, floor), 1, cfg.max_pages_per_seq)


@dataclass(frozen=True, order=True)
class WindowKey:
    """One windowed variant: one CUDA graph."""

    rows: int
    pages: int
    full_sampler: bool
    want_lp: bool


def resolve_window_key(cfg, nb: int, attn_pages: int, full_sampler: bool, want_lp: bool) -> WindowKey:
    """The key of a window over ``nb`` rows whose longest row needs
    ``attn_pages`` table columns. The engine pads its arrays to the
    key's rows and pages, eagerly or graphed alike."""
    return WindowKey(rows_bucket_for(cfg, nb), page_bucket_for(cfg, attn_pages),
                     bool(full_sampler), bool(want_lp))


def windowed_row_buckets(cfg) -> list[int]:
    return sorted({rows_bucket_for(cfg, n) for n in _pow2_candidates(cfg.max_decode_slots)})


def page_bound_buckets(cfg) -> list[int]:
    return sorted({page_bucket_for(cfg, n) for n in _pow2_candidates(cfg.max_pages_per_seq)})


def mixed_token_buckets(cfg) -> list[int]:
    """Flat-stream sizes a warm boot runs a mixed forward at: powers of
    two from 16 up to the largest stream (every slot prefilling a full
    chunk, or verifying the widest draft, each span q_tile-aligned)."""
    per_row = max(cfg.prefill_chunk, cfg.spec_max_draft + 1)
    most = cfg.max_decode_slots * (per_row + cfg.ragged_q_tile - 1)
    return sorted({pow2_bucket(n, 16) for n in _pow2_candidates(most)})


def window_keys(cfg) -> list[WindowKey]:
    """Every key a windowed dispatch can resolve to, deduplicated
    through :func:`resolve_window_key`."""
    keys = {
        resolve_window_key(cfg, nb, pages, fs, lp)
        for nb in _pow2_candidates(cfg.max_decode_slots)
        for pages in _pow2_candidates(cfg.max_pages_per_seq)
        for fs in (False, True)
        for lp in (False, True)
    }
    return sorted(keys)


_SCHEMA = 1


@dataclass
class WindowManifest:
    """The window lattice of one engine shape. ``hash()`` covers every
    field: the model, the knobs that shape a window, the attention
    implementation, the lattice and the mixed buckets."""

    model: dict
    engine: dict
    windows: list[WindowKey] = field(default_factory=list)
    mixed_buckets: list[int] = field(default_factory=list)
    schema: int = _SCHEMA

    def to_dict(self) -> dict:
        return {
            "schema": self.schema, "model": self.model, "engine": self.engine,
            "windows": [asdict(k) for k in self.windows],
            "mixed_buckets": list(self.mixed_buckets),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()

    def __len__(self) -> int:
        return len(self.windows)


def _fingerprint(obj) -> dict:
    out = {}
    for k, v in sorted(asdict(obj).items()):
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


def _engine_fingerprint(cfg, attn_impl: str) -> dict:
    return {
        "max_decode_slots": cfg.max_decode_slots,
        "page_size": cfg.page_size,
        "num_pages": cfg.num_pages,
        "max_model_len": cfg.max_model_len,
        "prefill_chunk": cfg.prefill_chunk,
        "decode_window": cfg.decode_window,
        "kv_dtype": cfg.kv_dtype,
        "attention_impl": attn_impl,
        "ragged_q_tile": cfg.ragged_q_tile,
        "spec_max_draft": cfg.spec_max_draft,
    }


def build_manifest(cfg, attn_impl: str) -> WindowManifest:
    """The window lattice of an engine config (``attn_impl`` is the
    engine's resolved implementation)."""
    return WindowManifest(
        model=_fingerprint(cfg.model),
        engine=_engine_fingerprint(cfg, attn_impl),
        windows=window_keys(cfg),
        mixed_buckets=mixed_token_buckets(cfg),
    )
