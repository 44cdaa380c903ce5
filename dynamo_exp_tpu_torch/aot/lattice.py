"""The graph lattice, enumerated offline: every decode-window key and
every mixed key an engine can dispatch.

Counterpart of ``dynamo_exp_tpu/aot/lattice.py``. In the JAX package
each ragged variant is one compiled XLA program; in the port it is one
CUDA graph per key (``engine/graphs.py``). Two kinds of key:

- a windowed dispatch (pure decode) keys on

      (rows bucket, page-bound bucket, full sampler?, logprobs?)

  - rows: the window's rows padded to a power of two, capped at
    ``max_decode_slots`` (the JAX ``windowed_token_buckets``);
  - page bound: the table columns the window reads, a power of two from
    ``PAGE_FLOOR_TOKENS`` of pages up to ``max_pages_per_seq``. Unlike
    the TPU key (``resolve_ragged_key``, whose Pallas kernel reads true
    lengths and drops the bound), it stays: the split-KV decode
    kernel's grid is sized from ``pages * page_size``
    (``ops/ragged_attention.py``);

- a mixed dispatch (prefill chunks, decode steps beside them,
  speculative verify spans) keys on

      (token bucket, page bound, full sampler?, logprobs?, verify spans?)

  - tokens: the flat query stream padded to the JAX mixed bucket
    (``EngineConfig.ragged_tokens_bucket_for(n, mixed=True)``): a power
    of two from 16, capped at :func:`ragged_max_tokens`;
  - page bound: ``None`` on the kernel path, as in the Pallas key: the
    port's mixed kernels read true lengths and their grids depend on
    the stream's length only. The plain version reads the first
    ``pages`` table columns, so there it is the window page bucket;
  - verify spans: an axis only when speculation is on (the JAX
    ``ragged_variants``' ``include_spec``).

One source of truth: :func:`resolve_window_key` and
:func:`resolve_mixed_key` key every live dispatch of ``TorchEngine``
and every entry of :func:`build_manifest`, so the manifest holds every
key the engine can dispatch.

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


def ragged_max_tokens(cfg) -> int:
    """Upper bound of one mixed dispatch's flat stream: every slot
    prefilling a full chunk or verifying the widest draft, each span
    q_tile-aligned, as a power of two (the JAX
    ``EngineConfig.ragged_max_tokens``)."""
    per_row = max(cfg.prefill_chunk, cfg.spec_max_draft + 1)
    return pow2_bucket(cfg.max_decode_slots * (per_row + cfg.ragged_q_tile - 1), 1)


def mixed_bucket_for(cfg, n_tokens: int) -> int:
    """The flat-stream bucket of a mixed dispatch of ``n_tokens``: a
    power of two from 16, capped at :func:`ragged_max_tokens` (the JAX
    ``ragged_tokens_bucket_for(n, mixed=True)``)."""
    return pow2_bucket(n_tokens, 16, ragged_max_tokens(cfg))


@dataclass(frozen=True)
class MixedKey:
    """One mixed variant: one CUDA graph."""

    tokens: int
    pages: int | None  # None: the kernel path, which reads true lengths
    full_sampler: bool
    want_lp: bool
    with_spec: bool


def resolve_mixed_key(cfg, attn_impl: str, n_tokens: int, attn_pages: int,
                      full_sampler: bool, want_lp: bool, with_spec: bool) -> MixedKey:
    """The key of a mixed dispatch whose rows' spans fill ``n_tokens``
    flat slots and whose longest row needs ``attn_pages`` table columns.
    The engine pads its stream to the key's tokens (padding at position
    -1, owned by the scratch row), eagerly or graphed alike."""
    if n_tokens > ragged_max_tokens(cfg):
        raise ValueError(f"a mixed stream of {n_tokens} tokens exceeds "
                         f"ragged_max_tokens={ragged_max_tokens(cfg)}")
    pages = None if attn_impl == "kernel" else page_bucket_for(cfg, attn_pages)
    return MixedKey(mixed_bucket_for(cfg, max(n_tokens, 1)), pages, bool(full_sampler),
                    bool(want_lp), bool(with_spec))


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


def mixed_keys(cfg, attn_impl: str) -> list[MixedKey]:
    """Every key a mixed dispatch can resolve to, deduplicated through
    :func:`resolve_mixed_key`; the verify-span axis only with
    speculation on."""
    spec_axis = (False, True) if cfg.spec_mode != "off" else (False,)
    keys = {
        resolve_mixed_key(cfg, attn_impl, n, pages, fs, lp, spec)
        for n in _pow2_candidates(ragged_max_tokens(cfg))
        for pages in _pow2_candidates(cfg.max_pages_per_seq)
        for fs in (False, True)
        for lp in (False, True)
        for spec in spec_axis
    }
    return sorted(keys, key=lambda k: (k.tokens, k.pages or 0, k.full_sampler, k.want_lp,
                                       k.with_spec))


# 2: mixed keys replaced the mixed buckets.
_SCHEMA = 2


@dataclass
class GraphManifest:
    """The graph lattice of one engine shape. ``hash()`` covers every
    field: the model, the knobs that shape a dispatch, the attention
    implementation and both lattices. ``len()`` counts window keys."""

    model: dict
    engine: dict
    windows: list[WindowKey] = field(default_factory=list)
    mixed: list[MixedKey] = field(default_factory=list)
    schema: int = _SCHEMA

    def to_dict(self) -> dict:
        return {
            "schema": self.schema, "model": self.model, "engine": self.engine,
            "windows": [asdict(k) for k in self.windows],
            "mixed": [asdict(k) for k in self.mixed],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GraphManifest":
        """The manifest :meth:`to_dict` wrote (a tuned artifact embeds
        one); the hash survives the round trip."""
        return cls(
            model=dict(d["model"]), engine=dict(d["engine"]),
            windows=[WindowKey(**k) for k in d.get("windows", [])],
            mixed=[MixedKey(**k) for k in d.get("mixed", [])],
            schema=int(d.get("schema", _SCHEMA)),
        )

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


def build_manifest(cfg, attn_impl: str) -> GraphManifest:
    """The graph lattice of an engine config (``attn_impl`` is the
    engine's resolved implementation)."""
    return GraphManifest(
        model=_fingerprint(cfg.model),
        engine=_engine_fingerprint(cfg, attn_impl),
        windows=window_keys(cfg),
        mixed=mixed_keys(cfg, attn_impl),
    )
