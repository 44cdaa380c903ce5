"""KV-router wire types.

Counterpart of ``dynamo_exp_tpu/kv_router/protocols.py``, with the same
dict shapes: ``ForwardPassMetrics`` (the stats scrape), the stored /
removed ``RouterEvent`` envelope (KV events), ``OverlapScores``,
``KVHitRateEvent`` (one per routing decision) and the event-plane
subjects. Block hashes are ``tokens.py``'s, bit-equal to the JAX
package's, so a router of either package indexes events of either.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any

from ..tokens import HASH_ALGO_VERSION

logger = logging.getLogger(__name__)

# Hash-algorithm versions we've already warned about (once per version,
# not per event — the event plane carries thousands of these).
_warned_hash_versions: set[int] = set()


@dataclass
class ForwardPassMetrics:
    """Worker load snapshot published via the stats plane."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d: dict) -> "ForwardPassMetrics":
        known = {k: d[k] for k in cls().__dict__ if k in d}
        return cls(**known)


@dataclass
class KvCacheStoredBlock:
    block_hash: int  # chained sequence hash
    tokens: list[int] | None = None


@dataclass
class KvCacheEventData:
    """One stored/removed notification from a worker's page manager."""

    kind: str  # "stored" | "removed"
    block_hashes: list[int] = field(default_factory=list)
    parent_hash: int | None = None


@dataclass
class RouterEvent:
    """Event envelope attributed to a worker."""

    worker_id: int
    data: KvCacheEventData
    hash_version: int = HASH_ALGO_VERSION

    def to_dict(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "kind": self.data.kind,
            "block_hashes": list(self.data.block_hashes),
            "parent_hash": self.data.parent_hash,
            "hash_version": self.hash_version,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RouterEvent":
        # A worker on a different block-hash algorithm produces hashes
        # the local indexer can never match: surface the mismatch once
        # instead of silently losing KV-aware routing mid-rollout.
        version = int(d.get("hash_version", 1))
        if version != HASH_ALGO_VERSION and version not in _warned_hash_versions:
            _warned_hash_versions.add(version)
            logger.warning(
                "KV event from worker %s uses block-hash algorithm v%d "
                "(local: v%d) — prefix reuse across this pair is disabled "
                "until versions match",
                d.get("worker_id"),
                version,
                HASH_ALGO_VERSION,
            )
        return cls(
            worker_id=int(d["worker_id"]),
            data=KvCacheEventData(
                kind=d["kind"],
                block_hashes=[int(h) for h in d.get("block_hashes", [])],
                parent_hash=d.get("parent_hash"),
            ),
            hash_version=version,
        )


@dataclass
class OverlapScores:
    """find_matches result: per-worker contiguous matched-prefix blocks."""

    scores: dict[int, int] = field(default_factory=dict)

    def best(self) -> int:
        return max(self.scores.values(), default=0)


@dataclass
class KVHitRateEvent:
    """Emitted per routing decision."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int

    def to_dict(self) -> dict:
        return self.__dict__.copy()


# Event-plane subjects.
def kv_events_subject(component_path: str) -> str:
    return f"{component_path}.kv_events"


KV_HIT_RATE_SUBJECT = "kv-hit-rate"


@dataclass
class RouterRequest:
    token_ids: list[int]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RouterRequest":
        return cls(token_ids=list(d.get("token_ids", [])))


@dataclass
class RouterResponse:
    worker_id: int
    overlap_blocks: int = 0

    def to_dict(self) -> dict:
        return {"worker_id": self.worker_id, "overlap_blocks": self.overlap_blocks}
