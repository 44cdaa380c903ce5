"""Global prefix index: which workers hold which KV blocks.

Counterpart of ``dynamo_exp_tpu/kv_router/indexer.py``, on the port's
own radix structure (``kv/prefix.py`` ``PrefixIndex``, the one the
engine's page manager matches against): one tree per worker, fed by the
stored / removed event stream. An overlap query walks each worker's
tree as that worker's page manager walks its index at admission, so the
score is the worker's coverage, not an estimate; a mid-chain eviction
detaches (not destroys) the suffix, which re-attaches if the block is
registered again.

Single-writer: events are applied on the indexer's asyncio task and
queries run on the same loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Sequence

from ..kv import PrefixIndex
from ..tokens import HASH_ALGO_VERSION, compute_block_hashes_for_seq
from .protocols import KvCacheEventData, OverlapScores, RouterEvent

logger = logging.getLogger(__name__)


class RadixIndex:
    """Per-worker radix prefix trees over chained block hashes."""

    def __init__(self):
        self._per_worker: dict[int, PrefixIndex] = {}

    def apply_event(self, event: RouterEvent) -> None:
        if event.hash_version != HASH_ALGO_VERSION:
            # Warned once at decode (protocols.from_dict). A mismatched
            # peer's hashes live in a disjoint seed space and can never
            # match a local query — indexing them would only grow
            # unmatchable state for the life of that worker.
            return
        w = event.worker_id
        data: KvCacheEventData = event.data
        if data.kind == "stored":
            index = self._per_worker.setdefault(w, PrefixIndex())
            # Within one event the hashes chain: parent_hash parents the
            # first block, each block parents the next (the engine emits
            # one block per event; batched senders chain).
            parent = data.parent_hash
            for h in data.block_hashes:
                index.insert(parent, h)
                parent = h
        elif data.kind == "removed":
            index = self._per_worker.get(w)
            if index is None:
                return
            for h in data.block_hashes:
                index.remove(h)
            if not index.num_blocks:
                del self._per_worker[w]
        else:
            logger.warning("unknown kv event kind %r", data.kind)

    def remove_worker(self, worker_id: int) -> None:
        self._per_worker.pop(worker_id, None)

    def find_matches(self, seq_hashes: Sequence[int]) -> OverlapScores:
        """Longest contiguous matched prefix per worker — each worker's
        tree is walked root-anchored, the same match its engine-side
        page manager performs at admission."""
        scores: dict[int, int] = {}
        for w, index in self._per_worker.items():
            n = index.coverage_blocks(seq_hashes)
            if n > 0:
                scores[w] = n
        return OverlapScores(scores)

    @property
    def num_blocks(self) -> int:
        """Distinct (worker, block) registrations still indexed."""
        return sum(ix.num_blocks for ix in self._per_worker.values())


class KvIndexer:
    """Event-pump wrapper: subscribes to a subject on the event plane and
    keeps the index current; offers block hashing + match queries."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.index = RadixIndex()
        self._task: asyncio.Task | None = None
        self.events_applied = 0

    def block_hashes(self, token_ids: Sequence[int]) -> list[int]:
        return compute_block_hashes_for_seq(token_ids, self.block_size)

    def find_matches_for_request(self, token_ids: Sequence[int]) -> OverlapScores:
        return self.index.find_matches(self.block_hashes(token_ids))

    def apply(self, event: RouterEvent) -> None:
        self.index.apply_event(event)
        self.events_applied += 1

    def remove_worker(self, worker_id: int) -> None:
        self.index.remove_worker(worker_id)

    async def start(self, event_plane, subject: str) -> None:
        if self._task is not None:
            return

        # Subscribe (fully registered on return) before the task runs so no
        # event can slip between start() returning and the pump's first
        # iteration.
        subscription = await event_plane.subscribe(subject)

        async def pump():
            async for payload in subscription:
                try:
                    self.apply(RouterEvent.from_dict(payload))
                except Exception:
                    logger.exception("bad kv event: %r", payload)

        self._task = asyncio.create_task(pump(), name=f"kv-indexer[{subject}]")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None


class KvIndexerSharded:
    """Shards the index by worker for very large clusters. Queries fan
    out and merge."""

    def __init__(self, block_size: int, num_shards: int = 4):
        self.block_size = block_size
        self.shards = [RadixIndex() for _ in range(num_shards)]

    def _shard(self, worker_id: int) -> RadixIndex:
        return self.shards[worker_id % len(self.shards)]

    def apply(self, event: RouterEvent) -> None:
        self._shard(event.worker_id).apply_event(event)

    def remove_worker(self, worker_id: int) -> None:
        self._shard(worker_id).remove_worker(worker_id)

    def find_matches_for_request(self, token_ids: Sequence[int]) -> OverlapScores:
        hashes = compute_block_hashes_for_seq(token_ids, self.block_size)
        merged: dict[int, int] = {}
        for shard in self.shards:
            merged.update(shard.find_matches(hashes).scores)
        return OverlapScores(merged)
