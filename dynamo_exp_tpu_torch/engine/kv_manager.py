"""Host-side KV page pool: allocation, refcounted prefix reuse, LRU
eviction, and KV event emission.

Trimmed counterpart of ``dynamo_exp_tpu/engine/kv_manager.py``: the
device pages live in the pools ``models/llama.py`` allocates; this
manager tracks page *ids* only. Reuse is content-addressed by the
chained sequence hash of each full page (``tokens.py``), indexed in the
radix :class:`~dynamo_exp_tpu_torch.kv.PrefixIndex`: a new prompt's
prefix maps onto resident pages, which are refcounted and shared across
live sequences, and park in an LRU at refcount zero (still matchable
until evicted). Every registered or evicted full page emits a KV event.

Left out of this slice (ROADMAP): the host offload tier, the persistent
tier, registration of pages still being filled, partial-tail sharing
with copy-on-write, and handoff leases. A page is registered here only
once its KV has been written, so every registered page is filled.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..kv import PrefixIndex
from ..tokens import compute_block_hashes_for_seq


@dataclass
class PageRecord:
    page_id: int
    seq_hash: int | None = None  # None until the page is registered
    ref_count: int = 0


@dataclass
class Allocation:
    """Result of ``allocate_sequence``: ``page_ids`` covers
    ceil(len(tokens)/page_size) pages; ``cached_len`` counts tokens whose
    KV is already resident (matched full pages, capped at len-1 so the
    prompt's last token is always computed); ``cached_pages`` counts the
    matched pages; ``hashes`` are the chained hashes of every full
    prompt page."""

    page_ids: list[int]
    cached_len: int
    hashes: list[int]
    cached_pages: int = 0


@dataclass
class KvEvent:
    """Stored/removed notification for a router's radix index."""

    kind: str  # "stored" | "removed"
    seq_hashes: list[int]
    parent_hash: int | None = None
    token_blocks: list[list[int]] | None = None  # only on stored
    ts: float = field(default_factory=time.time)


class KvPageManager:
    """Tracks ownership and reuse of the device page pool by id. Not
    thread-safe by design: owned by the engine loop thread."""

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        event_cb: Callable[[KvEvent], None] | None = None,
        sharing: bool = True,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.event_cb = event_cb
        self.sharing = sharing
        self._records = {i: PageRecord(i) for i in range(num_pages)}
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._by_hash: dict[int, int] = {}  # seq_hash -> resident page
        self.index = PrefixIndex()
        # Zero-ref registered pages, LRU order (oldest first).
        self._reclaimable: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    # ---------------------------------------------------------------- stats
    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._reclaimable)

    @property
    def active_pages(self) -> int:
        return self.num_pages - self.free_pages

    @property
    def usage(self) -> float:
        return self.active_pages / max(self.num_pages, 1)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # ------------------------------------------------------------ allocation
    def _match_hashes(self, hashes: list[int]) -> tuple[list[int], list[int]]:
        pages: list[int] = []
        matched: list[int] = []
        for h in self.index.match_hashes(hashes):
            pid = self._by_hash.get(h)
            if pid is None:
                break
            pages.append(pid)
            matched.append(h)
        return pages, matched

    def allocate_sequence(
        self, tokens: Sequence[int], max_pages: int
    ) -> Allocation | None:
        """Pages for a new sequence: attach the longest resident shared
        prefix, then fresh pages for the rest of the prompt. None when
        the pool cannot satisfy it right now (the caller re-queues)."""
        ps = self.page_size
        n_tokens = len(tokens)
        need_total = (n_tokens + ps - 1) // ps
        if need_total > max_pages:
            return None
        hashes = compute_block_hashes_for_seq(tokens, ps)
        matched = self._match_hashes(hashes)[0] if self.sharing else []
        need_fresh = need_total - len(matched)
        # Matched parked pages are about to leave the LRU; they cannot
        # also be counted as takeable.
        parked = sum(1 for pid in matched if self._records[pid].ref_count == 0)
        if need_fresh > self.free_pages - parked:
            return None
        for pid in matched:
            self._ref_page(pid)
        fresh = [self._take_free() for _ in range(need_fresh)]
        self.hits += len(matched)
        self.misses += need_fresh
        cached = min(len(matched) * ps, n_tokens - 1)
        return Allocation(matched + fresh, cached, hashes, cached_pages=len(matched))

    def allocate_page(self) -> int | None:
        """One fresh page (decode crossing a page boundary)."""
        if self.free_pages < 1:
            return None
        return self._take_free()

    # ------------------------------------------------------------- lifecycle
    def register_full_page(
        self,
        page_id: int,
        seq_hash: int,
        parent_hash: int | None = None,
        tokens: list[int] | None = None,
    ) -> None:
        """A page got its page_size-th token and its KV is written: make
        it reusable and announce it. The first page to register a given
        content stays authoritative."""
        rec = self._records[page_id]
        if rec.seq_hash == seq_hash:
            return
        if rec.seq_hash is not None:
            self._unregister(page_id)
        if seq_hash in self._by_hash:
            return
        rec.seq_hash = seq_hash
        self._by_hash[seq_hash] = page_id
        self.index.insert(parent_hash, seq_hash)
        if self.event_cb:
            self.event_cb(
                KvEvent(
                    "stored",
                    [seq_hash],
                    parent_hash=parent_hash,
                    token_blocks=[tokens] if tokens else None,
                )
            )

    def release_sequence(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page. Registered pages park in the LRU
        (still matchable); the rest return to the free list."""
        for pid in page_ids:
            rec = self._records[pid]
            if rec.ref_count > 0:
                rec.ref_count -= 1
            if rec.ref_count == 0:
                if rec.seq_hash is not None:
                    self._reclaimable[pid] = None
                    self._reclaimable.move_to_end(pid)
                else:
                    self._free.append(pid)

    # -------------------------------------------------------------- internal
    def _ref_page(self, pid: int) -> None:
        rec = self._records[pid]
        if rec.ref_count == 0:
            self._reclaimable.pop(pid, None)
        rec.ref_count += 1

    def _take_free(self) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            # Evict the least-recently-used parked page.
            pid, _ = self._reclaimable.popitem(last=False)
            self._unregister(pid)
        self._records[pid].ref_count = 1
        return pid

    def _unregister(self, pid: int) -> None:
        rec = self._records[pid]
        if rec.seq_hash is None:
            return
        self._by_hash.pop(rec.seq_hash, None)
        self.index.remove(rec.seq_hash)
        if self.event_cb:
            self.event_cb(KvEvent("removed", [rec.seq_hash]))
        rec.seq_hash = None
