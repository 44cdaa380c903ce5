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

With a G2 host tier (``host_pool``), an evicted registered page is
handed to ``on_evict`` (the engine gathers it and writes it back to the
host pool) before it can be overwritten, and an admission extends its
G1 match into the host pool: the matched host pages come back as
``Allocation.uploads`` for the engine to inject before the prefill.

Handoff leases (the JAX manager's, with its semantics): a lease pins a
set of pages with one extra reference each while a KV handoff is in
flight (a prefill worker's extracted prompt, a reclaim migration, a
decode worker's prefix pinned for a suffix-only transfer). Delivery
confirms it (``confirm_lease``), and the loop's reaper reclaims it once
its TTL passes (``reap_expired``); either way the pins drop through
``release_sequence``. A held page is never on the free list or in the
parked LRU, so eviction, swap-out and preemption cannot take it.

Left out (ROADMAP Queue 1 item 4): the persistent tier, registration of
pages still being filled and partial-tail sharing with copy-on-write. A
page is registered here only once its KV has been written (or, for an
upload or a seeded migration, once its inject is on the compute stream
ahead of every read), so every registered page is filled: the JAX pin's
``match_prefix(..., require_filled=True)`` is the resident-hash match
(``match_resident_hashes``).
"""

from __future__ import annotations

import time
import uuid
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
    KV the sequence need not compute (G1-matched plus G2-restored full
    pages, capped at len-1 so the prompt's last token is always
    computed); ``cached_pages`` counts those pages; ``hashes`` are the
    chained hashes of every full prompt page; ``uploads`` lists the
    ``(page_id, seq_hash, k_page, v_page)`` host pages the engine must
    inject before the prefill."""

    page_ids: list[int]
    cached_len: int
    hashes: list[int]
    cached_pages: int = 0
    uploads: list = field(default_factory=list)


@dataclass
class KvLease:
    """A pin on pages during a KV handoff: GRANTED, then CONFIRMED
    (delivery acked) or EXPIRED (reaped at ``expires_at``, on the
    manager's clock)."""

    lease_id: str
    page_ids: list[int]
    expires_at: float


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
        host_pool=None,
        on_evict: Callable[[int, int], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.event_cb = event_cb
        self.sharing = sharing
        # G2 tier: ``on_evict(page_id, seq_hash)`` writes an evicted
        # registered page back to ``host_pool`` (engine-side gather).
        self.host_pool = host_pool
        self.on_evict = on_evict
        self._records = {i: PageRecord(i) for i in range(num_pages)}
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._by_hash: dict[int, int] = {}  # seq_hash -> resident page
        self.index = PrefixIndex()
        # Zero-ref registered pages, LRU order (oldest first).
        self._reclaimable: OrderedDict[int, None] = OrderedDict()
        # Handoff leases by id, their clock, the pages the reaper has
        # freed, and the (lease id, pages) the last reap took.
        self.clock = clock
        self._leases: dict[str, KvLease] = {}
        self.lease_reclaimed_pages = 0
        self.last_reaped: list[tuple[str, int]] = []
        self.hits = 0
        self.misses = 0
        # G2 hit/miss: of the pages a prompt needed beyond its G1 match,
        # how many the host tier supplied.
        self.offload_hits = 0
        self.offload_misses = 0
        # Prompt pages at admission by source (dynamo_kv_prefix_hits_total):
        # shared (G1 attach), restore (G2 upload), miss (fresh prefill).
        self.prefix_hits = {"shared": 0, "restore": 0, "miss": 0}
        # Conservation ledger, kept at the same transitions that move
        # pages between the free list, the parked LRU and the held set
        # (``ledger_check`` is counter arithmetic; ``audit`` scans).
        self._held_pages = 0
        self._ref_total = 0
        self.live_shared = 0  # pages with ref_count >= 2

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

    def offload_hit_rate(self) -> float:
        total = self.offload_hits + self.offload_misses
        return self.offload_hits / total if total else 0.0

    def gauges(self) -> dict:
        """KV-tier gauges for the engine's metrics."""
        return {
            "hbm_page_occupancy": self.usage,
            "offload_hit_rate": self.offload_hit_rate(),
            "kv_shared_pages": self.live_shared,
            "kv_host_pages": self.host_pool.resident if self.host_pool else 0,
        }

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
        """Pages for a new sequence: attach the longest resident (G1)
        shared prefix, extend it from the host tier (G2), then fresh
        pages for the rest of the prompt. None when the pool cannot
        satisfy it right now (the caller re-queues)."""
        ps = self.page_size
        n_tokens = len(tokens)
        need_total = (n_tokens + ps - 1) // ps
        if need_total > max_pages:
            return None
        hashes = compute_block_hashes_for_seq(tokens, ps)
        matched = self._match_hashes(hashes)[0] if self.sharing else []
        # Match the host tier first (no copies): pages are fetched only
        # once the allocation is known to succeed.
        g2_hashes: list[int] = []
        if self.sharing and self.host_pool is not None:
            g2_hashes = self.host_pool.match_chain(hashes[len(matched) :])
        need_fresh = need_total - len(matched)
        # Matched parked pages are about to leave the LRU; they cannot
        # also be counted as takeable.
        parked = sum(1 for pid in matched if self._records[pid].ref_count == 0)
        if need_fresh > self.free_pages - parked:
            return None
        # fetch() copies each page out under the pool lock; a miss (the
        # host LRU dropped it since the match) shortens the restore.
        restored: list[tuple[int, object, object]] = []
        for h in g2_hashes:
            data = self.host_pool.fetch(h)
            if data is None:
                break
            restored.append((h, data[0], data[1]))
        for pid in matched:
            self._ref_page(pid)
        fresh = [self._take_free() for _ in range(need_fresh)]
        uploads = [(fresh[j], h, k, v) for j, (h, k, v) in enumerate(restored)]
        self.hits += len(matched) + len(restored)
        self.misses += need_fresh - len(restored)
        if self.host_pool is not None:
            self.offload_hits += len(restored)
            self.offload_misses += need_fresh - len(restored)
        self.prefix_hits["shared"] += len(matched)
        self.prefix_hits["restore"] += len(restored)
        self.prefix_hits["miss"] += need_fresh - len(restored)
        cached_pages = len(matched) + len(restored)
        cached = min(cached_pages * ps, n_tokens - 1)
        return Allocation(
            matched + fresh, cached, hashes, cached_pages=cached_pages, uploads=uploads
        )

    def allocate_page(self) -> int | None:
        """One fresh page (decode crossing a page boundary)."""
        if self.free_pages < 1:
            return None
        return self._take_free()

    # ------------------------------------------------------ tiering accessors
    def match_resident_hashes(self, hashes: list[int]) -> list[int]:
        """Device-resident (G1) prefix of a block-hash chain, as page
        ids (no refs taken): the forecast's and the prefetch planner's
        read-only match."""
        return self._match_hashes(hashes)[0]

    def page_ref(self, page_id: int) -> int:
        return self._records[page_id].ref_count

    def page_hash(self, page_id: int) -> int | None:
        return self._records[page_id].seq_hash

    def resident_page(self, seq_hash: int) -> int | None:
        """The device page holding this registered block, or None:
        swap-in re-attaches through it when the bytes never left."""
        return self._by_hash.get(seq_hash)

    def attach_page(self, page_id: int) -> None:
        """Take one reference on a resident page (swap-in re-attach)."""
        self._ref_page(page_id)

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
                self._ref_total -= 1
                if rec.ref_count == 1:
                    self.live_shared -= 1
                if rec.ref_count == 0:
                    self._held_pages -= 1
            if rec.ref_count == 0:
                if rec.seq_hash is not None:
                    self._reclaimable[pid] = None
                    self._reclaimable.move_to_end(pid)
                else:
                    self._free.append(pid)

    def reset_prefix_cache(self) -> int:
        """Forget every parked (zero-ref) registered page and return it
        to the free list; pages live sequences hold stay. Returns the
        number of pages dropped."""
        dropped = list(self._reclaimable)
        self._reclaimable.clear()
        for pid in dropped:
            self._unregister(pid)
            self._free.append(pid)
        return len(dropped)

    # ---------------------------------------------------------------- leases
    @property
    def active_leases(self) -> int:
        return len(self._leases)

    def grant_lease(self, page_ids: Sequence[int], ttl_s: float) -> str:
        """Pin ``page_ids`` (one extra reference each) for a handoff in
        flight and return the lease id the wire carries. Call while the
        pages are still referenced (before their sequence is released),
        or on resident pages a match just returned."""
        for pid in page_ids:
            self._ref_page(pid)
        lease = KvLease(uuid.uuid4().hex, list(page_ids), self.clock() + ttl_s)
        self._leases[lease.lease_id] = lease
        return lease.lease_id

    def confirm_lease(self, lease_id: str) -> bool:
        """Delivery confirmed: drop the lease's pins (registered pages
        park in the LRU). An unknown or already reaped id is a no-op:
        the confirm raced the reaper."""
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return False
        self.release_sequence(lease.page_ids)
        return True

    def lease_due(self, now: float | None = None) -> bool:
        """Whether some lease has expired (the loop breaks a chain of
        windows so that its reaper runs)."""
        now = self.clock() if now is None else now
        return any(now >= lease.expires_at for lease in self._leases.values())

    def reap_expired(self, now: float | None = None) -> int:
        """Reclaim every expired lease's pages; returns the pages freed
        and names the leases in ``last_reaped``."""
        now = self.clock() if now is None else now
        reclaimed = 0
        self.last_reaped = []
        for lid in [lid for lid, lease in self._leases.items() if now >= lease.expires_at]:
            lease = self._leases.pop(lid)
            self.release_sequence(lease.page_ids)
            reclaimed += len(lease.page_ids)
            self.last_reaped.append((lid, len(lease.page_ids)))
        self.lease_reclaimed_pages += reclaimed
        return reclaimed

    # ------------------------------------------------- conservation ledger
    def ledger_check(self) -> list[str]:
        """Counter arithmetic: every page is exactly one of {free,
        parked, held}, and the refcount total covers the holders.
        Returns violation descriptions (empty = conserved)."""
        violations: list[str] = []
        free, parked, held = len(self._free), len(self._reclaimable), self._held_pages
        if free + parked + held != self.num_pages:
            violations.append(
                f"page conservation broken: free={free} parked={parked} "
                f"held={held} sum={free + parked + held} != pool={self.num_pages}"
            )
        if not 0 <= self.live_shared <= held:
            violations.append(
                f"shared-page count out of range: live_shared={self.live_shared} held={held}"
            )
        if self._ref_total < held + self.live_shared:
            violations.append(
                f"refcount total below holder floor: ref_total={self._ref_total} "
                f"< held={held} + shared={self.live_shared}"
            )
        if self._ref_total < 0 or held < 0:
            violations.append(
                f"negative ledger counter: ref_total={self._ref_total} held={held}"
            )
        lease_pins = sum(len(lease.page_ids) for lease in self._leases.values())
        if lease_pins > self._ref_total:
            violations.append(
                f"lease pins exceed refcount total: lease_pins={lease_pins} "
                f"ref_total={self._ref_total}"
            )
        return violations

    def audit(self, holders: dict[str, Sequence[int]] | None = None) -> dict:
        """Full conservation audit: classify every page into exactly one
        state, and, when ``holders`` maps holder names to the page ids
        they believe they hold, cross-check each page's refcount
        against them so a leak is named. Leases join the holders as
        ``lease:<id>``. Read-only."""
        free_list = list(self._free)
        free = set(free_list)
        parked = set(self._reclaimable)
        expected: dict[int, list[str]] = {}
        all_holders: dict[str, Sequence[int]] = dict(holders or {})
        for lid, lease in self._leases.items():
            all_holders[f"lease:{lid}"] = lease.page_ids
        for name, pids in all_holders.items():
            for pid in pids:
                expected.setdefault(pid, []).append(name)
        cross = holders is not None or bool(self._leases)
        counts = {"free": 0, "parked": 0, "active": 0, "shared": 0,
                  "leased": sum(len(lease.page_ids) for lease in self._leases.values())}
        violations: list[dict] = []

        def flag(pid, kind: str, detail: str) -> None:
            violations.append({"page": pid, "kind": kind, "detail": detail,
                               "holders": sorted(expected.get(pid, []))})

        if len(free) != len(free_list):
            for pid in sorted(p for p in free if free_list.count(p) > 1):
                flag(pid, "double_release", "page appears twice in the free list")
        for pid, rec in self._records.items():
            states = [name for name, hit in (
                ("free", pid in free), ("parked", pid in parked),
                ("active", rec.ref_count > 0)) if hit]
            if len(states) != 1:
                flag(pid, "state_overlap" if states else "unaccounted",
                     f"page in states {states or ['none']} (ref_count={rec.ref_count})")
            if rec.ref_count > 0:
                counts["active"] += 1
                counts["shared"] += rec.ref_count >= 2
            elif pid in parked:
                counts["parked"] += 1
            elif pid in free:
                counts["free"] += 1
            if rec.ref_count < 0:
                flag(pid, "negative_refcount", f"ref_count={rec.ref_count}")
            want = len(expected.get(pid, []))
            if cross and rec.ref_count != want and (rec.ref_count > 0 or want > 0):
                kind = "leaked_ref" if rec.ref_count > want else "lost_ref"
                flag(pid, kind, f"ref_count={rec.ref_count} but {want} live holder(s)")
        for check in self.ledger_check():
            violations.append({"page": None, "kind": "counter", "detail": check, "holders": []})
        return {
            "ok": not violations,
            "counts": counts,
            "pool": self.num_pages,
            "leases": len(self._leases),
            "held_pages": self._held_pages,
            "ref_total": self._ref_total,
            "violations": violations,
        }

    # -------------------------------------------------------------- internal
    def _ref_page(self, pid: int) -> None:
        rec = self._records[pid]
        if rec.ref_count == 0:
            self._reclaimable.pop(pid, None)
            self._held_pages += 1
        rec.ref_count += 1
        self._ref_total += 1
        if rec.ref_count == 2:
            self.live_shared += 1

    def _take_free(self) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            # Evict the least-recently-used parked page.
            pid, _ = self._reclaimable.popitem(last=False)
            self._evict(pid)
        self._records[pid].ref_count = 1
        self._held_pages += 1
        self._ref_total += 1
        return pid

    def _evict(self, pid: int) -> None:
        rec = self._records[pid]
        if rec.seq_hash is not None:
            if self.on_evict is not None:
                # Write back to G2 before the page can be overwritten:
                # the engine gathers it ahead of the next compute
                # dispatch (stream order then protects the bytes).
                self.on_evict(pid, rec.seq_hash)
            self._unregister(pid)

    def _unregister(self, pid: int) -> None:
        rec = self._records[pid]
        if rec.seq_hash is None:
            return
        self._by_hash.pop(rec.seq_hash, None)
        self.index.remove(rec.seq_hash)
        if self.event_cb:
            self.event_cb(KvEvent("removed", [rec.seq_hash]))
        rec.seq_hash = None
