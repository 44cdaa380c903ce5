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

With a G3 store (``g3_store``, ``kv/persistent.py``), admission extends
an unbroken G1 + G2 match into it; each fetched page is checksum-verified
by the store and promoted through the host pool.

Sharing extends to pages still being filled and to partial tails (the
JAX manager's ``kv_manager.py:532-600``): a fresh full prompt page is
registered at allocation (``filled=False``, its filler the admitting
request) so a same-prefix admission attaches it instead of prefilling
it again, and waits (``Allocation.wait_fill``) until the filler's chunk
is dispatched (``mark_filled``); stream order then protects the read. A
filler that goes away first orphans its pending pages
(``abort_fills``); a waiting sharer claims them (``claim_fill``) and
fills them itself. A prompt ending inside a registered block attaches
that block read-shared as its tail (``Allocation.shared_tail``, the
radix ``partial_match``); before the sharer's first write into it the
engine calls :meth:`make_private` and copies the page on the device.
G2 uploads register pending too (``register_full_page(...,
content_ready=False)`` and ``begin_fill``) until their inject.
``sharing=False`` is the private-copy baseline (JAX
``engine/config.py:145-151``): no cross-sequence reuse at all.
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
    # Registered but its write not dispatched yet; ``filler`` names the
    # request that owes it ("" = orphaned: a sharer must claim it).
    filled: bool = True
    filler: str = ""


@dataclass
class Allocation:
    """Result of ``allocate_sequence``: ``page_ids`` covers
    ceil(len(tokens)/page_size) pages; ``cached_len`` counts tokens whose
    KV the sequence need not compute (G1-matched plus G2-restored full
    pages, capped at len-1 so the prompt's last token is always
    computed); ``cached_pages`` counts those pages; ``hashes`` are the
    chained hashes of every full prompt page; ``uploads`` lists the
    ``(page_id, seq_hash, k_page, v_page)`` host pages the engine must
    inject before the prefill; ``wait_fill`` the attached pages another
    sequence is still filling (the first prefill dispatch waits for
    them); ``shared_tail`` the ``(page_id, covered tokens)`` partial
    tail attached read-shared, copied before the first write into it
    (its tokens count in ``cached_len``)."""

    page_ids: list[int]
    cached_len: int
    hashes: list[int]
    cached_pages: int = 0
    uploads: list = field(default_factory=list)
    wait_fill: list[int] = field(default_factory=list)
    shared_tail: tuple[int, int] | None = None


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
        g3_store=None,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.event_cb = event_cb
        self.sharing = sharing
        # G2 tier: ``on_evict(page_id, seq_hash)`` writes an evicted
        # registered page back to ``host_pool`` (engine-side gather).
        self.host_pool = host_pool
        self.on_evict = on_evict
        # G3 tier (kv/persistent.py): admission extends an unbroken
        # G1 + G2 match into the persistent store; each fetched page is
        # checksum-verified there and promoted through the host pool (a
        # corrupt page quarantines and just shortens the restore).
        self.g3_store = g3_store
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
        # shared (G1 attach), restore (G2 upload), persist (G3 restore:
        # the restart re-attachment proof), miss (fresh prefill).
        self.prefix_hits = {"shared": 0, "restore": 0, "persist": 0, "miss": 0}
        # Shared pages copied before a divergent write (make_private).
        self.cow_copies = 0
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
            "kv_store_pages": self.g3_store.resident if self.g3_store else 0,
        }

    # ------------------------------------------------------------ allocation
    def _match_hashes(
        self, hashes: list[int], require_filled: bool = False
    ) -> tuple[list[int], list[int]]:
        pages: list[int] = []
        matched: list[int] = []
        for h in self.index.match_hashes(hashes):
            pid = self._by_hash.get(h)
            if pid is None:
                break
            if require_filled and not self._records[pid].filled:
                break
            pages.append(pid)
            matched.append(h)
        return pages, matched

    def allocate_sequence(
        self, tokens: Sequence[int], max_pages: int, request_id: str = ""
    ) -> Allocation | None:
        """Pages for a new sequence: attach the longest resident (G1)
        shared prefix, pages still being filled included, and a partial
        tail inside a registered block; extend the prefix from the host
        tier (G2) and the persistent store (G3), then fresh pages for
        the rest of the prompt, whose full pages register at once as
        pending fills of ``request_id``. None when the pool cannot
        satisfy it right now (the caller re-queues)."""
        ps = self.page_size
        n_tokens = len(tokens)
        need_total = (n_tokens + ps - 1) // ps
        if need_total > max_pages:
            return None
        hashes = compute_block_hashes_for_seq(tokens, ps)
        matched, matched_hashes = self._match_hashes(hashes) if self.sharing else ([], [])
        # Match the host tier first (no copies): pages are fetched only
        # once the allocation is known to succeed.
        g2_hashes: list[int] = []
        if self.sharing and self.host_pool is not None:
            g2_hashes = self.host_pool.match_chain(hashes[len(matched) :])
        # Then the G3 store (membership only; bytes are verified at fetch).
        g3_hashes: list[int] = []
        if self.sharing and self.g3_store is not None:
            g3_hashes = self.g3_store.match_chain(hashes[len(matched) + len(g2_hashes) :])
        # Shared partial tail: the prompt ends inside a block another
        # sequence registered; attach that page read-shared.
        shared_tail: tuple[int, int] | None = None
        tail_tokens = tokens[(n_tokens // ps) * ps :]
        if (self.sharing and tail_tokens and not g2_hashes and not g3_hashes
                and len(matched) == n_tokens // ps):
            parent = matched_hashes[-1] if matched_hashes else None
            hit = self.index.partial_match(parent, tail_tokens)
            if hit is not None and hit[0] in self._by_hash:
                shared_tail = (self._by_hash[hit[0]], hit[1])
        attach = matched + ([shared_tail[0]] if shared_tail else [])
        need_fresh = need_total - len(attach)
        # Matched parked pages are about to leave the LRU; they cannot
        # also be counted as takeable.
        parked = sum(1 for pid in attach if self._records[pid].ref_count == 0)
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
        # G3 fetches only extend an unbroken chain. A page that fails its
        # checksum is quarantined by the store and ends the restore: the
        # block re-prefills from the prompt, token-identically. Verified
        # bytes promote through the host pool.
        n_g2 = len(restored)
        if n_g2 == len(g2_hashes):
            for h in g3_hashes:
                data = self.g3_store.fetch(h)
                if data is None:
                    break
                restored.append((h, data[0], data[1]))
                if self.host_pool is not None:
                    self.host_pool.store(h, data[0], data[1])
        for pid in attach:
            self._ref_page(pid)
        fresh = [self._take_free() for _ in range(need_fresh)]
        uploads = [(fresh[j], h, k, v) for j, (h, k, v) in enumerate(restored)]
        if self.sharing:
            # This sequence's own full prompt pages register now, as
            # pending fills: a same-prefix admission next shares them.
            # (Uploads register at admission, the partial tail never.)
            for j in range(len(restored), need_fresh):
                block_idx = len(matched) + j
                if (block_idx + 1) * ps > n_tokens:
                    break
                h = hashes[block_idx]
                if h in self._by_hash:
                    continue  # racing duplicate content: stay private
                rec = self._records[fresh[j]]
                rec.filled, rec.filler = False, request_id
                parent = hashes[block_idx - 1] if block_idx else None
                block = list(tokens[block_idx * ps : (block_idx + 1) * ps])
                self._index_page(fresh[j], h, parent, block)
        self.hits += len(attach) + len(restored)
        self.misses += need_fresh - len(restored)
        if self.host_pool is not None:
            self.offload_hits += n_g2
            self.offload_misses += need_fresh - len(restored)
        self.prefix_hits["shared"] += len(attach)
        self.prefix_hits["restore"] += n_g2
        self.prefix_hits["persist"] += len(restored) - n_g2
        self.prefix_hits["miss"] += need_fresh - len(restored)
        cached_pages = len(matched) + len(restored)
        cached = cached_pages * ps + (shared_tail[1] if shared_tail else 0)
        return Allocation(
            matched + fresh + ([shared_tail[0]] if shared_tail else []),
            min(cached, n_tokens - 1), hashes, cached_pages=cached_pages, uploads=uploads,
            wait_fill=[pid for pid in attach if not self._records[pid].filled],
            shared_tail=shared_tail,
        )

    def allocate_page(self) -> int | None:
        """One fresh page (decode crossing a page boundary)."""
        if self.free_pages < 1:
            return None
        return self._take_free()

    # ------------------------------------------------------ tiering accessors
    def match_resident_hashes(self, hashes: list[int], require_filled: bool = False) -> list[int]:
        """Device-resident (G1) prefix of a block-hash chain, as page
        ids (no refs taken): the forecast's and the prefetch planner's
        read-only match. ``require_filled`` stops at the first page whose
        write is not dispatched yet (a pin counts only bytes that
        exist)."""
        return self._match_hashes(hashes, require_filled)[0]

    def page_ref(self, page_id: int) -> int:
        return self._records[page_id].ref_count

    def page_hash(self, page_id: int) -> int | None:
        return self._records[page_id].seq_hash

    def resident_page(self, seq_hash: int) -> int | None:
        """The device page holding this registered, filled block, or
        None: swap-in re-attaches through it when the bytes never left."""
        pid = self._by_hash.get(seq_hash)
        if pid is None or not self._records[pid].filled:
            return None
        return pid

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
        content_ready: bool = True,
    ) -> None:
        """A page got its page_size-th token and its KV is written (or,
        with ``content_ready=False``, its write is still to come: a G2
        upload before its inject): make it reusable and announce it.
        Registering a page already registered under this content marks
        it filled. The first page to register a given content stays
        authoritative."""
        rec = self._records[page_id]
        if rec.seq_hash == seq_hash:
            if content_ready:
                rec.filled, rec.filler = True, ""
            return
        if rec.seq_hash is not None:
            self._unregister(page_id)
        if seq_hash in self._by_hash:
            return
        rec.filled = content_ready
        self._index_page(page_id, seq_hash, parent_hash, tokens)

    def _index_page(self, page_id: int, seq_hash: int, parent_hash: int | None,
                    tokens: list[int] | None) -> None:
        self._records[page_id].seq_hash = seq_hash
        self._by_hash[seq_hash] = page_id
        self.index.insert(parent_hash, seq_hash, tokens)
        if self.event_cb:
            self.event_cb(
                KvEvent(
                    "stored",
                    [seq_hash],
                    parent_hash=parent_hash,
                    token_blocks=[tokens] if tokens else None,
                )
            )

    # -------------------------------------------------------- fill lifecycle
    def mark_filled(self, page_ids: Sequence[int]) -> None:
        """The writes of these pages are dispatched: waiting sharers may
        dispatch their reads (stream order protects them)."""
        for pid in page_ids:
            rec = self._records[pid]
            rec.filled, rec.filler = True, ""

    def begin_fill(self, page_id: int, request_id: str) -> None:
        """Mark a registered page as pending content from ``request_id``
        (a G2 upload awaiting its inject)."""
        rec = self._records[page_id]
        rec.filled, rec.filler = False, request_id

    def fill_state(self, page_id: int) -> str:
        """``"filled"``, ``"pending"`` (a live filler owes the write) or
        ``"orphaned"`` (its filler went away first: a sharer must claim
        the page and fill it)."""
        rec = self._records[page_id]
        if rec.filled:
            return "filled"
        return "pending" if rec.filler else "orphaned"

    def claim_fill(self, page_id: int, request_id: str) -> None:
        """A sharer adopts an orphaned page and prefills the block itself
        (the same prompt tokens give the same content)."""
        rec = self._records[page_id]
        if not rec.filled:
            rec.filler = request_id

    def abort_fills(self, request_id: str, page_ids: Sequence[int]) -> None:
        """The filler goes away (finish, cancel, preempt) with writes not
        dispatched: orphan its pending pages for a sharer to claim. Call
        before releasing the references."""
        for pid in page_ids:
            rec = self._records[pid]
            if not rec.filled and rec.filler == request_id:
                rec.filler = ""

    def make_private(self, page_id: int) -> int | None:
        """Copy-on-write: the caller is about to write a divergent value
        into ``page_id``. Sole holder: the page leaves the index (a
        filled page goes to the host tier first, still a valid block)
        and is returned as it is. Shared: a fresh page is returned for
        the caller to copy the content into, swap into its table and
        release the old one from; None when the pool is dry (the caller
        stalls and retries)."""
        rec = self._records[page_id]
        if rec.ref_count <= 1:
            if rec.seq_hash is not None:
                if self.on_evict is not None and rec.filled:
                    self.on_evict(page_id, rec.seq_hash)
                self._unregister(page_id)
            rec.filled, rec.filler = True, ""
            return page_id
        new_pid = self.allocate_page()
        if new_pid is None:
            return None
        self.cow_copies += 1
        return new_pid

    def release_sequence(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page. Registered filled pages park in
        the LRU (still matchable); a registered page whose fill never
        happened unregisters (its bytes are garbage), and it and the
        rest return to the free list."""
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
                if rec.seq_hash is not None and rec.filled:
                    self._reclaimable[pid] = None
                    self._reclaimable.move_to_end(pid)
                else:
                    self._unregister(pid)
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
        rec = self._records[pid]
        rec.ref_count = 1
        rec.filled, rec.filler = True, ""
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
        rec.filled, rec.filler = True, ""
