"""Predictive KV tiering: packed admission, swap planning.

Counterpart of ``dynamo_exp_tpu/engine/tiering.py`` (the same functions
on the same inputs give the same results; ``tests/test_torch_kv_tiering.py``
holds them to the JAX ones), without the G3 persistent tier:

- **Footprint-packed admission**: the scheduler forecasts each waiting
  sequence's lifetime KV footprint (prompt + generation budget, minus
  the radix-matched resident prefix) and admits the first sequence
  whose forecast fits the free pages; :func:`select_packed_index` keeps
  the priority and starvation rules.
- **Proactive cold-tail offload**: under KV pressure the engine swaps a
  cold row's refcount-1 pages out to the host tier (bytes kept) instead
  of preempting it; :func:`plan_swap_entries` classifies the pages and
  :class:`SwapRecord` is the row's page-table ledger until swap-in.

Pure host bookkeeping, owned by the engine loop thread (rank 0's under
tensor parallelism: the other ranks move their head slices of the pages
it plans, ``engine/tp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence as _Seq

from ..tokens import chain_hash, compute_block_hash, compute_block_hashes_for_seq

# Tag mixed into the host key of a swapped *partial* tail page so it can
# never collide with a full-block chain hash (the host pool holds both
# prefix-cache pages and swap write-backs).
_SWAP_TAIL_TAG = 0x517CC1B727220A95


def footprint_pages(
    prompt_len: int,
    max_tokens: int,
    page_size: int,
    max_model_len: int | None = None,
) -> int:
    """Lifetime device-page footprint of one sequence: prompt plus the
    full generation budget. The last sampled token never has its KV
    written, hence the ``- 1``."""
    tokens = prompt_len + max(max_tokens, 1) - 1
    if max_model_len is not None:
        tokens = min(tokens, max_model_len)
    return max(-(-tokens // page_size), 1)


def swap_tail_key(parent_hash: int | None, tokens: _Seq[int]) -> int:
    """Host-pool key of a swapped partial tail page (the tokens written
    into it so far, chained on the previous page's hash), tagged out of
    the full-block chain-hash space so it never matches as a prefix."""
    return chain_hash(parent_hash, compute_block_hash(list(tokens))) ^ _SWAP_TAIL_TAG


def select_packed_index(
    entries: _Seq[tuple[bool, int, int]], max_defers: int
) -> int | None:
    """Packed-admission choice over the scanned head of the waiting
    queue. ``entries`` holds ``(fits_headroom, priority, defers)`` per
    waiting sequence in queue order. Returns the index to admit, or
    ``None`` when no forecast fits (the caller then tries the head, so
    packing only reorders):

    - a candidate may bypass only deferred sequences of priority <= its
      own (no priority inversion);
    - a sequence bypassed ``max_defers`` times is a barrier: nothing
      behind it is considered until it admits (no starvation).
    """
    blocked_prio = -1
    for i, (fits, prio, defers) in enumerate(entries):
        if fits and prio >= blocked_prio:
            return i
        if defers >= max_defers:
            break
        if prio > blocked_prio:
            blocked_prio = prio
    return None


@dataclass
class SeqForecast:
    """One waiting sequence's KV footprint forecast."""

    total_pages: int  # lifetime footprint (prompt + budget), in pages
    resident_pages: int  # G1 radix-matched prefix (no fresh allocation)
    # Host-resident beyond the G1 match: a fresh page, but no prefill.
    host_pages: int

    @property
    def fresh_pages(self) -> int:
        """Device pages this sequence will allocate over its lifetime."""
        return max(self.total_pages - self.resident_pages, 0)


class KvFootprintForecast:
    """Forecasts waiting sequences' device-page footprints against the
    page manager's radix index and host tier. Prompt block hashes are
    cached on the sequence (``Sequence.forecast_hashes``, cleared by
    preemption) so a pass costs the radix walk, not a rehash."""

    def __init__(self, kv, cfg):
        self.kv = kv
        self.cfg = cfg

    def headroom(self) -> int:
        """Pages an admission could take right now (free + parked)."""
        return self.kv.free_pages

    def hashes_for(self, seq) -> list[int]:
        if seq.forecast_hashes is None:
            seq.forecast_hashes = compute_block_hashes_for_seq(
                seq.prompt, self.kv.page_size
            )
        return seq.forecast_hashes

    def forecast(self, seq) -> SeqForecast:
        sc = seq.stop.stop_conditions
        max_tokens = sc.max_tokens or self.cfg.default_max_tokens
        total = footprint_pages(
            len(seq.prompt), max_tokens, self.kv.page_size, self.cfg.max_model_len
        )
        resident = host = 0
        if self.kv.sharing:
            hashes = self.hashes_for(seq)
            resident = len(self.kv.match_resident_hashes(hashes))
            if self.kv.host_pool is not None:
                host = len(self.kv.host_pool.match_chain(hashes[resident:]))
        return SeqForecast(total, resident, host)


@dataclass
class SwapRecord:
    """Page-table ledger of one swapped-out row. ``entries`` covers the
    row's written pages in order:

    - ``("kept", pid)``: a shared page the row kept its ref on;
    - ``("hash", seq_hash)``: a registered page released to the parked
      LRU; swap-in re-attaches it if still resident, else restores it
      from the host tier by its chain hash (eviction wrote it there);
    - ``("host", key)``: an unregistered page (partial tail or
      duplicate-content block) written back under ``key``; swap-in must
      fetch it (a miss falls back to preemption).

    Unwritten growth pages are dropped at swap-out. ``committed`` flips
    (on the copy thread) once the write-back batch is in the host pool;
    swap-in waits for it."""

    entries: list[tuple[str, int]] = field(default_factory=list)
    committed: bool = False


def plan_swap_entries(
    page_ids: _Seq[int],
    tokens: _Seq[int],
    page_size: int,
    page_ref,
    page_hash,
    shared_tail_pid: int = -1,
) -> tuple[list[tuple[str, int]], list[int], list[int], list[int], list[int]]:
    """Classify one row's pages for swap-out. Returns ``(entries,
    offload_pids, offload_keys, park_pids, drop_pids)``: pages to write
    back under keys, registered pages to release into the parked LRU,
    and unwritten growth pages to drop. ``page_ref``/``page_hash`` read
    the page manager."""
    written = max(len(tokens) - 1, 0)  # KV exists through position written-1
    full = written // page_size
    chain = compute_block_hashes_for_seq(list(tokens[: full * page_size]), page_size)
    entries: list[tuple[str, int]] = []
    off_pids: list[int] = []
    off_keys: list[int] = []
    park_pids: list[int] = []
    drop_pids: list[int] = []
    for i, pid in enumerate(page_ids):
        if i * page_size >= written:
            drop_pids.append(pid)  # no KV written yet: nothing to keep
            continue
        if page_ref(pid) != 1 or pid == shared_tail_pid:
            entries.append(("kept", pid))
            continue
        h = page_hash(pid)
        if h is not None:
            entries.append(("hash", h))
            park_pids.append(pid)
            continue
        if i < full:
            key = chain[i]  # full block, unregistered (duplicate content)
        else:
            parent = chain[i - 1] if i else None
            key = swap_tail_key(parent, tokens[i * page_size : written])
        entries.append(("host", key))
        off_pids.append(pid)
        off_keys.append(key)
    return entries, off_pids, off_keys, park_pids, drop_pids
