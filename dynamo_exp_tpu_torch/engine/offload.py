"""G2 host-memory KV tier and the device <-> host copy stream.

Counterpart of ``dynamo_exp_tpu/engine/offload.py`` for one CUDA
device:

- :class:`HostKvPool` keeps the JAX pool's content addressing (pages
  keyed by the chained block hash of ``tokens.py``) and LRU, in torch
  tensors ``[host_pages, L, ps, Hkv*D]`` per K and V: pinned host memory
  when the engine runs on a card (numpy has no bf16), plain CPU tensors
  on the CPU.
- :class:`CopyStream` moves pages between the device pools and the host
  pool on side CUDA streams, off the compute stream:

  * device -> host (offload): the engine loop gathers the evicted pages
    on the compute stream into one contiguous device batch (a page is
    strided across layers in ``[L, pages, ...]`` pools) and records an
    event after the gather. The copy thread makes its stream wait on
    that event, copies the batch into pinned memory with
    ``non_blocking=True``, waits on the copy's own event (never on
    ``torch.cuda.synchronize()``, which would wait for the loop's work
    too), keeps the batch referenced until then, and stores page by
    page into the pool. Stream order on the compute stream keeps the
    gather ahead of any later forward that rewrites the freed pages.
  * host -> device (inject): :meth:`CopyStream.upload` copies a pinned
    host batch to the device on a second side stream and makes the
    compute stream wait on the copy's event; the engine then scatters
    the batch into its pages on the compute stream, before the first
    forward that reads them.
  * the host side of a prefetch (:meth:`CopyStream.fetch_batch`): pages
    are copied out of the pool on the copy thread and handed back to
    the loop, which uploads them. A page that misses the pool is read
    from the G3 store (``kv/persistent.py``), checksum-verified, into
    the pool.
- The G2 -> G3 write-through: :attr:`HostKvPool.on_demote` receives a
  copy of each LRU-evicted page before its slot is overwritten.

On the CPU the same calls run without streams or events.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict

import torch

from ..device import resolve_device

log = logging.getLogger(__name__)


class HostKvPool:
    """Fixed-capacity host page pool, content-addressed, LRU-evicted.
    Thread-safe: written by the copy thread, read by the loop thread."""

    def __init__(
        self,
        num_pages: int,
        page_shape: tuple[int, ...],
        dtype: torch.dtype,
        pin_memory: bool = False,
        on_demote=None,
    ):
        self.num_pages = num_pages
        self.page_shape = tuple(page_shape)
        self.dtype = dtype
        shape = (num_pages,) + self.page_shape
        self._k = torch.zeros(shape, dtype=dtype, pin_memory=pin_memory)
        self._v = torch.zeros(shape, dtype=dtype, pin_memory=pin_memory)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        # seq_hash -> host slot; the OrderedDict is the LRU (oldest first).
        self._by_hash: OrderedDict[int, int] = OrderedDict()
        self._lock = threading.Lock()
        # ``on_demote(seq_hash, k_copy, v_copy)``: called, outside the
        # lock, with a copy of each LRU-evicted page (cold G2 -> G3);
        # the copy thread calls it for offloads, the loop thread for
        # admission promotes.
        self.on_demote = on_demote
        self.stores = 0
        self.hits = 0
        self.evictions = 0

    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._by_hash

    @property
    def resident(self) -> int:
        with self._lock:
            return len(self._by_hash)

    def store(self, seq_hash: int, k_page: torch.Tensor, v_page: torch.Tensor) -> None:
        """Insert one page, evicting the LRU page when full. Idempotent
        per hash: a resident page is refreshed, not duplicated. A copy
        that raises leaves the hash out of the pool."""
        demoted = None
        with self._lock:
            slot = self._by_hash.pop(seq_hash, None)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    h_old, slot = self._by_hash.popitem(last=False)
                    self.evictions += 1
                    if self.on_demote is not None:
                        # Copied before the overwrite below; the callback
                        # (file I/O) runs outside the lock.
                        demoted = (h_old, self._k[slot].clone(), self._v[slot].clone())
            try:
                self._k[slot].copy_(k_page)
                self._v[slot].copy_(v_page)
            except BaseException:
                self._free.append(slot)
                raise
            self._by_hash[seq_hash] = slot  # most recently used
            self.stores += 1
        if demoted is not None:
            try:
                self.on_demote(*demoted)
            except Exception:  # a broken G3 writer must not break G2
                log.exception("G2->G3 demotion callback failed")

    def fetch(
        self, seq_hash: int, out: tuple[torch.Tensor, torch.Tensor] | None = None
    ) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Copy one page out (into ``out`` when given, else into new
        tensors); the copy pins the content against a concurrent LRU
        eviction overwriting the slot. None on a miss."""
        with self._lock:
            slot = self._by_hash.get(seq_hash)
            if slot is None:
                return None
            self._by_hash.move_to_end(seq_hash)
            self.hits += 1
            if out is None:
                return self._k[slot].clone(), self._v[slot].clone()
            out[0].copy_(self._k[slot])
            out[1].copy_(self._v[slot])
            return out

    def match_chain(self, seq_hashes: list[int]) -> list[int]:
        """Longest resident prefix of the hash chain (extends a G1 match
        into G2 without copying yet)."""
        out: list[int] = []
        with self._lock:
            for h in seq_hashes:
                if h not in self._by_hash:
                    break
                out.append(h)
        return out

    def snapshot(self) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
        """Copy every resident page out, LRU-oldest first, without
        touching recency or hit counters: the graceful-shutdown G2 -> G3
        drain (``TorchEngine.stop``) walks it so the sealed manifest
        covers the whole warm set."""
        with self._lock:
            return [(h, self._k[slot].clone(), self._v[slot].clone())
                    for h, slot in self._by_hash.items()]


def pinned_empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host staging tensor: pinned when the copy's other end is a
    card (so ``non_blocking`` copies are asynchronous), plain otherwise."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


class CopyStream:
    """Background device <-> host copy stream (see the module docstring).

    One bounded queue carries both the offloads and the host side of
    prefetches, so :meth:`drain` and :meth:`stop` cover both. Byte and
    time counters (CUDA events, so device time of the copies alone) read
    the rate of each direction. Without a host tier (``pool`` None) the
    stream serves the KV handoffs' uploads and :meth:`to_host` only."""

    def __init__(
        self, pool: HostKvPool | None, max_inflight: int = 256,
        device: torch.device | None = None, store=None,
    ):
        self.pool = pool
        # The G3 PersistentKvStore, when armed: a prefetch fetch that
        # misses the pool falls through to it (checksum-verified).
        self.store = store
        self.device = resolve_device(device if device is not None else "cpu")
        cuda = self.device.type == "cuda"
        self.d2h = torch.cuda.Stream(self.device) if cuda else None
        self.h2d = torch.cuda.Stream(self.device) if cuda else None
        # Bounded: each offload entry holds a gathered device batch, so a
        # burst of evictions outpacing the copies sheds (the tier is a
        # cache: a dropped offload costs a later recompute) instead of
        # growing device memory without bound.
        self._q: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._running = True
        self.dropped = 0
        # The first exception of an item stops the stream; the engine
        # loop raises it (a copy that failed is never passed over).
        self.error: BaseException | None = None
        self.d2h_pages = self.d2h_bytes = 0
        self.d2h_s = 0.0
        self.h2d_pages = self.h2d_bytes = 0
        self.h2d_s = 0.0
        # Host seconds spent enqueueing the uploads' copies (their events
        # time those gaps too), and uploads from pageable memory.
        self.h2d_host_s = 0.0
        self.h2d_pageable = 0
        # Uploads whose copy may still run: (start event, end event,
        # bytes, host K and V staging kept alive until the copy is done).
        self._uploads: list[tuple] = []
        self._thread = threading.Thread(target=self._run, name="kv-copy-stream", daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        """Queued items not yet committed (both directions): swap-in
        tells a write-back still in flight from a host-tier miss by it."""
        return self._q.unfinished_tasks

    def offload_batch(
        self, seq_hashes: list, k_dev: torch.Tensor, v_dev: torch.Tensor,
        on_stored=None, ready: "torch.cuda.Event | None" = None,
    ) -> bool:
        """Queue one gathered batch ``[L, n, ps, Hkv*D]`` per K and V
        covering ``len(seq_hashes)`` pages (page axis 1). ``ready`` is
        the event recorded after the gather on the compute stream (CUDA
        only); ``on_stored`` fires on the copy thread once the batch is
        in the pool. Returns False when the stream is saturated and the
        batch was shed."""
        try:
            self._q.put_nowait(("offload", list(seq_hashes), k_dev, v_dev, ready, on_stored))
            return True
        except queue.Full:
            self.dropped += len(seq_hashes)
            return False

    def fetch_batch(self, seq_hashes: list, ctx, on_fetched) -> bool:
        """Host side of a prefetch: copy ``seq_hashes``' pages out of the
        pool on the copy thread and call ``on_fetched(ctx, fetched)``
        with the ``(hash, k_page, v_page)`` prefix that was resident (the
        walk stops at the first miss: a restored prefix must stay chain-
        contiguous). The callback runs on the copy thread. Returns False
        when the stream is saturated."""
        try:
            self._q.put_nowait(("fetch", list(seq_hashes), ctx, on_fetched))
            return True
        except queue.Full:
            self.dropped += len(seq_hashes)
            return False

    def upload(self, k_host: torch.Tensor, v_host: torch.Tensor) -> tuple:
        """Host -> device copy of a ``[L, n, ps, Hkv*D]`` batch per K and
        V on the side stream; the current (compute) stream waits on the
        copy's event, so what it runs next reads the copied bytes. The
        host staging stays referenced until the copy has completed (see
        :meth:`poll`). Returns the device batches."""
        n, nbytes = k_host.shape[1], 2 * k_host.numel() * k_host.element_size()
        self.h2d_pages += n
        self.h2d_bytes += nbytes
        if self.h2d is None:
            return k_host.to(self.device), v_host.to(self.device)
        self.h2d_pageable += not (k_host.is_pinned() and v_host.is_pinned())
        compute = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.h2d):
            # Allocate first: the events then time the copies alone, not
            # a cudaMalloc the host makes between them.
            k_dev = torch.empty(k_host.shape, dtype=k_host.dtype, device=self.device)
            v_dev = torch.empty(v_host.shape, dtype=v_host.dtype, device=self.device)
            t0 = time.perf_counter()
            start.record()
            k_dev.copy_(k_host, non_blocking=True)
            v_dev.copy_(v_host, non_blocking=True)
            end.record()
            self.h2d_host_s += time.perf_counter() - t0
        compute.wait_event(end)
        # Allocated on the side stream, read on the compute stream: the
        # allocator must not reuse them before the compute stream is done.
        k_dev.record_stream(compute)
        v_dev.record_stream(compute)
        self._uploads.append((start, end, nbytes, k_host, v_host))
        return k_dev, v_dev

    def poll(self, wait: bool = False) -> None:
        """Retire completed uploads: book their event time and drop the
        host staging. ``wait`` blocks on each upload's own event."""
        keep = []
        for up in self._uploads:
            start, end = up[0], up[1]
            if wait:
                end.synchronize()  # dynlint: sync-point(upload events read for the copy totals)
            if end.query():
                self.h2d_s += start.elapsed_time(end) / 1e3
            else:
                keep.append(up)
        self._uploads = keep

    def stats(self) -> dict:
        """Pages, bytes and device seconds each way (seconds from CUDA
        events on a card; 0 on the CPU)."""
        self.poll(wait=True)
        return dict(
            d2h_pages=self.d2h_pages, d2h_bytes=self.d2h_bytes, d2h_s=self.d2h_s,
            h2d_pages=self.h2d_pages, h2d_bytes=self.h2d_bytes, h2d_s=self.h2d_s,
            h2d_host_s=self.h2d_host_s, h2d_pageable=self.h2d_pageable,
        )

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every queued item has committed (bounded)."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

    def stop(self) -> None:
        """Stop the stream. Items still queued are discarded: the tier is
        a cache, so stopping loses nothing but later hits."""
        self._running = False
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # the worker re-checks _running per item
        self._thread.join(timeout=10)
        self.poll(wait=True)

    def to_host(self, k_dev, v_dev, ready) -> tuple:
        """The device -> host leg alone, on the calling thread (the
        disaggregation extract and the reclaim extract, page-major
        batches ``[n, L, ps, Hkv*D]``): the batch's pinned host copy once
        it has landed, counted as d2h."""
        k_h, v_h, copy = self._to_host(k_dev, v_dev, ready)
        if copy is not None:
            start, end = copy
            end.synchronize()  # dynlint: sync-point(extract gather consume)
            self.d2h_s += start.elapsed_time(end) / 1e3
        self.d2h_pages += k_dev.shape[0]  # page-major: [n, L, ps, Hkv*D]
        self.d2h_bytes += 2 * k_dev.numel() * k_dev.element_size()
        return k_h, v_h

    def _to_host(self, k_dev, v_dev, ready):
        """Queue the device -> host leg of one offload (see the module
        docstring): pinned host tensors and the copy's (start, end)
        events, or on the CPU the tensors themselves and None. The
        caller waits on ``end`` before it reads the host tensors, and
        keeps the device batch referenced until then."""
        if self.d2h is None:
            return k_dev, v_dev, None
        k_h = pinned_empty(k_dev.shape, k_dev.dtype, self.device)
        v_h = pinned_empty(v_dev.shape, v_dev.dtype, self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.d2h):
            if ready is not None:
                self.d2h.wait_event(ready)
            start.record()
            k_h.copy_(k_dev, non_blocking=True)
            v_h.copy_(v_dev, non_blocking=True)
            end.record()
        return k_h, v_h, (start, end)

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        except BaseException as e:
            log.exception("KV copy stream could not start")
            self.error = e
            self._running = False
        while self._running:
            item = self._q.get()
            try:
                if item is None:
                    return
                if item[0] == "fetch":
                    _, seq_hashes, ctx, on_fetched = item
                    fetched = []
                    for h in seq_hashes:
                        data = self.pool.fetch(h)
                        if data is None and self.store is not None:
                            # G3 fallback: a verified page promotes into
                            # the pool; a corrupt one quarantines there
                            # and misses.
                            data = self.store.fetch(h)
                            if data is not None:
                                self.pool.store(h, data[0], data[1])
                        if data is None:
                            break  # chain broken: later pages unmatchable
                        fetched.append((h, data[0], data[1]))
                    on_fetched(ctx, fetched)
                    continue
                _, seq_hashes, k_dev, v_dev, ready, on_stored = item
                k_h, v_h, copy = self._to_host(k_dev, v_dev, ready)
                if copy is not None:
                    start, end = copy
                    end.synchronize()  # dynlint: sync-point(offload copy-thread transfer)
                    self.d2h_s += start.elapsed_time(end) / 1e3
                self.d2h_pages += len(seq_hashes)
                self.d2h_bytes += 2 * k_dev.numel() * k_dev.element_size()
                for j, h in enumerate(seq_hashes):
                    self.pool.store(h, k_h[:, j], v_h[:, j])
                if on_stored is not None:
                    on_stored()
            except BaseException as e:
                log.exception("KV copy-stream item %s failed; stopping the stream", item[0])
                self.error = e
                self._running = False
            finally:
                self._q.task_done()
