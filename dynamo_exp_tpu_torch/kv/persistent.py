"""G3 persistent KV tier: a crash-survivable, checksummed,
content-addressed page store (counterpart of
``dynamo_exp_tpu/kv/persistent.py``; the JAX package's
docs/fault_tolerance.md, "Durable KV & corruption containment").

The G1 device / G2 host tiers die with the process; this tier is a
local-SSD directory (optionally fleet-shared) keyed by the SAME
deterministic chained block hashes the radix prefix index and the swap
keys use (``tokens.py``), so a page demoted here is matchable by any
later prompt — including one admitted by a freshly restarted process.

Crash-consistency contract:

- **Atomic page writes**: each page lands as tmp + ``os.replace`` with
  a fixed-layout header (magic, CRC32 of meta+payload, masked hash,
  meta length) ahead of the K/V payload — a reader never observes a
  half-written final file under the rename, and a power-cut torn tail
  is detectable from the header's declared lengths.
- **Write-ahead manifest**: an append-only JSONL journal records the
  intent (``put``) before the rename and the terminal transitions
  (``del`` / ``quarantine``) after them. :meth:`boot_scan` replays it
  tolerantly — a torn final line is expected after a crash — and the
  page *files* stay authoritative: the manifest only contributes the
  LRU adoption order and crash forensics counters.
- **Verify-before-match**: every fetch re-checksums the payload before
  the bytes can become matchable KV. A mismatch (bit rot, torn tail
  that slipped past the structural scan, seeded chaos bit-flip)
  quarantines the entry — moved to ``quarantine/``, never re-adopted —
  bumps a counter, and returns a miss, so the caller degrades to
  journal re-prefill (token-identical by counter-based sampling);
  garbage bytes are never served.
- **Degradation ladder**: an absent/unwritable directory or an ENOSPC
  mid-write flips :attr:`degraded` — subsequent stores become no-ops
  and the engine behaves exactly as G2-only. The store never raises
  into the engine loop and never blocks it on durability (fsync only
  at :meth:`seal`, the graceful-shutdown path).

On-disk format: byte for byte the JAX store's (header, meta JSON with
the dtype's numpy name -- ``bfloat16`` for bf16 -- and the page shape,
raw K then V bytes, the same manifest lines), so either package adopts
the other's directory. Pages come in and go out as CPU torch tensors
(the G2 host pool's); numpy arrays are accepted too. A page is the
whole page at any tensor-parallel degree (the host pool is rank 0's and
holds every rank's heads), so a store written at one degree is adopted
at another.

Thread-safety mirrors :class:`~dynamo_exp_tpu_torch.engine.offload.HostKvPool`:
written by the copy thread (demotions) and the engine loop (admission
promotes / stop drain), read by both — index state sits under one lock;
file I/O runs outside it (same-hash racers write identical bytes, and
``os.replace`` is atomic, so the race is benign by content addressing).

No wall-clock reads, no unseeded randomness: eviction order is
insertion-order LRU and all fault injection comes from the seeded
:class:`~dynamo_exp_tpu_torch.runtime.transports.chaos.StorageChaos`
schedule.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict

import numpy as np
import torch

log = logging.getLogger(__name__)

# Page-file layout: HEADER | meta json (meta_len bytes) | K payload |
# V payload. The CRC covers meta+payloads; the header itself is
# length-checked structurally (magic + declared sizes vs file size), so
# a torn tail is detected even before the first payload byte is read.
_MAGIC = b"DKV3"
_HEADER = struct.Struct("<4sIQI")  # magic, crc32, hash (masked u64), meta_len
_U64 = (1 << 64) - 1


# The numpy names the JAX store writes into a page's meta ("bfloat16" is
# ml_dtypes' name for bf16, which numpy lacks).
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}
_NAMED = {v: k for k, v in _DTYPE_NAMES.items()}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _NAMED:
        raise ValueError(f"G3 store: unsupported page dtype {dtype!r}")
    return _NAMED[name]


def _page_bytes(page) -> bytes:
    """A page's raw bytes (a CPU torch tensor or a numpy array)."""
    if isinstance(page, torch.Tensor):
        t = page.detach().contiguous().cpu()  # dynlint: sync-point(host-resident G2 page, no device handle)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(page).tobytes()


def _fname(seq_hash: int) -> str:
    return f"{seq_hash & _U64:016x}.kv"


class PersistentKvStore:
    """Fixed-capacity on-disk KV page store, content-addressed,
    insertion-order-LRU evicted, checksummed end to end."""

    def __init__(
        self,
        root: str,
        capacity_pages: int,
        page_shape: tuple[int, ...],
        dtype,
        chaos=None,
    ):
        self.root = root
        self.capacity = max(int(capacity_pages), 0)
        self._page_shape = tuple(int(d) for d in page_shape)
        self._dtype = _torch_dtype(dtype)
        self._dtype_name = _DTYPE_NAMES[self._dtype]
        self._page_bytes = int(
            np.prod(self._page_shape)
        ) * self._dtype.itemsize
        # Seeded storage-fault schedule (StorageChaos) — None in prod.
        self.chaos = chaos
        self._lock = threading.Lock()
        # seq_hash -> file name; OrderedDict doubles as the LRU
        # (oldest first), seeded by manifest order at boot_scan.
        self._by_hash: "OrderedDict[int, str]" = OrderedDict()
        # Hashes proven corrupt: never matched, never re-adopted.
        self._quarantined: set[int] = set()
        # Conservation ledger counters, maintained at the SAME
        # transitions that mutate _by_hash (O(1) per transition):
        # resident == adopted + stores - evictions -
        # quarantined at all times, checked by ledger_check().
        self.adopted = 0  # pages rebuilt by boot_scan
        self.stores = 0  # NEW pages committed (refreshes excluded)
        self.refreshes = 0  # already-resident hash re-stored
        self.evictions = 0  # capacity-evicted pages
        self.quarantined = 0  # resident pages quarantined post-adopt
        self.hits = 0  # fetches that returned verified bytes
        self.misses = 0  # fetches that found nothing servable
        self.checksum_failures = 0  # CRC mismatches at fetch
        self.torn_pages = 0  # structurally-invalid files at boot
        self.manifest_torn = 0  # torn manifest tails tolerated at boot
        self.store_errors = 0  # write failures (ENOSPC, I/O)
        self.degraded = False
        self._manifest = None
        try:
            os.makedirs(self.root, exist_ok=True)
            os.makedirs(os.path.join(self.root, "quarantine"), exist_ok=True)
            self._manifest = open(  # noqa: SIM115 - long-lived WAL handle
                os.path.join(self.root, "manifest.jsonl"), "a"
            )
        except OSError as e:
            log.warning(
                "G3 store root %r unusable (%s): degrading to G2-only",
                self.root, e,
            )
            self.degraded = True

    # ---------------------------------------------------------------- stats
    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._by_hash

    @property
    def resident(self) -> int:
        with self._lock:
            return len(self._by_hash)

    @property
    def quarantined_hashes(self) -> int:
        with self._lock:
            return len(self._quarantined)

    # ------------------------------------------------------------- manifest
    def _journal(self, op: str, seq_hash: int) -> None:
        """One WAL line; flushed (not fsynced — seal() does that) so a
        crash loses at most the torn tail boot_scan tolerates."""
        if self._manifest is None:
            return
        try:
            self._manifest.write(
                json.dumps({"op": op, "hash": str(int(seq_hash))}) + "\n"
            )
            self._manifest.flush()
        except (OSError, ValueError):
            self.store_errors += 1
            self.degraded = True

    def seal(self) -> None:
        """Flush + fsync the manifest (graceful shutdown): the journal
        on disk is complete, so the next boot adopts every committed
        page without relying on directory-scan recovery."""
        if self._manifest is None:
            return
        try:
            self._manifest.flush()
            os.fsync(self._manifest.fileno())
        except (OSError, ValueError):
            self.store_errors += 1

    def close(self) -> None:
        self.seal()
        if self._manifest is not None:
            try:
                self._manifest.close()
            except OSError:
                pass
            self._manifest = None

    # ---------------------------------------------------------------- write
    def _encode(self, seq_hash: int, k_page, v_page) -> bytes:
        meta = json.dumps(
            {
                "hash": str(int(seq_hash)),
                "dtype": self._dtype_name,
                "shape": list(self._page_shape),
            }
        ).encode()
        payload = meta + _page_bytes(k_page) + _page_bytes(v_page)
        header = _HEADER.pack(
            _MAGIC, zlib.crc32(payload), seq_hash & _U64, len(meta)
        )
        return header + payload

    def store(self, seq_hash: int, k_page, v_page) -> bool:
        """Demote one page (atomic tmp+rename, WAL'd). Idempotent per
        hash; returns False when the page was not committed (degraded
        store, quarantined hash, injected write fault)."""
        if self.degraded or self.capacity <= 0:
            return False
        with self._lock:
            if seq_hash in self._quarantined:
                return False  # proven corrupt: never readmit the key
            if seq_hash in self._by_hash:
                self._by_hash.move_to_end(seq_hash)
                self.refreshes += 1
                return True
        evict: int | None = None
        fname = _fname(seq_hash)
        fault = self.chaos.take("store_write") if self.chaos else None
        try:
            if fault is not None and fault.kind == "enospc":
                raise OSError(28, "chaos: no space left on device")
            blob = self._encode(seq_hash, k_page, v_page)
            final = os.path.join(self.root, fname)
            self._journal("put", seq_hash)  # intent, ahead of the rename
            if fault is not None and fault.kind == "torn":
                # Crash-mid-write emulation: the file lands torn (a
                # prefix of the real bytes), exactly what a power cut
                # after the rename but before the data blocks flushed
                # leaves behind. boot_scan / fetch must reject it.
                cut = len(blob) // 2
                with open(final, "wb") as f:
                    f.write(blob[:cut])
            else:
                tmp = final + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, final)
        except OSError as e:
            self.store_errors += 1
            if getattr(e, "errno", None) == 28:  # ENOSPC: stop writing
                self.degraded = True
                log.warning("G3 store out of space: degrading to G2-only")
            else:
                log.warning("G3 store write failed for %s: %s", fname, e)
            return False
        with self._lock:
            if seq_hash not in self._by_hash:
                self._by_hash[seq_hash] = fname
                self.stores += 1
                if len(self._by_hash) > self.capacity:
                    evict, _ = self._by_hash.popitem(last=False)
                    self.evictions += 1
            else:
                self.refreshes += 1
        if evict is not None:
            self._journal("del", evict)
            self._remove_file(_fname(evict))
        return True

    def _remove_file(self, fname: str) -> None:
        try:
            os.remove(os.path.join(self.root, fname))
        except OSError:
            pass  # already gone (shared dir / racing evictor): fine

    # ----------------------------------------------------------------- read
    def _quarantine(self, seq_hash: int, fname: str, reason: str) -> None:
        """Terminal state for a corrupt entry: out of the index, file
        moved aside for forensics, key barred from re-adoption."""
        with self._lock:
            if self._by_hash.pop(seq_hash, None) is not None:
                self.quarantined += 1
            self._quarantined.add(seq_hash)
        self._journal("quarantine", seq_hash)
        src = os.path.join(self.root, fname)
        dst = os.path.join(self.root, "quarantine", fname)
        try:
            os.replace(src, dst)
        except OSError:
            self._remove_file(fname)
        log.warning(
            "G3 page %s quarantined (%s): degrading this block to "
            "journal re-prefill", fname, reason,
        )

    def _decode(self, blob: bytes, seq_hash: int):
        """Structural + checksum validation; returns (k, v) or raises
        ValueError naming the corruption."""
        if len(blob) < _HEADER.size:
            raise ValueError("torn header")
        magic, crc, h, meta_len = _HEADER.unpack_from(blob)
        if magic != _MAGIC:
            raise ValueError("bad magic")
        payload = blob[_HEADER.size:]
        want = meta_len + 2 * self._page_bytes
        if len(payload) != want:
            raise ValueError(f"torn payload ({len(payload)}/{want} bytes)")
        if h != (seq_hash & _U64):
            raise ValueError("hash/key mismatch")
        if zlib.crc32(payload) != crc:
            raise ValueError("checksum mismatch")
        meta = json.loads(payload[:meta_len])
        if (
            tuple(meta.get("shape", ())) != self._page_shape
            or meta.get("dtype") != self._dtype_name
        ):
            raise ValueError("dtype/shape mismatch")
        # A writable buffer: the caller injects these pages into pools.
        body = bytearray(payload[meta_len:])
        kv = torch.frombuffer(body, dtype=self._dtype)
        n = self._page_bytes // self._dtype.itemsize
        return kv[:n].view(self._page_shape), kv[n:].view(self._page_shape)

    def fetch(self, seq_hash: int):
        """Promote one page out of the store, checksum-verified.
        Returns ``(k_page, v_page)`` or None (miss / corrupt — a
        corrupt entry is quarantined and counted, and the caller's
        restored prefix just shortens: the journal re-prefill recomputes
        the block token-identically)."""
        with self._lock:
            fname = self._by_hash.get(seq_hash)
            if fname is None:
                self.misses += 1
                return None
            self._by_hash.move_to_end(seq_hash)
        fault = self.chaos.take("store_read") if self.chaos else None
        if fault is not None and fault.kind == "delay":
            # A slow store must slow restores, never wedge the engine:
            # callers treat the eventual miss/hit exactly the same.
            time.sleep(fault.delay_s)
        try:
            with open(os.path.join(self.root, fname), "rb") as f:
                blob = f.read()
        except OSError as e:
            self._quarantine(seq_hash, fname, f"unreadable: {e}")
            self.misses += 1
            return None
        if fault is not None and fault.kind == "bitflip":
            buf = bytearray(blob)
            if len(buf) > _HEADER.size:
                pos = _HEADER.size + self.chaos.rng.randrange(
                    len(buf) - _HEADER.size
                )
                buf[pos] ^= 0x40
            blob = bytes(buf)
        try:
            k, v = self._decode(blob, seq_hash)
        except (ValueError, json.JSONDecodeError) as e:
            self.checksum_failures += 1
            self._quarantine(seq_hash, fname, str(e))
            self.misses += 1
            return None
        self.hits += 1
        return k, v

    def match_chain(self, seq_hashes: list[int]) -> list[int]:
        """Longest store-resident prefix of the hash chain (membership
        only — bytes are verified at fetch, and a fetch-time quarantine
        shortens the restored prefix then)."""
        out: list[int] = []
        with self._lock:
            for h in seq_hashes:
                if h not in self._by_hash or h in self._quarantined:
                    break
                out.append(h)
        return out

    # ----------------------------------------------------------------- boot
    def boot_scan(self) -> int:
        """Crash recovery: replay the manifest (tolerating a torn last
        line), structurally validate every page file, quarantine torn
        tails, and rebuild the survivors as matchable entries — the
        returning conversation re-attaches through the ordinary
        admission match against this index. Returns pages adopted."""
        if self.degraded:
            return 0
        order: list[int] = []
        try:
            with open(os.path.join(self.root, "manifest.jsonl")) as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []
        dead: set[int] = set()
        journal_quarantined: set[int] = set()
        for i, line in enumerate(lines):
            try:
                entry = json.loads(line)
                h = int(entry["hash"])
                op = entry["op"]
            except (ValueError, KeyError, TypeError):
                # A torn tail is expected exactly once, on the final
                # line, after a crash mid-append; anything else is
                # still tolerated (the files are authoritative) but
                # counted so the operator sees it.
                self.manifest_torn += 1
                if i != len(lines) - 1:
                    log.warning("G3 manifest line %d unparseable", i + 1)
                continue
            if op == "put":
                order.append(h)
                dead.discard(h)
            elif op == "del":
                dead.add(h)
            elif op == "quarantine":
                dead.add(h)
                journal_quarantined.add(h)
        present: dict[str, int] = {}
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            self.degraded = True
            return 0
        for name in names:
            if not name.endswith(".kv"):
                # A crash between tmp write and rename leaves a .tmp
                # orphan: never adoptable (the rename that would have
                # published it did not happen), so clear it.
                if name.endswith(".kv.tmp"):
                    self._remove_file(name)
                continue
            path = os.path.join(self.root, name)
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    head = f.read(_HEADER.size)
                magic, _crc, h, meta_len = _HEADER.unpack_from(head)
                if (
                    magic != _MAGIC
                    or size != _HEADER.size + meta_len + 2 * self._page_bytes
                ):
                    raise ValueError("torn")
            except (OSError, struct.error, ValueError):
                # Torn tail / foreign shape: provably not servable.
                self.torn_pages += 1
                try:
                    os.replace(
                        path, os.path.join(self.root, "quarantine", name)
                    )
                except OSError:
                    self._remove_file(name)
                continue
            present[name] = h
        adopted = 0
        with self._lock:
            self._quarantined.update(journal_quarantined)
            # Manifest order first (it IS the LRU order the previous
            # process maintained), then any journal-less stragglers in
            # sorted-name order — deterministic either way.
            seen: set[int] = set()
            for h in order:
                name = _fname(h)
                if (
                    h in seen
                    or h in dead
                    or h in self._quarantined
                    or present.get(name) != (h & _U64)
                ):
                    continue
                seen.add(h)
                self._by_hash[h] = name
                adopted += 1
            masked = {h & _U64: h for h in seen}
            for name, hm in present.items():
                if hm in masked or hm in {q & _U64 for q in self._quarantined}:
                    continue
                # Hash keys are stored masked in the header; adopt under
                # the masked value (chain hashes are 64-bit already, so
                # this is the identity in practice).
                self._by_hash.setdefault(hm, name)
                masked[hm] = hm
                adopted += 1
            over = len(self._by_hash) - self.capacity
            evicted: list[int] = []
            for _ in range(max(over, 0)):
                h, _name = self._by_hash.popitem(last=False)
                evicted.append(h)
            self.adopted = adopted - len(evicted)
        for h in evicted:
            self._journal("del", h)
            self._remove_file(_fname(h))
        return self.adopted

    # --------------------------------------------------- conservation ledger
    def ledger_check(self) -> list[str]:
        """O(1) conservation arithmetic over the transition-maintained
        counters (the JAX package's docs/observability.md, "KV
        conservation auditor"):
        every page the store ever indexed is exactly one of
        {resident, evicted, quarantined}. Returns violation strings
        (empty = conserved)."""
        with self._lock:
            resident = len(self._by_hash)
            adopted, stores = self.adopted, self.stores
            evictions, quarantined = self.evictions, self.quarantined
        violations: list[str] = []
        if resident != adopted + stores - evictions - quarantined:
            violations.append(
                f"g3 page conservation broken: resident={resident} != "
                f"adopted={adopted} + stores={stores} - "
                f"evictions={evictions} - quarantined={quarantined}"
            )
        if min(adopted, stores, evictions, quarantined, resident) < 0:
            violations.append(
                f"g3 negative ledger counter: adopted={adopted} "
                f"stores={stores} evictions={evictions} "
                f"quarantined={quarantined}"
            )
        return violations

    def ledger(self) -> dict:
        """Audit snapshot (``llmctl audit`` renders it next to the page
        manager's G1 ledger)."""
        with self._lock:
            resident = len(self._by_hash)
            quarantined_keys = len(self._quarantined)
        return {
            "resident": resident,
            "adopted": self.adopted,
            "stores": self.stores,
            "refreshes": self.refreshes,
            "evictions": self.evictions,
            "quarantined": self.quarantined,
            "quarantined_keys": quarantined_keys,
            "hits": self.hits,
            "misses": self.misses,
            "checksum_failures": self.checksum_failures,
            "torn_pages": self.torn_pages,
            "manifest_torn": self.manifest_torn,
            "store_errors": self.store_errors,
            "degraded": self.degraded,
            "violations": self.ledger_check(),
        }
