"""Tensor parallelism of the engine: rank 0 drives, the other ranks follow.

Counterpart of the JAX engine's tp mesh (``engine.py:240``): there one
program runs over the mesh and XLA puts the collectives in it. Here
every rank is a process with its own ``TorchEngine`` over its shard of
the model and of the KV pools (``models/llama.py``), and the model's
forward issues the collectives (``parallel/comm.py``).

Rank 0 owns everything that decides: the scheduler, the KV page
manager and prefix cache, the front end, telemetry and sampling
decisions. Each dispatch it makes goes to the other ranks as one
command over the comm's control group (:meth:`TpDriver.send`), and
they run the same tensor code on their shards (:func:`follow`):

- ``window``: the engine's ``_window_body`` over the dispatch's host
  arrays, a chained window from the follower's own previous carry;
- ``mixed``: ``_mixed_body`` over the dispatch's host arrays;
- ``pages_out``: the KV tiers' page gather. Every rank selects its
  head slice of the listed pages and rank 0 gathers the slices into
  whole pages (``Comm.gather``), as one page of the tp=1 engine (and
  of the JAX engine's host tier) holds them: the host tier's offloads
  and swaps, a disaggregated prefill's extract, a reclaim's extract;
- ``pages_in``: the reverse, rank 0's whole host pages scattered by
  head slice (``Comm.scatter``) and written into the listed pages on
  every rank: swap-ins, prefetches and G2/G3 promotes, a remote
  prefill's inject, a migration's seed;
- ``noop``: a heartbeat while rank 0 idles, so that no follower's wait
  for the next command reaches the group's timeout;
- ``report``: every rank's report so far (:func:`rank_report`), gathered
  to every rank while the followers go on: what each rank has launched
  and moved up to this point of the command stream;
- ``stop``: the followers report and return.

Every command carries the device-side steps rank 0 took since the last
one (``TpDriver.ops``), which a follower applies first, in order:
copy-on-write page copies and the start of a row's penalty counts.

A page move is a command of its own, and its collective runs on every
rank right after the broadcast that carries it, so no rank waits in a
collective that another rank has not reached. Every command is sent
from one thread at a time, the engine loop's (or, once it has joined,
the thread that stops the engine), so every rank meets the page
collectives in one order; the copy thread and the asyncio thread hand
their page moves to the loop thread. Each rank counts its page moves
(calls and pages, by direction); at stop rank 0 raises if a rank's
differ from its own, as for the digests.

A follower never admits, schedules or chooses anything. The logits are
all-gathered, so every rank holds the same full logits, and the
counter-based threefry draws then give every rank the same tokens; this
keeps chained windows, whose tokens stay on the device, consistent.
Each rank folds every dispatch's outputs (tokens, and logprobs where
asked) into a digest in dispatch order; at stop rank 0 gathers every
rank's report and raises if a digest differs from its own.
"""

from __future__ import annotations

import hashlib
import logging
import time

import numpy as np
import torch

from ..ops import launches

log = logging.getLogger(__name__)

# Rank 0 sends a heartbeat when it has sent nothing for this long.
HEARTBEAT_S = 5.0


class Digest:
    """The outputs of every dispatch, in dispatch order, as one hash."""

    def __init__(self):
        self._h = hashlib.sha256()
        self.dispatches = 0

    def fold(self, arrays) -> None:
        for a in arrays:
            self._h.update(np.ascontiguousarray(a).tobytes())
        self.dispatches += 1

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def rank_report(engine, digest: Digest) -> dict:
    """What a rank tells rank 0 at stop: its device, its outputs' digest,
    its launch counters, its page moves, its peak device memory and its
    collectives."""
    dev = engine.device
    return {
        "rank": engine.comm.rank, "device": str(dev), "digest": digest.hexdigest(),
        "dispatches": digest.dispatches,
        "page_moves": {k: dict(v) for k, v in engine.page_moves.items()},
        "launches": {g: dict(c) for g, c in launches.COUNTERS.items()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "comm": engine.comm.stats(),
    }


class TpDriver:
    """Rank 0's side: sends the commands and gathers the reports."""

    def __init__(self, comm):
        self.comm = comm
        self.ops: list[tuple] = []  # device steps since the last command
        self.digest = Digest()
        self.closed = False
        self._last_send = time.monotonic()

    def send(self, kind: str, key=None, host: dict | None = None, chained: bool = False) -> None:
        if self.closed:
            raise RuntimeError("the engine's tp ranks were stopped")
        ops, self.ops = self.ops, []
        self.comm.broadcast((kind, key, host, chained, ops))
        self._last_send = time.monotonic()

    def heartbeat(self) -> None:
        if time.monotonic() - self._last_send >= HEARTBEAT_S:
            self.send("noop")

    def reports(self, engine) -> list[dict]:
        """Every rank's report so far (rank order); the followers go on."""
        self.send("report")
        return self.comm.all_gather_object(rank_report(engine, self.digest))

    def close(self, engine) -> list[dict]:
        """Stop the followers and gather every rank's report (rank order);
        raises if a follower's outputs differ from rank 0's."""
        self.send("stop")
        self.closed = True
        reports = self.comm.all_gather_object(rank_report(engine, self.digest))
        mine = reports[0]
        differ = [r["rank"] for r in reports
                  if (r["digest"], r["dispatches"]) != (mine["digest"], mine["dispatches"])]
        if differ:
            raise RuntimeError(f"tp ranks {differ} computed other outputs than rank 0 "
                               f"({[(r['rank'], r['dispatches']) for r in reports]})")
        moved = [r["rank"] for r in reports if r["page_moves"] != mine["page_moves"]]
        if moved:
            raise RuntimeError(f"tp ranks {moved} moved other KV pages than rank 0 "
                               f"({[(r['rank'], r['page_moves']) for r in reports]})")
        log.info("tp ranks agree on %d dispatches and page moves %s", mine["dispatches"],
                 mine["page_moves"])
        return reports


def follow(engine) -> list[dict]:
    """A follower rank's loop: run rank 0's commands on this rank's
    shard until ``stop``; returns every rank's report (rank order).
    A dispatch's outputs are folded into the digest after the next
    command has launched, so the host waits on them while the card
    runs that one."""
    comm, digest = engine.comm, Digest()
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)
    carry = None
    pending = None  # the last dispatch's fetched outputs, not yet folded
    while True:
        kind, key, host, chained, ops = comm.broadcast()
        for op in ops:
            engine._apply_tp_op(op)
        if kind == "stop":
            break
        if kind == "noop":
            continue
        if kind == "report":
            if pending is not None:
                digest.fold(_host_arrays(*pending))
                pending = None
            comm.all_gather_object(rank_report(engine, digest))
            continue
        if kind in ("pages_out", "pages_in"):
            if kind == "pages_out":
                engine._gather_pages(host["pids"], page_major=key)
            else:
                engine._scatter_pages(host["pids"])
            engine._poll_staged()
            continue
        ins = dict(zip(host, engine._upload(*host.values())))
        if kind == "window":
            if chained:
                ins["tokens"], ins["positions"] = carry
            outs = engine._window_body(key, ins)
            carry, ys = outs[-2:], outs[:-2]
        elif kind == "mixed":
            ys = engine._mixed_body(key, ins)
        else:
            raise ValueError(f"unknown tp command {kind!r}")
        fetched = engine._fetch(ys)
        if pending is not None:
            digest.fold(_host_arrays(*pending))
        pending = fetched
        engine._poll_staged()
    if pending is not None:
        digest.fold(_host_arrays(*pending))
    return comm.all_gather_object(rank_report(engine, digest))


def _host_arrays(ys, ready) -> list[np.ndarray]:
    if ready is not None:
        ready.synchronize()
    return [y.numpy() for y in ys]
