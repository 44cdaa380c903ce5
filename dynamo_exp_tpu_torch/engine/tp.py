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
- ``noop``: a heartbeat while rank 0 idles, so that no follower's wait
  for the next command reaches the group's timeout;
- ``stop``: the followers report and return.

Every command carries the device-side steps rank 0 took since the last
one (``TpDriver.ops``), which a follower applies first, in order:
copy-on-write page copies and the start of a row's penalty counts.

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
    its launch counters, its peak device memory and its collectives."""
    dev = engine.device
    return {
        "rank": engine.comm.rank, "device": str(dev), "digest": digest.hexdigest(),
        "dispatches": digest.dispatches,
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
        log.info("tp ranks agree on %d dispatches", mine["dispatches"])
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
