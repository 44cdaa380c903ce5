"""The collectives of the tensor-parallel ranks, over ``torch.distributed``.

The JAX package has no counterpart: there XLA inserts the ``psum`` and
``all_gather`` that the shardings imply (``models/llama.py`` runs with
``reduce=None`` and GSPMD does the rest). Here the model issues them
itself, through one :class:`Comm` per process:

- :meth:`Comm.all_reduce` (a sum) after the row-sharded products
  (``wo``, ``w_down``, the experts) and after the vocab-sharded
  embedding lookup;
- :meth:`Comm.all_gather` of the vocab-sharded logits, so every rank
  holds the full logits and samples the same tokens;
- :meth:`Comm.broadcast` of rank 0's dispatch commands to the other
  ranks (``engine/tp.py``) and :meth:`Comm.all_gather_object` of their
  reports.

The backend is an explicit choice, never switched behind the caller's
back (:func:`resolve_backend`): ``nccl`` when the ranks sit on
different cards, ``gloo`` when they share one card (NCCL refuses two
ranks on one device) or run on the CPU. ``nccl`` with two ranks on one
card raises before any process group is made. Gloo with CUDA tensors
stages through pinned host buffers: each collective synchronises the
stream, copies the tensor into a pinned buffer, runs the gloo
collective on the host and copies the result back. Commands always
travel over a gloo group (NCCL moves device memory only).

Every collective is counted by name in ``calls`` and timed in
``seconds``: on gloo, host time from the synchronise to the result
queued back on the stream; on NCCL, device time between CUDA events
recorded around the call (read when :meth:`Comm.stats` is called).
Every wait has the group's timeout (``DIST_TIMEOUT_S``): a rank that
died ends its peers' collectives with an error, not a hang.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from datetime import timedelta

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
DIST_TIMEOUT_S = 600.0
# NCCL's timing events: the completed ones are folded into the totals
# (without waiting on the card) once this many are pending.
_EVENT_BATCH = 512


def resolve_backend(backend: str | None, kind: str, shares_card: bool) -> str:
    """The backend for ranks on ``kind`` ("cuda" or "cpu"): ``backend``
    as given, else ``nccl`` on CUDA and ``gloo`` on the CPU. Raises on
    ``nccl`` on the CPU, and on ``nccl`` for ranks that share one card."""
    chosen = backend or ("nccl" if kind == "cuda" else "gloo")
    if chosen not in BACKENDS:
        raise ValueError(f"--dist-backend must be one of {BACKENDS}, got {chosen!r}")
    if chosen == "nccl" and kind != "cuda":
        raise ValueError("--dist-backend nccl needs CUDA devices; use --dist-backend gloo")
    if chosen == "nccl" and shares_card:
        raise ValueError(
            "NCCL refuses two ranks on one card: this node's ranks share one card, so "
            "pass --dist-backend gloo"
        )
    return chosen


class Comm:
    """This rank's collectives. Make one with :meth:`init` (or
    ``parallel.multihost.initialize_multihost``) on every rank."""

    def __init__(self, rank: int, world: int, backend: str, device: torch.device,
                 ctrl_group=None):
        self.rank, self.world, self.backend = rank, world, backend
        self.device = torch.device(device)
        self.ctrl_group = ctrl_group  # None: the default group (gloo)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.calls: dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
        self.seconds: dict[str, float] = dict.fromkeys(self.calls, 0.0)
        self._pinned: dict[torch.dtype, torch.Tensor] = {}
        self._events: deque = deque()  # NCCL: (name, start, end) not yet folded

    @classmethod
    def init(cls, rank: int, world: int, backend: str, device, store,
             timeout_s: float = DIST_TIMEOUT_S) -> "Comm":
        """Make the process group over ``store`` (a ``TCPStore``) and, on
        NCCL, a gloo group beside it for the commands."""
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        timeout = timedelta(seconds=timeout_s)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
        ctrl = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
        # One sum now brings the communicator up (NCCL makes it at the
        # first collective, seconds that the first request would pay).
        dist.all_reduce(torch.zeros(1, device=device if backend == "nccl" else "cpu"))
        log.info("rank %d/%d joined the process group: backend %s, device %s",
                 rank, world, backend, device)
        return cls(rank, world, backend, device, ctrl)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    # ------------------------------------------------------------- tensors
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``t`` (one per dtype, grown
        as needed; the stream was synchronised before it is rewritten,
        so the copy back from it has completed)."""
        buf = self._pinned.get(t.dtype)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(max(t.numel(), 1 << 16), dtype=t.dtype, pin_memory=True)
            self._pinned[t.dtype] = buf
        return buf[: t.numel()].view(t.shape)

    def _begin(self, name: str):
        self.calls[name] += 1
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
            return time.perf_counter()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start
        return time.perf_counter()

    def _end(self, name: str, start) -> None:
        if isinstance(start, float):
            self.seconds[name] += time.perf_counter() - start
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._events.append((name, start, end))
        if len(self._events) >= _EVENT_BATCH:
            self._fold(wait=False)

    def _fold(self, wait: bool = True) -> None:
        """Add the events' times to the totals: all of them, waiting for
        the last, or (``wait=False``) those the card has passed."""
        if wait and self._events:
            self._events[-1][2].synchronize()
        while self._events and self._events[0][2].query():
            name, start, end = self._events.popleft()
            self.seconds[name] += start.elapsed_time(end) / 1e3

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in place; returns ``x``."""
        t0 = self._begin("all_reduce")
        if self.staged:
            h = self._host(x)
            h.copy_(x)
            dist.all_reduce(h)
            x.copy_(h, non_blocking=True)
        else:
            dist.all_reduce(x)
        self._end("all_reduce", t0)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order."""
        t0 = self._begin("all_gather")
        src = x.contiguous()
        if self.staged:
            h = self._host(src)
            h.copy_(src)
            parts = [torch.empty_like(h) for _ in range(self.world)]
            dist.all_gather(parts, h)
            out = torch.cat(parts, dim).to(self.device, non_blocking=False)
        else:
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src)
            out = torch.cat(parts, dim)
        self._end("all_gather", t0)
        return out

    # ------------------------------------------------------------- objects
    def broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank (the others pass None)."""
        t0 = time.perf_counter()
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.ctrl_group)
        self.calls["broadcast"] += 1
        self.seconds["broadcast"] += time.perf_counter() - t0
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.ctrl_group)
        return out

    def stats(self) -> dict:
        """Calls and seconds by collective, with the backend and device."""
        self._fold()
        return {"backend": self.backend, "rank": self.rank, "world": self.world,
                "device": str(self.device), "calls": dict(self.calls),
                "seconds": dict(self.seconds)}
