"""Launch counters of the port's device kernels, one record for all.

A wrapper adds one to its counter where it launches its kernel, and
nowhere else (a CPU path does not count). Counters are grouped: each
op registers its group (:func:`counter`) and keeps the returned dict,
e.g. ``ops.ragged_attention.KERNEL_LAUNCHES`` or ``ops.moe.LAUNCHES``.
A wrapper called while a CUDA graph is being captured launches nothing:
its launch goes to the capture's record (:func:`record`), and every
replay of the graph adds the record to the counters (:func:`add`), so
the counters stay launch for launch what an eager run counts.
"""

from __future__ import annotations

import contextlib
import threading

import torch

COUNTERS: dict[str, dict[str, int]] = {}
_recording = threading.local()


def counter(group: str, names) -> dict[str, int]:
    """Register the group ``group`` of counters ``names``, all 0."""
    COUNTERS[group] = dict.fromkeys(names, 0)
    return COUNTERS[group]


def reset() -> None:
    for counts in COUNTERS.values():
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def record():
    """Within the block (on this thread), launches are counted into the
    yielded record, ``{group: {name: n}}``, and not into the counters."""
    rec = {group: dict.fromkeys(counts, 0) for group, counts in COUNTERS.items()}
    prev = getattr(_recording, "rec", None)
    _recording.rec = rec
    try:
        yield rec
    finally:
        _recording.rec = prev


def add(rec: dict) -> None:
    """Add a record's launches to the counters: one replay of the graph
    it was recorded for."""
    for group, counts in rec.items():
        for name, n in counts.items():
            COUNTERS[group][name] += n


def count(group: str, name: str) -> None:
    """One launch: into the current record, or the counters. A capture
    with no record would replay launches nobody counts, so it raises."""
    rec = getattr(_recording, "rec", None)
    if rec is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a kernel was captured outside launches.record(): its "
                               "replays would go uncounted")
        rec = COUNTERS
    rec[group][name] += 1
