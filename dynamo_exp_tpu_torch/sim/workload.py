"""Workload trace files.

Trimmed counterpart of ``dynamo_exp_tpu/sim/workload.py``: the request
record (:class:`SimRequest`) and its JSONL trace format (one request a
line: ``arrival_s``, ``prompt_len``, ``max_tokens``, ``priority`` by
name, the prefix group), byte-compatible with the JAX package's, so a
trace written by either package loads in the other. The generators
(burst, ramp, diurnal, synthetic users) wait with the simulator
(ROADMAP Queue 1 entry 8).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable

from ..protocols.common import parse_priority, priority_name


@dataclass(frozen=True)
class SimRequest:
    """One request of a workload. ``priority`` is the parsed class
    (0 low, 1 normal, 2 high), as edge admission and the engine speak it."""

    index: int
    arrival_s: float
    prompt_len: int
    max_tokens: int
    priority: int = 1
    # Requests sharing a non-negative prefix group share a prompt prefix
    # of ``prefix_len`` tokens.
    prefix_group: int = -1
    prefix_len: int = 0


def save_trace(path: str | Path, requests: Iterable[SimRequest]) -> int:
    """One JSON object per line, priorities by name. Returns the number
    of requests written."""
    n = 0
    with open(path, "w") as f:
        for r in requests:
            d = asdict(r)
            d["priority"] = priority_name(r.priority)
            f.write(json.dumps(d) + "\n")
            n += 1
    return n


def load_trace(path: str | Path) -> list[SimRequest]:
    """The requests of a trace file, sorted by arrival."""
    reqs: list[SimRequest] = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        d = json.loads(line)
        reqs.append(SimRequest(
            index=int(d.get("index", i)),
            arrival_s=float(d.get("arrival_s", 0.0)),
            prompt_len=int(d["prompt_len"]),
            max_tokens=int(d["max_tokens"]),
            priority=parse_priority(d.get("priority")),
            prefix_group=int(d.get("prefix_group", -1)),
            prefix_len=int(d.get("prefix_len", 0)),
        ))
    reqs.sort(key=lambda r: (r.arrival_s, r.index))
    return reqs
