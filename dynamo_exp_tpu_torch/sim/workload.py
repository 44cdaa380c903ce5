"""Workload sources for the cluster simulator.

Counterpart of ``dynamo_exp_tpu/sim/workload.py``: the same generators
and the same JSONL trace format, byte-compatible with the JAX
package's, so a trace written by either package loads in the other.
Four shapes, all seeded and deterministic:

- :func:`burst_workload` — the chaos harness's ``overload_burst``
  scenario (``runtime/transports/chaos.py``: same generator, same seed,
  the same prompts, priorities and budgets the live overload harness
  fires), mapped to sim requests. This is the calibration bridge: a
  seed replayed here and against the real engine must produce matching
  outcome counts.
- :func:`ramp_workload` / :func:`synthetic_users` — open-loop arrival
  processes (exponential inter-arrivals under a rate profile) for
  planner studies and fleet-scale runs. ``synthetic_users`` is a lazy
  generator: a million users never materialize as a list.
- :func:`diurnal_workload` — periodic burst (half-sine between a base
  and a peak rate): the provisioning study.
- :func:`load_trace` / :func:`save_trace` — JSONL trace files (one
  request per line: ``arrival_s``, ``prompt_len``, ``max_tokens``,
  ``priority`` by name, the prefix group), which the workload
  fingerprint (``telemetry/fingerprint.py``) also reads and writes.

Arrivals must be non-decreasing in time; the generators guarantee it
and :func:`load_trace` sorts.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, Iterator

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
    # Requests sharing a non-negative prefix group model a common
    # prompt prefix of ``prefix_len`` tokens (KV-router overlap).
    prefix_group: int = -1
    prefix_len: int = 0


def burst_workload(
    seed: int,
    n: int = 8,
    spread_s: float = 0.0,
    **overload_kwargs,
) -> list[SimRequest]:
    """The ``overload_burst`` chaos scenario as a sim workload. Keyword
    arguments pass through to the chaos generator so a test can mirror
    the live harness's exact call (``osl_range=(6, 12)`` etc.)."""
    from ..runtime.transports.chaos import overload_burst

    burst = overload_burst(seed, n=n, spread_s=spread_s, **overload_kwargs)
    reqs = [
        SimRequest(
            index=b.index,
            arrival_s=b.delay_s,
            prompt_len=len(b.prompt),
            max_tokens=b.max_tokens,
            priority=parse_priority(b.priority),
        )
        for b in burst
    ]
    reqs.sort(key=lambda r: (r.arrival_s, r.index))
    return reqs


_PRIORITY_MIX = ((0, 0.2), (1, 0.6), (2, 0.2))


def _draw_priority(rng: random.Random) -> int:
    x = rng.random()
    acc = 0.0
    for cls, w in _PRIORITY_MIX:
        acc += w
        if x < acc:
            return cls
    return 1


def ramp_workload(
    seed: int,
    duration_s: float = 600.0,
    rps_start: float = 2.0,
    rps_end: float = 20.0,
    prompt_len: tuple[int, int] = (64, 512),
    max_tokens: tuple[int, int] = (16, 128),
) -> list[SimRequest]:
    """Open-loop ramp: arrival rate climbs linearly from ``rps_start``
    to ``rps_end`` over the window — the planner-study workload (a
    reactive planner chases the ramp; a predictive one gets ahead of
    it)."""
    return list(
        synthetic_users(
            seed,
            users=None,
            duration_s=duration_s,
            rps_start=rps_start,
            rps_end=rps_end,
            prompt_len=prompt_len,
            max_tokens=max_tokens,
        )
    )


def diurnal_workload(
    seed: int,
    duration_s: float = 600.0,
    rps_base: float = 1.0,
    rps_peak: float = 10.0,
    period_s: float = 300.0,
    prompt_len: tuple[int, int] = (64, 512),
    max_tokens: tuple[int, int] = (16, 128),
) -> list[SimRequest]:
    """Periodic burst: arrival rate swings between ``rps_base`` and
    ``rps_peak`` along a half-sine each ``period_s`` (burst, trough,
    burst, …) — the provisioning-study workload (docs/aot.md
    "Coldstart study"). How many standby chips the fleet needs to
    absorb the rising edge of each burst is exactly a function of
    ``provision_s``: a cold fleet must scale before the edge (or eat
    SLO violations), a warm fleet can scale on it."""
    rng = random.Random(seed)
    out: list[SimRequest] = []
    t = 0.0
    i = 0
    while t < duration_s:
        phase = math.sin(2.0 * math.pi * t / period_s)
        rate = rps_base + (rps_peak - rps_base) * max(phase, 0.0)
        t += -math.log(1.0 - rng.random()) / max(rate, 1e-9)
        if t >= duration_s:
            break
        out.append(
            SimRequest(
                index=i,
                arrival_s=t,
                prompt_len=rng.randint(*prompt_len),
                max_tokens=rng.randint(*max_tokens),
                priority=_draw_priority(rng),
            )
        )
        i += 1
    return out


def synthetic_users(
    seed: int,
    users: int | None = 1_000_000,
    duration_s: float = 3600.0,
    rps_start: float | None = None,
    rps_end: float | None = None,
    prompt_len: tuple[int, int] = (32, 256),
    max_tokens: tuple[int, int] = (8, 64),
) -> Iterator[SimRequest]:
    """Lazy open-loop arrival stream: each user sends one request;
    inter-arrivals are exponential under a linear rate profile. With
    ``users`` given, the profile defaults to the flat rate
    ``users / duration_s``; with explicit ``rps_start``/``rps_end`` the
    stream ramps (and ``users`` caps the count if set)."""
    rng = random.Random(seed)
    if rps_start is None or rps_end is None:
        if users is None:
            raise ValueError("need users or an explicit rate profile")
        rps_start = rps_end = users / duration_s
    t = 0.0
    i = 0
    while t < duration_s and (users is None or i < users):
        frac = t / duration_s
        rate = rps_start + (rps_end - rps_start) * frac
        # Exponential inter-arrival at the current instantaneous rate
        # (thinning-free approximation: fine for slowly varying ramps).
        t += -math.log(1.0 - rng.random()) / max(rate, 1e-9)
        if t >= duration_s:
            return
        yield SimRequest(
            index=i,
            arrival_s=t,
            prompt_len=rng.randint(*prompt_len),
            max_tokens=rng.randint(*max_tokens),
            priority=_draw_priority(rng),
        )
        i += 1


# ------------------------------------------------------------------ traces
def save_trace(path: str | Path, requests: Iterable[SimRequest]) -> int:
    """One JSON object per line; priorities serialized by name for
    hand-editability. Returns the number of requests written."""
    n = 0
    with open(path, "w") as f:
        for r in requests:
            d = asdict(r)
            d["priority"] = priority_name(r.priority)
            f.write(json.dumps(d) + "\n")
            n += 1
    return n


def load_trace(path: str | Path) -> list[SimRequest]:
    reqs: list[SimRequest] = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        d = json.loads(line)
        reqs.append(
            SimRequest(
                index=int(d.get("index", i)),
                arrival_s=float(d.get("arrival_s", 0.0)),
                prompt_len=int(d["prompt_len"]),
                max_tokens=int(d["max_tokens"]),
                priority=parse_priority(d.get("priority")),
                prefix_group=int(d.get("prefix_group", -1)),
                prefix_len=int(d.get("prefix_len", 0)),
            )
        )
    reqs.sort(key=lambda r: (r.arrival_s, r.index))
    return reqs
