"""Engine flight recorder and no-progress watchdog.

Counterpart of ``dynamo_exp_tpu/telemetry/flight.py``. When the engine
loop wedges, spans and counters say nothing: the request that hangs
never finishes a stage. The flight recorder is a bounded in-memory ring
of loop events (admission, dispatch and consume, first token, finish,
stall start and end, preemption, swap, prefetch, speculation accept and
rewind, chain breaks, prewarm) that costs one locked list append an
event, dumped to JSONL with a scheduler/slot/page snapshot when
something is wrong:

- the **watchdog** thread sees no progress while work is queued and
  dumps once per stall episode;
- **SIGUSR1** dumps every registered engine's ring (``install_sigusr1``,
  the handler of ``dynamo_exp_tpu_torch.run``);
- an **engine-loop crash** dumps on the way out.

Event payloads are deterministic for a deterministic engine run; only
the wall stamp ``t`` differs between runs. In the port every event is
recorded on the host, at the loop's dispatch and consume points, never
inside a captured CUDA graph (a call there would run once, at capture).
"""


from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time

logger = logging.getLogger(__name__)


def default_dump_path() -> str:
    """``DYN_FLIGHT_DUMP`` or a per-process file under the tempdir."""
    return os.environ.get("DYN_FLIGHT_DUMP", "") or os.path.join(
        tempfile.gettempdir(), f"dynamo_flight_{os.getpid()}.jsonl"
    )


# The ring's size: the JAX engine's ``flight_capacity`` default, fixed
# here until a caller needs another.
CAPACITY = 2048


class FlightRecorder:
    """Bounded ring of engine-loop events.

    ``record`` is the hot-path call: one lock-guarded list append (the
    ring is a plain list + head index so ``seq`` numbering and eviction
    stay atomic). ``data`` must be JSON-serializable and — for the
    determinism guarantee — free of wall-clock values and run-global
    ids; the recorder adds ``seq`` and ``t`` itself.
    """

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = max(capacity, 16)
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._head = 0  # index of the oldest event once the ring wraps
        self.seq = 0  # total events ever recorded (watchdog progress)

    def record(self, kind: str, **data) -> None:
        ev = {"seq": 0, "t": time.time(), "kind": kind, **data}
        with self._lock:
            ev["seq"] = self.seq
            self.seq += 1
            if len(self._ring) < self.capacity:
                self._ring.append(ev)
            else:
                self._ring[self._head] = ev
                self._head = (self._head + 1) % self.capacity

    def snapshot(self) -> list[dict]:
        """Events oldest-first (a copy; safe from any thread)."""
        with self._lock:
            return self._ring[self._head :] + self._ring[: self._head]

    def clear(self) -> None:
        """Drop all events and restart ``seq`` at 0 — a warmed-up test
        harness clears the ring so dumps compare across runs whose
        warmup event counts raced differently."""
        with self._lock:
            self._ring = []
            self._head = 0
            self.seq = 0

    # ---------------------------------------------------------------- dump
    def dump(
        self, path: str, reason: str, snapshot: dict | None = None
    ) -> str:
        """Append one dump block (header, events, snapshot) to ``path``.
        Never raises into the caller — a failing dump must not worsen
        whatever triggered it."""
        events = self.snapshot()
        try:
            dirname = os.path.dirname(os.path.abspath(path))
            os.makedirs(dirname, exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(
                    json.dumps(
                        {
                            "type": "flight_header",
                            "reason": reason,
                            "t": time.time(),
                            "pid": os.getpid(),
                            "events": len(events),
                        }
                    )
                    + "\n"
                )
                for ev in events:
                    f.write(
                        json.dumps({"type": "flight_event", **ev}) + "\n"
                    )
                if snapshot is not None:
                    f.write(
                        json.dumps(
                            {
                                "type": "flight_snapshot",
                                "t": time.time(),
                                **snapshot,
                            }
                        )
                        + "\n"
                    )
        except Exception:  # noqa: BLE001 - diagnostics must not cascade
            logger.exception("flight dump to %s failed", path)
        else:
            logger.warning(
                "flight recorder dumped %d events to %s (reason=%s)",
                len(events), path, reason,
            )
        return path


class Watchdog:
    """No-progress detector over an opaque progress counter.

    Fires ``dump_fn(reason)`` once per stall episode when ``has_work()``
    has been true and ``progress()`` unchanged for ``stall_s`` seconds;
    re-arms as soon as progress moves again. Progress is whatever
    monotonically-increasing integer the owner bumps on real forward
    motion (the engine bumps per loop iteration that dispatched,
    consumed, or admitted), so a loop stuck compiling, spinning on a dry
    pool with nothing to preempt, or deadlocked all look the same:
    frozen counter, queued work.
    """

    def __init__(
        self,
        stall_s: float,
        progress,  # () -> int
        has_work,  # () -> bool
        dump_fn,  # (reason: str) -> None
        poll_s: float | None = None,
    ):
        self.stall_s = stall_s
        self._progress = progress
        self._has_work = has_work
        self._dump = dump_fn
        self._poll_s = poll_s if poll_s is not None else max(stall_s / 4, 0.05)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dumps = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="engine-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        last = self._progress()
        since = time.monotonic()
        fired = False
        while not self._stop.wait(self._poll_s):
            try:
                cur = self._progress()
                busy = self._has_work()
            except Exception:  # owner mid-teardown; try again next poll
                continue
            now = time.monotonic()
            if cur != last or not busy:
                last = cur
                since = now
                fired = False
                continue
            if not fired and now - since >= self.stall_s:
                fired = True  # once per episode
                self.dumps += 1
                try:
                    self._dump("watchdog")
                except Exception:  # noqa: BLE001
                    logger.exception("watchdog dump failed")


# ------------------------------------------------------- process registry
# Live engines register their dump callables so SIGUSR1 (and operators
# embedding several engines in one process) can dump every ring at once.
_dumpers: dict[int, object] = {}
_dumpers_lock = threading.Lock()


def register_dumper(dump_fn) -> int:
    """Register a ``(reason) -> None`` dump callable; returns a handle
    for :func:`unregister_dumper`."""
    with _dumpers_lock:
        handle = id(dump_fn)
        _dumpers[handle] = dump_fn
        return handle


def unregister_dumper(handle: int) -> None:
    with _dumpers_lock:
        _dumpers.pop(handle, None)


def dump_all(reason: str) -> int:
    """Dump every registered recorder; returns how many dumped."""
    with _dumpers_lock:
        fns = list(_dumpers.values())
    for fn in fns:
        try:
            fn(reason)
        except Exception:  # noqa: BLE001
            logger.exception("flight dump_all(%s) failed for one engine", reason)
    return len(fns)


def install_sigusr1() -> bool:
    """Chain a SIGUSR1 handler that dumps all registered recorders
    (keeps any existing handler). Main-thread only; returns False where
    signals aren't available."""
    import signal

    try:
        prev = signal.getsignal(signal.SIGUSR1)

        def handler(signum, frame):
            dump_all("sigusr1")
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGUSR1, handler)
        return True
    except (ValueError, OSError, AttributeError):
        return False


# ------------------------------------------------------------- load/render
def load_dumps(path: str) -> list[dict]:
    """Parse a dump file into blocks:
    ``{"header": ..., "events": [...], "snapshot": ...|None}`` per dump
    (a file accumulates one block per dump). Corrupt lines (torn write
    at crash) are skipped."""
    blocks: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                logger.warning("skipping corrupt flight line")
                continue
            t = d.get("type")
            if t == "flight_header":
                blocks.append({"header": d, "events": [], "snapshot": None})
            elif blocks and t == "flight_event":
                blocks[-1]["events"].append(d)
            elif blocks and t == "flight_snapshot":
                blocks[-1]["snapshot"] = d
    return blocks


def _event_label(ev: dict) -> str:
    skip = {"type", "seq", "t", "kind", "slot", "req"}
    details = " ".join(
        f"{k}={ev[k]}" for k in sorted(ev) if k not in skip
    )
    return f"{ev['kind']}({details})" if details else ev["kind"]


def render_flight(block: dict) -> str:
    """Per-slot timeline of one dump block, ``llmctl trace`` style:
    batch-level events (dispatch/consume/chain breaks/leases) on an
    ``engine`` lane, per-request events on the slot they were bound to,
    and the snapshot's slot table — stalled slots flagged — at the
    bottom."""
    header = block.get("header") or {}
    events = block.get("events") or []
    snapshot = block.get("snapshot")
    if not events and snapshot is None:
        return "empty flight dump"
    t0 = min((ev["t"] for ev in events), default=header.get("t", 0.0))
    span = max((ev["t"] for ev in events), default=t0) - t0
    lines = [
        f"flight dump — reason={header.get('reason', '?')}, "
        f"{len(events)} events, {span * 1e3:.1f}ms span"
    ]
    # req -> slot from admit events (finish/preempt events carry slot
    # too; first sighting wins so a reused slot keeps per-request lanes
    # distinct enough to read).
    req_slot: dict[str, object] = {}
    for ev in events:
        if (
            "req" in ev
            and ev.get("slot") is not None
            and ev["req"] not in req_slot
        ):
            req_slot[ev["req"]] = ev["slot"]
    lanes: dict[object, list[dict]] = {}
    for ev in events:
        # An explicit slot=None (e.g. a finish for work never bound to
        # a slot) falls back to the request's admitted lane, not a
        # bogus "slot None" lane.
        slot = ev.get("slot")
        if slot is None:
            slot = req_slot.get(ev.get("req"), "engine")
        lanes.setdefault(slot, []).append(ev)

    def lane_key(k):
        return (1, k) if isinstance(k, int) else (0, str(k))

    for slot in sorted(lanes, key=lane_key):
        evs = lanes[slot]
        name = "engine" if slot == "engine" else f"slot {slot}"
        reqs = sorted({ev["req"] for ev in evs if "req" in ev})
        head = f"{name:<8}" + (f" [{', '.join(reqs)}]" if reqs else "")
        lines.append(head)
        for ev in evs:
            lines.append(
                f"  {ev['t'] - t0:9.3f}s  {_event_label(ev)}"
            )
    if snapshot is not None:
        lines.append("snapshot:")
        for k in sorted(snapshot):
            if k in ("type", "t", "slots"):
                continue
            lines.append(f"  {k}={snapshot[k]}")
        for s in snapshot.get("slots") or []:
            flag = "  STALLED" if s.get("stalled") else ""
            lines.append(
                f"  slot {s.get('slot')}  req={s.get('req')} "
                f"state={s.get('state')} generated={s.get('generated')} "
                f"pages={s.get('pages')}{flag}"
            )
    return "\n".join(lines)
