"""Spot-reclamation survival: deadline-bounded live KV migration.

Counterpart of ``dynamo_exp_tpu/runtime/reclaim.py``. When the platform
reclaims a spot instance it grants a short, hard grace window (SIGTERM,
then SIGKILL). This module turns that window into a deadline-bounded
triage over in-flight sequences:

- The instance republishes its discovery metadata as ``reclaiming``
  (:meth:`~dynamo_exp_tpu_torch.runtime.component.ServedInstance.reclaim`),
  so routers stop sending it work within one watch event.
- :func:`plan_triage` (pure and deterministic) orders sequences by
  priority and KV invested, prices each migration with the
  :class:`~dynamo_exp_tpu_torch.telemetry.fleet.TransferLedger`, and picks
  the topology-nearest healthy survivor
  (:class:`~dynamo_exp_tpu_torch.parallel.multihost.TopologyCoordinate`).
  What fits inside ``grace - margin`` migrates live; the rest rides the
  replay journal (the continuation re-prefills on a survivor).
- A live migration is a prefix-cache transplant: the dying engine
  extracts the sequence's complete KV pages under a lease clamped past
  the grace window (:func:`migration_lease_ttl_s`) and ships them with
  their chained block hashes; the survivor parks them as matchable
  prefix pages (``TorchEngine.seed_prefix``), so the journal
  continuation admission-matches the transplanted prefix instead of
  re-prefilling it. Draws are keyed by (seed, position), so the resumed
  stream is the uninterrupted one whether or not the migration landed:
  correctness rides the journal, migration only saves the re-prefill.

A missed deadline degrades to journal failover: never a hang, never a
lost or duplicated token.

A tensor-parallel engine migrates as a tp=1 engine does: the pages it
ships and seeds are whole (rank 0 gathers and scatters the ranks' head
slices), and ``kv_page_nbytes()``, the triage's cost of a page, is the
whole page's bytes, which is what crosses the wire.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Iterable

from ..parallel.multihost import TOPOLOGY_KEY, TopologyCoordinate
from ..telemetry import get_telemetry, span
from ..telemetry.fleet import get_transfer_ledger
from .component import DEFAULT_RECLAIM_GRACE_S, ServedInstance
from .health import is_draining, is_reclaiming

logger = logging.getLogger(__name__)

# Safety margin subtracted from the grace window before a migration is
# committed: triage never plans into the last ``margin`` seconds, so a
# mispredicted transfer still finishes (or is abandoned to the journal)
# before SIGKILL.
DEFAULT_SAFETY_MARGIN_S = 1.0

# Wire request-id namespace for live-migration transfers (the
# MigrationSink claims these via KvPageReceiver.on_unclaimed).
MIGRATE_RID_PREFIX = "migrate:"

MIGRATE = "migrate"
FAILOVER = "failover"


def _env_margin(default: float = DEFAULT_SAFETY_MARGIN_S) -> float:
    raw = os.environ.get("DYN_RECLAIM_MARGIN_S", "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def migration_lease_ttl_s(
    cfg_ttl_s: float,
    grace_s: float,
    margin_s: float = DEFAULT_SAFETY_MARGIN_S,
) -> float:
    """TTL for a migration extract's lease: ``max(ttl, grace + margin)``.

    The configured handoff TTL (tuned for the disagg prefill→decode hop,
    often well under a reclaim grace) must never let the reaper free the
    pinned pages *mid-transfer* while the grace clock is still running —
    that race would strand a half-shipped prefix AND free pages a
    dispatched gather may still read. Clamping past the grace window
    makes the reap strictly later than any send the deadline permits.
    """
    return max(float(cfg_ttl_s), float(grace_s) + float(margin_s))


@dataclass(frozen=True)
class SequenceSnapshot:
    """One in-flight sequence as the triage planner sees it."""

    request_id: str
    priority: int = 1
    full_pages: int = 0
    kv_bytes: int = 0
    tokens_generated: int = 0


@dataclass(frozen=True)
class SurvivorInfo:
    """A healthy instance that can receive migrated KV."""

    instance: str  # telemetry/ledger name (the per-link key)
    instance_id: int = 0
    topology: TopologyCoordinate | None = None
    migrate_addr: str = ""  # host:port of its KvPageReceiver


@dataclass
class TriageDecision:
    seq: SequenceSnapshot
    action: str  # MIGRATE | FAILOVER
    dest: SurvivorInfo | None = None
    est_s: float = 0.0  # predicted transfer time for this sequence
    eta_s: float = 0.0  # cumulative finish offset from triage start


def nearest_survivor(
    origin: str,
    origin_topo: TopologyCoordinate | None,
    survivors: Iterable[SurvivorInfo],
    kv_bytes: int,
    est_fn: Callable[[str, str, int], float | None],
) -> tuple[SurvivorInfo | None, float | None]:
    """Topology-nearest survivor, ties broken by predicted transfer
    time then name (total order ⇒ deterministic). Pure."""
    best_key = None
    best: tuple[SurvivorInfo, float] | None = None
    for s in survivors:
        est = est_fn(origin, s.instance, kv_bytes)
        if est is None:
            continue
        dist = (
            3
            if origin_topo is None or s.topology is None
            else origin_topo.distance(s.topology)
        )
        key = (dist, est, s.instance)
        if best_key is None or key < best_key:
            best_key, best = key, (s, est)
    return best if best is not None else (None, None)


def plan_triage(
    sequences: Iterable[SequenceSnapshot],
    survivors: Iterable[SurvivorInfo],
    grace_s: float,
    *,
    origin: str,
    est_fn: Callable[[str, str, int], float | None],
    origin_topo: TopologyCoordinate | None = None,
    margin_s: float = DEFAULT_SAFETY_MARGIN_S,
) -> list[TriageDecision]:
    """Deadline-bounded triage: pure and deterministic (the JAX
    function, which the JAX simulator's reclaim event shares).

    Sequences are ordered most-valuable-first — (priority desc,
    KV bytes desc, request_id) — and each is assigned the topology-
    nearest survivor. Transfers are modeled sequential (one network
    path out of a dying host); a sequence migrates only if its
    *cumulative* predicted finish fits inside ``grace - margin``.
    Everything else — and everything with no shippable KV or no
    reachable survivor — fails over to its replay-journal continuation.
    """
    budget = float(grace_s) - float(margin_s)
    survivors = list(survivors)
    order = sorted(
        sequences,
        key=lambda s: (-s.priority, -s.kv_bytes, s.request_id),
    )
    decisions: list[TriageDecision] = []
    clock = 0.0
    for snap in order:
        dest: SurvivorInfo | None = None
        est: float | None = None
        if snap.kv_bytes > 0 and survivors:
            dest, est = nearest_survivor(
                origin, origin_topo, survivors, snap.kv_bytes, est_fn
            )
        if dest is not None and est is not None and clock + est <= budget:
            clock += est
            decisions.append(
                TriageDecision(snap, MIGRATE, dest, est_s=est, eta_s=clock)
            )
        else:
            decisions.append(
                TriageDecision(
                    snap, FAILOVER, None, est_s=est or 0.0, eta_s=clock
                )
            )
    return decisions


def survivors_from_instances(
    infos: Iterable, self_id: int
) -> list[SurvivorInfo]:
    """Build the survivor set from a discovery snapshot: every healthy
    peer that is not us, not draining, not itself reclaiming. Metadata
    keys: ``topology`` (slice/host/chip), ``migrate_addr`` (its
    KvPageReceiver), ``instance`` (its telemetry/ledger name)."""
    out: list[SurvivorInfo] = []
    for info in infos:
        if info.instance_id == self_id:
            continue
        if is_draining(info) or is_reclaiming(info):
            continue
        md = info.metadata or {}
        out.append(
            SurvivorInfo(
                instance=str(md.get("instance") or info.instance_id),
                instance_id=info.instance_id,
                topology=TopologyCoordinate.parse(md.get(TOPOLOGY_KEY, "")),
                migrate_addr=str(md.get("migrate_addr") or ""),
            )
        )
    return out


async def ship_over_wire(
    dest: SurvivorInfo,
    request_id: str,
    hashes: list[int],
    pages: list,
) -> None:
    """Default shipper: the chunked/windowed disagg KV wire, block-hash
    chain riding the BEGIN frame. The survivor's
    :class:`MigrationSink` claims the transfer and seeds its prefix
    cache."""
    if not dest.migrate_addr:
        raise RuntimeError(
            f"survivor {dest.instance} published no migrate_addr"
        )
    from ..disagg.transfer import send_kv_pages

    await send_kv_pages(
        dest.migrate_addr,
        MIGRATE_RID_PREFIX + request_id,
        first_token=0,
        pages=pages,
        dst_instance=dest.instance,
        extra_header={"migrate_hashes": [int(h) for h in hashes]},
    )


class ReclaimController:
    """Runs the reclaim plane on a serving instance.

    Wire it with :meth:`attach`: it installs itself as the
    :class:`~dynamo_exp_tpu_torch.runtime.component.ServedInstance`'s
    ``on_reclaim`` hook, so a reclaim notice (a ``v1/reclaim/`` KV
    entry or the SIGTERM helper) flows: metadata flip (routers stop
    sending) -> triage -> live migrations in plan order -> everything
    else to the journal. All parameters are injectable for tests:
    ``ship`` (the transfer), ``survivors_fn`` (discovery), ``clock``
    (deadline math), ``est_fn`` (cost prediction).
    """

    def __init__(
        self,
        engine=None,
        *,
        instance: str = "",
        topology: TopologyCoordinate | None = None,
        margin_s: float | None = None,
        ship: Callable[..., Awaitable[None]] = ship_over_wire,
        survivors_fn: (
            Callable[[], Awaitable[list[SurvivorInfo]]] | None
        ) = None,
        est_fn: Callable[[str, str, int], float | None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.engine = engine
        self.instance = instance or get_telemetry().instance
        self.topology = (
            topology
            if topology is not None
            else TopologyCoordinate.from_env()
        )
        self.margin_s = _env_margin() if margin_s is None else margin_s
        self.ship = ship
        self.survivors_fn = survivors_fn
        self.est_fn = est_fn or get_transfer_ledger().estimate_transfer_s
        self.clock = clock
        self.last_summary: dict = {}

    def attach(self, served: ServedInstance) -> "ReclaimController":
        served.on_reclaim = self.run
        return self

    # ------------------------------------------------------------- triage
    async def run(self, grace_s: float = DEFAULT_RECLAIM_GRACE_S) -> dict:
        """Triage + migrate inside the grace window. Returns (and stores
        on ``last_summary``) the outcome counts. Never raises: any
        failure inside the window degrades the affected sequences to
        journal failover."""
        t0 = self.clock()
        tel = get_telemetry()
        with span("reclaim", grace_s=round(float(grace_s), 3)):
            snaps: list[SequenceSnapshot] = []
            if self.engine is not None:
                try:
                    snaps = [
                        SequenceSnapshot(**s)
                        for s in await self.engine.reclaim_inflight()
                    ]
                except Exception:
                    logger.exception("reclaim snapshot failed")
            survivors: list[SurvivorInfo] = []
            if self.survivors_fn is not None:
                try:
                    survivors = list(await self.survivors_fn())
                except Exception:
                    logger.exception("reclaim survivor discovery failed")
            plan = plan_triage(
                snaps,
                survivors,
                grace_s,
                origin=self.instance,
                origin_topo=self.topology,
                margin_s=self.margin_s,
                est_fn=self.est_fn,
            )
            migrated = failover = degraded = pages = 0
            for d in plan:
                if d.action != MIGRATE:
                    tel.reclaim_events.labels("failover").inc()
                    failover += 1
                    continue
                elapsed = self.clock() - t0
                remaining = float(grace_s) - elapsed
                if elapsed + d.est_s > float(grace_s) - self.margin_s:
                    # The plan was feasible at t0 but reality was
                    # slower: abandon this (and implicitly every later)
                    # migration to the journal rather than blow the
                    # deadline mid-transfer.
                    tel.reclaim_events.labels("deadline_degraded").inc()
                    tel.reclaim_events.labels("failover").inc()
                    degraded += 1
                    failover += 1
                    continue
                try:
                    n = await asyncio.wait_for(
                        self._migrate(d, remaining),
                        timeout=max(0.05, remaining - self.margin_s),
                    )
                except Exception:
                    logger.exception(
                        "live migration of %s failed; journal failover",
                        d.seq.request_id,
                    )
                    tel.reclaim_events.labels("deadline_degraded").inc()
                    tel.reclaim_events.labels("failover").inc()
                    degraded += 1
                    failover += 1
                else:
                    migrated += 1
                    pages += n
            took = self.clock() - t0
            tel.reclaim_triage_seconds.observe(took)
            tel.reclaim_events.labels("completed").inc()
            self.last_summary = {
                "planned": len(plan),
                "migrated": migrated,
                "failover": failover,
                "deadline_degraded": degraded,
                "migrated_pages": pages,
                "triage_s": took,
            }
            logger.warning(
                "reclaim triage done in %.3fs (grace %.1fs): "
                "%d migrated (%d pages), %d journal failovers "
                "(%d deadline-degraded)",
                took, grace_s, migrated, pages, failover, degraded,
            )
            return self.last_summary

    async def _migrate(self, d: TriageDecision, remaining_s: float) -> int:
        """One live migration: extract under a grace-clamped lease, ship,
        confirm. Raises on any failure (caller degrades to journal)."""
        cfg_ttl = getattr(
            getattr(self.engine, "cfg", None), "kv_lease_ttl_s", 30.0
        )
        ttl = migration_lease_ttl_s(cfg_ttl, remaining_s, self.margin_s)
        res = await self.engine.reclaim_extract(d.seq.request_id, ttl)
        if res is None:
            raise RuntimeError(
                f"sequence {d.seq.request_id} no longer extractable"
            )
        hashes, pages, lease_id = res
        try:
            await self.ship(d.dest, d.seq.request_id, hashes, pages)
        finally:
            # Delivered or not, the pins are done: a failed send means
            # the pages simply park/free locally — the journal path
            # owns correctness either way.
            self.engine.confirm_kv_lease(lease_id)
        tel = get_telemetry()
        tel.reclaim_events.labels("migrated").inc()
        tel.reclaim_migrated_pages.inc(len(pages))
        logger.info(
            "migrated %s: %d pages -> %s (est %.3fs)",
            d.seq.request_id, len(pages), d.dest.instance, d.est_s,
        )
        return len(pages)


class MigrationSink:
    """Survivor side: claims ``migrate:*`` transfers off the shared
    :class:`~dynamo_exp_tpu_torch.disagg.transfer.KvPageReceiver` (via its
    ``on_unclaimed`` hook — a dying sender cannot pre-announce through
    any channel but the wire itself) and seeds the engine's prefix
    cache with the shipped blocks."""

    def __init__(self, engine, receiver):
        self.engine = engine
        self.receiver = receiver
        self.transfers = 0
        self.seeded_blocks = 0
        self._tasks: set[asyncio.Task] = set()
        receiver.on_unclaimed = self._claim

    def _claim(self, request_id: str, begin_header: dict) -> None:
        if not request_id.startswith(MIGRATE_RID_PREFIX):
            return
        hashes = [
            int(h) for h in begin_header.get("migrate_hashes") or []
        ]
        fut = self.receiver.expect(request_id)
        task = asyncio.ensure_future(self._inject(request_id, hashes, fut))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _inject(
        self, request_id: str, hashes: list[int], fut: asyncio.Future
    ) -> int:
        try:
            _first, pages = await fut
        except Exception:
            self.receiver.forget(request_id)
            logger.exception("migration receive for %s failed", request_id)
            return 0
        n = await self.engine.seed_prefix(hashes, pages)
        self.transfers += 1
        self.seeded_blocks += n
        logger.info(
            "migration %s: seeded %d/%d blocks into the prefix cache",
            request_id, n, len(pages),
        )
        return n

    async def drain(self) -> None:
        """Await every in-flight inject (tests / graceful shutdown)."""
        while self._tasks:
            await asyncio.gather(
                *list(self._tasks), return_exceptions=True
            )

    def close(self) -> None:
        if self.receiver.on_unclaimed is self._claim:
            self.receiver.on_unclaimed = None


def install_sigterm_reclaim(
    served: ServedInstance,
    loop: asyncio.AbstractEventLoop | None = None,
    grace_s: float | None = None,
    then: Callable[[], None] | None = None,
) -> bool:
    """Treat SIGTERM as a reclaim notice (the spot platform's actual
    signal): schedules ``served.reclaim(grace_s)`` on the loop, then —
    once triage has run to completion or the deadline degraded it —
    invokes ``then`` (typically the process's pre-existing graceful
    shutdown, which this handler displaces on the loop). Grace defaults
    to ``DYN_RECLAIM_GRACE_S`` (else ``DEFAULT_RECLAIM_GRACE_S``).
    Returns False where signal handlers are unavailable (non-main
    thread, Windows); callers lose nothing but the signal sugar: a
    ``v1/reclaim/`` notice still works."""
    import signal

    if grace_s is None:
        raw = os.environ.get("DYN_RECLAIM_GRACE_S", "").strip()
        try:
            grace_s = float(raw) if raw else DEFAULT_RECLAIM_GRACE_S
        except ValueError:
            grace_s = DEFAULT_RECLAIM_GRACE_S
    loop = loop or asyncio.get_event_loop()

    async def _reclaim_then_exit() -> None:
        try:
            await served.reclaim(grace_s)
        finally:
            if then is not None:
                then()

    def _notice() -> None:
        asyncio.ensure_future(_reclaim_then_exit(), loop=loop)

    try:
        loop.add_signal_handler(signal.SIGTERM, _notice)
    except (NotImplementedError, RuntimeError, ValueError):
        return False
    return True
