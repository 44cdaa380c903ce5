"""Fleet observability plane: the per-link KV transfer ledger and the
fleet view.

Counterpart of ``dynamo_exp_tpu/telemetry/fleet.py``:

- :class:`TransferLedger` records every KV handoff transfer per (src,
  dst) instance link with its payload size and extract->ack duration,
  and keeps an EWMA bandwidth estimate per link;
  ``estimate_transfer_s`` prices shipping N bytes over a link (the
  reclaim triage's cost model). A never-observed link answers at the
  cold-start prior, ``DYN_KV_DEFAULT_BW_BPS`` (100 MB/s by default).
- :class:`FleetAggregator` / :class:`FleetView` roll per-instance
  ``metrics()`` snapshots, or parsed ``/metrics`` text, into one view
  that tags dead or garbage members as missing instead of raising.
- :func:`render_top` is the plain-text dashboard body.

:func:`parse_prometheus_text` is the JAX function's lenient line parser
alone, since the port does not depend on ``prometheus_client``. On
well-formed text (the port's own ``/metrics``) it gives what the JAX
function gives.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass, field

from .fingerprint import DRIFT_ALERT_THRESHOLD

# EWMA weight for the per-link bandwidth estimate: new observations move
# the estimate by this fraction, so a link's number settles within a
# handful of transfers but one straggler doesn't erase the history.
BW_EWMA_ALPHA = 0.3

# Cold-start bandwidth prior for never-observed links (bytes/s):
# ~100 MB/s, well under any healthy host-bounce TCP link, so an
# unmeasured path is priced pessimistically until real transfers teach
# the ledger otherwise. Override per deployment with DYN_KV_DEFAULT_BW_BPS.
DEFAULT_LINK_BANDWIDTH_BPS = 100e6


def _env_bw(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default

# Tolerant key aliases: engine ``metrics()`` snapshots and parsed
# ``/metrics`` Prometheus text spell the same quantity differently.
_FIELD_ALIASES = {
    "running": ("num_requests_running", "dynamo_engine_num_requests_running",
                "request_active_slots"),
    "waiting": ("num_requests_waiting", "dynamo_engine_num_requests_waiting"),
    "occupancy": ("gpu_cache_usage_perc", "hbm_page_occupancy",
                  "dynamo_engine_hbm_page_occupancy"),
    "active_slots": ("request_active_slots",),
    "total_slots": ("request_total_slots",),
    "preemptions": ("preemptions", "dynamo_preemptions_total"),
    "shed": ("requests_shed", "dynamo_requests_shed_total"),
    "ledger_violations": ("kv_ledger_violations",
                          "dynamo_kv_ledger_violations_total"),
    # G2 host-tier occupancy (docs/engine_perf.md "Predictive KV
    # tiering"): fleet views show host-tier pressure per instance.
    "host_pages": ("kv_host_pages", "host_cache_resident",
                   "dynamo_kv_host_pages"),
    # Workload drift (docs/observability.md "Workload fingerprint"):
    # live-vs-pinned fingerprint distance per instance.
    "workload_drift": ("workload_drift_score",
                       "dynamo_workload_drift_score"),
}


@dataclass
class LinkStats:
    """One directed (src, dst) link's ledger entry."""

    src: str
    dst: str
    transfers: int = 0
    bytes: int = 0
    duration_s: float = 0.0
    bandwidth_bps: float = 0.0  # EWMA of bytes / extract->ack duration

    def to_dict(self) -> dict:
        return {
            "src": self.src,
            "dst": self.dst,
            "transfers": self.transfers,
            "bytes": self.bytes,
            "duration_s": round(self.duration_s, 6),
            "bandwidth_bps": round(self.bandwidth_bps, 1),
        }


class TransferLedger:
    """Per-link KV transfer accounting with online bandwidth estimates.

    Thread-safe: ``record`` runs on the asyncio transfer paths while
    scrapes read from serving threads; every access to ``_links`` sits
    under ``_lock``. Pure host ints and floats.
    """

    def __init__(self, default_bandwidth_bps: float | None = None):
        self._lock = threading.Lock()
        self._links: dict[tuple[str, str], LinkStats] = {}
        # Cold-start prior: `estimate_transfer_s` on a never-observed
        # link answers with this bandwidth instead of None, so reclaim
        # triage and the decode selector get a finite cost on a fresh
        # fleet (first transfer hasn't landed yet). Deliberately
        # conservative — a modest host-bounce TCP figure — so cold links
        # look *expensive* until measured, never free.
        if default_bandwidth_bps is None:
            default_bandwidth_bps = _env_bw(
                "DYN_KV_DEFAULT_BW_BPS", DEFAULT_LINK_BANDWIDTH_BPS
            )
        self.default_bandwidth_bps = float(default_bandwidth_bps)

    def record(
        self, src: str, dst: str, n_bytes: int, duration_s: float
    ) -> None:
        """One observed lease transfer: ``n_bytes`` moved src→dst in
        ``duration_s`` (extract→ack). Degenerate observations (empty,
        instantaneous) still count the transfer but leave the bandwidth
        estimate alone."""
        src, dst = src or "?", dst or "?"
        with self._lock:
            link = self._links.get((src, dst))
            if link is None:
                link = self._links[(src, dst)] = LinkStats(src, dst)
            link.transfers += 1
            link.bytes += int(n_bytes)
            link.duration_s += max(float(duration_s), 0.0)
            if n_bytes > 0 and duration_s > 0:
                obs = n_bytes / duration_s
                link.bandwidth_bps = (
                    obs
                    if link.bandwidth_bps <= 0
                    else (1 - BW_EWMA_ALPHA) * link.bandwidth_bps
                    + BW_EWMA_ALPHA * obs
                )
        # Prometheus mirrors ride the process hub (never raise into the
        # transfer path — the ledger must work under a bare registry).
        try:
            from .spans import get_telemetry

            tel = get_telemetry()
            tel.kv_link_transfers.labels(src, dst).inc()
            tel.kv_link_bytes.labels(src, dst).inc(max(int(n_bytes), 0))
            if n_bytes > 0 and duration_s > 0:
                tel.kv_link_bandwidth.labels(src, dst).set(
                    self.bandwidth_bps(src, dst) or 0.0
                )
        except Exception:  # noqa: BLE001 - telemetry must not break transfers
            pass

    def bandwidth_bps(self, src: str, dst: str) -> float | None:
        """The link's current EWMA estimate (None = never observed)."""
        with self._lock:
            link = self._links.get((src or "?", dst or "?"))
            if link is None or link.bandwidth_bps <= 0:
                return None
            return link.bandwidth_bps

    def estimate_transfer_s(
        self, src: str, dst: str, n_bytes: int
    ) -> float | None:
        """Predicted wall time to move ``n_bytes`` over the link — the
        number the topology-aware decode selector and reclaim triage
        fold into their scores. A never-observed link answers at
        ``default_bandwidth_bps`` (cold-start prior) instead of None, so
        a fresh fleet's first triage never divides by zero; None only
        when the prior itself is disabled (<= 0)."""
        bw = self.bandwidth_bps(src, dst)
        if bw is None:
            bw = self.default_bandwidth_bps
        if bw <= 0:
            return None
        return n_bytes / bw

    def snapshot(self) -> list[dict]:
        """Deterministically ordered link stats (src, dst sorted) — the
        ``kv_links`` metrics() key FleetAggregator rolls up."""
        with self._lock:
            links = [self._links[k].to_dict() for k in sorted(self._links)]
        return links

    def reset(self) -> None:
        with self._lock:
            self._links.clear()


_ledger: TransferLedger | None = None
_ledger_lock = threading.Lock()


def get_transfer_ledger() -> TransferLedger:
    """The process-wide ledger (one per instance, like the telemetry
    hub)."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = TransferLedger()
    return _ledger


# --------------------------------------------------------------- fleet view
# Label block: quoted values may contain '}' and escaped quotes, so the
# body is "runs of non-quote-non-} chars or whole quoted strings".
_LABELS_RE = re.compile(r'\{((?:[^"}]|"(?:[^"\\]|\\.)*")*)\}')
_LABEL_PAIR_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict[str, object]:
    """Collapse Prometheus exposition text into {metric_name: value},
    summing across label sets (enough for fleet rollups: totals and
    gauges; histograms contribute their series). The optional trailing
    exposition timestamp is discarded, never mistaken for the value.
    The ``dynamo_build_info`` sample's fingerprint lives in its labels,
    so they are returned as a ``build_info`` dict for the skew
    detector. Malformed lines (a member returning garbage) are skipped
    instead of discarding the whole payload."""
    out: dict[str, object] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            labels_m = _LABELS_RE.search(line)
            bare = _LABELS_RE.sub(" ", line, count=1)
            parts = bare.split()
            if len(parts) < 2:
                continue
            name = parts[0]
            if not name.isidentifier():
                continue
            value = float(parts[1])  # parts[2], if present, is the ts
            if name == "dynamo_build_info" and labels_m:
                out["build_info"] = dict(_LABEL_PAIR_RE.findall(labels_m.group(1)))
                continue
            out[name] = float(out.get(name, 0.0) or 0.0) + value
        except ValueError:
            continue
    return out


def _pick(d: dict, aliases: tuple[str, ...], default=0.0) -> float:
    for key in aliases:
        if key in d:
            try:
                return float(d[key])
            except (TypeError, ValueError):
                return default
    return default


@dataclass
class InstanceView:
    """One member's normalized slice of the fleet view."""

    name: str
    running: int = 0
    waiting: int = 0
    occupancy: float = 0.0
    active_slots: int = 0
    total_slots: int = 0
    preemptions: int = 0
    shed: int = 0
    ledger_violations: int = 0
    host_pages: int = 0
    workload_drift: float = 0.0
    draining: bool = False
    build_info: dict = field(default_factory=dict)
    links: list[dict] = field(default_factory=list)

    @classmethod
    def from_metrics(cls, name: str, m: dict) -> "InstanceView":
        """Tolerant extraction from an engine ``metrics()`` snapshot or
        a :func:`parse_prometheus_text` dict — unknown keys ignored,
        missing keys default, non-numeric garbage treated as missing."""
        view = cls(name=name)
        view.running = int(_pick(m, _FIELD_ALIASES["running"]))
        view.waiting = int(_pick(m, _FIELD_ALIASES["waiting"]))
        view.occupancy = _pick(m, _FIELD_ALIASES["occupancy"])
        view.active_slots = int(_pick(m, _FIELD_ALIASES["active_slots"]))
        view.total_slots = int(_pick(m, _FIELD_ALIASES["total_slots"]))
        view.preemptions = int(_pick(m, _FIELD_ALIASES["preemptions"]))
        view.shed = int(_pick(m, _FIELD_ALIASES["shed"]))
        view.ledger_violations = int(
            _pick(m, _FIELD_ALIASES["ledger_violations"])
        )
        view.host_pages = int(_pick(m, _FIELD_ALIASES["host_pages"]))
        view.workload_drift = round(
            float(_pick(m, _FIELD_ALIASES["workload_drift"])), 4
        )
        view.draining = bool(m.get("draining", False))
        bi = m.get("build_info")
        if isinstance(bi, dict):
            view.build_info = bi
        links = m.get("kv_links")
        if isinstance(links, list):
            view.links = [lk for lk in links if isinstance(lk, dict)]
        return view

    def fingerprint(self) -> str:
        """Comparable config identity for skew detection."""
        bi = self.build_info
        return (
            f"{bi.get('manifest_hash', '')}|{bi.get('jax_version', '')}"
            f"|{bi.get('prefix_sharing', '')}|{bi.get('spec', '')}"
        )


@dataclass
class FleetView:
    """One scrape's fleet state: healthy members, tagged missing
    members, and the deterministic rollup both the dashboard and the
    simulator report print."""

    members: dict[str, InstanceView] = field(default_factory=dict)
    missing: dict[str, str] = field(default_factory=dict)  # name -> reason
    scraped_at: float = 0.0

    @classmethod
    def from_snapshots(cls, snapshots: dict[str, object]) -> "FleetView":
        """Build a view from raw per-instance snapshots. A value that is
        not a dict (an exception a scraper caught, garbage bytes, None —
        a dead or lying member) tags the member as missing instead of
        raising; the healthy members still roll up."""
        view = cls(scraped_at=time.time())
        for name in sorted(snapshots, key=str):
            raw = snapshots[name]
            if isinstance(raw, dict):
                try:
                    view.members[str(name)] = InstanceView.from_metrics(
                        str(name), raw
                    )
                except Exception as e:  # noqa: BLE001 - tag, don't poison
                    view.missing[str(name)] = f"unparseable: {e}"
            elif isinstance(raw, BaseException):
                view.missing[str(name)] = f"{type(raw).__name__}: {raw}"
            else:
                view.missing[str(name)] = (
                    f"garbage snapshot ({type(raw).__name__})"
                )
        return view

    def config_skew(self) -> list[str]:
        """Instances whose build fingerprint differs from the fleet's
        most common one (empty = no skew / single instance). Members
        with no build_info at all (an exporter that predates the gauge,
        or a scrape surface that dropped it) are *unknown*, not skewed —
        flagging them would turn every mixed-surface fleet red."""
        prints: dict[str, list[str]] = {}
        for name, m in self.members.items():
            if not m.build_info:
                continue
            prints.setdefault(m.fingerprint(), []).append(name)
        if len(prints) <= 1:
            return []
        majority = max(prints.values(), key=len)
        return sorted(
            name
            for fp, names in prints.items()
            for name in names
            if names is not majority
        )

    def merged_links(self) -> list[dict]:
        """Per-link rollup across members: bytes/transfers summed,
        bandwidth duration-weighted (deterministic order)."""
        acc: dict[tuple[str, str], dict] = {}
        for m in self.members.values():
            for link in m.links:
                key = (str(link.get("src", "?")), str(link.get("dst", "?")))
                slot = acc.setdefault(
                    key,
                    {"src": key[0], "dst": key[1], "transfers": 0,
                     "bytes": 0, "duration_s": 0.0, "bandwidth_bps": 0.0},
                )
                slot["transfers"] += int(link.get("transfers", 0) or 0)
                slot["bytes"] += int(link.get("bytes", 0) or 0)
                slot["duration_s"] += float(link.get("duration_s", 0) or 0)
        for slot in acc.values():
            if slot["duration_s"] > 0:
                slot["bandwidth_bps"] = round(
                    slot["bytes"] / slot["duration_s"], 1
                )
            slot["duration_s"] = round(slot["duration_s"], 6)
        return [acc[k] for k in sorted(acc)]

    def rollup(self) -> dict:
        """The fleet headline numbers (deterministically ordered; the
        same dict shape as the JAX simulator's fleet report)."""
        members = list(self.members.values())
        n = len(members)
        occ = (
            sum(m.occupancy for m in members) / n if n else 0.0
        )
        return {
            "instances": n,
            "missing": sorted(self.missing),
            "running": sum(m.running for m in members),
            "waiting": sum(m.waiting for m in members),
            "occupancy_mean": round(occ, 4),
            "preemptions": sum(m.preemptions for m in members),
            "shed": sum(m.shed for m in members),
            "ledger_violations": sum(m.ledger_violations for m in members),
            "host_pages": sum(m.host_pages for m in members),
            # Max (not mean): one drifted instance is the actionable
            # signal — averaging would dilute it across a large fleet.
            "workload_drift": round(
                max((m.workload_drift for m in members), default=0.0), 4
            ),
            "config_skew": self.config_skew(),
            "links": self.merged_links(),
        }


class FleetAggregator:
    """Scrape a set of per-instance sources into one :class:`FleetView`.

    ``sources`` maps instance name → a zero-arg callable returning that
    instance's metrics dict (sync or async). Any source that raises,
    times out upstream, or returns garbage tags its member as missing —
    one bad instance can never break the fleet view. For a live
    cluster, :meth:`scrape_runtime` walks the discovery plane instead.
    """

    def __init__(
        self, sources: dict | None = None, timeout_s: float | None = 5.0
    ):
        self.sources = dict(sources or {})
        self.timeout_s = timeout_s

    async def scrape(self) -> FleetView:
        import asyncio
        import inspect

        async def one(src) -> object:
            # Bounded per member: an instance that accepted the scrape
            # and then wedged (died mid-scrape) must tag itself
            # missing, not hang the whole dashboard. Members scrape
            # concurrently, so the whole pass is bounded by ONE
            # timeout_s regardless of how many are wedged.
            try:
                raw = src()
                if inspect.isawaitable(raw):
                    raw = (
                        await asyncio.wait_for(raw, self.timeout_s)
                        if self.timeout_s
                        else await raw
                    )
                return raw
            except Exception as e:  # noqa: BLE001 - dead member, tagged
                return e

        names = list(self.sources)
        results = await asyncio.gather(
            *[one(self.sources[n]) for n in names]
        )
        return FleetView.from_snapshots(dict(zip(names, results)))

    @staticmethod
    async def scrape_runtime(drt, timeout_s: float = 5.0) -> FleetView:
        """Fleet view over every instance on a live discovery plane
        per-instance stats-plane scrapes, draining
        flags from discovery metadata. Each scrape is bounded by
        ``timeout_s`` — a member dying *mid*-scrape (accepted the
        connection, never answered) times out and is tagged missing
        like any other failure, instead of hanging the dashboard."""
        import asyncio

        try:
            instances = await drt.discovery.list_instances("")
        except Exception as e:  # noqa: BLE001 - no discovery = empty fleet
            view = FleetView(scraped_at=time.time())
            view.missing["discovery"] = f"{type(e).__name__}: {e}"
            return view

        async def one(info) -> object:
            try:
                stats = await asyncio.wait_for(
                    drt.request_plane.scrape_stats(info), timeout_s
                )
                if isinstance(stats, dict):
                    stats = dict(stats)
                    stats.setdefault(
                        "draining",
                        bool((info.metadata or {}).get("draining")),
                    )
                return stats
            except Exception as e:  # noqa: BLE001 - dead member, tagged
                return e

        names = [
            f"{getattr(getattr(i, 'address', None), 'component', '?')}"
            f"/{i.instance_id}"
            for i in instances
        ]
        # Concurrent member scrapes: wedged members cost ONE timeout_s
        # for the whole pass, not one each.
        results = await asyncio.gather(*[one(i) for i in instances])
        return FleetView.from_snapshots(dict(zip(names, results)))


def render_top(view: FleetView) -> str:
    """The fleet dashboard body (plain text, deterministic)."""
    roll = view.rollup()
    lines = [
        f"fleet: {roll['instances']} instance(s)"
        + (f", {len(roll['missing'])} missing" if roll["missing"] else "")
        + f" — running {roll['running']}, waiting {roll['waiting']}, "
        f"occupancy {roll['occupancy_mean']:.0%}, host pages "
        f"{roll['host_pages']}, shed {roll['shed']}, "
        f"preempt {roll['preemptions']}, ledger violations "
        f"{roll['ledger_violations']}, workload drift "
        f"{roll['workload_drift']:.2f}"
    ]
    if view.members:
        name_w = max(len(n) for n in view.members)
        lines.append(
            f"{'instance':<{name_w}}  run wait  occ%  slots  host  shed  "
            f"preempt  flags"
        )
        for name in sorted(view.members):
            m = view.members[name]
            flags = []
            if m.draining:
                flags.append("draining")
            if m.ledger_violations:
                flags.append(f"LEDGER!{m.ledger_violations}")
            if name in roll["config_skew"]:
                flags.append("SKEW")
            if m.workload_drift >= DRIFT_ALERT_THRESHOLD:
                flags.append(f"DRIFT:{m.workload_drift:.2f}")
            lines.append(
                f"{name:<{name_w}}  {m.running:3d} {m.waiting:4d}  "
                f"{m.occupancy:4.0%}  {m.active_slots}/{m.total_slots}"
                f"  {m.host_pages:4d}  {m.shed:4d}  {m.preemptions:7d}  "
                f"{','.join(flags) or '-'}"
            )
    for name in sorted(view.missing):
        lines.append(f"{name}  MISSING ({view.missing[name]})")
    if roll["links"]:
        lines.append("links (src -> dst):")
        for link in roll["links"]:
            mbps = link["bandwidth_bps"] / (1 << 20)
            lines.append(
                f"  {link['src']} -> {link['dst']}: "
                f"{link['transfers']} transfers, "
                f"{link['bytes'] / (1 << 20):.2f} MB, {mbps:.1f} MB/s"
            )
    if roll["config_skew"]:
        lines.append(
            "CONFIG SKEW: " + ", ".join(roll["config_skew"])
            + " differ from the fleet majority build"
        )
    return "\n".join(lines)
