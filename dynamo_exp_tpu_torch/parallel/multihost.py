"""Multi-node bring-up of the tensor-parallel ranks, and where an
instance sits in the fleet.

Counterpart of ``dynamo_exp_tpu/parallel/multihost.py``. There one
process per node joins a global JAX runtime; here every tp rank is a
process of its own, and the ranks join one ``torch.distributed``
process group over a ``TCPStore`` that the leader (global rank 0)
serves at ``host:dist_port``. The leader's address is either given
(``--dist-leader``) or found through the control plane: the leader
publishes it under ``multihost/<deployment>/leader`` on a lease, and
the other nodes read it from there, as in the JAX package.
:func:`bringup` runs the blocking init off the event loop.

Also the plain part: the topology coordinate a served instance
publishes under ``TOPOLOGY_KEY`` (the reclaim plane picks the nearest
survivor by it) and the primary-interface address helper.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta

logger = logging.getLogger(__name__)

LEADER_KEY_PREFIX = "multihost/"
LEADER_LEASE_TTL_S = 30.0
DEFAULT_DIST_PORT = 9911

# Discovery-metadata key a served instance publishes its coordinate
# under ("slice/host/chip" string — see TopologyCoordinate.parse).
TOPOLOGY_KEY = "topology"


@dataclass(frozen=True)
class TopologyCoordinate:
    """Where an instance sits in the fleet: (slice, host, chip).

    :meth:`distance` is a tiebreak prior beside the transfer ledger's
    measured bandwidth: same chip beats same host beats same slice beats
    another slice. Deployments set ``DYN_TOPOLOGY=slice/host/chip`` per
    process."""

    slice_id: int = 0
    host: int = 0
    chip: int = 0

    # Distance tiers, widest first: 0 = same chip, 1 = same host,
    # 2 = same slice, 3 = another slice.
    def distance(self, other: "TopologyCoordinate") -> int:
        if self.slice_id != other.slice_id:
            return 3
        if self.host != other.host:
            return 2
        if self.chip != other.chip:
            return 1
        return 0

    def encode(self) -> str:
        return f"{self.slice_id}/{self.host}/{self.chip}"

    @classmethod
    def parse(cls, raw: str | None) -> "TopologyCoordinate | None":
        """Parse a "slice/host/chip" metadata string (missing trailing
        parts default to 0; garbage returns None — callers treat an
        unknown coordinate as maximally distant)."""
        if not raw:
            return None
        parts = str(raw).strip().split("/")
        try:
            nums = [int(p) for p in parts if p != ""]
        except ValueError:
            return None
        if not nums:
            return None
        nums = (nums + [0, 0, 0])[:3]
        return cls(slice_id=nums[0], host=nums[1], chip=nums[2])

    @classmethod
    def from_env(
        cls, cfg: "MultiNodeConfig | None" = None
    ) -> "TopologyCoordinate":
        """This process's coordinate: ``DYN_TOPOLOGY`` wins; otherwise
        slice 0, host ``node_rank`` of ``cfg``, chip 0 (one node
        collapses to 0/0/0: every peer equally near, and the ledger's
        measured bandwidth decides)."""
        parsed = cls.parse(os.environ.get("DYN_TOPOLOGY", ""))
        if parsed is not None:
            return parsed
        return cls(slice_id=0, host=cfg.node_rank if cfg else 0, chip=0)


@dataclass
class MultiNodeConfig:
    """How this node fits into the multi-node engine: ``num_nodes``,
    ``node_rank`` (0 leads), ``leader_addr`` ("host:port" of the
    leader's ``TCPStore``; None = discover it through the control
    plane or, on the leader, derive and publish it), ``dist_port`` and
    ``deployment``, which namespaces the published leader key so two
    multi-node graphs on one coordinator do not read each other's."""

    num_nodes: int = 1
    node_rank: int = 0
    leader_addr: str | None = None
    dist_port: int = DEFAULT_DIST_PORT
    deployment: str = "default"

    @property
    def leader_key(self) -> str:
        return f"{LEADER_KEY_PREFIX}{self.deployment}/leader"

    @property
    def is_multi_node(self) -> bool:
        return self.num_nodes > 1

    @property
    def is_leader(self) -> bool:
        return self.node_rank == 0


def detect_host_ip() -> str:
    """Primary-interface address: a UDP socket connected towards a
    public address reads the route's local address without sending a
    packet; 127.0.0.1 when there is no route."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


async def resolve_leader_addr(
    cfg: MultiNodeConfig, discovery=None, timeout_s: float = 120.0
) -> str:
    """The leader derives its address and publishes it (on a lease, so
    a dead leader's address expires within one TTL); the other nodes
    read it from the control plane."""
    if cfg.leader_addr:
        return cfg.leader_addr
    key = cfg.leader_key
    if cfg.is_leader:
        addr = f"{detect_host_ip()}:{cfg.dist_port}"
        if discovery is not None:
            lease = await discovery.create_lease(ttl_s=LEADER_LEASE_TTL_S)
            await discovery.kv_put(key, addr.encode(), lease=lease)
        return addr
    if discovery is None:
        raise ValueError("follower needs --dist-leader or a coordinator to discover it")
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        value = await discovery.kv_get(key)
        if value:
            return value.decode()
        await asyncio.sleep(0.25)
    raise TimeoutError(f"no leader address under {key!r}")


def leader_store(addr: str, world_size: int, is_leader: bool, timeout_s: float):
    """The ``TCPStore`` at ``addr`` ("host:port"): served by the leader
    (port 0 picks a free one: read it back from ``.port``), dialled by
    everyone else."""
    from torch.distributed import TCPStore

    host, _, port = addr.rpartition(":")
    return TCPStore(host, int(port), world_size, is_master=is_leader,
                    timeout=timedelta(seconds=timeout_s), wait_for_workers=False)


def initialize_multihost(
    cfg: MultiNodeConfig, leader_addr: str | None = None, *, layout, backend: str,
    device, store=None,
):
    """Join the ranks' process group as ``layout``'s rank, over the
    ``TCPStore`` at the leader's address (or ``store``, one already
    made, as a node's first rank makes it for the ranks it spawns).
    Returns this rank's ``parallel.comm.Comm``."""
    from .comm import DIST_TIMEOUT_S, Comm

    if not cfg.is_multi_node:
        # One node: the collectives stay on the loopback interface (a
        # sealed host may have no other, or one its hostname does not
        # resolve to). An operator's own choice wins.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if store is None:
        addr = leader_addr or cfg.leader_addr
        if not addr:
            raise ValueError("multi-node init needs the leader address")
        store = leader_store(addr, layout.world_size, layout.rank == 0, DIST_TIMEOUT_S)
    logger.info("joining the process group: rank %d/%d (node %d/%d)", layout.rank,
                layout.world_size, cfg.node_rank, cfg.num_nodes)
    return Comm.init(layout.rank, layout.world_size, backend, device, store)


async def bringup(cfg: MultiNodeConfig, discovery=None, **init):
    """Resolve the leader, then join the process group off the event
    loop (init blocks until every rank dials in). ``init`` goes to
    :func:`initialize_multihost`; returns its ``Comm``."""
    addr = await resolve_leader_addr(cfg, discovery)
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: initialize_multihost(cfg, addr, **init)
    )
