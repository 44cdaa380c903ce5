"""Where an instance sits in the fleet.

Trimmed counterpart of ``dynamo_exp_tpu/parallel/multihost.py``: its
plain part, the topology coordinate a served instance publishes under
``TOPOLOGY_KEY`` (the reclaim plane picks the nearest survivor by it)
and the primary-interface address helper. ``MultiNodeConfig``, the
leader handshake and ``initialize_multihost`` wait for tensor
parallelism (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

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
    def from_env(cls) -> "TopologyCoordinate":
        """This process's coordinate: ``DYN_TOPOLOGY``, else 0/0/0 (one
        node: every peer equally near, and the ledger's measured
        bandwidth decides). The JAX function's multi-node default (the
        host from the node rank) comes with tensor parallelism."""
        parsed = cls.parse(os.environ.get("DYN_TOPOLOGY", ""))
        return parsed if parsed is not None else cls()


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
