"""Multi-device placement (counterpart of ``dynamo_exp_tpu/parallel/``):
the (sp, tp) rank layout (``mesh.py``), the ranks' collectives and the
sp ring (``comm.py``), multi-node bring-up and the fleet topology
coordinate (``multihost.py``)."""

from .comm import Comm, Ring, resolve_backend, sp_tp_comms
from .mesh import RankLayout, largest_tp, rank_layout
from .multihost import (
    TOPOLOGY_KEY,
    MultiNodeConfig,
    TopologyCoordinate,
    bringup,
    detect_host_ip,
    initialize_multihost,
    resolve_leader_addr,
)

__all__ = [
    "Comm",
    "Ring",
    "sp_tp_comms",
    "RankLayout",
    "largest_tp",
    "rank_layout",
    "resolve_backend",
    "MultiNodeConfig",
    "TOPOLOGY_KEY",
    "TopologyCoordinate",
    "bringup",
    "detect_host_ip",
    "initialize_multihost",
    "resolve_leader_addr",
]
