"""Multi-device placement (counterpart of ``dynamo_exp_tpu/parallel/``),
trimmed to the plain part of ``multihost.py``: an instance's topology
coordinate and the host address helper. Meshes, tensor parallelism and
``jax.distributed`` bring-up wait for a later slice (ROADMAP Queue 1)."""

from .multihost import TOPOLOGY_KEY, TopologyCoordinate, detect_host_ip

__all__ = ["TOPOLOGY_KEY", "TopologyCoordinate", "detect_host_ip"]
