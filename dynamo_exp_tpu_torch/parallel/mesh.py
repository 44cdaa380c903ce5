"""Where each tensor-parallel rank runs.

Counterpart of ``dynamo_exp_tpu/parallel/mesh.py``. The JAX package
lays one ``Mesh`` with axes (dp, sp, ep, tp) over every device and lets
XLA place the shards; here every rank is a process of its own that
holds one shard, so the mesh becomes a rank layout: the world size,
the tp degree, this process's rank and its device. Only the tp axis is
wider than 1 (the JAX engine's serving mesh has ``tp`` and ``sp`` only,
and ``sp`` there only replicates); ``dp``, ``sp`` and ``ep`` are
accepted at 1.

Ranks are numbered node by node: a node runs ``tp / num_nodes`` of
them, and global rank = node rank x that + local rank. All ranks of a
node share ``cuda:0`` when the node has one card, and rank ``i`` uses
``cuda:i`` otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["RankLayout", "largest_tp", "rank_layout"]


def largest_tp(n_devices: int, num_kv_heads: int) -> int:
    """Biggest power-of-two tp degree dividing both devices and kv heads."""
    tp = 1
    while tp * 2 <= n_devices and num_kv_heads % (tp * 2) == 0:
        tp *= 2
    return tp


@dataclass(frozen=True)
class RankLayout:
    """One rank of a ``tp``-way group spread over ``num_nodes`` nodes."""

    tp: int = 1
    rank: int = 0
    num_nodes: int = 1

    def __post_init__(self):
        if self.tp < 1 or self.num_nodes < 1 or self.tp % self.num_nodes:
            raise ValueError(
                f"tp={self.tp} must be a positive multiple of num_nodes={self.num_nodes}"
            )
        if not 0 <= self.rank < self.tp:
            raise ValueError(f"rank {self.rank} is outside tp={self.tp}")

    @property
    def world_size(self) -> int:
        return self.tp

    @property
    def local_world(self) -> int:
        """Ranks on each node."""
        return self.tp // self.num_nodes

    @property
    def node_rank(self) -> int:
        return self.rank // self.local_world

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_world

    def shares_card(self, kind: str, cards: int) -> bool:
        """Whether this node's ranks share one card."""
        return kind == "cuda" and self.local_world > 1 and cards <= 1

    def device(self, kind: str = "cuda", cards: int | None = None) -> torch.device:
        """This rank's device: the CPU, ``cuda:0`` on a one-card node,
        else ``cuda:<local rank>``. ``cards`` defaults to
        ``torch.cuda.device_count()``."""
        if kind == "cpu":
            return torch.device("cpu")
        if kind != "cuda":
            raise ValueError(f"a rank runs on 'cuda' or 'cpu', not {kind!r}")
        cards = torch.cuda.device_count() if cards is None else cards
        if cards <= 1:
            return torch.device("cuda", 0)
        if cards < self.local_world:
            raise ValueError(
                f"{self.local_world} ranks per node need one card each or one card in "
                f"all; this node has {cards}"
            )
        return torch.device("cuda", self.local_rank)


def rank_layout(
    tp: int = 1, rank: int = 0, num_nodes: int = 1, dp: int = 1, sp: int = 1, ep: int = 1
) -> RankLayout:
    """The layout that stands where ``build_mesh`` does: tp ranks,
    numbered node by node. ``dp``, ``sp`` and ``ep`` above 1 raise:
    data-parallel replicas run as separate engines behind the router,
    and ring-attention prefill (``sp``) and expert parallelism (``ep``)
    are ROADMAP Queue 1 items 7(c) and 7(d)."""
    for name, n in (("dp", dp), ("sp", sp), ("ep", ep)):
        if n != 1:
            raise ValueError(
                f"{name}={n}: the port's ranks split the tp axis only (ROADMAP Queue 1 "
                "items 7(c) and 7(d) bring sp and ep; dp replicas are separate engines)"
            )
    return RankLayout(tp=tp, rank=rank, num_nodes=num_nodes)
