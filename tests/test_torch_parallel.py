"""The port's ``parallel/`` package on the CPU, against the JAX package's.

- ``largest_tp`` equals the JAX function over a grid.
- ``rank_layout`` numbers ranks node by node and places them: one card
  shared by every rank of a node, else a card each; ``dp``/``sp``/``ep``
  above 1 are refused with their ROADMAP item.
- ``resolve_backend``: nccl on CUDA and gloo on the CPU by default,
  never switched: nccl on the CPU or for ranks sharing one card raises
  before any process group exists, naming ``--dist-backend gloo``.
- ``MultiNodeConfig`` roles, the leader's publish and a follower's
  discovery through the port's coordinator, and a follower without
  discovery refused, as ``tests/test_multihost.py:25-60`` holds the JAX
  package's.
- Two processes join one gloo group through ``initialize_multihost``
  and do one ``all_reduce``.
"""

import pytest
import torch

from dynamo_exp_tpu.parallel import largest_tp as jlargest_tp
from dynamo_exp_tpu.parallel import MultiNodeConfig as JMultiNodeConfig
from dynamo_exp_tpu_torch.parallel import (
    MultiNodeConfig,
    RankLayout,
    TopologyCoordinate,
    largest_tp,
    rank_layout,
    resolve_backend,
    resolve_leader_addr,
)

from .torch_ranks import all_reduce_once, run_ranks


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 16])
def test_largest_tp_equals_the_jax_function(n_devices):
    for kv in (1, 2, 3, 4, 6, 8, 16, 32):
        assert largest_tp(n_devices, kv) == jlargest_tp(n_devices, kv), (n_devices, kv)


def test_rank_layout_numbers_node_by_node_and_places_ranks():
    layout = rank_layout(tp=4, rank=3, num_nodes=2)
    assert (layout.world_size, layout.local_world) == (4, 2)
    assert (layout.node_rank, layout.local_rank) == (1, 1)
    one = [RankLayout(tp=2, rank=r).device("cuda", cards=1) for r in range(2)]
    assert one == [torch.device("cuda", 0)] * 2
    two = [RankLayout(tp=2, rank=r).device("cuda", cards=2) for r in range(2)]
    assert two == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert RankLayout(tp=2, rank=1).device("cpu") == torch.device("cpu")
    assert RankLayout(tp=2).shares_card("cuda", 1) and not RankLayout(tp=2).shares_card("cuda", 2)
    with pytest.raises(ValueError, match="one card each"):
        RankLayout(tp=4).device("cuda", cards=2)
    with pytest.raises(ValueError, match="multiple of num_nodes"):
        RankLayout(tp=3, num_nodes=2)
    with pytest.raises(ValueError, match="outside"):
        RankLayout(tp=2, rank=2)


@pytest.mark.parametrize("axis", ["dp", "sp", "ep"])
def test_only_the_tp_axis_is_wider_than_one(axis):
    """Only tp and, since ring prefill, sp are wider than one: sp lays
    its ranks out as (sp, tp); dp and ep still raise."""
    if axis == "sp":
        lay = rank_layout(tp=2, rank=3, sp=2)
        assert (lay.world_size, lay.sp_rank, lay.tp_rank) == (4, 1, 1)
        return
    with pytest.raises(ValueError, match=r"item 7\(d\)"):
        rank_layout(tp=2, **{axis: 2})


def test_backend_is_explicit_and_never_switched():
    assert resolve_backend(None, "cuda", shares_card=False) == "nccl"
    assert resolve_backend(None, "cpu", shares_card=False) == "gloo"
    assert resolve_backend("gloo", "cuda", shares_card=True) == "gloo"
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        resolve_backend(None, "cuda", shares_card=True)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        resolve_backend("nccl", "cpu", shares_card=False)
    with pytest.raises(ValueError, match="must be one of"):
        resolve_backend("mpi", "cpu", shares_card=False)


def test_multinode_config_roles_mirror_the_jax_ones():
    for kw in ({}, {"num_nodes": 2, "node_rank": 1}, {"num_nodes": 2, "node_rank": 0}):
        mine, theirs = MultiNodeConfig(**kw), JMultiNodeConfig(**kw)
        assert (mine.is_multi_node, mine.is_leader, mine.leader_key, mine.dist_port) == (
            theirs.is_multi_node, theirs.is_leader, theirs.leader_key, theirs.dist_port)
    assert TopologyCoordinate.from_env(MultiNodeConfig(num_nodes=2, node_rank=1)).host == 1


async def test_leader_publish_and_discover():
    """The leader publishes its address in the control-plane KV; a
    follower reads it back, through the port's own coordinator."""
    from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    server = CoordinatorServer()
    await server.start()
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
    try:
        leader = MultiNodeConfig(num_nodes=2, node_rank=0, dist_port=7707, deployment="d1")
        addr = await resolve_leader_addr(leader, drt.discovery)
        assert addr.endswith(":7707")
        follower = MultiNodeConfig(num_nodes=2, node_rank=1, deployment="d1")
        assert await resolve_leader_addr(follower, drt.discovery, timeout_s=5) == addr
        other = MultiNodeConfig(num_nodes=2, node_rank=1, deployment="d2")
        with pytest.raises(TimeoutError, match="multihost/d2/leader"):
            await resolve_leader_addr(other, drt.discovery, timeout_s=0.5)
    finally:
        await drt.close()
        await server.close()


async def test_follower_without_discovery_rejected():
    with pytest.raises(ValueError, match="follower needs"):
        await resolve_leader_addr(MultiNodeConfig(num_nodes=2, node_rank=1))
    given = MultiNodeConfig(num_nodes=2, node_rank=1, leader_addr="10.0.0.1:9911")
    assert await resolve_leader_addr(given) == "10.0.0.1:9911"


def test_two_processes_join_and_all_reduce_once():
    results = run_ranks(all_reduce_once, 2, 1.5, timeout=120)
    for value, calls in results:
        assert value == 1.5 + 2.5  # (1.5 + 0) + (1.5 + 1)
        assert calls["all_reduce"] == 1


def test_ranks_starting_together_build_the_kernel_library_once(tmp_path, monkeypatch):
    """``build_kernel`` takes a file lock in the library's directory and
    looks again under it: of several callers at once (tensor-parallel
    ranks starting together), one compiles and the others find it done."""
    import json
    import threading
    import time

    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    lib = tmp_path / "lib.so"
    compiles = []

    def compile_(sources, lib_path, hashes, out_dir):
        compiles.append(lib_path)
        time.sleep(0.2)
        lib.write_bytes(b"")
        (tmp_path / "lib.so.sources.json").write_text(json.dumps(hashes))

    monkeypatch.setattr(tra, "_compile", compile_)
    got = []
    threads = [threading.Thread(target=lambda: got.append(tra.build_kernel(lib_path=str(lib))))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert compiles == [str(lib)] and got == [str(lib)] * 4
