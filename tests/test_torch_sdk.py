"""The port's service SDK (``dynamo_exp_tpu_torch/sdk/``): decorators,
graph discovery, the JSON config merge, the card allocator, the
supervisor, and the hello-world pipeline served end to end by
``python -m dynamo_exp_tpu_torch.sdk.serve``; with the JAX package's SDK
beside it where the two are comparable."""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from dynamo_exp_tpu.sdk import ServiceConfig as JServiceConfig
from dynamo_exp_tpu.sdk.service import discover_graph as jdiscover_graph
from dynamo_exp_tpu_torch.sdk import ServiceConfig, depends, endpoint, get_spec, service
from dynamo_exp_tpu_torch.sdk.allocator import AllocationError, CudaAllocator, parse_devices
from dynamo_exp_tpu_torch.sdk.service import discover_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- decorators
def test_service_spec_and_graph_discovery():
    from examples.hello_world import hello_world as jhello

    from .torch_sdk_graphs import Backend, Frontend, Middle

    spec = get_spec(Frontend)
    assert spec.namespace == "hello"
    assert "generate" in spec.endpoints
    names = [s.name for s in discover_graph(Frontend)]
    # Dependencies first, root last; the JAX package's order.
    assert names == ["Backend", "Middle", "Frontend"]
    assert names == [s.name for s in jdiscover_graph(jhello.Frontend)]
    assert get_spec(Middle).cls is Middle
    assert get_spec(Backend).workers == 1
    with pytest.raises(TypeError, match="not decorated"):
        get_spec(int)


def test_endpoint_decorator_forms():
    @service()
    class S:
        @endpoint
        async def bare(self, request):
            yield {}

        @endpoint("named")
        async def other(self, request):
            yield {}

    spec = get_spec(S)
    assert set(spec.endpoints) == {"bare", "named"}
    assert spec.namespace == "dynamo" and spec.gpus == 0


def test_depends_unresolved_raises():
    from .torch_sdk_graphs import Middle

    with pytest.raises(RuntimeError, match="not resolved"):
        _ = Middle().backend
    assert isinstance(Middle.backend, depends)


# -------------------------------------------------------------------- config
def test_service_config_json_env_merge(tmp_path, monkeypatch):
    """The JSON file and the env override merge as the JAX loader merges
    the same keys from YAML: the env wins key by key."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"Frontend": {"greeting": "hi", "depth": 1}, "Middle": {"x": 2}}))
    ycfg = tmp_path / "c.yaml"
    ycfg.write_text("Frontend:\n  greeting: hi\n  depth: 1\nMiddle:\n  x: 2\n")
    monkeypatch.setenv("DYN_SERVICE_CONFIG", json.dumps({"Frontend": {"depth": 9}}))
    sc = ServiceConfig.load(str(cfg))
    assert sc.get("Frontend") == {"greeting": "hi", "depth": 9}
    assert sc.get("Middle") == {"x": 2}
    assert sc.get("Nope") == {}
    assert sc.data == JServiceConfig.load(str(ycfg)).data
    assert json.loads(sc.dumps()) == sc.data

    class Obj:
        pass

    o = Obj()
    sc.apply_to(o, "Frontend")
    assert o.greeting == "hi" and o.depth == 9


@pytest.mark.parametrize("name", ["c.yaml", "c.yml"])
def test_service_config_refuses_yaml(tmp_path, monkeypatch, name):
    monkeypatch.delenv("DYN_SERVICE_CONFIG", raising=False)
    path = tmp_path / name
    path.write_text("Frontend:\n  port: 1\n")
    with pytest.raises(ValueError, match="JSON"):
        ServiceConfig.load(str(path))
    assert ServiceConfig.load(None).data == {}


def test_example_configs_carry_the_jax_yaml_keys():
    """Each ``configs/*.json`` holds the JAX graph's YAML, service by
    service, with the worker services' names of the port."""
    names = {"TpuWorker": "CudaWorker", "PrefillTpuWorker": "PrefillCudaWorker"}
    for graph in ("agg", "agg_router", "disagg", "disagg_router"):
        want = JServiceConfig.load(os.path.join(REPO, "examples/llm/configs", f"{graph}.yaml"))
        got = ServiceConfig.load(os.path.join(
            REPO, "dynamo_exp_tpu_torch/examples/llm/configs", f"{graph}.json"))
        assert got.data == {names.get(k, k): v for k, v in want.data.items()}, graph


# ----------------------------------------------------------------- allocator
def test_cuda_allocator_assigns_disjoint_slots(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    alloc = CudaAllocator([0, 1, 2, 3])
    a = alloc.assign("decode", 2)
    b = alloc.assign("prefill", 2)
    assert a["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert b["CUDA_VISIBLE_DEVICES"] == "2,3"
    with pytest.raises(AllocationError):
        alloc.assign("extra", 1)
    # Host-side services never see a card.
    assert alloc.assign("frontend", 0) == {"CUDA_VISIBLE_DEVICES": ""}
    alloc.release(a)
    assert alloc.available == 2
    assert alloc.assign("again", 2)["CUDA_VISIBLE_DEVICES"] == "0,1"


def test_cuda_allocator_repeated_ordinal_and_release(monkeypatch):
    """``0,0``: two workers share card 0; a released slot returns to the
    free set and is handed out again."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    alloc = CudaAllocator("0,0")
    assert alloc.total == 2 and parse_devices("0,0,1") == [0, 0, 1]
    w1, w2 = alloc.assign("w", 1), alloc.assign("w", 1)
    assert w1["CUDA_VISIBLE_DEVICES"] == w2["CUDA_VISIBLE_DEVICES"] == "0"
    assert w1["DYN_CUDA_SLOTS"] != w2["DYN_CUDA_SLOTS"]
    with pytest.raises(AllocationError, match="0 of 2"):
        alloc.assign("w", 1)
    alloc.release(w2)
    assert alloc.available == 1
    assert alloc.assign("w", 1) == w2
    with pytest.raises(ValueError):
        parse_devices("0,-1")


def test_cuda_allocator_default_slots(monkeypatch):
    monkeypatch.setenv("DYN_CUDA_DEVICES", "1,1,0")
    assert CudaAllocator().slots == [1, 1, 0]
    monkeypatch.delenv("DYN_CUDA_DEVICES")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert CudaAllocator().slots == [0, 1]  # one slot a visible card


def test_cuda_allocator_maps_slots_through_visible_devices(monkeypatch):
    """A supervisor started on a share of the host's cards hands its
    workers cards of that share: slot ordinals index the inherited
    ``CUDA_VISIBLE_DEVICES``, and an ordinal beyond it is refused."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    alloc = CudaAllocator("0,0")
    assert [alloc.assign("w", 1)["CUDA_VISIBLE_DEVICES"] for _ in range(2)] == ["2", "2"]
    assert CudaAllocator("1,0").assign("w", 2)["CUDA_VISIBLE_DEVICES"] == "3,2"
    assert CudaAllocator().assign("w", 2)["CUDA_VISIBLE_DEVICES"] == "2,3"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-aa, GPU-bb")
    assert CudaAllocator("1").assign("w", 1)["CUDA_VISIBLE_DEVICES"] == "GPU-bb"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    with pytest.raises(AllocationError, match="beyond the 1 card"):
        CudaAllocator("0,1")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert CudaAllocator("1,1").assign("w", 1)["CUDA_VISIBLE_DEVICES"] == "1"


async def test_supervisor_releases_slots_when_a_spawn_fails(monkeypatch):
    """A worker whose process cannot start gives its slot back, so the
    planner's retries cannot drain the budget."""
    from dynamo_exp_tpu_torch.sdk.serve import Supervisor, Watcher

    from .torch_sdk_graphs import LoadWorker

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    alloc = CudaAllocator("0")
    sup = Supervisor("tests.torch_sdk_graphs:LoadWorker", discover_graph(LoadWorker),
                     ServiceConfig(), alloc, "127.0.0.1:1")

    async def boom(self):
        raise OSError("spawn failed")

    monkeypatch.setattr(Watcher, "start", boom)
    for _ in range(3):
        assert await sup.add_worker("LoadWorker") is False
        assert alloc.available == 1
    assert sup.counts() == {"LoadWorker": 0}
    assert await sup.add_worker("Nope") is False
    assert await sup.remove_worker("LoadWorker") is False


# ----------------------------------------------------------------------- e2e
async def test_hello_world_graph_end_to_end():
    """The real supervisor, three service processes, a request through
    Frontend -> Middle -> Backend, the config override applied."""
    from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.push_router import PushRouter
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    server = CoordinatorServer()
    await server.start()
    env = dict(os.environ, PYTHONPATH=REPO,
               DYN_SERVICE_CONFIG=json.dumps({"Frontend": {"greeting": "bonjour"}}))
    sup = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve",
        "tests.torch_sdk_graphs:Frontend", "--coordinator", server.address,
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
    try:
        ep = drt.namespace("hello").component("Frontend").endpoint("generate")
        client = await ep.client()
        for _ in range(300):
            if client.instances or sup.returncode is not None:
                break
            await asyncio.sleep(0.1)
        if not client.instances:
            out = await sup.stdout.read() if sup.returncode is not None else b""
            raise AssertionError(f"Frontend never came up (rc={sup.returncode}):\n"
                                 + out.decode())
        stream = await PushRouter(client).generate({"text": "world"})
        tokens = [item["token"] async for item in stream]
        assert tokens == ["bonjour", "world-mid-back"]
    finally:
        sup.terminate()
        try:
            await asyncio.wait_for(sup.wait(), 30)
        except asyncio.TimeoutError:
            sup.kill()
        await drt.close()
        await server.close()


async def test_serve_exits_with_an_error_when_a_watcher_gives_up(tmp_path):
    """A worker that keeps crashing is given up on (no endless restarts
    into a pass), and ``serve`` then exits non-zero."""
    mod = tmp_path / "crashing_graph.py"
    mod.write_text(
        "from dynamo_exp_tpu_torch.sdk import async_on_start, endpoint, service\n\n"
        "@service(dynamo={'namespace': 'crash'})\n"
        "class Crasher:\n"
        "    @async_on_start\n"
        "    async def boom(self):\n"
        "        raise SystemExit(3)\n\n"
        "    @endpoint()\n"
        "    async def generate(self, request):\n"
        "        yield {}\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{tmp_path}")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve", "crashing_graph:Crasher",
        "--start-coordinator", env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    import dynamo_exp_tpu_torch.sdk.serve as serve

    # 1 + MAX_RESTARTS starts, with backoffs of 1, 2 and 4 s between them.
    out, _ = await asyncio.wait_for(proc.communicate(), 90)
    text = out.decode()
    assert proc.returncode != 0, text
    assert text.count("restarting") == serve.MAX_RESTARTS, text
    assert "giving up" in text, text


async def test_two_node_worker_serves_through_rank_0(tiny_model_dir):
    """``serve --service-name CudaWorker --num-nodes 2``, one supervisor a
    node (the CPU here, over gloo): each node's worker joins the group,
    rank 0 alone registers ``generate`` and serves through the engine
    sharded over both, rank 1 follows it."""
    from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.push_router import PushRouter
    from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    from .fixtures import free_port

    server = CoordinatorServer()
    await server.start()
    leader = f"127.0.0.1:{free_port()}"
    cfg = {"CudaWorker": {"model_path": tiny_model_dir, "served_model_name": "tiny",
                          "random_weights": True, "max_decode_slots": 2, "num_pages": 32,
                          "max_model_len": 64, "page_size": 8, "kv_dtype": "float32",
                          "device": "cpu"}}
    env = dict(os.environ, PYTHONPATH=REPO, DYN_SERVICE_CONFIG=json.dumps(cfg),
               DYN_CUDA_DEVICES="0")
    sups = [await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve",
        "dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend", "--service-name", "CudaWorker",
        "--coordinator", server.address, "--num-nodes", "2", "--node-rank", str(rank),
        "--dist-leader", leader, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for rank in (0, 1)]
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
    try:
        client = await drt.namespace("dynamo").component("CudaWorker").endpoint(
            "generate").client()
        await client.wait_for_instances(1, timeout=90)
        stream = await PushRouter(client).generate({
            "token_ids": [5, 9, 17, 3], "stop_conditions": {"max_tokens": 4, "ignore_eos": True}})
        tokens = [t async for item in stream for t in item.get("token_ids") or []]
        assert len(tokens) == 4
        await asyncio.sleep(0.5)
        assert len(client.instance_ids()) == 1  # rank 1 serves nothing
    finally:
        for sup in sups:
            sup.terminate()
        for sup in sups:
            try:
                await asyncio.wait_for(sup.wait(), 30)
            except asyncio.TimeoutError:
                sup.kill()
        await drt.close()
        await server.close()
