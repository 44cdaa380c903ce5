"""The port's transports (``dynamo_exp_tpu_torch/runtime/transports/``)
against the JAX package's, on the CPU.

- ``codec.py``: the frames of both packages are the same bytes (a
  hypothesis property over headers and payloads), each reads the
  other's, and both refuse oversized frames.
- ``coordinator.py``: one script of leases (keepalive, revoke, expiry),
  instance and KV watches, the event plane, the work queue and the
  object store, run with each package's ``CoordinatorDiscovery``
  against each package's ``CoordinatorServer``: all four pairs observe
  the same.
- ``tcp.py``: a stream, an error frame, a stop, a deadline refusal and
  the stats scrape, with each package's ``TcpRequestPlane`` serving
  and each calling: all four pairs give the same decoded frames.
"""

import asyncio
import json
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu.runtime.engine import AsyncEngineContext as JContext
from dynamo_exp_tpu.runtime.transports import codec as jcodec
from dynamo_exp_tpu.runtime.transports import coordinator as jcoord
from dynamo_exp_tpu.runtime.transports import tcp as jtcp
from dynamo_exp_tpu.runtime.transports.base import EndpointAddress as JAddress
from dynamo_exp_tpu.runtime.transports.base import InstanceInfo as JInfo
from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext as TContext
from dynamo_exp_tpu_torch.runtime.transports import codec as tcodec
from dynamo_exp_tpu_torch.runtime.transports import coordinator as tcoord
from dynamo_exp_tpu_torch.runtime.transports import tcp as ttcp
from dynamo_exp_tpu_torch.runtime.transports.base import EndpointAddress as TAddress
from dynamo_exp_tpu_torch.runtime.transports.base import InstanceInfo as TInfo

PKGS = {
    "jax": dict(codec=jcodec, coord=jcoord, tcp=jtcp, ctx=JContext, addr=JAddress, info=JInfo),
    "torch": dict(codec=tcodec, coord=tcoord, tcp=ttcp, ctx=TContext, addr=TAddress,
                  info=TInfo),
}
PAIRS = [(s, c) for s in PKGS for c in PKGS]


# ------------------------------------------------------------------- codec
JSON = st.recursive(
    st.none() | st.booleans() | st.integers(-2**53, 2**53) | st.text(max_size=8)
    | st.floats(allow_nan=False, allow_infinity=False),
    lambda kids: st.lists(kids, max_size=3) | st.dictionaries(st.text(max_size=5), kids,
                                                              max_size=3),
    max_leaves=8,
)


async def _read_all(codec, data: bytes) -> list:
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    out = []
    while True:
        try:
            out.append(await codec.read_message(reader))
        except asyncio.IncompleteReadError:
            return out


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(list(jcodec.MsgType)),
                          st.dictionaries(st.text(max_size=6), JSON, max_size=4),
                          st.binary(max_size=64)), min_size=1, max_size=4))
def test_codec_bytes_equal_and_each_reads_the_other(msgs):
    jb = b"".join(jcodec.encode(jcodec.TwoPartMessage(t, h, p)) for t, h, p in msgs)
    tb = b"".join(tcodec.encode(tcodec.TwoPartMessage(tcodec.MsgType(int(t)), h, p))
                  for t, h, p in msgs)
    assert tb == jb
    for reader_codec, data in ((tcodec, jb), (jcodec, tb)):
        got = asyncio.run(_read_all(reader_codec, data))
        assert [(int(m.msg_type), m.header, m.payload) for m in got] == [
            (int(t), json.loads(json.dumps(h)), p) for t, h, p in msgs]


def test_codec_enum_and_limits_equal_the_jax_codec():
    assert {m.name: int(m) for m in tcodec.MsgType} == {m.name: int(m) for m in jcodec.MsgType}
    assert (tcodec.MAX_HEADER, tcodec.MAX_PAYLOAD) == (jcodec.MAX_HEADER, jcodec.MAX_PAYLOAD)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_codec_refuses_oversized_frames(pkg):
    codec = PKGS[pkg]["codec"]
    big = "x" * (codec.MAX_HEADER + 1)
    with pytest.raises(codec.CodecError):
        codec.encode(codec.TwoPartMessage(codec.MsgType.DATA, {"k": big}))
    # A hostile prefix announcing an oversized header is refused before
    # anything is allocated, and an unknown type is refused too.
    for prefix in (codec._PREFIX.pack(7, codec.MAX_HEADER + 1, 0),
                   codec._PREFIX.pack(7, 0, codec.MAX_PAYLOAD + 1),
                   codec._PREFIX.pack(99, 0, 0)):
        with pytest.raises(codec.CodecError):
            asyncio.run(_read_all(codec, prefix))


# ------------------------------------------------------------- coordinator
async def _coordinator_script(server_pkg: str, client_pkg: str) -> dict:
    S, C = PKGS[server_pkg], PKGS[client_pkg]
    server = S["coord"].CoordinatorServer()
    await server.start()
    d1 = C["coord"].CoordinatorDiscovery(server.address, lease_ttl_s=0.6)
    d2 = C["coord"].CoordinatorDiscovery(server.address)
    obs: dict = {}
    try:
        prefix = "ns/components/w"
        watch = d2.watch_instances(prefix)
        snaps = [await anext(watch)]
        kv_watch = d2.kv_watch_prefix("models/")
        kv_snaps = [await anext(kv_watch)]
        sub = await d2.event_plane().subscribe("ns.w.*")

        lease = await d1.create_lease()
        info = C["info"](C["addr"]("ns", "w", "gen"), instance_id=lease.lease_id * 10 + 1,
                         transport="tcp", transport_address="127.0.0.1:1",
                         metadata={"k": [1, 2]})
        await d1.register_instance(info, lease)
        snaps.append(await asyncio.wait_for(anext(watch), 5))
        await d1.kv_put("models/a/1", b"\x00entry", lease)
        kv_snaps.append(await asyncio.wait_for(anext(kv_watch), 5))
        obs["kv_create"] = [await d1.kv_create("models/b", b"1"),
                            await d1.kv_create("models/b", b"2")]
        kv_snaps.append(await asyncio.wait_for(anext(kv_watch), 5))
        obs["kv_get"] = [await d2.kv_get("models/b"), await d2.kv_get("nope")]
        obs["kv_prefix"] = await d2.kv_get_prefix("models/")

        await d1.event_plane().publish("ns.w.kv_events", {"worker_id": 3, "h": [1, 2]})
        await d1.event_plane().publish("other", {"no": 1})
        await d1.event_plane().publish("ns.w.x", {"seq": 2})
        obs["events"] = [await asyncio.wait_for(anext(sub), 5) for _ in range(2)]

        q1, q2 = d1.work_queue("prefill"), d2.work_queue("prefill")
        await q1.push(b"a")
        await q1.push(b"b")
        obs["queue"] = [await q2.size(), await q2.pull(), await q2.pull(0.5),
                        await q2.pull(0.1), await q1.size()]

        store = d1.object_store()
        await store.put("mdc", "m2", b"two")
        await store.put("mdc", "m1", b"one")
        obs["store"] = [await d2.object_store().list("mdc"),
                        await d2.object_store().get("mdc", "m1")]
        await store.delete("mdc", "m1")
        obs["store"] += [await store.list("mdc"), await store.get("mdc", "m1")]

        # Keepalive holds a 0.6 s lease past its TTL.
        await asyncio.sleep(1.0)
        obs["alive_after_ttl"] = [i.instance_id for i in await d2.list_instances(prefix)]
        # Revoke drops the instance and the lease's keys.
        await lease.revoke()
        snaps.append(await asyncio.wait_for(anext(watch), 5))
        kv_snaps.append(await asyncio.wait_for(anext(kv_watch), 5))
        obs["after_revoke"] = [await d2.list_instances(prefix), await d2.kv_get("models/a/1")]

        # Expiry: a lease whose keepalive stops is swept within its TTL.
        lease2 = await d1.create_lease(0.5)
        info2 = C["info"](C["addr"]("ns", "w", "gen"), instance_id=lease2.lease_id * 10 + 1)
        await d1.register_instance(info2, lease2)
        snaps.append(await asyncio.wait_for(anext(watch), 5))
        d1.client.stop_keepalive(lease2.lease_id)
        snaps.append(await asyncio.wait_for(anext(watch), 5))
        obs["expired"] = await d2.list_instances(prefix)
        await watch.aclose()
        await kv_watch.aclose()
        await sub.aclose()
    finally:
        await d1.close()
        await d2.close()
        await server.close()

    base_id = info.instance_id
    obs["snaps"] = [[dict(i.to_dict(), instance_id=i.instance_id - base_id) for i in s]
                    for s in snaps]
    # Lease ids are the server's counter: compare them relative to the first.
    obs["alive_after_ttl"] = [i - base_id for i in obs["alive_after_ttl"]]
    obs["kv_snaps"] = kv_snaps
    obs["after_revoke"][0] = [i.to_dict() for i in obs["after_revoke"][0]]
    obs["expired"] = [i.to_dict() for i in obs["expired"]]
    return obs


@pytest.mark.parametrize("server,client", PAIRS)
async def test_coordinator_planes_match_jax(server, client):
    got = await _coordinator_script(server, client)
    want = await _coordinator_script("jax", "jax")
    assert got == want
    assert got["queue"] == [2, b"a", b"b", None, 0]
    assert got["kv_create"] == [True, False] and got["alive_after_ttl"] == [0]
    assert got["events"] == [{"worker_id": 3, "h": [1, 2]}, {"seq": 2}]
    assert [len(s) for s in got["snaps"]] == [0, 1, 0, 1, 0]


def test_coordinator_cli_prints_ready(tmp_path):
    import os

    from .fixtures import free_port

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_exp_tpu_torch.runtime.transports.coordinator",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == f"coordinator ready on 127.0.0.1:{port}"

        async def ping():
            d = tcoord.CoordinatorDiscovery(f"127.0.0.1:{port}")
            try:
                await d.kv_put("k", b"v")
                return await d.kv_get("k")
            finally:
                await d.close()

        assert asyncio.run(ping()) == b"v"
    finally:
        proc.kill()
        proc.wait(timeout=30)


# --------------------------------------------------------------------- tcp
async def _tcp_script(server_pkg: str, client_pkg: str) -> dict:
    S, C = PKGS[server_pkg], PKGS[client_pkg]
    plane = S["tcp"].TcpRequestPlane()
    client = C["tcp"].TcpRequestPlane()
    stopped = asyncio.Event()

    async def handler(req, ctx):
        if req.get("fail"):
            raise ValueError("bad request shape")
        for i in range(req["n"]):
            if ctx.is_stopped:
                stopped.set()
                yield {"data": {"stopped_at": i}}
                return
            yield {"data": {"i": i, "echo": req.get("echo")}}
            await asyncio.sleep(0.01 if req.get("slow") else 0)

    info = S["info"](S["addr"]("ns", "w", "gen"), instance_id=7)
    served = await plane.serve(info, handler, stats_handler=lambda: {"kv_active_blocks": 3})
    cinfo = C["info"].from_dict(info.to_dict())
    obs: dict = {"transport": [info.transport, bool(info.transport_address)]}
    try:
        async def run(req, ctx=None):
            frames = await client.request_stream(cinfo, req, ctx or C["ctx"]())
            return [f async for f in frames]

        obs["stream"] = await run({"n": 3, "echo": "é"})
        obs["error"] = await run({"n": 1, "fail": True})
        ctx = C["ctx"]()
        frames = await client.request_stream(cinfo, {"n": 1000, "slow": True}, ctx)
        first = await anext(frames)
        ctx.stop_generating()
        rest = [f async for f in frames]
        obs["stop"] = [first, rest[-1]["data"].keys() == {"stopped_at"}, stopped.is_set()]
        late = C["ctx"]()
        late.start_timeout(-1.0)
        obs["deadline"] = await run({"n": 2}, late)
        obs["stats"] = await client.scrape_stats(cinfo)
        gone = C["info"].from_dict(dict(info.to_dict(), instance_id=8))
        obs["unknown"] = [f["comment"] async for f in
                          await client.request_stream(gone, {"n": 1}, C["ctx"]())]
    finally:
        await served.close()
        await plane.close()
    obs["deadline"][0]["comment"] = [c.split(" for request")[0]
                                     for c in obs["deadline"][0]["comment"]]
    return obs


@pytest.mark.parametrize("server,client", PAIRS)
async def test_tcp_request_plane_matches_jax(server, client):
    got = await _tcp_script(server, client)
    want = await _tcp_script("jax", "jax")
    assert got == want
    assert got["stream"] == [{"data": {"i": i, "echo": "é"}} for i in range(3)]
    assert got["error"] == [{"event": "error", "comment": ["ValueError: bad request shape"]}]
    assert got["stats"] == {"inflight": 0, "kv_active_blocks": 3}
    assert got["deadline"] == [{"event": "error", "comment": ["deadline exceeded"]}]
