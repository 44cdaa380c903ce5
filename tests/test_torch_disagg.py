"""The port's disaggregation plane (``dynamo_exp_tpu_torch/disagg/``)
against the JAX package's, on the CPU (TINY, float32 KV, page size 8).

- Wire parity, exact: ``kv_signature`` strings, ``RemotePrefillRequest``
  and ``LeaseGrant`` bytes, ``DisaggConfig`` decisions and bytes on
  seeded inputs, and ``encode_pages`` / ``decode_pages`` frames in both
  directions, float32 and bfloat16 (the JAX plane encodes, the port
  decodes, and the reverse; bit-equal pages, byte-equal frames).
- The port alone: its disaggregated pair (``PrefillWorker`` and
  ``DisaggDecodeEngine`` around two ``TorchEngine``s, the real TCP KV
  plane) gives its local engine's tokens and ``TPUEngine``'s on the same
  ``params_from_jax`` weights (exact: float32); the fallback to local
  prefill without a prefill worker; the layout and page-size refusals;
  the suffix-only transfer (only the unshared pages are gathered and
  shipped, the pin released).
- Across packages: a JAX ``PrefillWorker`` hands KV to the port's
  ``DisaggDecodeEngine`` through the port's coordinator (its work
  queue), and the reverse; the tokens equal ``TPUEngine``'s (exact).
"""

import asyncio
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_exp_tpu import disagg as jdisagg
from dynamo_exp_tpu.disagg import protocol as jprotocol
from dynamo_exp_tpu.disagg import transfer as jtransfer
from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.parallel import single_device_mesh
from dynamo_exp_tpu.planner.planner import prefill_queue_name as jprefill_queue_name
from dynamo_exp_tpu.runtime import DistributedRuntime as JDistributedRuntime
from dynamo_exp_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_exp_tpu.runtime.runtime import CancellationToken as JCancellationToken
from dynamo_exp_tpu.runtime.transports.inproc import InProcDiscovery as JInProcDiscovery
from dynamo_exp_tpu_torch import disagg
from dynamo_exp_tpu_torch.disagg import protocol, transfer
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.models import TINY, params_from_jax
from dynamo_exp_tpu_torch.planner import prefill_queue_name
from dynamo_exp_tpu_torch.runtime import DistributedRuntime
from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
from dynamo_exp_tpu_torch.runtime.runtime import CancellationToken
from dynamo_exp_tpu_torch.runtime.transports.coordinator import CoordinatorServer
from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcDiscovery, InProcWorkQueue

PS = 8
JCFG = replace(JTINY, dtype="float32")
CFG = replace(TINY, dtype="float32")
ENGINE_KW = dict(max_decode_slots=2, page_size=PS, num_pages=64, max_model_len=128,
                 eos_token_ids=[], kv_dtype="float32")


# ------------------------------------------------------------ wire parity
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", [8, 16])
def test_kv_signature_is_the_jax_string(kv_dtype, page_size):
    for layers, kv_heads in ((2, 2), (32, 8)):
        jm = replace(JTINY, num_layers=layers, num_kv_heads=kv_heads)
        tm = replace(TINY, num_layers=layers, num_kv_heads=kv_heads)
        want = jprotocol.kv_signature(JEngineConfig(model=jm, page_size=page_size,
                                                    kv_dtype=kv_dtype))
        got = protocol.kv_signature(EngineConfig(model=tm, page_size=page_size,
                                                 kv_dtype=kv_dtype))
        assert got == want == (f"L{layers}-ps{page_size}-kv{kv_heads}-d{tm.head_dim_}-"
                               f"{kv_dtype}")
    assert prefill_queue_name("llama-8b") == jprefill_queue_name("llama-8b")


def test_request_and_lease_bytes_are_the_jax_bytes():
    rs = np.random.RandomState(0)
    for i in range(20):
        fields = dict(
            request_id=f"r{i}", token_ids=rs.randint(0, 1000, size=rs.randint(1, 40)).tolist(),
            return_addr=f"127.0.0.1:{rs.randint(1024, 65535)}",
            sampling_options={"temperature": float(rs.rand()), "seed": int(rs.randint(99))},
            page_size=int(rs.choice([8, 16])), model=f"L2-ps8-kv2-d{i}-float32",
            trace_id=f"{rs.randint(1 << 30):x}", parent_span_id=f"{rs.randint(1 << 30):x}",
            deadline_unix=float(rs.rand() * 1e9), skip_blocks=int(rs.randint(5)),
            decode_instance=f"host:{i}",
        )
        raw = protocol.RemotePrefillRequest(**fields).to_bytes()
        assert raw == jprotocol.RemotePrefillRequest(**fields).to_bytes()
        assert asdict(jprotocol.RemotePrefillRequest.from_bytes(raw)) == fields
        assert asdict(protocol.RemotePrefillRequest.from_bytes(raw)) == fields
        lease = dict(lease_id=f"{rs.randint(1 << 30):x}", ttl_s=float(rs.rand() * 30))
        header = protocol.LeaseGrant(**lease).to_header()
        assert header == jprotocol.LeaseGrant(**lease).to_header()
        assert protocol.LeaseGrant.from_header(header) == protocol.LeaseGrant(**lease)
    # Unknown keys from a newer sender are ignored by both.
    raw = b'{"request_id": "x", "token_ids": [1], "return_addr": "h:1", "future": 3}'
    assert (asdict(protocol.RemotePrefillRequest.from_bytes(raw))
            == asdict(jprotocol.RemotePrefillRequest.from_bytes(raw)))
    assert protocol.LeaseGrant.from_header({}) is None is jprotocol.LeaseGrant.from_header({})


def test_disagg_config_decisions_match_jax():
    rs = np.random.RandomState(1)
    for _ in range(500):
        knobs = dict(max_local_prefill_length=int(rs.randint(0, 2048)),
                     max_prefill_queue_size=int(rs.randint(0, 10)))
        t, j = disagg.DisaggConfig(**knobs), jdisagg.DisaggConfig(**knobs)
        assert t.to_bytes() == j.to_bytes()
        assert disagg.DisaggConfig.from_bytes(j.to_bytes()) == t
        for _ in range(4):
            n, q = int(rs.randint(0, 4096)), int(rs.randint(0, 12))
            assert t.prefill_remote(n, q) == j.prefill_remote(n, q)
    assert disagg.disagg_config_key("m") == jdisagg.disagg_config_key("m")


def _pages(seed: int, n: int, dtype: str):
    """n (k, v) pages [L, ps, Hkv*D] of seeded values: the numpy arrays
    the JAX plane ships and the torch tensors the port ships, with the
    same bits."""
    rs = np.random.RandomState(seed)
    shape = (2, PS, 64)
    out_np, out_t = [], []
    for _ in range(n):
        pair_np, pair_t = [], []
        for _ in range(2):
            x = rs.standard_normal(shape).astype(np.float32)
            if dtype == "bfloat16":
                t = torch.from_numpy(x).to(torch.bfloat16)
                a = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            else:
                t, a = torch.from_numpy(x), x
            pair_np.append(a)
            pair_t.append(t)
        out_np.append(tuple(pair_np))
        out_t.append(tuple(pair_t))
    return out_np, out_t


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_frames_are_byte_equal_in_both_directions(dtype):
    pages_np, pages_t = _pages(3, 5, dtype)
    jh, jp = jtransfer.encode_pages(pages_np)
    th, tp = transfer.encode_pages(pages_t)
    assert th == jh and tp == jp  # header (dtype name, shape, CRCs) and payload
    assert th["dtype"] == dtype
    # JAX encodes, the port decodes.
    got = transfer.decode_pages(jh, jp)
    assert [(k.dtype, tuple(k.shape)) for k, _ in got] == [
        (getattr(torch, dtype), (2, PS, 64))] * 5
    assert [(_bits(k), _bits(v)) for k, v in got] == [(_bits(k), _bits(v)) for k, v in pages_t]
    # The port encodes, the JAX plane decodes.
    back = jtransfer.decode_pages(th, tp)
    assert [(_bits(k), _bits(v)) for k, v in back] == [
        (_bits(k), _bits(v)) for k, v in pages_np]
    # Non-contiguous host views (a gathered batch's page slices) encode
    # as their contiguous copies.
    batch = torch.stack([k for k, _ in pages_t], dim=1)
    views = [(batch[:, j], v) for j, (_, v) in enumerate(pages_t)]
    assert transfer.encode_pages(views) == (th, tp)


def test_wire_checksum_failure_is_counted_and_refused():
    _, pages_t = _pages(4, 2, "float32")
    header, payload = transfer.encode_pages(pages_t)
    bad = bytearray(payload)
    bad[len(bad) - 3] ^= 0x40  # a bit of page 1's V
    before = transfer.wire_checksum_failures()
    with pytest.raises(ValueError, match="checksum mismatch on page 1/2"):
        transfer.decode_pages(header, bytes(bad))
    with pytest.raises(ValueError, match="checksum mismatch on page 1/2"):
        jtransfer.decode_pages(header, bytes(bad))
    assert transfer.wire_checksum_failures() == before + 1


# ----------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0), JCFG))


def port_engine(np_params, **kw) -> TorchEngine:
    return TorchEngine(EngineConfig(model=CFG, **{**ENGINE_KW, **kw}),
                       model=params_from_jax(np_params, CFG, device="cpu"), device="cpu")


def jax_engine(np_params, **kw) -> TPUEngine:
    return TPUEngine(JEngineConfig(model=JCFG, attention_impl="xla", **{**ENGINE_KW, **kw}),
                     params=jax.tree.map(jnp.asarray, np_params), mesh=single_device_mesh())


def body(prompt, n) -> dict:
    return {"token_ids": list(prompt), "stop_conditions": {"max_tokens": n, "ignore_eos": True}}


async def collect(engine, prompt, n) -> list[int]:
    stream = await engine.generate(body(prompt, n))
    return [t async for item in stream for t in (item.get("token_ids") or [])]


def prompt_of(seed: int, n: int) -> list[int]:
    return [int(t) for t in np.random.RandomState(seed).randint(3, 200, size=n)]


class Pair:
    """A prefill worker and a disaggregated decode engine of one package
    around its engines, on an in-process work queue and the real TCP KV
    plane."""

    def __init__(self, mod, prefill_eng, decode_eng, queue, discovery, cancel, **kw):
        self.recv = mod.KvPageReceiver()
        self.worker = mod.PrefillWorker(prefill_eng, queue, cancel) if prefill_eng else None
        watcher = mod.DisaggConfigWatcher(
            discovery, "m", default=mod.DisaggConfig(max_local_prefill_length=0))
        self.disagg = mod.DisaggDecodeEngine(decode_eng, queue, self.recv, watcher, **kw)
        self.cancel = cancel
        self.task = None

    async def __aenter__(self):
        await self.recv.start()
        if self.worker is not None:
            self.task = asyncio.ensure_future(self.worker.run())
        return self

    async def __aexit__(self, *exc):
        self.cancel.cancel()
        if self.task is not None:
            await asyncio.wait_for(self.task, 10)
        await self.recv.close()


async def disagg_tokens(pair, prompt, n) -> list[int]:
    return await collect(pair.disagg, prompt, n)


def test_port_disagg_pair_matches_local_and_tpu_engine(np_params):
    """The counterpart of ``tests/test_disagg.py::test_disagg_e2e_matches_local``:
    exact token equality (float32) with the port's local engine and with
    ``TPUEngine`` on the same weights; the decode engine computed no
    prefill (no mixed dispatch), and the handoff lease was confirmed."""
    prompt = prompt_of(3, 3 * PS + 5)
    jeng = jax_engine(np_params)
    try:
        want = asyncio.run(asyncio.wait_for(collect(jeng, prompt, 10), 300))
    finally:
        jeng.stop()
    pre, dec, local = (port_engine(np_params) for _ in range(3))

    async def scenario():
        async with Pair(disagg, pre, dec, InProcWorkQueue(), InProcDiscovery(),
                        CancellationToken()) as pair:
            got = await disagg_tokens(pair, prompt, 10)
            loc = await collect(local, prompt, 10)
            for _ in range(200):  # the confirm is queued for the prefill loop
                if pre.kv.active_leases == 0:
                    break
                await asyncio.sleep(0.01)
            return got, loc, pair

    try:
        got, loc, pair = asyncio.run(asyncio.wait_for(scenario(), 300))
        assert got == loc == want
        assert pair.disagg.remote_prefills == 1 and pair.worker.served == 1
        assert dec.metrics()["dispatches"]["mixed"] == 0
        assert dec.metrics()["prefill_tokens_computed"] == 0
        assert dec.metrics()["kv_inject_pages"] == 4
        assert pre.metrics()["kv_extract_pages"] == 4
        assert pre.kv.active_leases == 0
        for eng in (pre, dec):
            with eng.hold_admission():
                audit = eng.kv_audit()
            assert audit["ok"], audit
    finally:
        for eng in (pre, dec, local):
            eng.stop()


def test_falls_back_to_local_without_a_prefill_worker(np_params):
    prompt = prompt_of(5, PS + 3)
    dec, local = port_engine(np_params), port_engine(np_params)

    async def scenario():
        async with Pair(disagg, None, dec, InProcWorkQueue(), InProcDiscovery(),
                        CancellationToken(), transfer_timeout_s=0.2) as pair:
            return await disagg_tokens(pair, prompt, 6), await collect(local, prompt, 6), pair

    try:
        got, want, pair = asyncio.run(asyncio.wait_for(scenario(), 120))
        assert got == want
        assert pair.disagg.local_fallbacks == 1 and pair.disagg.remote_prefills == 0
    finally:
        dec.stop()
        local.stop()


@pytest.mark.parametrize("bad", ["layout", "page_size"])
def test_prefill_worker_refuses_a_foreign_layout(np_params, bad):
    pre = port_engine(np_params)

    async def scenario():
        queue = InProcWorkQueue()
        recv = disagg.KvPageReceiver()
        await recv.start()
        cancel = CancellationToken()
        worker = disagg.PrefillWorker(pre, queue, cancel)
        task = asyncio.ensure_future(worker.run())
        try:
            fut = recv.expect("bad")
            sig = protocol.kv_signature(pre.cfg)
            req = disagg.RemotePrefillRequest(
                request_id="bad", token_ids=[4, 5, 6], return_addr=recv.address,
                page_size=PS + 1 if bad == "page_size" else PS,
                model=sig + "-different" if bad == "layout" else sig)
            await queue.push(req.to_bytes())
            with pytest.raises(RuntimeError, match=bad):
                await asyncio.wait_for(fut, 10)
            return worker
        finally:
            cancel.cancel()
            await asyncio.wait_for(task, 10)
            await recv.close()

    try:
        worker = asyncio.run(asyncio.wait_for(scenario(), 60))
        assert worker.failed == 1 and worker.served == 0
    finally:
        pre.stop()


def test_suffix_only_transfer(np_params):
    """The counterpart of ``test_prefix_sharing.py::test_disagg_suffix_only_transfer``:
    with the prefix resident on the decode side, only the unshared pages
    are gathered and shipped, the tokens are the local run's, and the
    decode side's pin is released."""
    rs = np.random.RandomState(37)
    prefix = rs.randint(3, 200, size=3 * PS).tolist()
    prompt = prefix + rs.randint(3, 200, size=PS + 4).tolist()
    pre, dec, local = (port_engine(np_params) for _ in range(3))

    async def scenario():
        async with Pair(disagg, pre, dec, InProcWorkQueue(), InProcDiscovery(),
                        CancellationToken()) as pair:
            await collect(dec, prefix + [5], 2)  # the prefix resident on the decode side
            want = await collect(local, prompt, 8)
            got = await disagg_tokens(pair, prompt, 8)
            for _ in range(200):
                if dec.kv.active_leases == 0 and pre.kv.active_leases == 0:
                    break
                await asyncio.sleep(0.01)
            return got, want, pair

    try:
        got, want, pair = asyncio.run(asyncio.wait_for(scenario(), 300))
        assert got == want
        assert pair.disagg.remote_prefills == 1 and pair.disagg.blocks_skipped == 3
        assert pre.metrics()["kv_extract_pages"] == 2  # 5 prompt pages less 3
        assert dec.metrics()["kv_inject_pages"] == 2
        assert dec.kv.active_leases == 0 and pre.kv.active_leases == 0
        with dec.hold_admission():
            audit = dec.kv_audit()
        assert audit["ok"], audit
    finally:
        for eng in (pre, dec, local):
            eng.stop()


# ---------------------------------------------------------- across packages
@pytest.mark.parametrize("direction", ["jax_prefill_torch_decode", "torch_prefill_jax_decode"])
def test_handoff_across_packages_through_the_port_coordinator(np_params, direction):
    """One package's prefill worker hands a prompt's KV to the other's
    decode engine: the queue is the port's coordinator's (each package's
    runtime reaches it as a client), the pages ride the TCP KV plane,
    and the tokens are ``TPUEngine``'s local ones."""
    prompts = [prompt_of(7, 2 * PS + 3), prompt_of(8, 4 * PS)]
    local = jax_engine(np_params)

    async def reference():
        return [await collect(local, p, 8) for p in prompts]

    try:
        want = asyncio.run(asyncio.wait_for(reference(), 300))
    finally:
        local.stop()
    jax_side = jax_engine(np_params)
    port_side = port_engine(np_params)

    async def scenario():
        server = CoordinatorServer()
        await server.start()
        tdrt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
        jdrt = JDistributedRuntime(config=JRuntimeConfig(coordinator_endpoint=server.address))
        name = prefill_queue_name("tiny")
        try:
            if direction == "jax_prefill_torch_decode":
                worker = jdisagg.PrefillWorker(jax_side, jdrt.work_queue(name),
                                               JCancellationToken())
                pair = Pair(disagg, None, port_side, tdrt.work_queue(name), InProcDiscovery(),
                            worker.cancel)
            else:
                worker = disagg.PrefillWorker(port_side, tdrt.work_queue(name),
                                              CancellationToken())
                pair = Pair(jdisagg, None, jax_side, jdrt.work_queue(name), JInProcDiscovery(),
                            worker.cancel)
            task = asyncio.ensure_future(worker.run())
            try:
                async with pair:
                    got = [await disagg_tokens(pair, p, 8) for p in prompts]
            finally:
                worker.cancel.cancel()
                await asyncio.wait_for(task, 10)
            return got, pair, worker
        finally:
            await tdrt.close()
            await jdrt.close()
            await server.close()

    try:
        got, pair, worker = asyncio.run(asyncio.wait_for(scenario(), 300))
        assert got == want
        assert pair.disagg.remote_prefills == 2 and worker.served == 2
        assert pair.disagg.local_fallbacks == 0
    finally:
        jax_side.stop()
        port_side.stop()
