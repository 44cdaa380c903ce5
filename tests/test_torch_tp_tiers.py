"""The KV tiers under tensor parallelism, on the CPU over gloo ranks.

A page that leaves the card (the G2 host tier, a G3 file, the wire of
disaggregation and of live migration) is the whole page at any tp, the
JAX package's layout: ``[L, ps, Hkv*D]`` with the heads in rank order.
Rank 0 gathers the ranks' head slices into whole pages and scatters a
whole page's slices back (``engine/tp.py``'s page moves):

- Layout: a tp=2 engine's gathered page batch is the tp=1 engine's for
  the same prompt (bit for bit at layer 0, whose K and V come from the
  embedding through the same per-head products; deeper layers within
  1e-5, the float32 rounding of the row-sharded products' all-reduce),
  and a whole page injected at tp=2 lands each rank's head slice and
  gathers back unchanged.
- G2 under pressure: the tp=2 engine emits the JAX ``TPUEngine``'s
  tokens at tp=2 with the same host tier, and swaps and moves as many
  pages as the port's tp=1 engine.
- G3: the store's files written at tp=2 equal those written at tp=1
  (a one-layer model, so the bytes are equal), and each degree adopts
  the other's store and serves its prefix from it. The JAX
  ``TPUEngine`` at tp=2 writes the same files (names, headers, meta;
  K and V within 1e-5, as the two packages' float32 products round),
  and the port's tp=2 engine serves its prefix from the JAX store.
- Disaggregation across degrees, both ways, whole and suffix-only
  (``pin_prefix``'s ``skip_blocks``): the JAX ``TPUEngine``'s tokens at
  tp=2; and ``reclaim_extract`` at tp=2 into ``seed_prefix`` at tp=1.
- Threads and agreement: a page move asked for on the asyncio thread
  runs on the engine loop's; a pin takes no device step; a follower
  whose page moves differ from rank 0's makes the stop raise.
"""

import asyncio
import dataclasses
import json
import os
import shutil
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.engine import EngineConfig as JEngineConfig
from dynamo_exp_tpu.engine import TPUEngine
from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_exp_tpu_torch.kv.persistent import _HEADER

from . import torch_ranks as tr
from .test_torch_tp import ENGINE_KW, _cfgs, _jax_tokens, _params
from .torch_ranks import engine_scenario, run_ranks

PS = 8
JCFG, TCFG = _cfgs("llama")
# One layer: K and V come from the embedding with no collective between,
# so the two degrees write the same bytes.
JCFG1, TCFG1 = (dataclasses.replace(c, num_layers=1) for c in (JCFG, TCFG))
# The JAX package's tests/test_overload.py pressure: two 8-token prompts
# decoding 40 tokens need 12 pages of an 8-page pool.
PRESSURE_KW = dict(max_decode_slots=4, page_size=PS, num_pages=8, max_model_len=128,
                   prefill_chunk=16, decode_window=4, kv_dtype="float32", eos_token_ids=[],
                   preempt_stall_grace_s=0.5, host_cache_pages=64)
P1 = [5, 9, 17, 23, 4, 31, 8, 2]
P2 = [7, 3, 19, 28, 41, 13, 6, 11]


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(3, 200, size=n)]


@pytest.fixture(scope="module")
def np_params():
    return _params(JCFG)


@pytest.fixture(scope="module")
def np_params1():
    return _params(JCFG1)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 150))


def _local(np_params, cfg):
    return tr.local_engine(np_params, cfg)


def _jax_tp2(jcfg, np_params, **kw):
    jeng = TPUEngine(JEngineConfig(model=jcfg, tp=2, attention_impl="xla", **{**ENGINE_KW, **kw}),
                     params=jax.tree.map(jnp.asarray, np_params))
    assert jeng.mesh.shape["tp"] == 2
    return jeng


def _jax_in_turn(jeng, prompts, n):
    """Each prompt served alone on the JAX engine, in order; stopped."""
    async def go():
        return [await tr._tokens(jeng, p, n) for p in prompts]

    try:
        return _run(go())
    finally:
        jeng.stop()


# ------------------------------------------------------------------ layout
@pytest.fixture(scope="module")
def layout_run(np_params):
    """One tp=2 pair: a prompt served and its resident pages gathered to
    rank 0, then whole random pages injected into three other pages;
    every rank's K and V of those pages read back."""
    cfg = EngineConfig(model=TCFG, tp=2, **ENGINE_KW)
    rs = np.random.RandomState(0)
    shape = (TCFG.num_layers, PS, TCFG.num_kv_heads * TCFG.head_dim_)
    kp = [rs.standard_normal(shape).astype(np.float32) for _ in range(3)]
    vp = [rs.standard_normal(shape).astype(np.float32) for _ in range(3)]
    prompt, pids = _prompt(3, 3 * PS + 5), [45, 59, 52]
    out = run_ranks(engine_scenario, 2, np_params, cfg, "gather_then_inject",
                    (prompt, pids, kp, vp), pids, timeout=150)
    return dict(cfg=cfg, prompt=prompt, kp=kp, vp=vp, out=out)


def test_a_gathered_tp2_page_batch_is_the_tp1_batch(np_params, layout_run):
    ((pids, k2, v2), moves), reports, _, _ = layout_run["out"][0]
    eng = _local(np_params, layout_run["cfg"])
    try:
        pids1, k1, v1 = _run(tr.serve_then_gather(eng, np_params, layout_run["prompt"]))
    finally:
        eng.stop()
    assert len(pids) == len(pids1) == 3
    hd = TCFG.num_kv_heads * TCFG.head_dim_
    for a, b in zip(k2 + v2, k1 + v1):
        assert a.shape == b.shape == (TCFG.num_layers, PS, hd)
        assert np.array_equal(a[0], b[0])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert moves == {"gather": {"calls": 1, "pages": 3}, "scatter": {"calls": 0, "pages": 0}}
    assert reports[0]["page_moves"] == reports[1]["page_moves"]
    assert reports[0]["comm"]["calls"]["page_gather"] == 1


def test_an_injected_whole_page_lands_each_ranks_head_slice(layout_run):
    hd = TCFG.num_kv_heads * TCFG.head_dim_
    kp, vp = layout_run["kp"], layout_run["vp"]
    for r, (_, reports, _, (k, v)) in enumerate(layout_run["out"]):
        part = slice(r * hd // 2, (r + 1) * hd // 2)
        assert np.array_equal(k, np.stack(kp, 1)[..., part])
        assert np.array_equal(v, np.stack(vp, 1)[..., part])
        assert reports[r]["page_moves"]["scatter"] == {"calls": 1, "pages": 3}


# ------------------------------------------------------------ G2 pressure
def _pressure_requests():
    so = dict(temperature=0.8, top_k=20, seed=1234)
    return [{"token_ids": P1, "stop_conditions": {"max_tokens": 40, "ignore_eos": True},
             "sampling_options": {}},
            {"token_ids": P2, "stop_conditions": {"max_tokens": 40, "ignore_eos": True},
             "sampling_options": so}]


def test_tp2_under_g2_pressure_emits_the_jax_engines_tokens(np_params):
    requests = _pressure_requests()
    want = _run(_jax_tokens(_jax_tp2(JCFG, np_params, **PRESSURE_KW), requests))
    cfg = EngineConfig(model=TCFG, tp=2, **PRESSURE_KW)
    (res, reports, metrics, _), _ = run_ranks(engine_scenario, 2, np_params, cfg,
                                              "serve_and_count", (requests,), timeout=150)
    tokens, out2, in2, pre2, moves = res
    assert tokens == want
    assert out2 > 0 and in2 > 0 and pre2 == 0
    assert reports[0]["page_moves"] == reports[1]["page_moves"] == moves
    # The port's tp=1 engine swaps as often and moves as many pages.
    eng = _local(np_params, cfg)
    try:
        tokens1, out1, in1, pre1, _ = _run(tr.serve_and_count(eng, np_params, requests))
        copies = eng.copy_stats()
    finally:
        eng.stop()
    copies = eng.copy_stats()
    assert tokens1 == want
    assert (out1, in1, pre1) == (out2, in2, pre2)
    assert moves["gather"]["pages"] == copies["d2h_pages"] > 0
    assert moves["scatter"]["pages"] == copies["h2d_pages"] > 0
    assert metrics["swapped_out"] == out2 and metrics["host_cache_stores"] > 0


# --------------------------------------------------------------------- G3
@pytest.fixture(scope="module")
def g3_stores(np_params1, tmp_path_factory):
    """Prompt A served, then B, on an 8-page pool at each degree with a
    host tier and a G3 store each: B evicts A's parked pages to the host
    tier, and the stop drains the host tier into the store and seals it.
    Returns the stores by degree and A's and B's tokens by degree."""
    a, b = _prompt(11, 3 * PS + 2), _prompt(12, 7 * PS + 2)
    out = {}
    for tp in (1, 2):
        path = str(tmp_path_factory.mktemp(f"g3_tp{tp}"))
        cfg = EngineConfig(model=TCFG1, tp=tp, **{**ENGINE_KW, "num_pages": 8,
                                                  "host_cache_pages": 32,
                                                  "kv_store_dir": path})
        if tp == 2:
            (res, reports, _, _), _ = run_ranks(engine_scenario, 2, np_params1, cfg,
                                                "serve_in_turn", ([a, b], 6), timeout=150)
            assert reports[0]["page_moves"] == reports[1]["page_moves"]
        else:
            eng = _local(np_params1, cfg)
            try:
                res = _run(tr.serve_in_turn(eng, np_params1, [a, b], 6))
            finally:
                eng.stop()
        out[tp] = dict(path=path, tokens=res[0])
    return dict(out, a=a, b=b)


def _store_files(path):
    files = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            if "manifest" not in name:
                with open(full, "rb") as f:
                    files[os.path.relpath(full, path)] = f.read()
    return files


def test_g3_files_written_at_tp2_equal_those_written_at_tp1(g3_stores):
    one, two = (_store_files(g3_stores[tp]["path"]) for tp in (1, 2))
    assert len(one) >= 3
    assert one == two
    assert g3_stores[1]["tokens"] == g3_stores[2]["tokens"]


@pytest.fixture(scope="module")
def jax_g3_store(np_params1, g3_stores, tmp_path_factory):
    """The JAX ``TPUEngine`` at tp=2 on ``g3_stores``' config and
    prompts: its store and tokens."""
    path = str(tmp_path_factory.mktemp("g3_jax_tp2"))
    jeng = _jax_tp2(JCFG1, np_params1, num_pages=8, host_cache_pages=32, kv_store_dir=path)
    return dict(path=path, tokens=_jax_in_turn(jeng, [g3_stores["a"], g3_stores["b"]], 6))


def _g3_file(blob: bytes):
    """A page file's header, meta and K/V payload (float32)."""
    header = _HEADER.unpack_from(blob)
    payload = blob[_HEADER.size:]
    meta = payload[:header[3]]
    assert zlib.crc32(payload) == header[1]
    return header, meta, np.frombuffer(payload[header[3]:], np.float32)


def test_g3_files_written_at_tp2_hold_the_jax_engines_pages_at_tp2(g3_stores, jax_g3_store):
    """The port's tp=2 store and the JAX engine's at tp=2: the same files
    by name, each with its CRC holding, equal headers (magic, hash key,
    meta length) and meta (hash, dtype, the whole page's shape), and K
    and V within 1e-5: the two packages' float32 K/V products round
    differently, so the payload bytes are not equal."""
    assert jax_g3_store["tokens"] == g3_stores[2]["tokens"]
    port, jx = (_store_files(p) for p in (g3_stores[2]["path"], jax_g3_store["path"]))
    assert len(port) >= 3 and sorted(port) == sorted(jx)
    whole = [TCFG1.num_layers, PS, TCFG1.num_kv_heads * TCFG1.head_dim_]
    for name, blob in port.items():
        (hp, mp, kvp), (hj, mj, kvj) = _g3_file(blob), _g3_file(jx[name])
        assert len(blob) == len(jx[name])
        assert hp[0] == hj[0] and hp[2:] == hj[2:] and mp == mj
        assert json.loads(mp)["shape"] == whole
        np.testing.assert_allclose(kvp, kvj, rtol=0, atol=1e-5)


def test_tp2_reads_the_jax_engines_g3_store(jax_g3_store, g3_stores, np_params1, tmp_path):
    """A port tp=2 engine over (a copy of) the JAX tp=2 engine's store:
    prompt A's pages come from the store and its tokens are JAX's."""
    path = str(tmp_path / "store")
    shutil.copytree(jax_g3_store["path"], path)
    cfg = EngineConfig(model=TCFG1, tp=2, **{**ENGINE_KW, "host_cache_pages": 32,
                                             "kv_store_dir": path})
    (res, _, metrics, _), _ = run_ranks(engine_scenario, 2, np_params1, cfg, "serve_in_turn",
                                        ([g3_stores["a"]], 6), timeout=150)
    (tokens,), hits = res
    assert metrics["kv_store_adopted"] >= 3 and hits["persist"] == 3
    assert tokens == jax_g3_store["tokens"][0]


@pytest.mark.parametrize("reader", [1, 2], ids=["tp1_reads_tp2s", "tp2_reads_tp1s"])
def test_each_degree_reads_the_others_g3_store(g3_stores, np_params1, reader):
    """A restarted engine of one degree over the other degree's store:
    prompt A's pages come from the store (persist hits) and its tokens
    are the writer's."""
    writer = 3 - reader
    a = g3_stores["a"]
    cfg = EngineConfig(model=TCFG1, tp=reader, **{**ENGINE_KW, "host_cache_pages": 32,
                                                  "kv_store_dir": g3_stores[writer]["path"]})
    if reader == 2:
        (res, _, metrics, _), _ = run_ranks(engine_scenario, 2, np_params1, cfg,
                                            "serve_in_turn", ([a], 6), timeout=150)
        adopted = metrics["kv_store_adopted"]
    else:
        eng = _local(np_params1, cfg)
        try:
            res = _run(tr.serve_in_turn(eng, np_params1, [a], 6))
        finally:
            eng.stop()
        adopted = eng.g3_store.adopted
    (tokens,), hits = res
    assert adopted >= 3 and hits["persist"] == 3
    assert tokens == g3_stores[writer]["tokens"][0]


# --------------------------------------------------------- disaggregation
_DISAGG: dict = {}
DISAGG_PROMPT, DISAGG_TOKENS = _prompt(21, 4 * PS + 3), 8


@pytest.fixture(scope="module")
def jax_disagg_tokens(np_params):
    """The JAX ``TPUEngine``'s tokens at tp=2 for the disaggregated prompt."""
    return _jax_in_turn(_jax_tp2(JCFG, np_params), [DISAGG_PROMPT], DISAGG_TOKENS)[0]


def _disagg_run(np_params, direction):
    """Both transfers of one direction on one tp=2 pair (cached)."""
    if direction not in _DISAGG:
        cfg = EngineConfig(model=TCFG, tp=2, **ENGINE_KW)
        (res, reports, _, _), _ = run_ranks(
            engine_scenario, 2, np_params, cfg, "disagg_across",
            (direction, DISAGG_PROMPT, DISAGG_TOKENS, 2), timeout=150)
        _DISAGG[direction] = (res, reports)
    return _DISAGG[direction]


@pytest.mark.parametrize("prefix_pages", [0, 2], ids=["whole", "suffix_only"])
@pytest.mark.parametrize("direction", ["tp2_prefill", "tp2_decode"])
def test_disaggregation_across_tp_degrees(np_params, jax_disagg_tokens, direction,
                                         prefix_pages):
    """A prefill worker of one degree hands a prompt's KV over the TCP
    plane to a decode engine of the other: the tokens are the decode
    side's own local prefill's and the JAX engine's at tp=2, no
    fallback, no checksum failure, and a pinned resident prefix is
    skipped (``skip_blocks``), not shipped."""
    res, reports = _disagg_run(np_params, direction)
    got, want, c = res["suffix_only" if prefix_pages else "whole"]
    assert got == want == jax_disagg_tokens
    assert c["remote"] == 1 and c["fallbacks"] == 0 and c["served"] == 1
    assert c["checksum_failures"] == 0 and c["leases"] == (0, 0)
    assert c["skipped"] == prefix_pages
    assert c["extracted"] == c["injected"] == 5 - prefix_pages
    moves = reports[0]["page_moves"]
    assert reports[1]["page_moves"] == moves
    side = "gather" if direction == "tp2_prefill" else "scatter"
    assert moves[side]["pages"] >= 5 + 3


def test_reclaim_extract_at_tp2_seeds_a_tp1_prefix(np_params):
    """Live migration across degrees: a tp=2 stream's complete pages,
    gathered whole, seed a tp=1 engine's prefix cache; its journal
    continuation attaches them and emits the tp=2 stream's tokens."""
    cfg = EngineConfig(model=TCFG, tp=2, **{**ENGINE_KW, "decode_window": 2})
    prompt = _prompt(31, 2 * PS + 3)
    (res, reports, _, _), _ = run_ranks(engine_scenario, 2, np_params, cfg,
                                        "reclaim_across", (prompt, 24), timeout=150)
    tokens, start, cont, shipped, seeded, hits = res
    assert shipped >= 2 and seeded == shipped
    assert hits >= shipped
    assert cont == tokens[start:]
    assert reports[0]["page_moves"] == reports[1]["page_moves"]
    assert reports[0]["page_moves"]["gather"]["pages"] == shipped


# ------------------------------------------------------ threads, agreement
def test_a_page_move_from_the_asyncio_thread_runs_on_the_loop_thread(np_params):
    cfg = EngineConfig(model=TCFG, tp=2, **{**ENGINE_KW, "decode_window": 2})
    (res, reports, _, _), _ = run_ranks(engine_scenario, 2, np_params, cfg,
                                        "thread_of_page_moves", (_prompt(41, 2 * PS + 1), 24),
                                        timeout=150)
    threads, caller, shipped = res
    assert shipped >= 2
    assert threads and set(threads) == {"torch-engine-loop"} and caller != "torch-engine-loop"


def test_a_pin_under_tp_takes_no_device_step(np_params):
    """``pin_prefix`` is rank 0's page manager alone: the pin covers the
    resident prefix, the lease is released, and no rank moved a page."""
    cfg = EngineConfig(model=TCFG, tp=2, **ENGINE_KW)
    prefix = _prompt(51, 2 * PS)
    (res, reports, _, _), _ = run_ranks(engine_scenario, 2, np_params, cfg, "pin_and_read",
                                        (prefix + [5], prefix + _prompt(52, PS)),
                                        timeout=150)
    n, granted, active, after = res
    assert (n, granted, active, after) == (2, True, 1, 0)
    idle = {"gather": {"calls": 0, "pages": 0}, "scatter": {"calls": 0, "pages": 0}}
    assert [r["page_moves"] for r in reports] == [idle, idle]
    assert reports[0]["digest"] == reports[1]["digest"]


def test_a_followers_other_page_moves_make_the_stop_raise(np_params):
    cfg = EngineConfig(model=TCFG, tp=2, **ENGINE_KW)
    (res, _, _, _), _ = run_ranks(engine_scenario, 2, np_params, cfg, "serve",
                                  ([tr._body(P1, 4)],), (), True, timeout=150)
    assert res[0] == "stop raised" and "moved other KV pages" in res[1]


# ------------------------------------------------------------ construction
def _stand_in(rank):
    return types.SimpleNamespace(rank=rank, world=2, device=torch.device("cpu"))


@pytest.mark.parametrize("kw", [{"host_cache_pages": 8}, {"kv_store_dir": "store"}],
                         ids=["g2", "g3"])
def test_rank0_alone_holds_the_tiers_in_whole_pages(tmp_path, kw):
    kw = {k: str(tmp_path / v) if k == "kv_store_dir" else v for k, v in kw.items()}
    kw.setdefault("host_cache_pages", 8)
    cfg = EngineConfig(model=TCFG, tp=2, **{**ENGINE_KW, **kw})
    lead = TorchEngine(cfg, device="cpu", comm=_stand_in(0))
    follower = TorchEngine(cfg, device="cpu", comm=_stand_in(1))
    whole = (TCFG.num_layers, PS, TCFG.num_kv_heads * TCFG.head_dim_)
    assert lead.host_pool.page_shape == whole
    assert (lead.g3_store is not None) == ("kv_store_dir" in kw)
    assert follower.host_pool is None and follower.g3_store is None
    assert lead.k_cache.shape[-1] == whole[-1] // 2
