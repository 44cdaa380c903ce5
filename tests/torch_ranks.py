"""Run a function on every rank of a CPU process group, for the port's
tensor- and sequence-parallel tests.

:func:`run_ranks` spawns one process per rank (``spawn`` start method;
``sp`` x ``tp`` ranks laid out as (sp, tp), ``parallel.rank_layout``),
joins them into a gloo process group over a ``TCPStore`` on a free
local port, calls ``fn(comm, *args)`` on each and returns the results
in rank order. Every wait has a deadline: on expiry (or a rank's
failure) the children are killed and the call raises, so no test can
stall the suite. The module imports no JAX, so children start lean.
"""

import multiprocessing as mp
import queue
import traceback

import numpy as np

from .fixtures import free_port


def _rank_main(fn, rank: int, tp: int, sp: int, port: int, out, args) -> None:
    try:
        import torch

        from dynamo_exp_tpu_torch.parallel.mesh import rank_layout
        from dynamo_exp_tpu_torch.parallel.multihost import MultiNodeConfig, initialize_multihost

        torch.set_num_threads(2)
        comm = initialize_multihost(
            MultiNodeConfig(), f"127.0.0.1:{port}",
            layout=rank_layout(tp=tp, rank=rank, sp=sp),
            backend="gloo", device="cpu",
        )
        try:
            out.put((rank, True, fn(comm, *args)))
        finally:
            comm.close()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, tp: int, *args, sp: int = 1, timeout: float = 180.0) -> list:
    """``fn(comm, *args)`` on each of ``sp * tp`` gloo ranks; their
    results in rank order. ``fn`` must be importable (a module-level
    function)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    world = sp * tp
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tp, sp, port, out, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    try:
        import time

        deadline = time.monotonic() + timeout
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} did not "
                                   f"finish within {timeout}s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    # Give a dying rank a moment to report its traceback.
                    try:
                        rank, ok, value = out.get(timeout=5)
                    except queue.Empty:
                        raise RuntimeError(f"a rank exited with {dead[0].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ------------------------------------------------------------ rank functions
def forward_logits(comm, np_params, cfg, tokens, ps: int = 8):
    """This rank's shard of ``np_params`` (``params_from_jax``) through
    both forward shapes over one prompt: ``forward`` as a T-token
    prefill (the plain attention) and ``forward_ragged`` over the same
    tokens as one row; (logits, ragged logits), both [T, V] numpy."""
    import torch

    from dynamo_exp_tpu_torch.models import convert, llama

    model = convert.params_from_jax(np_params, cfg, device="cpu", rank=comm.rank, tp=comm.world)
    T = len(tokens)
    pages = -(-T // ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    toks = torch.tensor([tokens], dtype=torch.int64)
    pos = torch.arange(T, dtype=torch.int32)[None]
    k, v = llama.init_kv_cache(cfg, pages + 1, ps, torch.float32, "cpu", tp=comm.world)
    logits, _, _ = llama.forward(model, cfg, toks, pos, table, k, v, attn_impl="reference",
                                 comm=comm)
    k, v = llama.init_kv_cache(cfg, pages + 1, ps, torch.float32, "cpu", tp=comm.world)
    ragged, _, _ = llama.forward_ragged(
        model, cfg, toks[0], pos[0], torch.zeros(T, dtype=torch.int32), table, k, v,
        torch.arange(T), attn_impl="reference", comm=comm,
    )
    return logits[0].numpy(), ragged.numpy()


async def _collect_all(engine, requests):
    streams = [engine.submit(r) for r in requests]
    engine.start()
    out = []
    for stream in streams:
        toks = []
        async for item in stream:
            toks += item.get("token_ids") or []
        out.append(toks)
    return out


def engine_tokens(comm, np_params, engine_cfg, requests):
    """A ``TorchEngine`` over this rank's shard: rank 0 serves
    ``requests`` (all queued before the loop starts) and returns
    (tokens per request, every rank's report, metrics); the others
    follow and return the reports."""
    import asyncio

    from dynamo_exp_tpu_torch.engine import TorchEngine
    from dynamo_exp_tpu_torch.models import convert

    model = convert.params_from_jax(np_params, engine_cfg.model, device="cpu",
                                    rank=comm.rank, tp=comm.world)
    engine = TorchEngine(engine_cfg, model=model, device="cpu", comm=comm)
    if comm.rank != 0:
        return engine.follow()
    try:
        tokens = asyncio.run(asyncio.wait_for(_collect_all(engine, requests), 120))
    finally:
        engine.stop()
    return tokens, engine.tp_reports, engine.metrics()


def all_reduce_once(comm, value: float):
    """One sum over the ranks of ``value + rank`` (and the comm's counts)."""
    import torch

    x = torch.tensor([value + comm.rank], dtype=torch.float32)
    comm.all_reduce(x)
    return float(x[0]), comm.stats()["calls"]


def ring_cases(comm, sp: int, cases):
    """This sp rank's ``ring_attention`` output on its sequence shard of
    each case ``(q, k, v, pos)`` (whole numpy arrays, T on axis 1), the
    K/V blocks rotating over gloo; the shards, numpy, in case order."""
    import torch

    from dynamo_exp_tpu_torch.ops.ring_attention import ring_attention
    from dynamo_exp_tpu_torch.parallel.comm import sp_tp_comms

    _, ring = sp_tp_comms(comm, sp, 1)
    outs = []
    for q, k, v, pos in cases:
        n = q.shape[1] // sp
        part = slice(ring.rank * n, (ring.rank + 1) * n)
        t = [torch.from_numpy(np.ascontiguousarray(a[:, part])) for a in (q, k, v, pos)]
        outs.append(ring_attention(t[0], t[1], t[2], t[3], t[3], ring).numpy())
    return outs, ring.calls


def ring_prefill(comm, np_params, cfg, tokens, sp: int, tp: int):
    """``forward_ring_prefill`` on this rank of an (sp, tp) layout, the
    model this rank's tp shard of ``np_params``: (logits, k, v) of its
    sequence shard (and its kv heads), numpy."""
    import torch

    from dynamo_exp_tpu_torch.models import convert, llama
    from dynamo_exp_tpu_torch.parallel.comm import sp_tp_comms

    tp_comm, ring = sp_tp_comms(comm, sp, tp)
    tp_rank = comm.rank % tp
    model = convert.params_from_jax(np_params, cfg, device="cpu", rank=tp_rank, tp=tp)
    toks = torch.tensor(tokens, dtype=torch.int64)
    pos = torch.arange(toks.shape[1], dtype=torch.int64)[None].expand_as(toks)
    logits, k, v = llama.forward_ring_prefill(model, cfg, toks, pos, ring=ring, comm=tp_comm)
    return logits.numpy(), k.numpy(), v.numpy()


def ring_cases_and_prefill(comm, cases, np_params, cfg, tokens):
    """:func:`ring_cases` then :func:`ring_prefill` on one sp=2 group."""
    return ring_cases(comm, 2, cases), ring_prefill(comm, np_params, cfg, tokens, 2, 1)


# -------------------------------------------- the KV tiers under tensor parallelism
def engine_scenario(comm, np_params, engine_cfg, scenario: str, args=(), read_pids=(),
                    perturb: bool = False):
    """A ``TorchEngine`` over this rank's shard of ``np_params``: rank 0
    runs the async ``scenario`` (a function of this module, named) as
    ``scenario(engine, np_params, *args)`` and stops the engine; the
    others follow. Every rank returns (the scenario's result on rank 0,
    else None; every rank's report; rank 0's metrics, else None; this
    rank's K and V of ``read_pids``, numpy). ``perturb``: a follower
    counts one page gather it never made (the stop must then raise)."""
    import asyncio

    from dynamo_exp_tpu_torch.engine import TorchEngine
    from dynamo_exp_tpu_torch.models import convert

    model = convert.params_from_jax(np_params, engine_cfg.model, device="cpu",
                                    rank=comm.rank, tp=comm.world)
    engine = TorchEngine(engine_cfg, model=model, device="cpu", comm=comm)
    result = metrics = None
    if comm.rank != 0:
        if perturb:
            engine.page_moves["gather"]["calls"] += 1
        reports = engine.follow()
    else:
        try:
            result = asyncio.run(asyncio.wait_for(
                globals()[scenario](engine, np_params, *args), 150))
        finally:
            try:
                engine.stop()
            except RuntimeError as e:
                result = ("stop raised", str(e))
        reports, metrics = engine.tp_reports, engine.metrics()
    pids = list(read_pids)
    kv = (engine.k_cache[:, pids].numpy(), engine.v_cache[:, pids].numpy())
    return result, reports, metrics, kv


def local_engine(np_params, engine_cfg):
    """A tp=1 ``TorchEngine`` on the CPU over the whole ``np_params``."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.engine import TorchEngine
    from dynamo_exp_tpu_torch.models import convert

    cfg = replace(engine_cfg, tp=1)
    return TorchEngine(cfg, model=convert.params_from_jax(np_params, cfg.model, device="cpu"),
                       device="cpu")


def _body(prompt, n, **so) -> dict:
    return {"token_ids": list(prompt), "stop_conditions": {"max_tokens": n, "ignore_eos": True},
            "sampling_options": so}


async def _tokens(engine, prompt, n, ctx=None) -> list[int]:
    stream = await engine.generate(_body(prompt, n), ctx)
    return [t async for item in stream for t in (item.get("token_ids") or [])]


def resident_pids(engine, prompt) -> list[int]:
    """The device pages of ``prompt``'s full blocks resident in the
    engine's prefix cache (call with the loop paused)."""
    from dynamo_exp_tpu_torch.tokens import compute_block_hashes_for_seq

    hashes = compute_block_hashes_for_seq(list(prompt), engine.cfg.page_size)
    return engine.kv.match_resident_hashes(hashes)


async def serve(engine, _np_params, requests):
    """``requests`` admitted together; their tokens."""
    return await _collect_all(engine, requests)


async def serve_then_gather(engine, _np_params, prompt):
    """``prompt`` served (one token), then its resident full pages on
    the host through the engine's page gather (the wire's extract):
    (pids, K pages, V pages), numpy, page-major."""
    await _tokens(engine, prompt, 1)
    with engine.hold_admission():
        pids = resident_pids(engine, prompt)
        pages = engine._pages_to_host(pids)
    return pids, [k.numpy() for k, _ in pages], [v.numpy() for _, v in pages]


async def inject_pages(engine, _np_params, pids, k_pages, v_pages):
    """Whole host pages (numpy, ``[L, ps, Hkv*D]`` each) injected into
    device pages ``pids`` through the engine's page scatter."""
    import torch

    with engine.hold_admission():
        engine._inject_page_batch(
            list(pids), torch.from_numpy(np.stack(k_pages, 1)),
            torch.from_numpy(np.stack(v_pages, 1)), op="inject")
    return list(pids)


async def gather_then_inject(engine, np_params, prompt, pids, k_pages, v_pages):
    """:func:`serve_then_gather` of ``prompt``, then :func:`inject_pages`
    into ``pids`` (pages the prompt does not hold): the gather's result
    and each rank's moves after the gather."""
    gathered = await serve_then_gather(engine, np_params, prompt)
    moves = {k: dict(v) for k, v in engine.page_moves.items()}
    await inject_pages(engine, np_params, pids, k_pages, v_pages)
    return gathered, moves


async def serve_and_count(engine, _np_params, requests):
    """``requests`` admitted together under KV pressure: (tokens, the
    engine's swaps out and in, preemptions, rank 0's page moves)."""
    tokens = await _collect_all(engine, requests)
    return (tokens, engine.swapped_out, engine.swapped_in, engine.preempted,
            {k: dict(v) for k, v in engine.page_moves.items()})


async def serve_twice(engine, _np_params, requests):
    """``requests`` together, then again after the G1 prefix cache is
    dropped (the second pass restores from the tiers): both passes'
    tokens and the prefix hits by tier after each."""
    first = await _collect_all(engine, requests)
    hits = dict(engine.kv.prefix_hits)
    with engine.hold_admission():
        engine.reset_prefix_cache()
    second = await _collect_all(engine, requests)
    return first, second, hits, dict(engine.kv.prefix_hits)


async def pin_and_read(engine, _np_params, prefix, prompt):
    """``prefix`` served, then ``pin_prefix(prompt)``: (pages pinned,
    lease granted, the leases active), the lease then confirmed."""
    import asyncio

    await _tokens(engine, prefix, 1)
    n, lease = await engine.pin_prefix(prompt)
    active = engine.kv.active_leases
    if lease is not None:
        engine.confirm_kv_lease(lease)
    for _ in range(200):
        if engine.kv.active_leases == 0:
            break
        await asyncio.sleep(0.01)
    return n, lease is not None, active, engine.kv.active_leases


async def thread_of_page_moves(engine, _np_params, prompt, n):
    """``prompt`` streamed while ``reclaim_extract`` is called from this
    (the asyncio) thread mid-stream: the threads every page collective
    ran on, and the extract's result."""
    import threading

    comm = engine.comm
    threads = []
    gather = comm.gather

    def spy(*a, **k):
        threads.append(threading.current_thread().name)
        return gather(*a, **k)

    comm.gather = spy
    _slow_consume(engine)
    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext

    ctx = AsyncEngineContext("mover")
    import asyncio

    task = asyncio.ensure_future(_tokens(engine, prompt, n, ctx))
    await _wait_inflight(engine, "mover", 1)
    res = await engine.reclaim_extract("mover", 5.0)
    await task
    if res is not None:
        engine.confirm_kv_lease(res[2])
    return threads, threading.current_thread().name, res is not None and len(res[1])


def _slow_consume(engine, s: float = 0.02) -> None:
    """Slow each consumed window, so a stream stays in flight."""
    import time

    consume = engine._consume_windowed

    def slow(pending):
        time.sleep(s)
        return consume(pending)

    engine._consume_windowed = slow


async def _wait_inflight(engine, request_id, min_pages):
    import asyncio

    while True:
        for snap in await engine.reclaim_inflight():
            if snap["request_id"] == request_id and snap["full_pages"] >= min_pages:
                return snap
        await asyncio.sleep(0.002)


async def serve_in_turn(engine, _np_params, prompts, n):
    """Each prompt served alone, in order: their tokens and the engine's
    prefix hits by tier after the last."""
    out = [await _tokens(engine, p, n) for p in prompts]
    return out, dict(engine.kv.prefix_hits)


async def disagg_across(engine, np_params, direction: str, prompt, n, prefix_pages: int):
    """A disaggregated pair across tp degrees: ``direction``
    ``"tp2_prefill"`` puts this tp=2 engine on the prefill side and a
    tp=1 engine of this process on the decode side, ``"tp2_decode"`` the
    reverse; an in-process work queue, the real TCP KV plane. The decode
    side's local tokens for ``prompt`` first; then, each after both
    prefix caches are dropped, a whole transfer and a suffix-only one
    (the decode side first holds the prompt's first ``prefix_pages``
    pages, a shorter prompt served, so ``pin_prefix`` gives
    ``skip_blocks``). Returns, by case (``whole``, ``suffix_only``):
    (remote tokens, local tokens, the pair's counters in that case)."""
    import asyncio

    from dynamo_exp_tpu_torch import disagg
    from dynamo_exp_tpu_torch.disagg.transfer import wire_checksum_failures
    from dynamo_exp_tpu_torch.runtime.runtime import CancellationToken
    from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcDiscovery, InProcWorkQueue

    other = local_engine(np_params, engine.cfg)
    pre, dec = (engine, other) if direction == "tp2_prefill" else (other, engine)

    def totals(dis, worker) -> dict:
        return dict(remote=dis.remote_prefills, fallbacks=dis.local_fallbacks,
                    skipped=dis.blocks_skipped, served=worker.served,
                    extracted=pre.metrics()["kv_extract_pages"],
                    injected=dec.metrics()["kv_inject_pages"],
                    checksum_failures=wire_checksum_failures())

    try:
        want = await _tokens(dec, prompt, n)
        queue, cancel = InProcWorkQueue(), CancellationToken()
        recv = disagg.KvPageReceiver()
        await recv.start()
        worker = disagg.PrefillWorker(pre, queue, cancel)
        watcher = disagg.DisaggConfigWatcher(
            InProcDiscovery(), "m", default=disagg.DisaggConfig(max_local_prefill_length=0))
        dis = disagg.DisaggDecodeEngine(dec, queue, recv, watcher)
        task = asyncio.ensure_future(worker.run())
        out = {}
        try:
            for case, skip in (("whole", 0), ("suffix_only", prefix_pages)):
                for eng in (pre, dec):
                    with eng.hold_admission():
                        eng.reset_prefix_cache()
                if skip:
                    ps = dec.cfg.page_size
                    await _tokens(dec, list(prompt[: skip * ps]) + [5], 1)
                before = totals(dis, worker)
                got = await _tokens(dis, prompt, n)
                for _ in range(300):  # the confirms are queued for the loops
                    if pre.kv.active_leases == 0 and dec.kv.active_leases == 0:
                        break
                    await asyncio.sleep(0.01)
                after = totals(dis, worker)
                counts = {k: after[k] - before[k] for k in after}
                counts["leases"] = (pre.kv.active_leases, dec.kv.active_leases)
                out[case] = (got, want, counts)
        finally:
            cancel.cancel()
            await asyncio.wait_for(task, 10)
            await recv.close()
        return out
    finally:
        other.stop()


async def reclaim_across(engine, np_params, prompt, n):
    """A stream on this tp=2 engine, live-migrated mid-flight to a tp=1
    engine of this process: ``reclaim_extract`` here, ``seed_prefix``
    there. Then the stream's journal continuation (the prompt and the
    tokens its seeded blocks cover) on the tp=1 engine. Returns (the
    tp=2 stream's tokens, the continuation's start and tokens, blocks
    shipped, blocks seeded, the tp=1 engine's shared prefix hits)."""
    import asyncio

    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext

    survivor = local_engine(np_params, engine.cfg)
    survivor.start()  # seed_prefix is served by a running loop
    try:
        _slow_consume(engine)
        task = asyncio.ensure_future(_tokens(engine, prompt, n, AsyncEngineContext("victim")))
        # Past the prompt: the shipped blocks hold generated tokens too.
        await _wait_inflight(engine, "victim", -(-len(prompt) // engine.cfg.page_size) + 1)
        hashes, pages, lease = await engine.reclaim_extract("victim", 5.0)
        seeded = await survivor.seed_prefix(hashes, pages)
        engine.confirm_kv_lease(lease)
        tokens = await task
        ps = engine.cfg.page_size
        start = len(hashes) * ps - len(prompt) + 1  # one token past the shipped blocks
        cont = await _tokens(survivor, list(prompt) + tokens[:start], n - start)
        return tokens, start, cont, len(hashes), seeded, survivor.kv.prefix_hits["shared"]
    finally:
        survivor.stop()
