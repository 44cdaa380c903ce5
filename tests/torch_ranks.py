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
