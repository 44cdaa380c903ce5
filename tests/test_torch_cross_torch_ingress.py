"""A torch ingress routes to a JAX worker, over TCP, through either
package's coordinator (a case each), on the CPU.

The worker is the JAX CLI in its own process (``python -m
dynamo_exp_tpu.run in=dyn://… out=tpu``, float32 checkpoint, XLA
attention on the CPU); the ingress is the port's ``run.main_async``
(``in=http out=dyn://… --router-mode kv``, no ``--model-path``: the
model arrives through the port's ``ModelWatcher`` from the card the JAX
worker published). Checked: the model appears; a greedy completion over
HTTP gives the text of a single ``TPUEngine``'s tokens on the same
weights; token-level requests through the port's ``KvPushRouter`` give
those tokens exactly, each routing decision on ``kv-hit-rate``; the JAX
worker's KV events, read by the port's ``KvIndexer``, carry the port's
own block hashes of the prompt and cover its full pages.
"""

import asyncio
import contextlib

import pytest

from dynamo_exp_tpu.tokenizer import Tokenizer
from dynamo_exp_tpu_torch import run, tokens
from dynamo_exp_tpu_torch.http import client
from dynamo_exp_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT, KvIndexer, kv_events_subject
from dynamo_exp_tpu_torch.kv_router.router import build_routed_core
from dynamo_exp_tpu_torch.runtime import DistributedRuntime, RouterMode
from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig

from .torch_cross import (
    COORDINATORS, PAGE, SHAPE, checkpoint_dir, greedy_request, prompts, reference_tokens, spawn, stop,
    wait_for_model,
)

N = 8


@pytest.mark.parametrize("coordinator", list(COORDINATORS))
def test_torch_ingress_routes_to_a_jax_worker(coordinator, tiny_model_dir, tmp_path):
    model_dir = checkpoint_dir(tiny_model_dir, str(tmp_path / "ckpt"))
    tok = Tokenizer.from_pretrained(model_dir)
    ps = prompts(2, tok.vocab_size)
    want = reference_tokens(model_dir, ps, N)

    async def scenario():
        server = COORDINATORS[coordinator]()
        await server.start()
        worker = spawn("dynamo_exp_tpu.run", "in=dyn://y.worker.generate", "out=tpu",
                       "--model-path", model_dir, "--model-name", "tiny",
                       "--coordinator", server.address, *SHAPE)
        opts = run.parse_args(["in=http", "out=dyn://y.worker.generate", "--coordinator",
                               server.address, "--http-host", "127.0.0.1", "--http-port",
                               "0", "--router-mode", "kv"])
        ready = asyncio.get_running_loop().create_future()
        ingress = asyncio.ensure_future(run.main_async(opts, ready))
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
        indexer = KvIndexer(PAGE)
        subject = kv_events_subject("y/components/worker")
        await indexer.start(drt.event_plane, subject)
        events = await drt.event_plane.subscribe(subject)
        hits = await drt.event_plane.subscribe(KV_HIT_RATE_SUBJECT)
        kv_router = None
        try:
            served = await asyncio.wait_for(ready, 30)
            base = f"http://127.0.0.1:{served.port}"
            await wait_for_model(base, "tiny", [worker], timeout_s=120)
            ep = drt.namespace("y").component("worker").endpoint("generate")
            core, kv_router = await build_routed_core(ep, RouterMode.KV, PAGE)
            r = await client.request(base + "/v1/completions", "POST", {
                "model": "tiny", "prompt": ps[0], "max_tokens": N, "temperature": 0,
                "ignore_eos": True})
            assert r.status == 200, r.body
            text = r.json()["choices"][0]["text"]
            first = [await asyncio.wait_for(anext(events), 10) for _ in range(2)]
            for _ in range(50):
                if kv_router.indexer.find_matches_for_request(ps[0]).best() == 2:
                    break
                await asyncio.sleep(0.1)
            got = []
            for p in ps:
                stream = await core.generate(greedy_request(p, N))
                got.append([t async for f in stream for t in (f.get("token_ids") or [])])
            decisions = [await asyncio.wait_for(anext(hits), 10) for _ in range(3)]
            return text, got, first, decisions, indexer.find_matches_for_request(ps[0]).scores
        finally:
            if kv_router is not None:
                await kv_router.stop()
            await indexer.stop()
            ingress.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await ingress
            out = await stop(worker)
            await drt.close()
            await server.close()
            assert "worker serving dyn://y.worker.generate" in out, out

    text, got, first, decisions, scores = asyncio.run(asyncio.wait_for(scenario(), 240))
    assert got == want and all(len(t) == N for t in got)
    assert text == tok.decode(want[0])
    hashes = tokens.compute_block_hashes_for_seq(ps[0], PAGE)
    assert [(e["kind"], e["block_hashes"]) for e in first] == [("stored", [h]) for h in hashes]
    assert list(scores.values()) == [2]
    # The HTTP request (the ingress's own router), then the two token-level
    # requests through a router that indexed the worker's events: ps[0]
    # again overlaps its 2 pages.
    assert [(d["isl_blocks"], d["overlap_blocks"]) for d in decisions] == [(2, 0), (2, 2), (1, 0)]
