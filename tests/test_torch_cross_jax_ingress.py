"""A JAX ingress routes to a torch worker, over TCP, through either
package's coordinator (a case each), on the CPU.

The worker is the port's CLI in its own process (``python -m
dynamo_exp_tpu_torch.run in=dyn://… out=cuda --device cpu``) serving a
float32 checkpoint; the ingress is the JAX CLI's ``main_async`` (``in=http
out=dyn://… --router-mode kv``, no ``--model-path``: the model arrives
through the JAX ``ModelWatcher`` from the card the torch worker
published). Checked: the model appears; a greedy completion over HTTP
gives the text of a single ``TPUEngine``'s tokens on the same weights;
token-level requests through the JAX ``PushRouter`` give those tokens
exactly; the torch worker's KV events, read by a JAX ``KvIndexer`` on the
coordinator's event plane, carry the JAX package's own block hashes
of the prompt (its native hasher), and cover the prompt's full pages.
"""

import asyncio
import contextlib

import pytest

from dynamo_exp_tpu import run as jrun
from dynamo_exp_tpu import tokens as jtokens
from dynamo_exp_tpu.kv_router import KvIndexer, kv_events_subject
from dynamo_exp_tpu.kv_router.router import build_routed_core
from dynamo_exp_tpu.runtime import DistributedRuntime, RouterMode
from dynamo_exp_tpu.runtime.config import RuntimeConfig
from dynamo_exp_tpu.tokenizer import Tokenizer
from dynamo_exp_tpu_torch.http import client

from .fixtures import free_port
from .torch_cross import (
    COORDINATORS, PAGE, SHAPE, checkpoint_dir, greedy_request, prompts, reference_tokens, spawn, stop,
    wait_for_model,
)

N = 8


@pytest.mark.parametrize("coordinator", list(COORDINATORS))
def test_jax_ingress_routes_to_a_torch_worker(coordinator, tiny_model_dir, tmp_path):
    model_dir = checkpoint_dir(tiny_model_dir, str(tmp_path / "ckpt"))
    tok = Tokenizer.from_pretrained(model_dir)
    ps = prompts(1, tok.vocab_size)
    want = reference_tokens(model_dir, ps, N)

    async def scenario():
        server = COORDINATORS[coordinator]()
        await server.start()
        worker = spawn("dynamo_exp_tpu_torch.run", "in=dyn://x.worker.generate", "out=cuda",
                       "--device", "cpu", "--model-path", model_dir, "--model-name", "tiny",
                       "--coordinator", server.address, *SHAPE)
        port = free_port()
        opts = jrun.parse_args(["in=http", "out=dyn://x.worker.generate", "--coordinator",
                                server.address, "--http-host", "127.0.0.1", "--http-port",
                                str(port), "--router-mode", "kv"])
        ingress = asyncio.ensure_future(jrun.main_async(opts))
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=server.address))
        indexer = KvIndexer(PAGE)
        subject = kv_events_subject("x/components/worker")
        await indexer.start(drt.event_plane, subject)
        events = await drt.event_plane.subscribe(subject)
        try:
            base = f"http://127.0.0.1:{port}"
            await wait_for_model(base, "tiny", [worker])
            r = await client.request(base + "/v1/completions", "POST", {
                "model": "tiny", "prompt": ps[0], "max_tokens": N, "temperature": 0,
                "ignore_eos": True})
            assert r.status == 200, r.body
            text = r.json()["choices"][0]["text"]
            ep = drt.namespace("x").component("worker").endpoint("generate")
            core, _ = await build_routed_core(ep, RouterMode.ROUND_ROBIN, PAGE)
            got = []
            for p in ps:
                stream = await core.generate(greedy_request(p, N))
                got.append([t async for f in stream for t in (f.get("token_ids") or [])])
            for _ in range(50):
                if indexer.find_matches_for_request(ps[0]).best() >= len(ps[0]) // PAGE:
                    break
                await asyncio.sleep(0.1)
            first = [await asyncio.wait_for(anext(events), 10) for _ in range(2)]
            return text, got, indexer.find_matches_for_request(ps[0]).scores, first
        finally:
            await indexer.stop()
            ingress.cancel()
            with contextlib.suppress(asyncio.CancelledError, SystemExit):
                await ingress
            out = await stop(worker)
            await drt.close()
            await server.close()
            assert "worker serving dyn://x.worker.generate" in out, out

    text, got, scores, first = asyncio.run(asyncio.wait_for(scenario(), 240))
    assert got == want and all(len(t) == N for t in got)
    assert text == tok.decode(want[0])
    # The worker's first events are the prompt's two full pages, under
    # the JAX package's own hashes; the JAX index covers both.
    assert [(e["kind"], e["block_hashes"]) for e in first] == [
        ("stored", [h]) for h in jtokens.compute_block_hashes_for_seq(ps[0], PAGE)]
    assert list(scores.values()) == [len(ps[0]) // PAGE] == [2]
