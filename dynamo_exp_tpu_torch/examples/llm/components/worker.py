"""CudaWorker: the engine service of the LLM graphs.

Counterpart of ``examples/llm/components/worker.py``'s ``TpuWorker``:
``TorchEngine`` (``run.build_cuda_engine``) behind a ``generate``
endpoint, configured through ServiceConfig, with its KV events published
for the KV router, its load report (``engine.metrics()``) on the stats
plane, its model card registered, and, with ``disagg_mode: decode``,
long uncached prefills sent to the prefill fleet. The engine runs on the
card (``device: cuda``); only the CPU tests set ``device: cpu``.
"""

from __future__ import annotations

import asyncio
import logging
import threading

from dynamo_exp_tpu_torch.sdk import (
    async_on_start,
    dynamo_context,
    endpoint,
    service,
    stats_handler,
)

logger = logging.getLogger(__name__)


def engine_argv(worker, max_decode_slots: int) -> list[str]:
    """``run.py`` flags for a worker's engine, from its config keys."""
    argv = ["in=http", "out=cuda", "--model-path", worker.model_path,
            "--model-name", worker.served_model_name, "--device", worker.device,
            "--max-decode-slots", str(max_decode_slots), "--page-size", str(worker.page_size),
            "--num-pages", str(worker.num_pages), "--max-model-len", str(worker.max_model_len),
            "--kv-dtype", worker.kv_dtype]
    if worker.random_weights:
        argv.append("--random-weights")
    return argv


def build_engine(argv: list[str]):
    """(TorchEngine, model card) through the CLI's engine builder; under
    a multi-node group (``dynamo_context["comm"]``) this node's rank of
    it."""
    from dynamo_exp_tpu_torch import run

    comm = dynamo_context.get("comm")
    if comm is not None:
        argv = [*argv, "--tp", str(comm.world)]
    return run.build_cuda_engine(run.parse_args(argv), comm)


def follow_then_exit(engine) -> None:
    """A follower rank of a multi-node group runs rank 0's dispatches
    until rank 0 stops, then stops this process."""
    loop = asyncio.get_running_loop()
    token = dynamo_context["runtime"].runtime.primary_token

    def follow():
        try:
            engine.follow()
        finally:
            loop.call_soon_threadsafe(token.cancel)

    threading.Thread(target=follow, name="tp-follower", daemon=True).start()


@service(dynamo={"namespace": "dynamo"}, resources={"gpu": 1})
class CudaWorker:
    """Decode (or aggregated) engine worker."""

    # ServiceConfig-overridable (configs/*.json).
    model_path: str = ""
    served_model_name: str = ""
    random_weights: bool = False
    max_decode_slots: int = 8
    page_size: int = 16
    num_pages: int = 0  # 0 = auto
    max_model_len: int = 2048
    kv_dtype: str = "bfloat16"
    device: str = "cuda"
    # "none" = aggregated; "decode" = offload long prefills to the
    # prefill fleet through the work queue and the KV transfer plane.
    disagg_mode: str = "none"
    max_local_prefill_length: int = 1000
    # Speculative decoding: "off" | a drafter name.
    spec: str = "off"
    spec_draft_len: int = 4
    spec_max_draft: int = 8
    spec_ngram: int = 3

    def __init__(self):
        self.engine = None
        self.serving = None
        self._kv_pub = None
        self._receiver = None
        self._watcher = None

    @async_on_start
    async def start_engine(self) -> None:
        from dynamo_exp_tpu_torch.local_model import register_llm

        drt = dynamo_context["runtime"]
        component = dynamo_context["component"]
        argv = engine_argv(self, self.max_decode_slots) + [
            "--spec", self.spec, "--spec-draft-len", str(self.spec_draft_len),
            "--spec-max-draft", str(self.spec_max_draft), "--spec-ngram", str(self.spec_ngram)]
        # Off the loop: building the engine (weights, pools) takes seconds,
        # and this process's coordinator keepalives must go on meanwhile.
        self.engine, mdc = await asyncio.to_thread(build_engine, argv)
        comm = dynamo_context.get("comm")
        if comm is not None and comm.rank > 0:
            follow_then_exit(self.engine)
            return
        self.engine.start()
        self.serving = self.engine
        if self.disagg_mode == "decode":
            from dynamo_exp_tpu_torch.disagg import (
                DisaggConfig,
                DisaggConfigWatcher,
                DisaggDecodeEngine,
                KvPageReceiver,
            )
            from dynamo_exp_tpu_torch.planner import prefill_queue_name

            self._receiver = KvPageReceiver()
            await self._receiver.start()
            self._watcher = DisaggConfigWatcher(
                drt.discovery,
                mdc.display_name if mdc else "model",
                default=DisaggConfig(max_local_prefill_length=self.max_local_prefill_length),
            )
            await self._watcher.start()
            queue = drt.work_queue(prefill_queue_name(self.served_model_name or "model"))
            self.serving = DisaggDecodeEngine(self.engine, queue, self._receiver, self._watcher)
        if mdc is not None:
            await register_llm(drt, component.endpoint("generate"), self.model_path,
                               self.served_model_name or None,
                               kv_cache_block_size=self.page_size)
        # KV events -> the router's index. The endpoint's instance id
        # exists once serving starts (after this hook), so the publisher
        # is wired from a deferred task.
        from dynamo_exp_tpu_torch.kv_router.publisher import KvEventPublisher

        loop = asyncio.get_running_loop()

        async def wire_kv_events():
            for _ in range(200):
                iid = dynamo_context["instance_ids"].get("generate")
                if iid is not None:
                    self._kv_pub = KvEventPublisher(drt.event_plane, component.path, iid, loop)
                    self.engine.kv.event_cb = self._kv_pub.engine_callback()
                    return
                await asyncio.sleep(0.05)
            logger.warning("generate endpoint never served; no KV events")

        self._kv_task = asyncio.ensure_future(wire_kv_events())

    @endpoint()
    async def generate(self, request: dict):
        stream = await self.serving.generate(request)
        async for item in stream:
            yield item

    @stats_handler
    def stats(self) -> dict:
        return self.engine.metrics() if self.serving is not None else {}

    def stop(self) -> None:
        """At the process's shutdown, after its endpoints closed."""
        if self.serving is not None:
            self.engine.stop()
