"""PrefillCudaWorker: the prefill fleet of the disaggregated graphs.

Counterpart of ``examples/llm/components/prefill_worker.py``'s
``PrefillTpuWorker``: it pulls the prefill work queue, computes the
prompt's KV on its own ``TorchEngine`` and writes the pages to the
decode worker over the TCP transfer plane. Its ``pull`` endpoint is
presence only: the planner counts the prefill fleet through it.
"""

from __future__ import annotations

import asyncio
import logging

from dynamo_exp_tpu_torch.sdk import async_on_start, dynamo_context, endpoint, service

from .worker import build_engine, engine_argv

logger = logging.getLogger(__name__)


@service(dynamo={"namespace": "dynamo"}, resources={"gpu": 1})
class PrefillCudaWorker:
    model_path: str = ""
    served_model_name: str = ""
    random_weights: bool = False
    page_size: int = 16
    num_pages: int = 0
    max_model_len: int = 2048
    kv_dtype: str = "bfloat16"
    device: str = "cuda"

    def __init__(self):
        self.engine = None
        self.worker = None
        self._run_task = None

    @async_on_start
    async def start_engine(self) -> None:
        from dynamo_exp_tpu_torch.disagg import PrefillWorker
        from dynamo_exp_tpu_torch.planner import prefill_queue_name
        from dynamo_exp_tpu_torch.runtime.runtime import CancellationToken

        drt = dynamo_context["runtime"]
        # Prefill only: two decode slots are enough to park rows in.
        self.engine, _mdc = await asyncio.to_thread(build_engine, engine_argv(self, 2))
        self.engine.start()
        queue = drt.work_queue(prefill_queue_name(self.served_model_name or "model"))
        # No component= here: the SDK serves this service's
        # @endpoint("pull") for presence; a second registration would
        # count the fleet twice.
        self.worker = PrefillWorker(self.engine, queue, CancellationToken())
        self._run_task = asyncio.ensure_future(self.worker.run())

    @endpoint("pull")
    async def pull(self, request: dict):
        yield {
            "served": self.worker.served if self.worker else 0,
            "failed": self.worker.failed if self.worker else 0,
        }

    def stop(self) -> None:
        if self.worker is not None:
            self.worker.cancel.cancel()
        if self.engine is not None:
            self.engine.stop()
