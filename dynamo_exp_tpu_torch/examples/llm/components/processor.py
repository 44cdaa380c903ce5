"""Processor: tokenize, route, detokenize: the OpenAI-level middle tier.

Counterpart of ``examples/llm/components/processor.py``: the port's
OpenAIPreprocessor -> Backend (incremental detokenize, stop strings) ->
a routed core over the CudaWorker fleet (``router: random | round-robin
| kv``; ``kv`` is ``kv_router/router.py``'s KV-aware router).
"""

from __future__ import annotations

import logging

from dynamo_exp_tpu_torch.sdk import async_on_start, depends, dynamo_context, endpoint, service

from .worker import CudaWorker

logger = logging.getLogger(__name__)


@service(dynamo={"namespace": "dynamo"})
class Processor:
    # Graph edge: serving the processor launches the worker fleet; the
    # requests go through the routed core built below.
    workers = depends(CudaWorker)

    model_path: str = ""
    served_model_name: str = ""
    router: str = "round-robin"  # random | round-robin | kv
    page_size: int = 16

    def __init__(self):
        self.engine = None
        self._kv_router = None

    @async_on_start
    async def build(self) -> None:
        from dynamo_exp_tpu_torch.http.service import build_pipeline_engine
        from dynamo_exp_tpu_torch.kv_router.router import build_routed_core
        from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
        from dynamo_exp_tpu_torch.models.hub import resolve_model_path
        from dynamo_exp_tpu_torch.run import ROUTER_MODES
        from dynamo_exp_tpu_torch.runtime.push_router import RouterMode
        from dynamo_exp_tpu_torch.sdk.service import get_spec

        if self.router not in ROUTER_MODES:
            raise ValueError(f"router {self.router!r}: one of {' | '.join(ROUTER_MODES)}")
        drt = dynamo_context["runtime"]
        path = resolve_model_path(self.model_path)
        mdc = ModelDeploymentCard.from_local_path(path, self.served_model_name or None)
        mdc.kv_cache_block_size = self.page_size
        spec = get_spec(CudaWorker)
        ep = drt.namespace(spec.namespace).component(spec.component_name).endpoint("generate")
        core, self._kv_router = await build_routed_core(ep, RouterMode[ROUTER_MODES[self.router]],
                                                        mdc.kv_cache_block_size)
        self.engine = build_pipeline_engine(mdc, core)

    @endpoint()
    async def generate(self, request: dict):
        """{"request": <OpenAI dict>} in, OpenAI chunk dicts out."""
        # Graph services boot together; the first request waits for the
        # worker fleet to be discoverable instead of failing.
        await self.workers.wait_ready(1, timeout_s=120.0)
        stream = await self.engine.generate(request.get("request", request))
        async for chunk in stream:
            yield chunk.to_dict()
