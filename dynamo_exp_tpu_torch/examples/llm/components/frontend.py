"""Frontend: the OpenAI HTTP ingress of the LLM graphs.

Counterpart of ``examples/llm/components/frontend.py``: the port's
OpenAI service (``http/service.py``) runs in this service's process;
chat and completion requests go to the Processor over the request plane
and stream back as SSE.
"""

from __future__ import annotations

import logging

from dynamo_exp_tpu_torch.sdk import async_on_start, depends, service

from .processor import Processor

logger = logging.getLogger(__name__)


class _RemoteOpenAIEngine:
    """AsyncEngine adapter: OpenAI request dict -> the Processor's
    ``generate`` endpoint -> OpenAI chunk dicts (the service types them)."""

    def __init__(self, dep):
        self.dep = dep

    async def generate(self, request: dict, context=None):
        from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext, ResponseStream

        ctx = context or AsyncEngineContext()
        stream = await self.dep.generate({"request": request})
        return ResponseStream(stream, ctx)


@service(dynamo={"namespace": "dynamo"})
class Frontend:
    processor = depends(Processor)

    served_model_name: str = "model"
    port: int = 8000
    host: str = "0.0.0.0"

    def __init__(self):
        self.service = None

    @async_on_start
    async def start_http(self) -> None:
        from dynamo_exp_tpu_torch.http.service import HttpService

        self.service = HttpService(host=self.host, port=self.port)
        engine = _RemoteOpenAIEngine(self.processor)
        self.service.manager.add_chat_model(self.served_model_name, engine)
        self.service.manager.add_completion_model(self.served_model_name, engine)
        port = await self.service.start()
        logger.info("frontend listening on %s:%d", self.host, port)
        print(f"frontend on http://{self.host}:{port}", flush=True)
