"""Service graphs the port's SDK and planner tests serve: the three-stage
hello-world pipeline (Frontend -> Middle -> Backend, namespace
``hello``), and a worker whose reported KV load tracks its in-flight
requests (namespace ``plan``), so synthetic load drives the planner."""

from __future__ import annotations

import asyncio

from dynamo_exp_tpu_torch.sdk import depends, endpoint, service, stats_handler


@service(dynamo={"namespace": "hello"})
class Backend:
    """Generates tokens from the (twice-decorated) request text."""

    @endpoint()
    async def generate(self, request: dict):
        text = request.get("text", "")
        for word in f"{text}-back".split(","):
            yield {"token": word}


@service(dynamo={"namespace": "hello"})
class Middle:
    backend = depends(Backend)

    @endpoint()
    async def generate(self, request: dict):
        text = request.get("text", "")
        stream = await self.backend.generate({"text": f"{text}-mid"})
        async for item in stream:
            yield item


@service(dynamo={"namespace": "hello"})
class Frontend:
    middle = depends(Middle)

    greeting = "hello"  # ServiceConfig: {"Frontend": {"greeting": ...}}

    @endpoint()
    async def generate(self, request: dict):
        text = f"{self.greeting},{request.get('text', '')}"
        stream = await self.middle.generate({"text": text})
        async for item in stream:
            yield item


@service(dynamo={"namespace": "plan"}, resources={"gpu": 1}, workers=1)
class LoadWorker:
    SLOTS = 4

    def __init__(self):
        self.active = 0

    @endpoint("generate")
    async def generate(self, request):
        self.active += 1
        try:
            for i in range(int(request.get("steps", 40))):
                await asyncio.sleep(0.05)
                yield {"token": i}
        finally:
            self.active -= 1

    @stats_handler
    def stats(self) -> dict:
        usage = min(self.active / self.SLOTS, 1.0)
        return {
            "request_active_slots": self.active,
            "request_total_slots": self.SLOTS,
            "kv_active_blocks": self.active * 10,
            "kv_total_blocks": self.SLOTS * 10,
            "num_requests_waiting": max(self.active - self.SLOTS, 0),
            "gpu_cache_usage_perc": usage,
            "gpu_prefix_cache_hit_rate": 0.0,
        }
