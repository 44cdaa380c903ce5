"""The KV-aware router as a service of its own.

Counterpart of ``dynamo_exp_tpu/components/router.py``: a ``KvRouter``
(``kv_router/router.py``) watches a worker component's KV events and
load metrics, and serves ``{token_ids} -> {worker_id, overlap_blocks}``
on ``<router component>.generate``, so that any ingress, not only the
Processor's embedded router, can ask which worker holds the most of a
prompt. Each answer is a routing decision: it is published on
``kv-hit-rate`` as the embedded router's are. The router learns only
the KV events published after it subscribed.

    python -m dynamo_exp_tpu_torch.components.router \
        --coordinator HOST:PORT --namespace dynamo \
        --workers CudaWorker --block-size 16 [--component kv_aware_router]

SIGTERM stops it (exit 0).
"""

from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger(__name__)


class RouterService:
    """Owns a KvRouter watching ``worker_component`` and serves it on
    ``router_component``'s ``generate`` endpoint."""

    def __init__(self, drt, namespace: str, worker_component: str, block_size: int,
                 router_component: str = "kv_aware_router"):
        from ..kv_router.router import KvRouter

        self.drt = drt
        self.router = KvRouter(drt.namespace(namespace).component(worker_component),
                               block_size=block_size)
        self.endpoint = drt.namespace(namespace).component(router_component).endpoint("generate")
        self._served = None

    async def start(self) -> int:
        from ..runtime.component import annotated_stream

        await self.router.start()

        async def handler(request: dict, context=None):
            async for frame in annotated_stream(self.router, request, context):
                yield frame

        self._served = await self.endpoint.serve_endpoint(handler)
        logger.info("kv router serving %s (watching %s)", self.endpoint.path,
                    self.router.component.path)
        return self._served.instance_id

    async def stop(self) -> None:
        if self._served is not None:
            await self._served.close()
            self._served = None
        await self.router.stop()


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..runtime.component import DistributedRuntime
    from ..runtime.config import RuntimeConfig
    from ..runtime.logging import configure_logging
    from ..runtime.runtime import run_until_signalled

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--workers", required=True,
                   help="worker component whose KV events and metrics to watch")
    p.add_argument("--block-size", type=int, required=True)
    p.add_argument("--component", default="kv_aware_router")
    args = p.parse_args(argv)
    configure_logging()

    async def run():
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=args.coordinator))
        svc = RouterService(drt, args.namespace, args.workers, args.block_size, args.component)
        try:
            print(f"kv router instance {await svc.start()}", flush=True)
            await asyncio.Event().wait()
        finally:
            await svc.stop()
            await drt.close()

    run_until_signalled(run())


if __name__ == "__main__":
    main()
