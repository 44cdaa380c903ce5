"""The service SDK: decorate classes, link them into graphs, serve each
component as its own process.

Counterpart of ``dynamo_exp_tpu/sdk/``: ``@service``, ``@endpoint``
(also spelled ``dynamo_endpoint``), ``@async_on_start``,
``@stats_handler``, ``depends()``, ``dynamo_context`` and
``ServiceConfig``; ``python -m dynamo_exp_tpu_torch.sdk.serve`` runs a
graph with one watcher a worker process and card slots from
``CudaAllocator``. Configs are JSON (the JAX package reads YAML).
"""

from .config import ServiceConfig
from .dependency import DependencyClient, depends
from .service import (
    async_on_start,
    dynamo_context,
    endpoint,
    get_spec,
    service,
    stats_handler,
)

dynamo_endpoint = endpoint

__all__ = [
    "service",
    "endpoint",
    "dynamo_endpoint",
    "async_on_start",
    "depends",
    "DependencyClient",
    "dynamo_context",
    "ServiceConfig",
    "get_spec",
    "stats_handler",
]
