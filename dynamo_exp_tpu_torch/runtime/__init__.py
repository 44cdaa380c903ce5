"""The distributed runtime (counterpart of ``dynamo_exp_tpu/runtime/``):
engines and contexts, the component model, discovery and the request
planes, routing with health, retries and resumable streams.

``reclaim.py`` is the spot-reclaim plane (triage and live KV
migration); ``profiler.py`` the ``torch.profiler`` capture hooks and
their ``--profiler-port`` listener. Waits for a later slice (ROADMAP
Queue 1): ``pool.py``, the pipeline node graph beyond ``Operator`` /
``build_pipeline`` and ``transports/chaos.py``.
"""

from .annotated import Annotated
from .client import Client, EngineError
from .component import (
    DRAIN_PREFIX,
    Component,
    DistributedRuntime,
    Endpoint,
    Namespace,
    ServedInstance,
    annotated_stream,
)
from .config import RuntimeConfig
from .engine import (
    AsyncEngine,
    AsyncEngineContext,
    DeadlineExceededError,
    LambdaEngine,
    ResponseStream,
)
from .health import BreakerState, CircuitBreaker, HealthTracker, is_draining
from .journal import ReplayJournal
from .logging import configure_logging
from .pipeline import Operator, build_pipeline
from .push_router import (
    NoHealthyInstancesError,
    NoInstancesError,
    PushRouter,
    RecoveryExhaustedError,
    RouterMode,
)
from .runtime import CancellationToken, Runtime, Worker
from .transports.base import EndpointAddress, InstanceInfo, Lease

__all__ = [
    "Annotated",
    "AsyncEngine",
    "AsyncEngineContext",
    "BreakerState",
    "CancellationToken",
    "CircuitBreaker",
    "Client",
    "Component",
    "DRAIN_PREFIX",
    "DeadlineExceededError",
    "DistributedRuntime",
    "Endpoint",
    "EndpointAddress",
    "EngineError",
    "HealthTracker",
    "InstanceInfo",
    "LambdaEngine",
    "Lease",
    "Namespace",
    "NoHealthyInstancesError",
    "NoInstancesError",
    "Operator",
    "PushRouter",
    "RecoveryExhaustedError",
    "ReplayJournal",
    "ResponseStream",
    "RouterMode",
    "Runtime",
    "RuntimeConfig",
    "ServedInstance",
    "Worker",
    "annotated_stream",
    "build_pipeline",
    "configure_logging",
    "is_draining",
]
