"""KV-cache-aware routing (counterpart of ``dynamo_exp_tpu/kv_router/``):
the worker-side publishers, the global prefix index, the metrics
aggregator, the selector and the router engines."""

from .indexer import KvIndexer, KvIndexerSharded, RadixIndex
from .metrics_aggregator import KvMetricsAggregator
from .protocols import (
    KV_HIT_RATE_SUBJECT,
    ForwardPassMetrics,
    KvCacheEventData,
    KVHitRateEvent,
    OverlapScores,
    RouterEvent,
    RouterRequest,
    RouterResponse,
    kv_events_subject,
)
from .publisher import KvEventPublisher, KvMetricsPublisher
from .router import KvPushRouter, KvRouter
from .scheduler import (
    DefaultWorkerSelector,
    NoWorkersError,
    ProcessedEndpoints,
    WorkerSelector,
)

__all__ = [
    "KvIndexer",
    "KvIndexerSharded",
    "RadixIndex",
    "KvMetricsAggregator",
    "ForwardPassMetrics",
    "KvCacheEventData",
    "KVHitRateEvent",
    "OverlapScores",
    "RouterEvent",
    "RouterRequest",
    "RouterResponse",
    "kv_events_subject",
    "KV_HIT_RATE_SUBJECT",
    "KvEventPublisher",
    "KvMetricsPublisher",
    "KvRouter",
    "KvPushRouter",
    "DefaultWorkerSelector",
    "WorkerSelector",
    "NoWorkersError",
    "ProcessedEndpoints",
]
