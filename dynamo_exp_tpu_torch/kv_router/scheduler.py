"""KV-aware worker selection.

Counterpart of ``dynamo_exp_tpu/kv_router/scheduler.py``, with the same
cost and tie rule:

    logit = 2 * overlap_ratio - gpu_cache_usage - normalized_active
            - queue_weight * waiting / total_slots

the highest logit wins; logits within 1e-12 tie and the selector's
``random.Random`` picks among them (``rng.choice`` over the tied ids in
metrics order), so equal seeds pick equal workers.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Protocol

from .protocols import ForwardPassMetrics, OverlapScores


@dataclass
class ProcessedEndpoints:
    """Live worker set + metrics snapshot."""

    metrics: dict[int, ForwardPassMetrics] = field(default_factory=dict)

    @property
    def worker_ids(self) -> list[int]:
        return list(self.metrics)


class WorkerSelector(Protocol):
    def select_worker(
        self,
        endpoints: ProcessedEndpoints,
        overlaps: OverlapScores,
        isl_tokens: int,
        block_size: int,
    ) -> tuple[int, int]:
        """Returns (worker_id, overlap_blocks). Raises if no workers."""
        ...


class NoWorkersError(RuntimeError):
    pass


class DefaultWorkerSelector:
    def __init__(
        self, rng: random.Random | None = None, queue_weight: float = 1.0
    ):
        self.rng = rng or random.Random()
        # Weight of the queue-depth penalty (waiting / total_slots). 0
        # drops the queue term; 1.0 makes one slot-envelope
        # of backlog as repulsive as a fully busy decode batch.
        self.queue_weight = queue_weight

    def select_worker(
        self,
        endpoints: ProcessedEndpoints,
        overlaps: OverlapScores,
        isl_tokens: int,
        block_size: int,
    ) -> tuple[int, int]:
        if not endpoints.metrics:
            raise NoWorkersError("no live workers")
        best_ids: list[int] = []
        best_logit = -float("inf")
        for wid, m in endpoints.metrics.items():
            matched = overlaps.scores.get(wid, 0)
            overlap_ratio = (
                matched * block_size / isl_tokens if isl_tokens > 0 else 0.0
            )
            normalized_active = (
                m.request_active_slots / m.request_total_slots
                if m.request_total_slots
                else 0.0
            )
            normalized_waiting = (
                m.num_requests_waiting / m.request_total_slots
                if m.request_total_slots
                else float(m.num_requests_waiting > 0)
            )
            logit = (
                2.0 * overlap_ratio
                - m.gpu_cache_usage_perc
                - normalized_active
                - self.queue_weight * normalized_waiting
            )
            if logit > best_logit + 1e-12:
                best_logit = logit
                best_ids = [wid]
            elif abs(logit - best_logit) <= 1e-12:
                best_ids.append(wid)
        wid = self.rng.choice(best_ids)
        return wid, overlaps.scores.get(wid, 0)
