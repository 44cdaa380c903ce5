"""Prometheus metrics of the HTTP service.

Counterpart of ``dynamo_exp_tpu/http/metrics.py``: request counters by
model, endpoint, request type and status, request duration and TTFT
histograms, and in-flight gauges (the ``llm_http_service_*`` families),
rendered on ``/metrics`` together with the process's telemetry registry
(``telemetry/spans.py``). Built on ``telemetry/prom.py`` in place of
``prometheus_client``.
"""

from __future__ import annotations

import time

from ..telemetry import CONTENT_TYPE_LATEST, get_telemetry
from ..telemetry.prom import Counter, Gauge, Histogram, Registry

__all__ = ["CONTENT_TYPE_LATEST", "RequestTracker", "ServiceMetrics"]


class ServiceMetrics:
    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.requests_total = Counter(
            "llm_http_service_requests_total",
            "Total HTTP requests",
            ["model", "endpoint", "request_type", "status"],
            registry=self.registry,
        )
        self.request_duration = Histogram(
            "llm_http_service_request_duration_seconds",
            "End-to-end request duration",
            ["model", "endpoint"],
            registry=self.registry,
        )
        self.inflight = Gauge(
            "llm_http_service_inflight_requests",
            "Currently executing requests",
            ["model", "endpoint"],
            registry=self.registry,
        )
        self.time_to_first_token = Histogram(
            "llm_http_service_time_to_first_token_seconds",
            "TTFT for streaming requests",
            ["model", "endpoint"],
            registry=self.registry,
        )

    def render(self) -> bytes:
        """The service's families, then the process telemetry registry's."""
        return self.registry.render() + get_telemetry().render()

    def track(self, model: str, endpoint: str, request_type: str) -> "RequestTracker":
        return RequestTracker(self, model, endpoint, request_type)

    def count_shed(self, model: str, endpoint: str, status: int) -> None:
        """One request refused by admission (429/503): request type
        ``shed``, status ``shed_<code>``; the per-priority count is
        ``dynamo_requests_shed_total``."""
        self.requests_total.labels(model, endpoint, "shed", f"shed_{status}").inc()


class RequestTracker:
    """Context manager recording one request's metrics."""

    def __init__(self, metrics: ServiceMetrics, model: str, endpoint: str, request_type: str):
        self._m = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_type = request_type
        self._start = 0.0
        self._first_token_seen = False
        self.status = "success"

    def __enter__(self) -> "RequestTracker":
        self._start = time.monotonic()
        self._m.inflight.labels(self.model, self.endpoint).inc()
        return self

    def first_token(self) -> None:
        if not self._first_token_seen:
            self._first_token_seen = True
            self._m.time_to_first_token.labels(self.model, self.endpoint).observe(
                time.monotonic() - self._start
            )

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.status == "success":
            self.status = "error"
        self._m.inflight.labels(self.model, self.endpoint).dec()
        self._m.requests_total.labels(
            self.model, self.endpoint, self.request_type, self.status
        ).inc()
        self._m.request_duration.labels(self.model, self.endpoint).observe(
            time.monotonic() - self._start
        )
