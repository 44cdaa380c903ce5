"""Request tracing, metric families, SLO attribution, the flight recorder
and per-dispatch profiling (counterpart of ``dynamo_exp_tpu/telemetry/``,
trimmed to the parts the port feeds; ``prom.py`` stands in for
``prometheus_client``).

``fleet.py`` holds the per-link transfer ledger and the fleet view;
``fingerprint.py`` only its drift threshold. Waits for a later slice
(ROADMAP Queue 1): ``anatomy.py``, the rest of ``fingerprint.py``,
``timeline.py`` and ``bench_compare.py``.
"""

from .context import (
    TraceContext,
    attach,
    current_span_id,
    current_trace,
    current_trace_id,
    detach,
    new_trace,
    wire_headers,
)
from .dispatch import DISPATCH_KINDS, DispatchProfiler
from .flight import (
    FlightRecorder,
    Watchdog,
    dump_all,
    install_sigusr1,
    load_dumps,
    register_dumper,
    render_flight,
    unregister_dumper,
)
from .prom import CONTENT_TYPE_LATEST, Counter, Gauge, Histogram, Registry
from .slo import BURN_WINDOWS, SloAttribution, SloConfig, percentile
from .spans import Span, Telemetry, adopt, get_telemetry, span

__all__ = [
    "BURN_WINDOWS",
    "CONTENT_TYPE_LATEST",
    "DISPATCH_KINDS",
    "Counter",
    "DispatchProfiler",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "SloAttribution",
    "SloConfig",
    "Span",
    "Telemetry",
    "TraceContext",
    "Watchdog",
    "adopt",
    "attach",
    "current_span_id",
    "current_trace",
    "current_trace_id",
    "detach",
    "dump_all",
    "get_telemetry",
    "install_sigusr1",
    "load_dumps",
    "new_trace",
    "percentile",
    "register_dumper",
    "render_flight",
    "span",
    "unregister_dumper",
    "wire_headers",
]
