"""Request tracing, metric families, SLO attribution, the flight recorder,
per-dispatch profiling, the request anatomy and the workload
fingerprint (counterpart of ``dynamo_exp_tpu/telemetry/``; ``prom.py``
stands in for ``prometheus_client``).

``fleet.py`` holds the per-link transfer ledger and the fleet view;
``anatomy.py`` splits a request's wall into components (from spans, a
flight dump, or the engine's own stamps); ``fingerprint.py`` summarizes
a workload into a digest and scores its drift; ``timeline.py`` reads
span files back into traces; ``bench_compare.py`` compares two bench
captures.

Under tensor parallelism the families (the JAX package's) are rank 0's,
which serves: its KV transfers, page moves by op and tier hits. Each
rank counts its own page moves (``TorchEngine.metrics()["tp_page_moves"]``)
and its page collectives' calls, bytes and seconds (``Comm.stats()``);
rank 0 gathers them by rank at stop (``engine/tp.py``'s reports, the
``{"tp": ...}`` line of ``run.py``).
"""

from .anatomy import (
    COMPONENTS,
    AnatomyRing,
    RequestAnatomy,
    anatomy_from_flight,
    anatomy_from_spans,
    anatomy_from_timing,
    render_anatomy,
    render_slow,
)
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
from .fingerprint import (
    FingerprintBuilder,
    WorkloadDriftWatch,
    WorkloadFingerprint,
    drift_score,
    fingerprint_from_bench,
    fingerprint_from_spans,
    fingerprint_from_trace,
    load_fingerprint,
    render_fingerprint,
    replay_workload,
)
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
from .timeline import (
    find_trace,
    list_traces,
    load_spans,
    render_timeline,
    transfer_hops,
)

__all__ = [
    "AnatomyRing",
    "BURN_WINDOWS",
    "COMPONENTS",
    "CONTENT_TYPE_LATEST",
    "Counter",
    "DISPATCH_KINDS",
    "DispatchProfiler",
    "FingerprintBuilder",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "RequestAnatomy",
    "SloAttribution",
    "SloConfig",
    "Span",
    "Telemetry",
    "TraceContext",
    "Watchdog",
    "WorkloadDriftWatch",
    "WorkloadFingerprint",
    "adopt",
    "anatomy_from_flight",
    "anatomy_from_spans",
    "anatomy_from_timing",
    "attach",
    "current_span_id",
    "current_trace",
    "current_trace_id",
    "detach",
    "drift_score",
    "dump_all",
    "find_trace",
    "fingerprint_from_bench",
    "fingerprint_from_spans",
    "fingerprint_from_trace",
    "get_telemetry",
    "install_sigusr1",
    "list_traces",
    "load_dumps",
    "load_fingerprint",
    "load_spans",
    "new_trace",
    "percentile",
    "register_dumper",
    "render_anatomy",
    "render_fingerprint",
    "render_flight",
    "render_slow",
    "render_timeline",
    "replay_workload",
    "span",
    "transfer_hops",
    "unregister_dumper",
    "wire_headers",
]
