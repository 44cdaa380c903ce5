"""Profiling hooks: an on-demand capture listener and trace capture.

Counterpart of ``dynamo_exp_tpu/runtime/profiler.py``, on
``torch.profiler`` where the JAX module starts ``jax.profiler``:

- ``trace_to(log_dir)`` records CPU and CUDA activity of the enclosed
  block (CPU only with ``device="cpu"``) and writes a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) into
  ``log_dir``; ``capture_trace(log_dir, duration_ms)`` records that
  many milliseconds of whatever the process runs.
- ``start_profiler_server(port)`` is the counterpart of the JAX
  collection server (``run.py --profiler-port``): a small HTTP listener
  on that port whose ``GET /capture?duration_ms=N`` runs
  :func:`capture_trace` into a fresh directory and answers with a JSON
  summary naming it.

On a card the profiler must see the card: ``trace_to`` launches one
probe kernel inside the trace and raises if the recorded trace does not
hold it (no CUPTI, or CUDA activity off), rather than hand back a trace
without device time. A profile never starts or stops while the engine
captures a CUDA graph (``engine.graphs.CAPTURE_LOCK``): the profiler
allocates, and a capture runs with garbage collection off for the same
reason.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)

TRACE_NAME = "trace.json"
_PROBE = "dynamo_profiler_probe"


class TraceCapture:
    """One recorded trace: its file, and after the block the device
    kernels it holds by name (``kernels``) and its event count."""

    def __init__(self, log_dir: str, device: str):
        self.log_dir = log_dir
        self.device = device
        self.path = os.path.join(log_dir, TRACE_NAME)
        self.kernels: collections.Counter = collections.Counter()
        self.events = 0
        self.seconds = 0.0

    def count(self, *needles: str) -> int:
        """Kernel launches whose name holds any of ``needles``."""
        return sum(n for name, n in self.kernels.items() if any(k in name for k in needles))

    def summary(self) -> dict:
        return {
            "trace_dir": self.log_dir, "trace_file": self.path, "device": self.device,
            "events": self.events, "kernel_launches": sum(self.kernels.values()),
            "seconds": round(self.seconds, 6), "kernels": dict(self.kernels.most_common()),
        }


def _capture_guard(device: str):
    """The engine's graph-capture lock on a card (no capture on the CPU)."""
    if device == "cpu":
        return contextlib.nullcontext()
    from ..engine.graphs import CAPTURE_LOCK

    return CAPTURE_LOCK


def _check_cuda_profiling(torch) -> None:
    from torch.profiler import ProfilerActivity, supported_activities

    if not torch.cuda.is_available():
        raise RuntimeError("profiler: device='cuda' without a CUDA device (pass device='cpu')")
    if ProfilerActivity.CUDA not in supported_activities():
        raise RuntimeError("profiler: this torch build cannot record CUDA activity (no CUPTI)")


def _all_threads():
    """Record the CPU operators of every thread (the engine's loop thread,
    not only the caller's), where this torch build offers it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # an older build: the caller's thread only
        return None


@contextlib.contextmanager
def trace_to(log_dir: str, device: str = "cuda"):
    """Trace the enclosed block into ``log_dir/trace.json``; yields the
    :class:`TraceCapture`, filled in when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        _check_cuda_profiling(torch)
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    cap = TraceCapture(log_dir, device)
    prof = profile(activities=activities, experimental_config=_all_threads())
    with _capture_guard(device):
        prof.start()
    t0 = time.perf_counter()
    try:
        yield cap
    finally:
        if device != "cpu":
            with torch.profiler.record_function(_PROBE):
                probe = torch.zeros(1, device=device)
                probe.add_(1.0)
            torch.cuda.synchronize()
        with _capture_guard(device):
            prof.stop()
        cap.seconds = time.perf_counter() - t0
        prof.export_chrome_trace(cap.path)
    with open(cap.path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    cap.events = len(events)
    for e in events:
        if e.get("cat") == "kernel":
            cap.kernels[e.get("name", "?")] += 1
    if device != "cpu" and not cap.kernels:
        raise RuntimeError(
            f"profiler: the trace in {log_dir} holds no CUDA kernel, not even its "
            "probe's: the card's activity was not recorded")


def capture_trace(log_dir: str, duration_ms: int = 2000, device: str = "cuda") -> TraceCapture:
    """Record ``duration_ms`` of the process's activity into ``log_dir``."""
    with trace_to(log_dir, device) as cap:
        time.sleep(duration_ms / 1000.0)
    return cap


class ProfilerServer:
    """The ``--profiler-port`` listener: ``GET /capture?duration_ms=N``
    runs one capture (one at a time) into a new directory under
    ``base_dir`` and answers with its summary as JSON."""

    def __init__(self, port: int, device: str = "cuda", host: str = "127.0.0.1",
                 base_dir: str | None = None):
        self.device = device
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="dynamo_profile_")
        self.captures: list[dict] = []
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - the http.server hook's name
                url = urlparse(self.path)
                if url.path != "/capture":
                    self._answer(404, {"error": f"no route {url.path}"})
                    return
                try:
                    ms = int(parse_qs(url.query).get("duration_ms", ["2000"])[0])
                    self._answer(200, server.capture(ms))
                except Exception as e:  # noqa: BLE001 - answered to the caller
                    logger.exception("profile capture failed")
                    self._answer(500, {"error": f"{type(e).__name__}: {e}"})

            def _answer(self, status: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("profiler listener: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="profiler-listener", daemon=True)
        self._thread.start()

    def capture(self, duration_ms: int) -> dict:
        with self._lock:
            log_dir = os.path.join(self.base_dir, f"capture_{len(self.captures):03d}")
            doc = capture_trace(log_dir, duration_ms, self.device).summary()
            self.captures.append(doc)
            return doc

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server: ProfilerServer | None = None
_server_lock = threading.Lock()


def start_profiler_server(port: int, device: str = "cuda", host: str = "127.0.0.1",
                          base_dir: str | None = None) -> ProfilerServer:
    """Start the capture listener once a process (idempotent). On a card
    it raises at once when CUDA activity cannot be recorded."""
    global _server
    with _server_lock:
        if _server is None:
            if device != "cpu":
                import torch

                _check_cuda_profiling(torch)
            _server = ProfilerServer(port, device, host, base_dir)
            logger.info("profiler listener on %s:%d (traces under %s)",
                        host, _server.port, _server.base_dir)
        return _server


def stop_profiler_server() -> None:
    """Close the listener (a test's or a served process's exit)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.close()
            _server = None
