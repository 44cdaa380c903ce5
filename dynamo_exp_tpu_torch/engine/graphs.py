"""CUDA graphs of the engine's dispatches, one per key.

The JAX package compiles each ragged variant into one XLA program
(``TPUEngine._ragged_fn``). PyTorch runs eagerly: a decode window is
``decode_window`` steps of about 30 small launches per layer plus the
sampler's, and a mixed dispatch (prefill chunks, decode steps beside
them, verify spans) one forward of the same launches plus its sampler,
verify and logprobs, each enqueued from Python. A :class:`DispatchGraph`
captures one dispatch for one key and replays it with one launch. The
key says the kind: a :class:`~..aot.lattice.WindowKey` is captured from
the engine's ``_window_host`` / ``_window_out_spec`` / ``_window_body``,
a :class:`~..aot.lattice.MixedKey` from ``_mixed_host`` /
``_mixed_out_spec`` / ``_mixed_body``. For every key:

- its inputs are views of one device byte buffer laid out as the
  engine's pinned upload, so a dispatch's host arrays go up in one
  ``non_blocking`` copy straight into them; a chained window then
  copies the previous window's carry (tokens, positions) over them on
  the device. The upload is queued behind the previous replay of the
  key on the same stream, so it never overwrites inputs still read;
- its outputs are tensors allocated outside the graph pool, which the
  captured body copies its results into, so that no other graph's
  replay can overwrite them; the engine's ``_fetch`` queues their host
  copies right after the replay, ahead of the key's next replay. Only
  intermediates live in the pool, which every graph of the engine
  shares;
- the kernel wrappers' launches, and the MoE FFN's grouped products,
  are recorded at capture (``ops.launches.record``) and added to the
  launch counters at every replay, so the counters stay launch for
  launch what an eager run counts.

A key is captured the first time it is dispatched (or by
``aot.warmup.prewarm_engine`` before traffic) and replayed after. A
capture that fails raises; nothing falls back to the eager dispatch.
Graphs live in one process: they are captured again on every boot.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..aot.lattice import MixedKey
from ..ops import launches
from ..ops import ragged_attention as tra
from .config import refuse_under_tp

log = logging.getLogger(__name__)

# Held for every capture: ``runtime/profiler.py`` starts and stops a
# trace only under it, so a profile's allocations never land inside one.
CAPTURE_LOCK = threading.Lock()


# Host array dtype -> the device tensor's, for the views of an upload.
TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def pack_layout(arrays) -> tuple[list[int], int]:
    """Byte offsets of ``arrays`` packed into one buffer, each on a
    16-byte boundary, and the buffer's size."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    return offs, max(total, 16)


def views(buf: torch.Tensor, arrays, offs) -> list[torch.Tensor]:
    """Typed views of ``buf`` at ``offs`` with ``arrays``' shapes."""
    return [
        buf[o : o + a.nbytes].view(TORCH_DTYPES[a.dtype]).reshape(a.shape)
        for a, o in zip(arrays, offs)
    ]


class CudaGraphRunner:
    """Capture and replay through ``torch.cuda.CUDAGraph``, every graph
    of an engine in one memory pool, captured on one side stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._warm = threading.local()

    def capture(self, fn: Callable[[], None]):
        """Capture ``fn`` on the side stream, after the work queued so
        far on the current one. No device sync (unlike the
        ``torch.cuda.graph`` context), so a first-use capture may happen
        inside a chained dispatch. Any sync inside ``fn`` raises (sync
        debug mode "error"), as would any call the capture forbids. The
        first capture on a thread runs ``fn`` once eagerly on the side
        stream before it, uncounted: PyTorch asks for such a warm-up on
        a side stream before a capture, so that lazily made state (the
        CUDA libraries' handles and workspaces) is not made inside it.
        A thread's first dispatch may be a capture now that mixed
        dispatches are graphed too."""
        g = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        if not getattr(self._warm, "done", False):
            with torch.cuda.stream(self.stream), launches.record():
                fn()
            self._warm.done = True
        mode = torch.cuda.get_sync_debug_mode()
        # No garbage collection inside the capture: a collected cycle
        # can free pinned host memory (an old engine's staging), whose
        # allocator then queries CUDA events on this thread, which
        # invalidates the capture (seen on an H100 as
        # CUBLAS_STATUS_EXECUTION_FAILED in the next GEMM).
        collecting = gc.isenabled()
        CAPTURE_LOCK.acquire()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                # This thread's cuBLAS handle and its workspace on the
                # capture stream, made before the capture: cublasCreate
                # inside one fails (a new process's first GEMM).
                torch.cuda.current_blas_handle()
                # thread_local: another thread of the process (the KV
                # copy stream's) may call what a global-mode capture
                # forbids.
                g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                except BaseException:
                    torch.cuda.set_sync_debug_mode(mode)
                    with contextlib.suppress(Exception):
                        g.capture_end()
                    raise
                torch.cuda.set_sync_debug_mode(mode)
                g.capture_end()
        finally:
            if collecting:
                gc.enable()
            CAPTURE_LOCK.release()
        current.wait_stream(self.stream)
        return g

    @staticmethod
    def replay(g) -> None:
        g.replay()

    def pool_bytes(self) -> int:
        """Device memory held by the graphs' pool (its segments)."""
        pool = tuple(self.pool)
        segments = torch.cuda.memory._snapshot(self.device)["segments"]
        return sum(
            s["total_size"] for s in segments if tuple(s.get("segment_pool_id", ())) == pool
        )


def kind_of(key) -> str:
    return "mixed" if isinstance(key, MixedKey) else "window"


class DispatchGraph:
    """One captured dispatch: its input buffer and views, its outputs,
    the graph, the kernel launches one replay makes and its replays."""

    def __init__(self, key, in_buf, inputs, offs, outputs, graph, launches):
        self.key = key
        self.in_buf = in_buf
        self.inputs = inputs  # name -> view of in_buf
        self.offs = offs
        self.outputs = outputs  # tuple, allocated outside the pool
        self.graph = graph
        self.launches = launches  # ops.launches.record()
        self.replays = 0


class DispatchGraphs:
    """The engine's graphs by key (window and mixed), captured at first
    use; counters by kind."""

    KINDS = ("window", "mixed")

    def __init__(self, engine, runner=None):
        if engine.cfg.tp > 1:
            # Gloo's host-staged collectives cannot be captured, and NCCL
            # ones are not yet (ROADMAP Queue 1 item 7(b)).
            raise refuse_under_tp("CUDA graph capture", "graphs")
        self.engine = engine
        self.runner = runner if runner is not None else CudaGraphRunner(engine.device)
        self.graphs: dict = {}
        self.captured = dict.fromkeys(self.KINDS, 0)
        # The loop (or boot) thread's seconds in captures.
        self.capture_seconds = dict.fromkeys(self.KINDS, 0.0)
        self.replays = dict.fromkeys(self.KINDS, 0)

    def get(self, key) -> DispatchGraph:
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key)
        return g

    def _capture(self, key) -> DispatchGraph:
        eng, kind = self.engine, kind_of(key)
        t0 = time.perf_counter()
        # The engine's _{kind}_host / _out_spec / _body.
        host = getattr(eng, f"_{kind}_host")(key)  # all padding
        names, arrays = list(host), list(host.values())
        offs, total = pack_layout(arrays)
        in_buf = torch.empty(total, dtype=torch.uint8, device=eng.device)
        eng._upload_into(in_buf, arrays, offs)
        inputs = dict(zip(names, views(in_buf, arrays, offs)))
        outputs = tuple(
            torch.empty(shape, dtype=dt, device=eng.device)
            for shape, dt in getattr(eng, f"_{kind}_out_spec")(key)
        )

        def body():
            for out, res in zip(outputs, getattr(eng, f"_{kind}_body")(key, inputs)):
                out.copy_(res)

        if eng.attn_impl == "kernel" and eng.device.type == "cuda":
            tra.load_kernel()  # nvcc cannot run inside a capture
        with launches.record() as rec:
            graph = self.runner.capture(body)
        self.captured[kind] += 1
        seconds = time.perf_counter() - t0
        self.capture_seconds[kind] += seconds
        log.info("captured %s graph %s in %.3fs", kind, key, seconds)
        return DispatchGraph(key, in_buf, inputs, offs, outputs, graph, rec)

    def replay(self, g: DispatchGraph) -> None:
        self.runner.replay(g.graph)
        launches.add(g.launches)
        g.replays += 1
        self.replays[kind_of(g.key)] += 1

    def pool_bytes(self) -> int:
        return self.runner.pool_bytes()
