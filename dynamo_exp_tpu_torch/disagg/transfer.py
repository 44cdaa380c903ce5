"""KV-page transfer plane: direct TCP between prefill and decode workers.

Counterpart of ``dynamo_exp_tpu/disagg/transfer.py``, frame for frame:
the prefill engine gathers pages into pinned host memory, this plane
ships the bytes, and the decode engine injects them (host -> device on
a side stream, then a scatter). A BEGIN frame, then ``chunk_pages``-page
DATA frames under a bounded in-flight ack window (the sender never has
more than ``window`` unacked frames on the wire), then END; per-frame
memory at both ends is capped whatever the prompt's length.

Pages are ``(k, v)`` pairs of host tensors (or numpy arrays), each
``[L, page_size, Hkv*D]`` in the pools' own order, so a page's bytes are
the JAX package's for the same KV. They travel as raw bytes tagged with
the dtype name: float32 as its words, bfloat16 (which numpy has no type
for) as its raw 16-bit words under the name ``"bfloat16"``, decoded back
with ``torch.frombuffer`` as bfloat16. A frame is byte-equal to the JAX
plane's in both directions, and each page carries a CRC32 over its K
then V bytes (``sums``), verified on receipt. A page is the whole page
at any tensor-parallel degree (every rank's heads, in rank order: the
engine gathers them to rank 0 before a send and scatters them after a
receive), so a prefill worker of one degree serves a decode worker of
another and the frames never carry the degree.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
import warnings
import zlib

import numpy as np
import torch

from ..runtime.transports.codec import (
    MsgType,
    TwoPartMessage,
    read_message,
    write_message,
)
from ..telemetry import TraceContext, current_trace, get_telemetry, wire_headers
from ..telemetry.fleet import get_transfer_ledger

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

# Inbound KV pages that failed their per-page wire checksum. Every
# restore path that decodes pages off the wire (disagg inject and the
# reclaim migration sink, both through KvPageReceiver._handle) verifies
# before the bytes can become matchable KV; a mismatch fails the
# transfer and the request degrades to local (or journal) prefill.
# Mirrored as dynamo_kv_checksum_failures_total{path="wire"}.
_WIRE_CHECKSUM_FAILURES = 0


def wire_checksum_failures() -> int:
    return _WIRE_CHECKSUM_FAILURES


def _dtype_name(page) -> str:
    if isinstance(page, np.ndarray):
        return str(page.dtype)
    return str(page.dtype).removeprefix("torch.")


def _raw(page) -> memoryview:
    """A host page's bytes in memory order, without a copy where it is
    contiguous already (a bfloat16 tensor as its 16-bit words)."""
    if isinstance(page, np.ndarray):
        return memoryview(np.ascontiguousarray(page).reshape(-1).view(np.uint8))
    t = page.detach()
    if t.device.type != "cpu":
        raise ValueError(f"KV pages travel from host memory, not {t.device}")
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def encode_pages(pages: list) -> tuple[dict, bytes]:
    """Pack [(k_page, v_page), ...] into (header, payload). The header
    carries a per-page CRC32 over each page's K+V bytes (``sums``), so
    the receive side verifies content end to end."""
    if not pages:
        return {"n_pages": 0, "shape": [], "dtype": "float32", "sums": []}, b""
    shape = [int(d) for d in pages[0][0].shape]
    dtype = _dtype_name(pages[0][0])
    per = _raw(pages[0][0]).nbytes
    parts: list[memoryview] = []
    sums: list[int] = []
    for k, v in pages:
        kb, vb = _raw(k), _raw(v)
        if kb.nbytes != per or vb.nbytes != per:
            raise ValueError("KV pages of one transfer must share a shape")
        parts += (kb, vb)
        sums.append(zlib.crc32(vb, zlib.crc32(kb)))
    return {"n_pages": len(pages), "shape": shape, "dtype": dtype, "sums": sums}, b"".join(parts)


def decode_pages(header: dict, payload: bytes) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Unpack pages as host tensors (views of ``payload``), verifying
    each against the header's per-page CRC when present (an older
    sender omits ``sums``; its frames decode unverified). A mismatch
    raises ``ValueError``: the receiver fails the transfer and the
    restore path falls back to a re-prefill rather than ever serving
    the corrupt page."""
    global _WIRE_CHECKSUM_FAILURES
    n = header["n_pages"]
    if n == 0:
        return []
    shape = tuple(header["shape"])
    name = header["dtype"]
    if name not in _DTYPES:
        raise ValueError(f"unsupported KV page dtype {name!r}")
    dtype = _DTYPES[name]
    count = int(np.prod(shape))
    per = count * torch.empty((), dtype=dtype).element_size()
    if len(payload) < 2 * per * n:
        raise ValueError(f"KV frame payload short: {len(payload)} < {2 * per * n}")
    sums = header.get("sums")
    pages = []
    with warnings.catch_warnings():
        # The views are read-only: every consumer copies them out.
        warnings.simplefilter("ignore", UserWarning)
        for i in range(n):
            off = i * 2 * per
            if sums is not None:
                crc = zlib.crc32(memoryview(payload)[off : off + 2 * per])
                if crc != sums[i]:
                    _WIRE_CHECKSUM_FAILURES += 1
                    get_telemetry().kv_checksum_failures.labels("wire").inc()
                    raise ValueError(f"KV wire checksum mismatch on page {i}/{n}")
            k = torch.frombuffer(payload, dtype=dtype, count=count, offset=off)
            v = torch.frombuffer(payload, dtype=dtype, count=count, offset=off + per)
            pages.append((k.view(shape), v.view(shape)))
    return pages


# The receiver's stream buffer limit.
_READ_LIMIT = 16 << 20

# Defaults for the chunked transfer: pages per DATA frame and the
# bounded number of unacked frames in flight.
DEFAULT_CHUNK_PAGES = 4
DEFAULT_WINDOW = 4


async def send_kv_pages(
    return_addr: str,
    request_id: str,
    first_token: int,
    pages: list,
    error: str | None = None,
    chunk_pages: int = DEFAULT_CHUNK_PAGES,
    window: int = DEFAULT_WINDOW,
    lease: "object | None" = None,  # disagg.protocol.LeaseGrant
    dst_instance: str = "",
    extra_header: dict | None = None,
) -> None:
    """Deliver one prefill result (or failure notice) to a decode worker.

    Pages go out as ``chunk_pages``-page DATA frames with at most
    ``window`` frames unacknowledged — per-frame memory at both ends is
    capped at ``chunk_pages * page_bytes`` regardless of prompt length,
    and arrival overlaps transmission. ``lease`` (if the sender pinned
    the source pages under a handoff lease) rides the BEGIN frame so the
    receive side can trace which lease covered the transfer; a clean
    final ack is the sender's cue to confirm the lease.

    ``dst_instance`` names the receiving decode worker for the per-link
    :class:`~dynamo_exp_tpu_torch.telemetry.fleet.TransferLedger` (falls
    back to the return address); the sender's own instance identity
    rides the BEGIN frame so the receive side ledgers the same link by
    name.
    """
    host, _, port = return_addr.rpartition(":")
    t0 = time.time()
    total_bytes = 0
    tel = get_telemetry()
    try:
        reader, writer = await asyncio.open_connection(
            host or "127.0.0.1", int(port)
        )
    except BaseException:
        tel.kv_transfer_total.labels("send", "error").inc()
        raise

    async def _read_ack() -> None:
        """An ack that is an ERROR frame (or ok=False) means the receiver
        rejected the transfer — the sender must NOT treat it as delivery
        and release its device pages."""
        ack = await read_message(reader)
        if ack.msg_type == MsgType.ERROR or ack.header.get("ok") is False:
            raise RuntimeError(
                f"KV transfer rejected by receiver: "
                f"{ack.header.get('error', 'unknown error')}"
            )

    try:
        if error is not None:
            await write_message(
                writer,
                TwoPartMessage(
                    MsgType.ERROR, {"request_id": request_id, "error": error}
                ),
            )
            await read_message(reader)
            return
        chunks = [
            pages[i : i + chunk_pages]
            for i in range(0, len(pages), chunk_pages)
        ]
        begin = {
            "request_id": request_id,
            "first_token": first_token,
            "kind": "begin",
            "n_pages": len(pages),
            "n_chunks": len(chunks),
            # The sending instance's identity: the receive side ledgers
            # the (src, dst) link by name.
            "src_instance": tel.instance,
        }
        # The receiver's transfer span joins the sender's trace.
        trace = wire_headers()
        if trace:
            begin["trace"] = trace
        if lease is not None:
            begin.update(lease.to_header())
        if extra_header:
            # Caller-supplied BEGIN metadata (the reclaim plane ships
            # its block-hash chain here).
            begin.update(extra_header)
        await write_message(writer, TwoPartMessage(MsgType.FRAME, begin))
        unacked = 0
        for idx, chunk in enumerate(chunks):
            header, payload = encode_pages(chunk)
            header.update(
                {"request_id": request_id, "kind": "data", "chunk": idx}
            )
            await write_message(
                writer, TwoPartMessage(MsgType.FRAME, header, payload)
            )
            total_bytes += len(payload)
            unacked += 1
            if unacked >= window:
                await _read_ack()  # per-chunk ack
                unacked -= 1
        while unacked > 0:
            await _read_ack()
            unacked -= 1
        await write_message(
            writer,
            TwoPartMessage(
                MsgType.FRAME, {"request_id": request_id, "kind": "end"}
            ),
        )
        # Final ack: pages are known-delivered before the prefill worker
        # releases/reuses its device pages.
        await _read_ack()
        end = time.time()
        tel.kv_transfer_duration.labels("send").observe(end - t0)
        tel.kv_transfer_bytes.labels("send").observe(total_bytes)
        tel.kv_transfer_total.labels("send", "ok").inc()
        # Per-link ledger: the sender's extract->ack view of the link.
        dst = dst_instance or return_addr
        get_transfer_ledger().record(tel.instance, dst, total_bytes, end - t0)
        tel.emit_stage(
            "kv_transfer_send",
            t0,
            end,
            current_trace(),
            request_id=request_id,
            pages=len(pages),
            bytes=total_bytes,
            src=tel.instance,
            dst=dst,
        )
    except BaseException:
        tel.kv_transfer_total.labels("send", "error").inc()
        raise
    finally:
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()


class KvPageReceiver:
    """Decode-worker side: accepts prefill results, resolves per-request
    futures. One receiver per decode worker process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._pending: dict[str, asyncio.Future] = {}
        self._chunk_cbs: dict[str, object] = {}
        # Late-claim hook for transfers nobody pre-registered: called
        # with (request_id, begin_header) and may call expect() to adopt
        # the transfer before it is dropped. The reclaim plane's
        # MigrationSink claims "migrate:*" ids here — a dying sender
        # cannot pre-announce through any channel but the wire itself.
        self.on_unclaimed = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        # A stream buffer that holds whole DATA frames: the reader is
        # not paused and resumed every 128 KiB of a frame's megabytes.
        self._server = await asyncio.start_server(self._handle, self.host, self.port,
                                                  limit=_READ_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("KV receiver closed"))
        self._pending.clear()
        self._chunk_cbs.clear()

    def expect(self, request_id: str, on_chunk=None) -> asyncio.Future:
        """Register interest *before* queueing the prefill request, so the
        result can't race past us. ``on_chunk(pages)`` (if given) fires
        per arriving DATA frame — the hook that lets a decode engine
        start injecting while later pages are still in flight; pages
        then travel ONLY through the callback (bounded receiver memory)
        and the future resolves to (first_token, []) at END."""
        fut = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        if on_chunk is not None:
            self._chunk_cbs[request_id] = on_chunk
        return fut

    def forget(self, request_id: str) -> None:
        self._pending.pop(request_id, None)
        self._chunk_cbs.pop(request_id, None)

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        fut = None
        rid = ""
        try:
            msg = await read_message(reader)
            rid = msg.header.get("request_id", "")
            fut = self._pending.pop(rid, None)
            if (
                fut is None
                and self.on_unclaimed is not None
                and msg.header.get("kind") == "begin"
            ):
                with contextlib.suppress(Exception):
                    self.on_unclaimed(rid, dict(msg.header))
                fut = self._pending.pop(rid, None)
            if fut is None or fut.done():
                logger.warning("KV pages for unknown request %s dropped", rid)
                # Still drain the sender's frames so it doesn't hang on
                # acks, then ack-close.
                if msg.header.get("kind") == "begin":
                    while msg.header.get("kind") != "end":
                        await write_message(
                            writer,
                            TwoPartMessage(MsgType.COMPLETE, {"ok": True}),
                        )
                        msg = await read_message(reader)
            elif msg.msg_type == MsgType.ERROR:
                fut.set_exception(
                    RuntimeError(msg.header.get("error", "prefill failed"))
                )
            elif msg.header.get("kind") == "begin":
                begin_header = msg.header
                first_token = msg.header["first_token"]
                t0 = time.time()
                n_bytes = 0
                n_pages = 0
                trace = TraceContext.from_wire(msg.header.get("trace"))
                on_chunk = self._chunk_cbs.pop(rid, None)
                pages: list = []
                while True:
                    msg = await read_message(reader)
                    if msg.header.get("kind") == "end":
                        break
                    n_bytes += len(msg.payload or b"")
                    chunk = decode_pages(msg.header, msg.payload)
                    n_pages += len(chunk)
                    if on_chunk is not None:
                        # Streaming consumer: pages leave through the
                        # callback as they land (the receiver-side
                        # memory bound); the future carries only the
                        # first token so nothing is delivered twice.
                        on_chunk(chunk)
                    else:
                        pages.extend(chunk)
                    await write_message(
                        writer, TwoPartMessage(MsgType.COMPLETE, {"ok": True})
                    )
                fut.set_result((first_token, pages))
                end = time.time()
                tel = get_telemetry()
                tel.kv_transfer_duration.labels("recv").observe(end - t0)
                tel.kv_transfer_bytes.labels("recv").observe(n_bytes)
                tel.kv_transfer_total.labels("recv", "ok").inc()
                # Per-link ledger, receive-side view: in a real fleet
                # each process only ever sees its own side of a link, so
                # the decode worker learns inbound bandwidth without a
                # cross-instance scrape.
                src = begin_header.get("src_instance") or "?"
                get_transfer_ledger().record(
                    src, tel.instance, n_bytes, end - t0
                )
                tel.emit_stage(
                    "kv_transfer_recv",
                    t0,
                    end,
                    trace,
                    request_id=rid,
                    pages=n_pages,
                    bytes=n_bytes,
                    src=src,
                    dst=tel.instance,
                    # Which handoff lease covered this transfer (tracing
                    # orphan reclaims back to their request).
                    lease_id=begin_header.get("lease_id"),
                )
            else:
                # Unchunked single-frame transfers are rejected outright:
                # one frame would buffer the whole KV payload (hundreds of
                # MB at long ISL) in receiver memory, defeating the
                # chunked/windowed bound. A sender speaking the old shape
                # must fail visibly, not degrade silently.
                err = (
                    "unchunked KV transfer frame rejected (sender too "
                    "old: expected begin/data/end chunk protocol)"
                )
                get_telemetry().kv_transfer_total.labels("recv", "error").inc()
                fut.set_exception(RuntimeError(err))
                # The sender treats the final ack as proof of delivery
                # before releasing its device pages — it must see the
                # failure: an ERROR frame (checked by _read_ack) rather
                # than an ok-shaped COMPLETE a naive sender would take
                # as confirmation.
                await write_message(
                    writer, TwoPartMessage(MsgType.ERROR, {"error": err})
                )
                return
            await write_message(writer, TwoPartMessage(MsgType.COMPLETE, {"ok": True}))
        except (asyncio.IncompleteReadError, ConnectionError) as e:
            # A connection drop mid-transfer must fail the waiting
            # request immediately: the future was already popped from
            # _pending, so close() can no longer reach it. Count the
            # error only for a real in-flight transfer — port scanners
            # connecting and hanging up (fut None), or a post-outcome
            # write failure (fut already done), must not skew the rate.
            if fut is not None and not fut.done():
                get_telemetry().kv_transfer_total.labels("recv", "error").inc()
                fut.set_exception(
                    ConnectionError(f"KV transfer dropped mid-stream: {e}")
                )
        except Exception as e:  # noqa: BLE001 - a malformed frame must fail
            # the waiting request *now*, not leave it to time out.
            logger.exception("bad KV transfer frame")
            if fut is not None and not fut.done():
                get_telemetry().kv_transfer_total.labels("recv", "error").inc()
                fut.set_exception(RuntimeError(f"bad KV transfer frame: {e}"))
        finally:
            self._chunk_cbs.pop(rid, None)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()
