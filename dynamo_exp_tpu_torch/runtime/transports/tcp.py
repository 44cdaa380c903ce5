"""TCP request plane: streaming request / response between processes.

Counterpart of ``dynamo_exp_tpu/runtime/transports/tcp.py``, on the same
wire: the client connects straight to the chosen worker's TCP server
and the response frames stream back on the same socket.

- two-part framing (header + payload, ``codec.py``);
- early errors ride an ERROR frame; an ERROR mid-stream ends it;
- upstream cancellation: the client writes CONTROL {stop|kill} frames;
  a dropped client connection kills the request context;
- deadlines travel as the caller's *remaining* budget (``timeout_s``),
  and an expired request is refused before its handler runs;
- the STATS scrape answers ``{"inflight": n, **stats_handler()}``;
- graceful drain: a closing endpoint stops taking requests and waits
  for those in flight.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import weakref
from typing import AsyncIterator

from ...telemetry import (
    TraceContext,
    attach as trace_attach,
    detach as trace_detach,
    get_telemetry,
    wire_headers,
)
from ..engine import AsyncEngineContext
from .base import (
    Handler,
    InstanceInfo,
    RequestPlane,
    ServedEndpoint,
    StatsHandler,
)
from .codec import MsgType, TwoPartMessage, read_message, write_message

logger = logging.getLogger(__name__)


class _Served(ServedEndpoint):
    def __init__(self, plane: "TcpRequestPlane", instance_id: int):
        self._plane = plane
        self._instance_id = instance_id

    async def close(self) -> None:
        entry = self._plane._handlers.pop(self._instance_id, None)
        if entry is not None:
            _, _, inflight = entry
            while inflight[0] > 0:
                await asyncio.sleep(0.005)


class TcpRequestPlane(RequestPlane):
    """One TCP listener per process serves every endpoint the process
    hosts; requests carry the target instance_id in the header."""

    def __init__(self, bind_host: str = "127.0.0.1", bind_port: int = 0):
        self.bind_host = bind_host
        self.bind_port = bind_port
        self._server: asyncio.AbstractServer | None = None
        self._handlers: dict[int, tuple[Handler, StatsHandler | None, list[int]]] = {}

    async def _ensure_server(self) -> None:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._handle_conn, self.bind_host, self.bind_port
            )
            self.bind_port = self._server.sockets[0].getsockname()[1]
            logger.info(
                "tcp request plane listening on %s:%d", self.bind_host, self.bind_port
            )

    @property
    def address(self) -> str:
        return f"{self.bind_host}:{self.bind_port}"

    # ------------------------------------------------------------- serving
    async def serve(
        self,
        info: InstanceInfo,
        handler: Handler,
        stats_handler: StatsHandler | None = None,
    ) -> ServedEndpoint:
        await self._ensure_server()
        info.transport = "tcp"
        info.transport_address = self.address
        self._handlers[info.instance_id] = (handler, stats_handler, [0])
        return _Served(self, info.instance_id)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            msg = await read_message(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        try:
            if msg.msg_type == MsgType.STATS:
                await self._handle_stats(msg, writer)
            elif msg.msg_type == MsgType.REQUEST:
                await self._handle_request(msg, reader, writer)
            else:
                await write_message(
                    writer,
                    TwoPartMessage(
                        MsgType.ERROR, {"message": f"unexpected {msg.msg_type}"}
                    ),
                )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _handle_stats(
        self, msg: TwoPartMessage, writer: asyncio.StreamWriter
    ) -> None:
        entry = self._handlers.get(msg.header.get("instance_id", 0))
        if entry is None:
            await write_message(
                writer, TwoPartMessage(MsgType.ERROR, {"message": "no such instance"})
            )
            return
        _, stats_handler, inflight = entry
        stats = {"inflight": inflight[0]}
        if stats_handler is not None:
            stats.update(stats_handler())
        await write_message(writer, TwoPartMessage(MsgType.STATS, stats))

    async def _handle_request(
        self,
        msg: TwoPartMessage,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        instance_id = msg.header.get("instance_id", 0)
        entry = self._handlers.get(instance_id)
        if entry is None:
            # Prologue-style early error: instance not served here.
            await write_message(
                writer,
                TwoPartMessage(
                    MsgType.ERROR, {"message": f"instance {instance_id} not here"}
                ),
            )
            return
        handler, _, inflight = entry
        request = json.loads(msg.payload) if msg.payload else {}
        context = AsyncEngineContext(request_id=msg.header.get("request_id"))
        # Deadline propagation: the caller ships its *remaining* budget
        # (not an absolute timestamp), so host clock skew can't shrink or
        # grow the window. An already-expired request is refused before
        # the handler runs — the remote stage must not waste work on it.
        timeout_s = msg.header.get("timeout_s")
        if timeout_s is not None:
            context.start_timeout(float(timeout_s))
        if context.deadline_expired:
            get_telemetry().deadline_exceeded.labels("request_plane").inc()
            await write_message(
                writer,
                TwoPartMessage(
                    MsgType.ERROR,
                    {"message": f"deadline exceeded for request {context.id}"},
                ),
            )
            return
        # Cross-process trace continuation: the caller's trace context
        # rides the request header; adopt it so every span/log emitted
        # while handling joins the caller's trace.
        trace_token = trace_attach(TraceContext.from_wire(msg.header.get("trace")))
        inflight[0] += 1

        # Control reader: stop/kill frames, and connection-drop => kill.
        async def _control() -> None:
            try:
                while True:
                    cmsg = await read_message(reader)
                    if cmsg.msg_type == MsgType.CONTROL:
                        if cmsg.header.get("op") == "kill":
                            context.kill()
                        else:
                            context.stop_generating()
            except (asyncio.IncompleteReadError, ConnectionError):
                context.kill()

        control_task = asyncio.ensure_future(_control())
        try:
            agen = handler(request, context)
            async for frame in agen:
                if context.is_killed:
                    with contextlib.suppress(Exception):
                        await agen.aclose()
                    break
                await write_message(
                    writer, TwoPartMessage(MsgType.FRAME, {}, json.dumps(frame).encode())
                )
            if not context.is_killed:
                await write_message(writer, TwoPartMessage(MsgType.COMPLETE, {}))
        except (ConnectionError, asyncio.IncompleteReadError):
            context.kill()
        except Exception as e:  # noqa: BLE001 - handler errors go in-band
            logger.exception("handler failed for instance %d", instance_id)
            with contextlib.suppress(ConnectionError):
                await write_message(
                    writer,
                    TwoPartMessage(MsgType.ERROR, {"message": f"{type(e).__name__}: {e}"}),
                )
        finally:
            trace_detach(trace_token)
            inflight[0] -= 1
            control_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await control_task

    # ------------------------------------------------------------- client
    async def request_stream(
        self,
        instance: InstanceInfo,
        request: dict,
        context: AsyncEngineContext,
    ) -> AsyncIterator[dict]:
        if instance.transport != "tcp" or not instance.transport_address:
            raise ConnectionError(
                f"instance {instance.instance_id} has no tcp address"
            )
        host, _, port = instance.transport_address.rpartition(":")
        try:
            reader, writer = await asyncio.open_connection(host, int(port))
        except OSError as e:
            raise ConnectionError(
                f"connect to {instance.transport_address} failed: {e}"
            ) from e
        header = {"instance_id": instance.instance_id, "request_id": context.id}
        trace = wire_headers()
        if trace:
            header["trace"] = trace
        remaining = context.time_remaining()
        if remaining is not None:
            header["timeout_s"] = max(remaining, 0.0)
        await write_message(
            writer,
            TwoPartMessage(MsgType.REQUEST, header, json.dumps(request).encode()),
        )

        # Forward local stop/kill upstream as CONTROL frames.
        async def _forward_control() -> None:
            with contextlib.suppress(ConnectionError, OSError):
                await context.stopped()
                await write_message(
                    writer, TwoPartMessage(MsgType.CONTROL, {"op": "stop"})
                )
                await context.killed()
                await write_message(
                    writer, TwoPartMessage(MsgType.CONTROL, {"op": "kill"})
                )

        control_task = asyncio.ensure_future(_forward_control())
        done = [False]

        def _teardown() -> None:
            if done[0]:
                return
            done[0] = True
            control_task.cancel()
            writer.close()

        async def _gen() -> AsyncIterator[dict]:
            try:
                while True:
                    try:
                        msg = await read_message(reader)
                    except (asyncio.IncompleteReadError, ConnectionError) as e:
                        raise ConnectionError("response stream dropped") from e
                    if msg.msg_type == MsgType.FRAME:
                        yield json.loads(msg.payload)
                    elif msg.msg_type == MsgType.COMPLETE:
                        return
                    elif msg.msg_type == MsgType.ERROR:
                        # Surface as an in-band error frame (Annotated shape)
                        # so Client.generate_to raises EngineError uniformly.
                        yield {
                            "event": "error",
                            "comment": [msg.header.get("message", "remote error")],
                        }
                        return
            finally:
                _teardown()
                with contextlib.suppress(asyncio.CancelledError):
                    await control_task
                with contextlib.suppress(Exception):
                    await writer.wait_closed()

        gen = _gen()
        # A never-iterated generator's finally never runs; closing the
        # socket on GC kills the request server-side so the handler can't
        # pin the inflight counter (the inproc plane's weakref guard,
        # ``inproc.py`` _finish).
        weakref.finalize(gen, _teardown)
        return gen

    async def scrape_stats(self, instance: InstanceInfo) -> dict:
        if instance.transport != "tcp" or not instance.transport_address:
            raise ConnectionError(
                f"instance {instance.instance_id} has no tcp address"
            )
        host, _, port = instance.transport_address.rpartition(":")
        try:
            reader, writer = await asyncio.open_connection(host, int(port))
        except OSError as e:
            raise ConnectionError(f"stats connect failed: {e}") from e
        try:
            await write_message(
                writer,
                TwoPartMessage(MsgType.STATS, {"instance_id": instance.instance_id}),
            )
            msg = await read_message(reader)
            if msg.msg_type == MsgType.ERROR:
                raise ConnectionError(msg.header.get("message", "stats error"))
            return msg.header
        except asyncio.IncompleteReadError as e:
            raise ConnectionError("stats stream dropped") from e
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
