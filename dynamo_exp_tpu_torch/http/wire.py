"""The port's HTTP/1.1 reader and writer on ``asyncio`` streams.

Shared by the OpenAI ingress (``http/service.py``) and the port's small
JSON and text services (the api-store, the metrics exporter), which
serve through :class:`PlainServer`. The JAX package serves both through
aiohttp. Request bodies by ``Content-Length`` (``Expect: 100-continue``
answered), keep-alive as the client asks. This module imports only the
standard library, so a process that serves a plain service does not
load the OpenAI pipeline or torch.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)

MAX_HEAD_BYTES = 64 << 10
MAX_BODY_BYTES = 32 << 20
_REASONS = {
    100: "Continue", 200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclass
class _Request:
    method: str
    path: str
    version: str
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


@dataclass
class _Response:
    status: int
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: dict[str, str] = field(default_factory=dict)


def _json_response(obj: Any, status: int = 200, headers: dict[str, str] | None = None) -> _Response:
    return _Response(status, json.dumps(obj).encode(), headers=headers or {})


class _Connection:
    """One client connection: request reading with a push-back buffer
    (the disconnect watch may read ahead of the next request)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_body: int = MAX_BODY_BYTES):
        self.reader = reader
        self.writer = writer
        self.max_body = max_body
        self.buf = bytearray()

    async def _fill(self) -> bool:
        data = await self.reader.read(65536)
        self.buf += data
        return bool(data)

    async def read_head(self) -> bytes | None:
        while b"\r\n\r\n" not in self.buf:
            if len(self.buf) > MAX_HEAD_BYTES:
                raise _BadRequest(400, "request head too large")
            if not await self._fill():
                if self.buf.strip():
                    raise _BadRequest(400, "connection closed inside a request head")
                return None
        head, _, rest = bytes(self.buf).partition(b"\r\n\r\n")
        self.buf = bytearray(rest)
        return head

    async def read_body(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise ConnectionResetError("connection closed inside a request body")
        body, self.buf = bytes(self.buf[:n]), self.buf[n:]
        return body

    async def read_request(self) -> _Request | None:
        head = await self.read_head()
        if head is None:
            return None
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise _BadRequest(400, "malformed request line") from None
        if not version.startswith("HTTP/1."):
            raise _BadRequest(400, f"unsupported protocol {version!r}")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(400, "malformed header line")
            headers[name.strip().lower()] = value.strip()
        req = _Request(method, target.split("?", 1)[0], version, headers)
        if "transfer-encoding" in headers:
            raise _BadRequest(501, "request bodies must carry Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "bad Content-Length") from None
        if length < 0 or length > self.max_body:
            raise _BadRequest(413, f"body of {length} bytes")
        if length and headers.get("expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self.writer.drain()
        req.body = await self.read_body(length)
        return req

    async def watch_disconnect(self) -> None:
        """Return when the client closes its end (reads ahead into
        ``buf`` if it sends another request meanwhile)."""
        while await self._fill():
            pass

    def write_head(self, status: int, headers: dict[str, str]) -> None:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        self.writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def send(self, resp: _Response, keep_alive: bool) -> None:
        self.write_head(
            resp.status,
            {
                "Content-Type": resp.content_type,
                "Content-Length": str(len(resp.body)),
                "Connection": "keep-alive" if keep_alive else "close",
                **resp.headers,
            },
        )
        self.writer.write(resp.body)
        await self.writer.drain()

    async def send_chunk(self, data: bytes) -> None:
        self.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self.writer.drain()


# The public names of a plain service's reply and of its JSON form.
PlainResponse = _Response
plain_json = _json_response


class PlainServer:
    """HTTP/1.1 for the port's small services (the api-store, the
    metrics exporter): every request read whole (up to ``max_body``
    bytes), ``await handler(request)`` answers it, keep-alive as the
    client asks. The JAX package serves these through aiohttp."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 max_body: int = MAX_BODY_BYTES):
        self.handler = handler
        self.host = host
        self.port = port
        self.max_body = max_body
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> int:
        """Start serving; returns the bound port."""
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer, self.max_body)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    await conn.send(_json_response({"error": str(e)}, e.status), False)
                    return
                if req is None:
                    return
                try:
                    resp = await self.handler(req)
                except Exception as e:  # a handler's fault is the request's 500
                    logger.exception("%s %s failed", req.method, req.path)
                    resp = _json_response({"error": str(e)}, 500)
                await conn.send(resp, req.keep_alive)
                if not req.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(ConnectionError, asyncio.CancelledError):
                await writer.wait_closed()
