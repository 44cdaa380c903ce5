"""A small asyncio HTTP/1.1 client for the OpenAI routes.

The standard library's ``http.client`` blocks, and the servers it talks
to here run on the caller's own event loop (the tests, ``chip_smoke.py``),
so this reads and writes ``asyncio`` streams instead: one connection a
request, bodies by ``Content-Length`` or chunked transfer encoding, and
SSE frames decoded as they arrive.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Any, AsyncIterator
from urllib.parse import urlsplit

from ..protocols.sse import DONE_SENTINEL, SseDecoder
from ..runtime.annotated import Annotated


class HttpError(Exception):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}: {body[:300]!r}")
        self.status = status
        self.body = body


@dataclass
class HttpResponse:
    status: int
    headers: dict[str, str]
    body: bytes

    def json(self) -> Any:
        return json.loads(self.body)


async def _open(url: str, method: str, payload: Any | None, headers: dict | None = None):
    parts = urlsplit(url)
    reader, writer = await asyncio.open_connection(parts.hostname, parts.port or 80)
    # Bytes go as they are (an artifact upload); anything else as JSON.
    raw = isinstance(payload, bytes)
    body = payload if raw else b"" if payload is None else json.dumps(payload).encode()
    ctype = "application/octet-stream" if raw else "application/json"
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    head = (
        f"{method} {parts.path or '/'} HTTP/1.1\r\nHost: {parts.netloc}\r\n"
        f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
        f"{extra}Connection: close\r\n\r\n"
    )
    writer.write(head.encode("latin-1") + body)
    await writer.drain()
    status_line = (await reader.readline()).decode("latin-1")
    if not status_line:
        writer.close()
        raise ConnectionResetError(f"{url}: no response")
    status = int(status_line.split(" ")[1])
    headers: dict[str, str] = {}
    while True:
        line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
        if not line:
            break
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return reader, writer, status, headers


async def _body_pieces(reader: asyncio.StreamReader, headers: dict) -> AsyncIterator[bytes]:
    if headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                await reader.readline()
                return
            data = await reader.readexactly(size)
            await reader.readexactly(2)
            yield data
    elif "content-length" in headers:
        yield await reader.readexactly(int(headers["content-length"]))
    else:
        yield await reader.read()


async def request(
    url: str, method: str = "GET", payload: Any | None = None, headers: dict | None = None
) -> HttpResponse:
    """One request (with extra ``headers``, if given); the whole body read."""
    reader, writer, status, headers = await _open(url, method, payload, headers)
    try:
        body = b"".join([p async for p in _body_pieces(reader, headers)])
    finally:
        writer.close()
    return HttpResponse(status, headers, body)


async def sse_frames(
    url: str, payload: Any, headers: dict | None = None
) -> AsyncIterator[Annotated]:
    """POST ``payload`` (with extra ``headers``, if given) and yield its
    SSE frames as they arrive, the ``[DONE]`` frame last (its ``data``
    is ``DONE_SENTINEL``). Raises ``HttpError`` on a non-200 answer.
    Closing the iterator early closes the connection (a client
    disconnect)."""
    reader, writer, status, headers = await _open(url, "POST", payload, headers)
    try:
        if status != 200:
            body = b"".join([p async for p in _body_pieces(reader, headers)])
            raise HttpError(status, body)
        decoder = SseDecoder()
        async for piece in _body_pieces(reader, headers):
            for frame in decoder.feed(piece.decode("utf-8")):
                yield frame
                if frame.data == DONE_SENTINEL:
                    return
    finally:
        writer.close()
