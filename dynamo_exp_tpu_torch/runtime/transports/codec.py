"""Two-part wire codec: JSON header + raw payload, length-prefixed.

Counterpart of ``dynamo_exp_tpu/runtime/transports/codec.py``, byte for
byte: a frame of one package is read by the other. Every message is a
small control header plus an opaque payload, so control messages
(stop / kill, early errors) ride the same stream as data frames.

Frame layout (all integers big-endian):

    u8  type        (MsgType)
    u32 header_len
    u32 payload_len
    header bytes    (JSON, compact separators)
    payload bytes   (opaque)
"""

from __future__ import annotations

import asyncio
import enum
import json
import struct
from dataclasses import dataclass, field

_PREFIX = struct.Struct(">BII")

# Refuse absurd frames rather than allocating unbounded buffers on a
# corrupt or hostile stream.
MAX_HEADER = 1 << 20  # 1 MiB of JSON header
MAX_PAYLOAD = 1 << 30  # 1 GiB payload


class MsgType(enum.IntEnum):
    REQUEST = 1  # open a request stream (header: routing info, payload: request)
    FRAME = 2  # one response frame
    COMPLETE = 3  # response stream finished cleanly
    ERROR = 4  # stream aborted; the header carries the message
    CONTROL = 5  # upstream control: {"op": "stop"|"kill"}
    STATS = 6  # stats scrape request / response
    DATA = 7  # generic RPC of the coordinator protocol


# Payloads above this are written apart from their header.
_SPLIT_PAYLOAD = 1 << 16


class CodecError(RuntimeError):
    pass


@dataclass
class TwoPartMessage:
    msg_type: MsgType
    header: dict = field(default_factory=dict)
    payload: bytes = b""


def _head(msg: TwoPartMessage) -> bytes:
    """A frame's prefix and header (its payload follows them)."""
    header = json.dumps(msg.header, separators=(",", ":")).encode()
    if len(header) > MAX_HEADER or len(msg.payload) > MAX_PAYLOAD:
        raise CodecError("frame exceeds size limits")
    return _PREFIX.pack(int(msg.msg_type), len(header), len(msg.payload)) + header


def encode(msg: TwoPartMessage) -> bytes:
    return _head(msg) + msg.payload


async def read_message(reader: asyncio.StreamReader) -> TwoPartMessage:
    """Read one frame; raises ``asyncio.IncompleteReadError`` at clean EOF."""
    mtype, hlen, plen = _PREFIX.unpack(await reader.readexactly(_PREFIX.size))
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise CodecError(f"oversized frame: header={hlen} payload={plen}")
    header = json.loads(await reader.readexactly(hlen)) if hlen else {}
    payload = await reader.readexactly(plen) if plen else b""
    try:
        return TwoPartMessage(MsgType(mtype), header, payload)
    except ValueError as e:
        raise CodecError(f"unknown message type {mtype}") from e


async def write_message(writer: asyncio.StreamWriter, msg: TwoPartMessage) -> None:
    if len(msg.payload) > _SPLIT_PAYLOAD:
        # The same bytes without joining a large payload (a KV frame's
        # megabytes) to its header first.
        writer.write(_head(msg))
        writer.write(msg.payload)
    else:
        writer.write(encode(msg))
    await writer.drain()
