"""Server-Sent Events codec for OpenAI-style streaming responses.

Counterpart of ``dynamo_exp_tpu/protocols/sse.py``: encode Annotated
frames as SSE ``data:``/``event:``/comment lines, and decode them back
(the tests and ``chip_smoke.py`` read streams with ``SseDecoder``).
"""

from __future__ import annotations

import json
from typing import Any, Iterator

from ..runtime.annotated import Annotated

DONE_SENTINEL = "[DONE]"


def encode_frame(ann: Annotated[Any]) -> str:
    """Encode one Annotated frame as an SSE message."""
    lines: list[str] = [f": {c}" for c in ann.comment]
    if ann.event is not None:
        lines.append(f"event: {ann.event}")
    if ann.id is not None:
        lines.append(f"id: {ann.id}")
    if ann.data is not None:
        data = ann.data if isinstance(ann.data, str) else json.dumps(ann.data)
        lines.extend(f"data: {line}" for line in data.split("\n"))
    return "\n".join(lines) + "\n\n"


def encode_done() -> str:
    return f"data: {DONE_SENTINEL}\n\n"


class SseDecoder:
    """Incremental SSE parser: feed text chunks, yields Annotated frames
    (the ``[DONE]`` sentinel as a frame whose data is ``DONE_SENTINEL``)."""

    def __init__(self):
        self._buf = ""

    def feed(self, chunk: str) -> Iterator[Annotated[Any]]:
        self._buf += chunk
        while "\n\n" in self._buf:
            raw, self._buf = self._buf.split("\n\n", 1)
            frame = self._parse(raw)
            if frame is not None:
                yield frame

    @staticmethod
    def _parse(raw: str) -> Annotated[Any] | None:
        data_lines: list[str] = []
        event = None
        frame_id = None
        comments: list[str] = []
        for line in raw.split("\n"):
            if not line:
                continue
            if line.startswith(":"):
                comments.append(line[1:].strip())
            elif line.startswith("event:"):
                event = line[len("event:") :].strip()
            elif line.startswith("id:"):
                frame_id = line[len("id:") :].strip()
            elif line.startswith("data:"):
                # SSE: strip at most ONE leading space; more is payload.
                value = line[len("data:") :]
                data_lines.append(value[1:] if value.startswith(" ") else value)
        if not data_lines and event is None and not comments:
            return None
        data: Any = None
        if data_lines:
            joined = "\n".join(data_lines)
            if joined == DONE_SENTINEL:
                data = DONE_SENTINEL
            else:
                try:
                    data = json.loads(joined)
                except json.JSONDecodeError:
                    data = joined
        return Annotated(data=data, event=event, id=frame_id, comment=comments)
