"""Structured logging: human-readable or JSONL, set from the environment.

Counterpart of ``dynamo_exp_tpu/runtime/logging.py``: ``DYN_LOG`` sets
the level and ``DYN_LOGGING_JSONL`` the format. A JSONL line emitted
while a request's trace context is current carries its ``trace_id``
and ``span_id`` (``telemetry/context.py``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from ..telemetry.context import current_trace


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        tc = current_trace()
        if tc is not None:
            entry["trace_id"] = tc.trace_id
            entry["span_id"] = tc.span_id
        if record.exc_info and record.exc_info[0] is not None:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def configure_logging(level: str | None = None, jsonl: bool | None = None, stream=None) -> None:
    level = (level or os.environ.get("DYN_LOG", "INFO")).upper()
    if jsonl is None:
        jsonl = os.environ.get("DYN_LOGGING_JSONL", "").lower() in {"1", "true", "yes"}
    handler = logging.StreamHandler(stream or sys.stderr)
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s", datefmt="%Y-%m-%dT%H:%M:%S",
        ))
    root = logging.getLogger()
    root.handlers = [handler]
    try:
        root.setLevel(level)
    except ValueError:
        root.setLevel(logging.INFO)
