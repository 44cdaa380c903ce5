"""JSONL event recorder with rotation, plus replay.

Counterpart of ``dynamo_exp_tpu/recorder.py``: an append-only JSONL log
rotated at ``max_bytes`` (``Recorder``), and ``KvRecorder``, which taps
a KV-router event subject into a recording and replays it into a
``kv_router.indexer.KvIndexer`` (rebuild-from-log). The span file of
``telemetry/spans.py`` is one of these recordings.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import time
from typing import Any, Iterator

logger = logging.getLogger(__name__)


class Recorder:
    """Append-only JSONL event log; rotates at ``max_bytes`` keeping up to
    ``max_files`` older generations (``path``, ``path.1``, ``path.2`` …)."""

    def __init__(self, path: str, max_bytes: int = 64 << 20, max_files: int = 4):
        self.path = path
        self.max_bytes = max_bytes
        self.max_files = max_files
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self.count = 0

    def record(self, event: Any, ts: float | None = None) -> None:
        line = json.dumps({"ts": ts if ts is not None else time.time(), "event": event})
        self._fh.write(line + "\n")
        self._fh.flush()
        self.count += 1
        if self._fh.tell() >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        oldest = f"{self.path}.{self.max_files}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def replay(path: str) -> Iterator[tuple[float, Any]]:
        """Yield (ts, event) from one JSONL file, oldest line first.
        Corrupt lines (a torn write at a crash) are skipped."""
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                try:
                    d = json.loads(line)
                    yield float(d["ts"]), d["event"]
                except (ValueError, KeyError):
                    logger.warning("skipping corrupt recorder line")


class KvRecorder:
    """Taps a KV-router event subject into a :class:`Recorder`, and
    replays a recording into an indexer."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder
        self._task: asyncio.Task | None = None

    async def start(self, event_plane, subject: str) -> None:
        # Subscribe before returning: events published right after
        # start() must land in the recording.
        stream = await event_plane.subscribe(subject)

        async def pump(stream) -> None:
            # Re-subscribe on connection loss, so a coordinator blip does
            # not end the recording; a dead stream is never re-iterated.
            while True:
                try:
                    async for event in stream:
                        self.recorder.record(event)
                    return  # subscription closed cleanly
                except asyncio.CancelledError:
                    return
                except Exception as exc:
                    logger.warning("kv recorder stream lost (%s); retrying", exc)
                stream = None
                while stream is None:
                    await asyncio.sleep(1.0)
                    try:
                        stream = await event_plane.subscribe(subject)
                    except asyncio.CancelledError:
                        return
                    except Exception:
                        pass

        self._task = asyncio.ensure_future(pump(stream))

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        self.recorder.close()

    @staticmethod
    def replay_into(path: str, indexer) -> int:
        """Feed a recording's RouterEvents into a KvIndexer; returns the
        number of events applied."""
        from .kv_router.protocols import RouterEvent

        n = 0
        for _ts, event in Recorder.replay(path):
            indexer.apply(RouterEvent.from_dict(event))
            n += 1
        return n
