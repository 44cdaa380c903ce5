"""Disaggregation config: stored in the control-plane KV, watched live.

Counterpart of ``dynamo_exp_tpu/disagg/config.py``: the same key, the
same JSON value and the same remote-or-local decision, so a config
published by either package's fleet steers both.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from dataclasses import asdict, dataclass

from ..runtime.transports.base import Discovery

logger = logging.getLogger(__name__)


def disagg_config_key(model: str) -> str:
    return f"public/disagg_router/models/{model}"


@dataclass
class DisaggConfig:
    """Tunables for the remote-prefill decision.

    ``max_local_prefill_length``: prompts with more uncached tokens than
    this go to a prefill worker. ``max_prefill_queue_size``: but not if
    the queue is already this deep (prefill workers saturated — local
    prefill beats queueing).
    """

    max_local_prefill_length: int = 1024
    max_prefill_queue_size: int = 2

    def prefill_remote(self, prefill_length: int, queue_size: int) -> bool:
        return (
            prefill_length > self.max_local_prefill_length
            and queue_size < self.max_prefill_queue_size
        )

    def to_bytes(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DisaggConfig":
        return cls(**json.loads(raw))


class DisaggConfigWatcher:
    """Live view of a model's DisaggConfig from the control-plane KV.

    ``current()`` is synchronous and lock-free (read by the request hot
    path); a background watch task applies updates as they land.
    """

    def __init__(
        self,
        discovery: Discovery,
        model: str,
        default: DisaggConfig | None = None,
    ):
        self._discovery = discovery
        self._key = disagg_config_key(model)
        self._config = default or DisaggConfig()
        self._task: asyncio.Task | None = None

    def current(self) -> DisaggConfig:
        return self._config

    async def start(self) -> None:
        """Load the initial value, then follow updates."""
        raw = await self._discovery.kv_get(self._key)
        if raw:
            self._config = DisaggConfig.from_bytes(raw)
        self._task = asyncio.ensure_future(self._follow())

    async def publish(self, config: DisaggConfig) -> None:
        """Write a new config for every watcher of this model."""
        await self._discovery.kv_put(self._key, config.to_bytes())

    async def _follow(self) -> None:
        # The watch raises (e.g. ConnectionError) when the coordinator
        # connection drops; without the retry loop the live-reconfig
        # feature would silently freeze at its last value forever.
        while True:
            try:
                async for snapshot in self._discovery.kv_watch_prefix(self._key):
                    raw = snapshot.get(self._key)
                    if raw:
                        try:
                            self._config = DisaggConfig.from_bytes(raw)
                            logger.info("disagg config updated: %s", self._config)
                        except (ValueError, TypeError, KeyError):
                            logger.warning("ignoring malformed disagg config")
            except asyncio.CancelledError:
                return
            except Exception as exc:
                logger.warning("disagg config watch lost (%s); retrying", exc)
                await asyncio.sleep(1.0)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
