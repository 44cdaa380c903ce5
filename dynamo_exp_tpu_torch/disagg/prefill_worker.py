"""Prefill worker: pulls the prefill queue, computes, ships KV pages.

Counterpart of ``dynamo_exp_tpu/disagg/prefill_worker.py`` around a
:class:`~dynamo_exp_tpu_torch.engine.TorchEngine`: it drops an item
whose deadline passed at pull (``prefill_queue`` stage), refuses a page
size or KV layout that differs from its engine's with a failure notice
on the wire, runs ``prefill_extract`` (the prompt's pages pinned under a
handoff lease; whole pages at any tp degree, rank 0 gathering the
ranks' heads) and ships them with ``send_kv_pages``; the transfer's
final ack confirms the lease. A delivery that fails leaves the lease to
the engine's reaper. On cancellation the worker finishes the request it
already pulled, then stops pulling.
"""

from __future__ import annotations

import logging
import time

from ..engine.engine import TorchEngine
from ..protocols.common import BackendInput, SamplingOptions
from ..runtime.runtime import CancellationToken
from ..runtime.transports.base import WorkQueue
from ..telemetry import TraceContext, adopt, get_telemetry
from .protocol import LeaseGrant, RemotePrefillRequest, kv_signature
from .transfer import send_kv_pages

logger = logging.getLogger(__name__)


class PrefillWorker:
    """One pull loop around an engine doing prefill-only work."""

    def __init__(
        self,
        engine: TorchEngine,
        queue: WorkQueue,
        cancel: CancellationToken | None = None,
        component=None,
    ):
        self.engine = engine
        self.queue = queue
        self.cancel = cancel or CancellationToken()
        self.component = component
        self.served = 0  # requests completed (metrics)
        self.failed = 0
        self.expired = 0  # dropped at pull: deadline already passed
        self._presence = None

    async def register(self) -> None:
        """Advertise this worker on the discovery plane so a planner can
        count the prefill fleet. Pull workers take no pushed requests:
        the endpoint exists for presence and stats only."""
        if self.component is None:
            return

        async def handler(request: dict, context=None):
            yield {
                "data": {
                    "served": self.served,
                    "failed": self.failed,
                    "expired": self.expired,
                }
            }

        self._presence = await self.component.endpoint("pull").serve_endpoint(
            handler, stats_handler=lambda: self.engine.metrics()
        )

    async def run(self) -> None:
        """Pull until cancelled. Short pull timeouts keep the drain
        window tight without busy-waiting."""
        if self.component is not None and self._presence is None:
            await self.register()
        try:
            while not self.cancel.is_cancelled():
                item = await self.queue.pull(timeout_s=0.25)
                if item is None:
                    continue
                await self._serve_one(item)
        finally:
            if self._presence is not None:
                await self._presence.close()
                self._presence = None

    async def _serve_one(self, item: bytes) -> None:
        try:
            req = RemotePrefillRequest.from_bytes(item)
        except (ValueError, TypeError, KeyError):
            logger.exception("malformed prefill request dropped")
            self.failed += 1
            return
        if req.deadline_unix and time.time() >= req.deadline_unix:
            # The decode side has already given up (its transfer wait is
            # bounded by the same deadline): drop before prefill compute
            # and KV transfer — expired work must not occupy the fleet.
            self.expired += 1
            get_telemetry().deadline_exceeded.labels("prefill_queue").inc()
            logger.info(
                "dropping expired prefill request %s (deadline passed %.2fs ago)",
                req.request_id, time.time() - req.deadline_unix,
            )
            return
        if req.page_size and req.page_size != self.engine.cfg.page_size:
            await self._fail(req, "page_size mismatch")
            return
        if req.model and req.model != kv_signature(self.engine.cfg):
            await self._fail(req, "KV layout mismatch between fleets")
            return
        # Continue the decode worker's trace: spans emitted while serving
        # (engine queue wait + prefill compute, KV transfer send) and any
        # JSONL log lines parent into the request's trace tree.
        trace = TraceContext.from_wire(
            {"trace_id": req.trace_id, "parent_span_id": req.parent_span_id}
        )
        with adopt(trace):
            try:
                binput = BackendInput(
                    token_ids=req.token_ids,
                    sampling_options=SamplingOptions.from_dict(req.sampling_options),
                )
                skip = max(int(req.skip_blocks or 0), 0)
                # Keyword only when the decode side asked for a suffix:
                # engine stubs that do not know skip_pages keep working
                # for full transfers.
                first_token, pages, lease_id = await (
                    self.engine.prefill_extract(binput, skip_pages=skip)
                    if skip
                    else self.engine.prefill_extract(binput)
                )
            except Exception as e:  # noqa: BLE001 - report upstream, keep serving
                logger.exception("prefill failed for %s", req.request_id)
                await self._fail(req, f"{type(e).__name__}: {e}")
                return
            lease = (
                LeaseGrant(lease_id, self.engine.cfg.kv_lease_ttl_s)
                if lease_id
                else None
            )
            try:
                await send_kv_pages(
                    req.return_addr, req.request_id, first_token, pages,
                    lease=lease, dst_instance=req.decode_instance,
                )
                # Delivery acked end-to-end: the decode side owns a host
                # copy of every page, so the handoff lease is confirmed
                # and the pinned device pages may park for reuse (the
                # confirm is queued for the engine loop).
                if lease_id:
                    self.engine.confirm_kv_lease(lease_id)
                self.served += 1
            except Exception:  # noqa: BLE001 - a delivery failure (decode worker
                # died, dropped the connection pre-ack, …) must never kill the
                # pull loop; the decode side times out and prefills locally.
                # The handoff lease is deliberately NOT confirmed: the
                # engine's reaper reclaims the pinned pages at expiry, so
                # a decode death between extract and inject cannot strand
                # device memory.
                logger.warning(
                    "KV delivery failed for %s (lease %s left to the reaper)",
                    req.request_id, lease_id or "-", exc_info=True,
                )
                self.failed += 1

    async def _fail(self, req: RemotePrefillRequest, error: str) -> None:
        self.failed += 1
        try:
            await send_kv_pages(req.return_addr, req.request_id, 0, [], error=error)
        except Exception:  # noqa: BLE001 - best-effort notification
            logger.debug("could not deliver failure notice for %s", req.request_id)
