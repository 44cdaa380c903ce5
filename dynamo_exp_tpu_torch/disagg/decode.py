"""Decode-side disaggregation: the conditional remote-prefill engine.

Counterpart of ``dynamo_exp_tpu/disagg/decode.py`` around a
:class:`~dynamo_exp_tpu_torch.engine.TorchEngine`: per request it
decides local or remote prefill from the uncached prefill length, the
prefill queue's depth and the live :class:`DisaggConfig`; on remote it
pins the resident prefix (the suffix-only transfer's ``skip_blocks``),
queues a :class:`RemotePrefillRequest` and hands the engine the pages
that arrive (``generate(..., remote_kv=)``), after checking their count
and shape (the whole page: every kv head, at any tp degree of either
side). Any transfer problem falls back to local prefill, and a
circuit breaker sends every request local while the prefill fleet is
down: disaggregation is an optimisation, never a correctness
dependency.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import asdict

from ..engine.engine import TorchEngine
from ..engine.scheduler import RemoteKv
from ..protocols.common import BackendInput
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from ..runtime.health import CircuitBreaker
from ..runtime.transports.base import WorkQueue
from ..telemetry import get_telemetry, span as trace_span
from .config import DisaggConfigWatcher
from .protocol import RemotePrefillRequest, kv_signature
from .transfer import KvPageReceiver

logger = logging.getLogger(__name__)


class DisaggDecodeEngine(AsyncEngine):
    """Wraps a TorchEngine; long uncached prefills are offloaded to the
    prefill fleet through the work queue + KV transfer plane.

    A circuit breaker guards the remote path: when the prefill fleet is
    dead, every offload attempt burns ``transfer_timeout_s`` of TTFT
    before falling back — after ``breaker``'s threshold of consecutive
    failures new requests prefill locally immediately, with a half-open
    probe re-testing the fleet each cooldown."""

    def __init__(
        self,
        engine: TorchEngine,
        queue: WorkQueue,
        receiver: KvPageReceiver,
        config: DisaggConfigWatcher,
        transfer_timeout_s: float = 60.0,
        breaker: CircuitBreaker | None = None,
    ):
        self.engine = engine
        self.queue = queue
        self.receiver = receiver
        self.config = config
        self.transfer_timeout_s = transfer_timeout_s
        self.breaker = breaker or CircuitBreaker(name="remote-prefill")
        self.remote_prefills = 0  # metrics
        self.local_fallbacks = 0
        self.queue_probe_failures = 0
        # Suffix-only transfers: prompt blocks NOT shipped because this
        # decode worker already held them.
        self.blocks_skipped = 0

    async def generate(
        self, request: dict | BackendInput, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        ctx = context or AsyncEngineContext()
        ctx.check_deadline("decode")
        binput = (
            request
            if isinstance(request, BackendInput)
            else BackendInput.from_dict(request)
        )
        remote_kv = None
        # Breaker state first (would_allow doesn't claim the half-open
        # probe slot): with the fleet dead, requests must go local
        # without even paying the queue.size() round-trip.
        if (
            self.breaker.would_allow()
            and await self._should_prefill_remote(binput)
            and self.breaker.allow()
        ):
            try:
                remote_kv = await self._remote_prefill(binput, ctx)
            except BaseException:
                # _remote_prefill records success/failure for everything
                # it catches; only cancellation (and kin) escapes — free
                # the claimed half-open probe slot without an outcome.
                self.breaker.release()
                raise
        return await self.engine.generate(binput, ctx, remote_kv=remote_kv)

    async def _should_prefill_remote(self, binput: BackendInput) -> bool:
        cfg = self.config.current()
        # The router annotates its prefix-overlap estimate; subtract the
        # cached part so the decision weighs actual prefill compute.
        cached = (binput.estimated_prefix_hit_num_blocks or 0) * self.engine.cfg.page_size
        prefill_len = max(len(binput.token_ids) - cached, 0)
        if prefill_len <= cfg.max_local_prefill_length:
            return False
        try:
            queue_size = await self.queue.size()
        except Exception:  # noqa: BLE001 - a broken queue means "no fleet":
            # prefill locally, per the module's best-effort contract. The
            # request must not die because an optimization's control
            # plane is down.
            logger.warning(
                "prefill queue size probe failed; prefilling locally",
                exc_info=True,
            )
            self.queue_probe_failures += 1
            return False
        return cfg.prefill_remote(prefill_len, queue_size)

    async def _remote_prefill(
        self, binput: BackendInput, ctx: AsyncEngineContext
    ) -> RemoteKv | None:
        """Queue the prefill and await its KV; None means do it locally."""
        rid = ctx.id
        fut = self.receiver.expect(rid)
        # The transfer wait never outlives the request's own deadline.
        timeout = self.transfer_timeout_s
        remaining = ctx.time_remaining()
        if remaining is not None:
            timeout = min(timeout, max(remaining, 0.0))
        # Suffix-only transfer: pin the locally
        # resident shared prefix so the wire ships only the unshared
        # suffix. The pin (a KV lease) keeps those pages resident until
        # admission re-references them; at least the last page always
        # ships (it carries the partial tail + proves the worker ran).
        need_pages = -(-len(binput.token_ids) // self.engine.cfg.page_size)
        skip, pin_lease = 0, None
        try:
            skip, pin_lease = await self.engine.pin_prefix(binput.token_ids)
        except Exception:  # noqa: BLE001 - the pin is an optimization
            logger.warning("prefix pin failed; full transfer", exc_info=True)
        skip = min(skip, max(need_pages - 1, 0))
        with trace_span(
            "remote_prefill",
            request_id=rid,
            prompt_tokens=len(binput.token_ids),
            skipped_blocks=skip or None,
            # Failover continuation (prompt + journaled tokens being
            # re-prefilled): the re-prefill hop's remote leg.
            resumed_tokens=binput.resume_offset or None,
        ) as sp:
            # The span's own context rides the queue, so the prefill
            # worker's spans (engine queue wait, prefill compute, KV
            # transfer send) land under this node of the trace.
            req = RemotePrefillRequest(
                request_id=rid,
                token_ids=list(binput.token_ids),
                return_addr=self.receiver.address,
                sampling_options={
                    k: v for k, v in asdict(binput.sampling_options).items()
                    if v is not None
                },
                page_size=self.engine.cfg.page_size,
                model=kv_signature(self.engine.cfg),
                trace_id=sp.context.trace_id,
                parent_span_id=sp.context.span_id,
                deadline_unix=ctx.deadline or 0.0,
                skip_blocks=skip,
                # Per-link transfer ledger: the prefill worker records
                # the (src, dst) link by instance name, not by this
                # process's ephemeral receiver port.
                decode_instance=get_telemetry().instance,
            )
            try:
                await self.queue.push(req.to_bytes())
                first_token, pages = await asyncio.wait_for(
                    fut, timeout=timeout
                )
                skip_used = self._check_page_shapes(
                    pages, len(binput.token_ids), skip
                )
                self.remote_prefills += 1
                self.blocks_skipped += skip_used
                self.breaker.record_success()
                sp.set(outcome="remote", skipped_blocks=skip_used or None)
                return RemoteKv(
                    first_token=first_token,
                    pages=pages,
                    skip_pages=skip_used,
                    pin_lease=pin_lease,
                )
            except Exception:  # noqa: BLE001 - remote prefill is best-effort
                logger.exception(
                    "remote prefill failed for %s; prefilling locally", rid
                )
                self.receiver.forget(rid)
                self.local_fallbacks += 1
                if pin_lease:
                    # Local prefill will re-match (or recompute) the
                    # prefix itself; release the routing-time pin.
                    self.engine.confirm_kv_lease(pin_lease)
                # A wait cut short by the *request's own deadline* says
                # nothing about fleet health — only count fleet-attributable
                # failures toward the breaker, or three short-deadline
                # requests would lock healthy remote prefill out for a
                # whole cooldown. But allow() may have claimed the
                # half-open probe slot: a no-outcome exit must RELEASE
                # it, or the breaker sticks in HALF_OPEN and remote
                # prefill is locked out forever (ROADMAP open item).
                if not ctx.deadline_expired:
                    self.breaker.record_failure()
                else:
                    self.breaker.release()
                sp.set(outcome="local_fallback")
                return None
            except BaseException:
                # Cancellation (client disconnect / deadline) must not
                # strand the suffix-transfer pin until the lease TTL —
                # under a burst of cancelled long-prefix requests that
                # transiently shrinks the decode pool for live work.
                self.receiver.forget(rid)
                if pin_lease:
                    self.engine.confirm_kv_lease(pin_lease)
                raise

    def _check_page_shapes(
        self, pages: list, prompt_len: int, skip: int = 0
    ) -> int:
        """Last line of defense: a wrong-shaped or short transfer must
        fall back to local prefill here, not leave uninitialized device
        pages that decode silently attends over. Returns the skip the
        sender actually honored: a full-length reply (older worker that
        ignores ``skip_blocks``) is accepted as skip 0."""
        cfg = self.engine.cfg
        need = (prompt_len + cfg.page_size - 1) // cfg.page_size
        if len(pages) == need:
            skip_used = 0  # full transfer (skip ignored or 0)
        elif skip and len(pages) == need - skip:
            skip_used = skip  # suffix-only transfer
        else:
            raise ValueError(
                f"got {len(pages)} KV pages, expected {need} "
                f"(or {need - skip} with skip_blocks={skip})"
            )
        expected = (
            cfg.model.num_layers,
            cfg.page_size,
            cfg.model.num_kv_heads * cfg.model.head_dim_,
        )
        for k, v in pages:
            if tuple(k.shape) != expected or tuple(v.shape) != expected:
                raise ValueError(
                    f"KV page shape {tuple(k.shape)} != expected {expected}"
                )
        return skip_used

    def metrics(self) -> dict:
        m = self.engine.metrics()
        m["disagg_remote_prefills"] = self.remote_prefills
        m["disagg_local_fallbacks"] = self.local_fallbacks
        m["disagg_queue_probe_failures"] = self.queue_probe_failures
        m["disagg_blocks_skipped"] = self.blocks_skipped
        m["disagg_breaker_state"] = self.breaker.state.value
        return m
