"""Ingress model discovery: watch ``models/``, build serving chains.

Counterpart of ``dynamo_exp_tpu/http/discovery.py`` (``ModelWatcher``):
on a new ModelEntry, fetch the ModelDeploymentCard from the object
store and register a preprocessor -> backend -> router chain with the
ModelManager; when the last entry of a model goes (lease expiry =
worker death), drop the model. Expired cards are swept.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging

from ..local_model import MDC_BUCKET, MODELS_PREFIX, ModelEntry
from ..model_card import ModelDeploymentCard
from ..runtime.component import DistributedRuntime
from ..runtime.push_router import RouterMode
from ..runtime.transports.base import EndpointAddress
from .service import ModelManager, build_pipeline_engine

logger = logging.getLogger(__name__)


class ModelWatcher:
    """Keeps a ModelManager in sync with the discovery KV's ``models/``."""

    def __init__(
        self,
        drt: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.RANDOM,
    ):
        self.drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self._task: asyncio.Task | None = None
        # Reconciled state. Bindings map each served surface —
        # (name, "chat"/"completion") — to the serving identity it is
        # currently routed through. Chains/routers are keyed by that
        # identity — (name, endpoint, mdc_key) — NOT by name alone: one
        # name's chat and completion entries may point at different
        # workers, and each surface's traffic must ride its own entry's
        # chain.
        self._bindings: dict[tuple[str, str], tuple] = {}
        self._kv_routers: dict[tuple, object] = {}
        self._chains: dict[tuple, object] = {}

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._watch())
        self._sweep_task = asyncio.ensure_future(self._sweep_expired_cards())

    async def close(self) -> None:
        for attr in ("_task", "_sweep_task"):
            task = getattr(self, attr, None)
            if task is not None:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
                setattr(self, attr, None)
        for r in self._kv_routers.values():
            await r.stop()
        self._kv_routers.clear()

    async def _watch(self) -> None:
        # The watch stream itself can break (coordinator hiccup); an
        # ingress must re-establish it, not freeze its model set.
        while True:
            try:
                async for snapshot in self.drt.discovery.kv_watch_prefix(
                    MODELS_PREFIX
                ):
                    try:
                        await self._apply(snapshot)
                    except Exception:  # noqa: BLE001 - keep watching
                        logger.exception("model watch apply failed")
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - reconnect after backoff
                logger.exception("model watch stream broke; retrying")
                await asyncio.sleep(1.0)

    async def _sweep_expired_cards(self, period_s: float | None = None) -> None:
        """Delete cards whose heartbeat went stale, checked every
        CARD_MAX_AGE/3. The worker-side
        purge is best-effort — two replicas closing simultaneously can
        each skip deletion seeing the other's entry — so ingress owns
        the authoritative sweep; ``is_expired`` at fetch time fences any
        card a sweep hasn't reached yet."""
        from ..model_card import CARD_MAX_AGE_S

        if period_s is None:
            period_s = CARD_MAX_AGE_S / 3
        while True:
            await asyncio.sleep(period_s)
            try:
                for key in await self.drt.object_store.list(MDC_BUCKET):
                    raw = await self.drt.object_store.get(MDC_BUCKET, key)
                    if raw is None:
                        continue
                    try:
                        card = ModelDeploymentCard.from_json(raw.decode())
                    except Exception:  # noqa: BLE001 - unreadable card:
                        continue  # leave for an operator to inspect
                    if card.is_expired():
                        # Re-fetch immediately before deleting: a worker
                        # heartbeat landing between the first read and
                        # the delete re-stamps the card, and deleting on
                        # the stale copy would sweep a live model. The
                        # narrow re-check window can't fully close the
                        # race (the store has no compare-and-delete) but
                        # the heartbeat re-publishes every
                        # CARD_MAX_AGE_S/3, so a lost card outlives one
                        # period at most.
                        raw = await self.drt.object_store.get(MDC_BUCKET, key)
                        if raw is None:
                            continue
                        try:
                            card = ModelDeploymentCard.from_json(raw.decode())
                        except Exception:  # noqa: BLE001 - unreadable now:
                            continue  # leave for an operator to inspect
                        if not card.is_expired():
                            continue  # heartbeat won the race; keep it
                        await self.drt.object_store.delete(MDC_BUCKET, key)
                        logger.info("swept expired model card %s", key)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - retry next period
                logger.exception("model card sweep failed")

    @staticmethod
    def _types_of(model_type: str) -> set[str]:
        return {"chat", "completion"} if model_type == "both" else {model_type}

    async def _apply(self, snapshot: dict[str, bytes]) -> None:
        """Reconcile served surfaces with the snapshot, declaratively.

        Desired state is recomputed from scratch each time: for every
        (name, type) surface, the first live entry (sorted by KV key,
        deterministic) provides the serving identity. Diffing desired
        against current bindings handles every transition in one place
        — add, last-replica removal, AND identity churn (a worker
        re-registering with a new endpoint or model card rebinds the
        surface to the new identity instead of freezing on the old).
        """
        desired: dict[tuple[str, str], tuple] = {}
        entries_by_identity: dict[tuple, ModelEntry] = {}
        for key in sorted(snapshot):
            try:
                entry = ModelEntry.from_bytes(snapshot[key])
            except Exception:  # noqa: BLE001 - one bad entry: skip it
                logger.exception("undecodable model entry %s", key)
                continue
            ident = (entry.name, entry.endpoint, entry.mdc_key)
            entries_by_identity.setdefault(ident, entry)
            for t in self._types_of(entry.model_type):
                desired.setdefault((entry.name, t), ident)

        # Bind new/changed surfaces. Per-surface guard: one bad entry
        # (missing MDC, unreadable tokenizer) must not block siblings.
        for surface, ident in desired.items():
            if self._bindings.get(surface) == ident:
                continue
            try:
                engine = self._chains.get(ident)
                if engine is None:
                    engine = await self._build_chain(entries_by_identity[ident])
                    self._chains[ident] = engine
                name, t = surface
                if t == "chat":
                    self.manager.add_chat_model(name, engine)
                else:
                    self.manager.add_completion_model(name, engine)
                self._bindings[surface] = ident
                logger.info("model %s (%s) bound to %s", name, t, ident[1])
            except Exception:  # noqa: BLE001 - retried on next KV change
                logger.exception("failed to bind %s to %s", surface, ident)

        # Unbind surfaces with no live entry left.
        for surface in [s for s in self._bindings if s not in desired]:
            name, t = surface
            if t == "chat":
                self.manager.remove_chat_model(name)
            else:
                self.manager.remove_completion_model(name)
            del self._bindings[surface]
            logger.info("model %s (%s) removed (last worker gone)", name, t)

        # Tear down chains/routers no surface routes through anymore
        # (identity died, or a rebind moved its surfaces elsewhere).
        in_use = set(self._bindings.values())
        for ck in [k for k in self._chains if k not in in_use]:
            del self._chains[ck]
        for rk in [k for k in self._kv_routers if k not in in_use]:
            router = self._kv_routers.pop(rk)
            await router.stop()  # drop its event sub + scrape loop

    async def _build_chain(self, entry: ModelEntry):
        raw = await self.drt.object_store.get(MDC_BUCKET, entry.mdc_key)
        if raw is None:
            raise RuntimeError(f"no MDC in object store for {entry.name}")
        mdc = ModelDeploymentCard.from_json(raw.decode())
        if mdc.is_expired():
            # Heartbeats re-stamp every CARD_MAX_AGE_S/3; a stale stamp
            # means every publisher of this card is gone (the ModelEntry
            # that led us here is a leftover about to be swept). Never
            # build a serving chain from a dead worker's card.
            raise RuntimeError(
                f"model card for {entry.name} expired "
                f"(last published {mdc.last_published})"
            )
        addr = EndpointAddress.from_url(entry.endpoint)
        ep = (
            self.drt.namespace(addr.namespace)
            .component(addr.component)
            .endpoint(addr.name)
        )
        from ..kv_router.router import build_routed_core

        core, kv_router = await build_routed_core(
            ep, self.router_mode, mdc.kv_cache_block_size
        )
        if kv_router is not None:
            # A retry after a partially-failed registration may rebuild
            # the chain; stop the superseded router or it scrapes forever.
            rk = (entry.name, entry.endpoint, entry.mdc_key)
            old = self._kv_routers.pop(rk, None)
            if old is not None:
                await old.stop()
            self._kv_routers[rk] = kv_router
        return build_pipeline_engine(mdc, core)
