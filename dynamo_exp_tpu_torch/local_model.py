"""Publish a model so an ingress can discover and serve it.

Counterpart of ``dynamo_exp_tpu/local_model.py`` (``register_llm``): the
worker puts its ModelDeploymentCard in the object store (bucket ``mdc``)
and writes a lease-scoped ModelEntry into the discovery KV under
``models/``; ingresses watch that prefix, fetch the card and build the
preprocessor -> backend -> router chain. A worker's death revokes its
lease, its entry goes, and the ingress drops the model once no replica
is left. A heartbeat re-stamps the card every ``CARD_MAX_AGE_S / 3``.

The card carries config.json and the chat template; the tokenizer
travels as a path (``tokenizer_path``), so ingresses share a filesystem
with workers, and the object store holds kilobytes, well inside the
codec's limits, not the megabytes of a 128k-entry ``tokenizer.json``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from dataclasses import asdict, dataclass

from .model_card import CARD_MAX_AGE_S, ModelDeploymentCard
from .runtime.component import DistributedRuntime, Endpoint

logger = logging.getLogger(__name__)

MDC_BUCKET = "mdc"
MODELS_PREFIX = "models/"


@dataclass
class ModelEntry:
    """What ingress needs to route to a served model."""

    name: str
    endpoint: str  # dyn://namespace.component.endpoint
    model_type: str = "both"  # "chat" | "completion" | "both"
    mdc_key: str = ""  # object-store key of the ModelDeploymentCard

    def to_bytes(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ModelEntry":
        return cls(**json.loads(raw))


async def register_llm(
    drt: DistributedRuntime,
    endpoint: Endpoint,
    model_path: str,
    model_name: str | None = None,
    model_type: str = "both",
    kv_cache_block_size: int | None = None,
) -> ModelEntry:
    """Publish MDC + ModelEntry so frontends can discover this worker's
    model. The entry rides the process's primary lease: if this worker
    dies, ingress unregisters the model automatically."""
    mdc = ModelDeploymentCard.from_local_path(model_path, model_name)
    if kv_cache_block_size:
        mdc.kv_cache_block_size = kv_cache_block_size
    mdc.stamp()
    await drt.object_store.put(MDC_BUCKET, mdc.slug, mdc.to_json().encode())
    entry = ModelEntry(
        name=mdc.display_name,
        endpoint=f"dyn://{endpoint.address.subject}",
        model_type=model_type,
        mdc_key=mdc.slug,
    )
    lease = await drt.primary_lease()
    # Keyed per worker (lease id suffix): N replicas write N entries, and
    # one replica's death removes only its own — the model stays served
    # until the last replica is gone.
    key = f"{MODELS_PREFIX}{mdc.slug}/{lease.lease_id}"
    await drt.discovery.kv_put(key, entry.to_bytes(), lease)
    # Heartbeat: keep last_published fresh while this worker lives, so
    # ingress can tell a served card from a dead worker's leftover. The
    # card outliving its entries is harmless only as long as it is
    # visibly stale-dated.
    drt.spawn_background(
        _mdc_heartbeat(drt, mdc, lease), name=f"mdc-heartbeat[{mdc.slug}]"
    )
    return entry


async def _mdc_heartbeat(
    drt: DistributedRuntime,
    mdc: ModelDeploymentCard,
    lease,
    period_s: float = CARD_MAX_AGE_S / 3,
) -> None:
    """Re-publish the card every ``period_s`` while the lease is valid;
    on lease loss (or cancellation at shutdown) delete it so the bucket
    doesn't accumulate dead workers' cards."""
    try:
        while lease.is_valid():
            await asyncio.sleep(period_s)
            if not lease.is_valid():
                break
            mdc.stamp()
            try:
                await drt.object_store.put(
                    MDC_BUCKET, mdc.slug, mdc.to_json().encode()
                )
            except Exception:  # noqa: BLE001 - a coordinator hiccup must
                # not kill the heartbeat (and thereby purge a live
                # worker's card); retry on the next beat.
                logger.warning(
                    "mdc heartbeat publish failed for %s; retrying",
                    mdc.slug,
                    exc_info=True,
                )
    finally:
        # Best-effort purge — but only when no other replica still has a
        # live ModelEntry for this model (N replicas share one card key;
        # the last one out removes it). Bounded: an unresponsive
        # coordinator must not wedge worker shutdown — an unpurged card
        # is still fenced by its TTL.
        with contextlib.suppress(Exception):
            remaining = await asyncio.wait_for(
                asyncio.shield(
                    drt.discovery.kv_get_prefix(f"{MODELS_PREFIX}{mdc.slug}/")
                ),
                5.0,
            )
            ours = f"{MODELS_PREFIX}{mdc.slug}/{lease.lease_id}"
            if not any(k != ours for k in remaining):
                await asyncio.wait_for(
                    asyncio.shield(
                        drt.object_store.delete(MDC_BUCKET, mdc.slug)
                    ),
                    5.0,
                )
                logger.info("purged model card %s", mdc.slug)
