"""Wire types for the prefill queue and the KV handoff.

Counterpart of ``dynamo_exp_tpu/disagg/protocol.py``, byte for byte on
the wire: for the same fields ``RemotePrefillRequest.to_bytes()`` is the
JAX one's, and ``kv_signature`` names a layout as the JAX function does,
so the two packages' fleets serve each other and refuse a mismatch
alike.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..engine.config import EngineConfig


def kv_signature(cfg: "EngineConfig") -> str:
    """Structural identity of an engine's KV page layout. Both fleets
    must agree or injected pages would be shape-garbage."""
    m = cfg.model
    return (
        f"L{m.num_layers}-ps{cfg.page_size}-kv{m.num_kv_heads}"
        f"-d{m.head_dim_}-{cfg.kv_dtype}"
    )


@dataclass
class RemotePrefillRequest:
    """One unit of prefill work pushed by a decode worker."""

    request_id: str
    token_ids: list[int]
    # Where the prefill worker delivers the pages (host:port of the
    # decode worker's KvPageReceiver).
    return_addr: str
    sampling_options: dict = field(default_factory=dict)
    # Sanity guards: both engines must agree on the KV layout.
    page_size: int = 0
    model: str = ""
    # The decode worker's trace context, so the prefill worker's spans
    # join the request's trace.
    trace_id: str = ""
    parent_span_id: str = ""
    # End-to-end deadline (unix seconds, 0 = none): the prefill worker
    # drops an expired item at pull, before any compute or transfer.
    deadline_unix: float = 0.0
    # Suffix-only transfer: leading prompt pages the decode worker
    # already holds (pinned resident there); the prefill worker neither
    # gathers nor ships them.
    skip_blocks: int = 0
    # The requesting decode worker's instance name, so the prefill
    # worker's transfer ledger records the link by name.
    decode_instance: str = ""

    def to_bytes(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "RemotePrefillRequest":
        # Unknown keys are ignored, so a newer sender's additions do not
        # make this worker drop its requests.
        d = json.loads(raw)
        known = {f.name for f in cls.__dataclass_fields__.values()}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class LeaseGrant:
    """KV-handoff lease metadata riding the transfer's BEGIN frame: the
    prefill worker pins the extracted device pages under it until the
    transfer's final ack confirms delivery, and its loop's reaper
    reclaims them once ``ttl_s`` passes (GRANTED -> CONFIRMED |
    EXPIRED). The receiver gets it for tracing: the confirm is the ack."""

    lease_id: str
    ttl_s: float = 0.0

    def to_header(self) -> dict:
        return {"lease_id": self.lease_id, "lease_ttl_s": self.ttl_s}

    @classmethod
    def from_header(cls, header: dict) -> "LeaseGrant | None":
        lid = header.get("lease_id")
        if not lid:
            return None
        return cls(lease_id=lid, ttl_s=float(header.get("lease_ttl_s") or 0.0))
