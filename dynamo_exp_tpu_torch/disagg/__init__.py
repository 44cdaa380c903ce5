"""Disaggregated prefill/decode serving.

Counterpart of ``dynamo_exp_tpu/disagg/``, on the same wire:

- decode workers conditionally push long prefills onto a shared work
  queue (the coordinator's);
- prefill workers pull, run prefill on their own engine, and stream the
  computed KV pages to the decode worker over a direct TCP data plane
  (host-bounced through pinned memory, injected on arrival);
- the remote/local decision is a live-reconfigurable config watched
  from the control-plane KV store.
"""

from .config import DisaggConfig, DisaggConfigWatcher, disagg_config_key
from .decode import DisaggDecodeEngine
from .prefill_worker import PrefillWorker
from .protocol import RemotePrefillRequest
from .transfer import KvPageReceiver, send_kv_pages

__all__ = [
    "DisaggConfig",
    "DisaggConfigWatcher",
    "disagg_config_key",
    "DisaggDecodeEngine",
    "PrefillWorker",
    "RemotePrefillRequest",
    "KvPageReceiver",
    "send_kv_pages",
]
