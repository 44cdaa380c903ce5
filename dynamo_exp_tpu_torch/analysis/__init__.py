"""dynlint: AST invariant checkers for the port's hot-path contracts.

Counterpart of ``dynamo_exp_tpu/analysis/``, over ``dynamo_exp_tpu_torch/``.
Four properties the engine leans on are machine-checked rules here:

- ``host-sync`` — declared hot-path zones (the engine loop, scheduler,
  offload / CopyStream, CUDA graphs, dispatch profiler) may not add
  implicit device->host syncs: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` of a device tensor, ``torch.cuda.synchronize()``, an
  event's ``.synchronize()``, casts and truthiness of a device tensor,
  and the ops with a data-dependent output shape. Every legitimate sync
  point is an inline-waived, reviewed allowlist entry. Complements the
  smoke's ``torch.cuda.set_sync_debug_mode``, which catches syncs only
  on the paths one run drives.
- ``determinism`` — seed-deterministic zones (``sim/``, ``spec/``, the
  chaos schedules, the flight recorder's payloads, ``aot/``, ``tune/``)
  may not read wall clocks, unseeded RNGs (torch's global generator
  included), ``uuid`` / ``os.urandom``, or leak ``id()`` / ``hash()``
  into recorded payloads.
- ``thread-ownership`` — a manifest declares which ``TorchEngine``
  attributes only the loop thread may mutate; writes to them on call
  paths reachable from non-loop entry points are flagged, as are
  accesses to lock-guarded state outside its ``with lock:`` block.
- ``recompile-hazard`` — CUDA graph keys (``WindowKey`` / ``MixedKey``
  and the keys reaching ``DispatchGraphs.get``) must come from the
  lattice (``resolve_window_key``, ``resolve_mixed_key``, the
  ``*_bucket_for`` helpers); a raw dynamic int in a key captures a
  graph per value.
- ``waiver-syntax`` — every waiver names a known token and a reason.

Waivers: ``# dynlint: <token>(<reason>)`` on any line of the flagged
statement, tokens ``sync-point``, ``determinism``, ``thread-ownership``
and ``recompile-hazard`` (the JAX package's spelling). The allowlist's
reasons, each used in the tree:

- ``ragged consume`` — the wait on a dispatch's event before its pinned
  outputs are read (``TorchEngine._host``): the loop's one sync a
  dispatch.
- ``extract gather consume`` — the device -> host leg of a page
  extraction, on the calling thread (``CopyStream.to_host``).
- ``offload copy-thread transfer`` — an offload batch's copy waited on
  by the copy thread, off the loop (``CopyStream._run``).
- ``upload events read for the copy totals`` — finished uploads'
  events when the copy totals are read, at ``stats()`` or ``stop()``
  (``CopyStream.poll``).
- ``host-resident G2 page, no device handle`` — a host pool page's
  bytes for the disk tier (``kv/persistent.py``).
- ``loop thread joined before teardown flush`` — ``stop()``'s flush of
  loop-owned state, after the loop thread has been joined.
- ``prewarm wall-clock metric``, ``recorder-owned wall stamp``,
  ``live validation wall-clock measurement`` and
  ``host-only wall-clock report field`` — wall times recorded beside
  seeded results, never part of them.

Everything here is pure stdlib (``ast``, ``re``, ``tokenize``).
"""

from .core import Finding, Zone, parse_waivers
from .determinism import DeterminismChecker
from .host_sync import HostSyncChecker
from .ownership import LockManifest, ThreadManifest, ThreadOwnershipChecker
from .recompile import RecompileHazardChecker, VariantSiteManifest
from .runner import RULES, WAIVER_TOKENS, lint_tree, run_cli

__all__ = [
    "Finding",
    "Zone",
    "parse_waivers",
    "HostSyncChecker",
    "DeterminismChecker",
    "ThreadOwnershipChecker",
    "ThreadManifest",
    "LockManifest",
    "RecompileHazardChecker",
    "VariantSiteManifest",
    "RULES",
    "WAIVER_TOKENS",
    "lint_tree",
    "run_cli",
]
