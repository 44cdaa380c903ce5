"""Declared dynlint zones and manifests of the port.

Counterpart of ``dynamo_exp_tpu/analysis/zones.py``: the same contracts,
mapped onto the port's files. This file is the one place the lint suite
learns *where* each contract applies; when files split or move, update
the declarations here and the checkers follow.
"""

from __future__ import annotations

from .core import Zone
from .ownership import LockManifest, ThreadManifest
from .recompile import VariantSiteManifest

PKG = "dynamo_exp_tpu_torch/"

# --------------------------------------------------------- host-sync zones
# The engine hot path: code that runs on (or hands work to) the engine
# loop thread, where one accidental blocking copy serializes the
# dispatch pipeline. ``generate``/``prefill_extract`` are excluded: they
# run on asyncio threads at submission time and never touch device
# values.
HOT_PATH_ZONES: tuple[Zone, ...] = (
    Zone(
        PKG + "engine/engine.py",
        exclude=("TorchEngine.generate", "TorchEngine.prefill_extract"),
    ),
    Zone(PKG + "engine/scheduler.py"),
    Zone(PKG + "engine/offload.py"),
    Zone(PKG + "engine/kv_manager.py"),
    # The prefix-sharing radix index runs inside allocate_sequence /
    # register_full_page on the loop thread: pure host bookkeeping.
    Zone(PKG + "kv/prefix.py"),
    # The G3 store's match/fetch run inside admission and the prefetch
    # planner on the loop thread (file I/O is host work; no device
    # value may reach it).
    Zone(PKG + "kv/persistent.py"),
    # Footprint forecasts, packing and swap planning run inside the
    # admission/pressure paths on the loop thread.
    Zone(PKG + "engine/tiering.py"),
    # The profiler's whole contract is "zero added host syncs".
    Zone(PKG + "telemetry/dispatch.py"),
    # The transfer ledger and the conservation auditor run inside the
    # engine loop: pure host bookkeeping.
    Zone(PKG + "telemetry/fleet.py"),
    # The CUDA graphs of the dispatches: capture at a key's first use
    # and every replay run on the loop thread.
    Zone(PKG + "engine/graphs.py"),
)

# ------------------------------------------------------ determinism zones
# Seed-deterministic code: the same seed must mean bit-identical outputs
# across runs and hosts. The FlightRecorder class is in zone because its
# ring payloads are compared across runs; the Watchdog in the same file
# is wall-clock-driven by design and stays out.
DETERMINISM_ZONES: tuple[Zone, ...] = (
    Zone(PKG + "sim/"),
    Zone(PKG + "spec/"),
    Zone(PKG + "runtime/transports/chaos.py"),
    # The G3 store: eviction order, boot-scan adoption order and chaos
    # fault injection must be seed/insertion-deterministic. The only
    # sanctioned sleep is the injected-latency fault (time.sleep is not
    # a clock read).
    Zone(PKG + "kv/persistent.py"),
    Zone(PKG + "telemetry/flight.py", include=("FlightRecorder",)),
    # The graph lattice: the manifest hash is the warm boot's cache key,
    # so enumeration and hashing must be byte-identical across
    # processes. The prewarm's timing metrics are the only sanctioned
    # wall-clock reads (inline-waived).
    Zone(PKG + "aot/"),
    # Request anatomy and the workload fingerprint: the same trace must
    # always yield the same waterfall and the same digest.
    Zone(PKG + "telemetry/anatomy.py"),
    Zone(PKG + "telemetry/fingerprint.py"),
    # The reclaim triage planner is shared between the live controller
    # and the simulator: its pure planning functions are in zone; the
    # controller races a SIGKILL deadline by design and stays out.
    Zone(
        PKG + "runtime/reclaim.py",
        include=(
            "plan_triage",
            "nearest_survivor",
            "migration_lease_ttl_s",
            "survivors_from_instances",
        ),
    ),
    # The autotuner: the trial journal is the resume contract and the
    # knob-space digest a cache key. The live validation times a real
    # engine; its reads are inline-waived.
    Zone(PKG + "tune/"),
)

# ------------------------------------------------- thread-ownership model
# Engine-loop-owned state vs cross-thread handoff surfaces: scheduler
# and page state may only be mutated on the loop thread; other threads
# talk to the loop through the queues and events below.
OWNERSHIP_MANIFESTS: tuple[ThreadManifest, ...] = (
    ThreadManifest(
        path=PKG + "engine/engine.py",
        cls="TorchEngine",
        loop_entries=("_loop",),
        external_entries=(
            "start",
            "stop",
            "generate",  # asyncio ingress
            "prefill_extract",  # asyncio ingress (disagg prefill)
            "confirm_kv_lease",  # prefill worker's delivery ack thread
            "pin_prefix",  # disagg router's suffix-transfer pin (asyncio)
            # Spot-reclamation plane: asyncio ingress for the triage
            # snapshot / page extraction / survivor-side prefix seeding,
            # all serviced on the loop through _reclaim_q.
            "reclaim_inflight",
            "reclaim_extract",
            "seed_prefix",
            "_reclaim_call",
            "metrics",  # /metrics scrapes from serving threads
            "_flight_snapshot",  # watchdog thread
            "_dump_flight",  # watchdog / SIGUSR1 / crash paths
            "_on_prefetched",  # CopyStream fetch completion (copy thread)
        ),
        loop_owned=frozenset(
            {
                "sched",
                "kv",
                "k_cache",
                "v_cache",
                "model",
                "graphs",
                "_counts",
                "_inflight",
                "_pending_offloads",
                "_staged",
                "_spec",
                "steps",
                "wasted_steps",
                "dispatches",
                "preempted",
                "swapped_out",
                "swapped_in",
                "spec_dispatches",
                "spec_row_dispatches",
                "spec_draft_tokens",
                "spec_accepted_tokens",
                "spec_emitted_tokens",
                "_progress_mark",
                "_last_gauge_pub",
                "_last_reap",
                "_pub_prefix_hits",  # gauge-publish counter snapshots
                "_pub_store_checksum_failures",  # G3 counter snapshots
                "_pub_store_quarantined",
                # The KV conservation auditor's episode state and
                # violation counter, and the open lease-span map (grant,
                # confirm and reap all run on the loop).
                "kv_ledger_violations",
                "_ledger_last",
                "_ledger_dumped",
                "_lease_traces",
                "leases_granted",
                "leases_confirmed",
                "kv_extract_pages",
                "kv_extract_s",
                "kv_inject_pages",
                # Prefetch planning state and counters, mutated on the
                # loop only; the copy thread answers through
                # _prefetch_done_q.
                "_prefetch_inflight",
                "_prefetch_served",
                "_last_prefetch_scan",
                "prefetched_pages",
                "prefetch_hits",
                # Request anatomy totals, accumulated in the scheduler's
                # finish callback on the loop; metrics() reads them
                # cross-thread as monotonic GIL-atomic snapshots.
                "anatomy_totals",
                "anatomy_requests",
            }
        ),
        handoff=frozenset(
            {
                # Queues/events other threads feed the loop through.
                "_submit_q",
                "_lease_confirm_q",
                "_pin_q",
                "_reclaim_q",
                "_prefetch_done_q",
                "_wake",
                "_held",  # hold_admission's pause flag (an Event)
                # Lifecycle flags/threads, written only before the loop
                # starts or after it is joined.
                "_running",
                "_thread",
                "_crashed",
                "_watchdog",
                "_flight_handle",
                "copy_stream",
                # Internally synchronized (lock / GIL-relying, see the
                # lock manifests).
                "host_pool",
                "g3_store",
                "flight",
                "profiler",
                "anatomy_ring",
                "fingerprint",
                "drift_watch",
                "cfg",
                "comm",
                "_tp",
                "_seed_rng",  # submission-side only (asyncio threads)
                "_build_info",  # written once in __init__, read-only after
                "_copy_totals",
                "prewarm_report",  # written by the prewarm, before start
            }
        ),
    ),
)

# Lock-guarded shared state: every read or write of a guarded attribute
# inside its class must sit under ``with self.<lock>:``.
LOCK_MANIFESTS: tuple[LockManifest, ...] = (
    LockManifest(
        path=PKG + "engine/offload.py",
        cls="HostKvPool",
        lock="_lock",
        guarded=frozenset(
            {"_k", "_v", "_free", "_by_hash", "stores", "hits", "evictions"}
        ),
    ),
    LockManifest(
        # The G3 store's index: written by the copy thread (demotions)
        # and the engine loop (admission promotes, stop drain). File I/O
        # runs OUTSIDE the lock (content addressing makes same-hash
        # racers benign); only the index state is guarded.
        path=PKG + "kv/persistent.py",
        cls="PersistentKvStore",
        lock="_lock",
        guarded=frozenset({"_by_hash", "_quarantined"}),
    ),
    LockManifest(
        path=PKG + "telemetry/flight.py",
        cls="FlightRecorder",
        lock="_lock",
        guarded=frozenset({"_ring", "_head", "seq"}),
    ),
    LockManifest(
        # Recorded from asyncio transfer paths, snapshotted from
        # serving/scraper threads.
        path=PKG + "telemetry/fleet.py",
        cls="TransferLedger",
        lock="_lock",
        guarded=frozenset({"_links"}),
    ),
    LockManifest(
        path=PKG + "telemetry/slo.py",
        cls="SloAttribution",
        lock="_lock",
        guarded=frozenset(
            {
                "_win_ttft",
                "_win_itl",
                "completed",
                "violations",
                "goodput_by_priority",
                "_burn",
            }
        ),
    ),
    LockManifest(
        # Worst-N anatomy exemplars: offered from the loop's finish
        # callback, snapshotted by /metrics scrapes and `llmctl slow`.
        path=PKG + "telemetry/anatomy.py",
        cls="AnatomyRing",
        lock="_lock",
        guarded=frozenset({"_worst"}),
    ),
    LockManifest(
        # Online workload fingerprint: admissions observed on the loop,
        # snapshots from /metrics scrapes and the drift watch.
        path=PKG + "telemetry/fingerprint.py",
        cls="FingerprintBuilder",
        lock="_lock",
        guarded=frozenset(
            {
                "_n",
                "_isl",
                "_osl",
                "_prio",
                "_prompt_tokens",
                "_cached_tokens",
                "_spec_sum",
                "_spec_n",
                "_first_t",
                "_last_t",
                "_ia_n",
                "_ia_mean",
                "_ia_m2",
            }
        ),
    ),
)

# ------------------------------------------------- CUDA graph key sites
# Callables whose listed arguments (position, name) become CUDA graph
# keys: they must trace to the lattice (``resolve_*_key``, a
# ``*_bucket_for`` helper), a constant or static config, never a raw
# dynamic int. The JAX sites map as: ``_ragged_fn`` (the compiled
# variant of a ragged dispatch) -> ``DispatchGraphs.get`` through
# ``_launch_window`` / ``_launch_mixed``; ``_gather_pages`` /
# ``_inject_pages`` have no counterpart: the port's page movers
# (``_gather_page_batch`` / ``_inject_page_batch``) run eagerly outside
# any graph, so their page counts key nothing.
VARIANT_SITE_MANIFESTS: tuple[VariantSiteManifest, ...] = (
    VariantSiteManifest(
        path=PKG,
        sites={
            # The shape-carrying fields of the two keys; the trailing
            # sampler / logprob / spec flags are bools.
            "WindowKey": ((0, "rows"), (1, "pages")),
            "MixedKey": ((0, "tokens"), (1, "pages")),
        },
    ),
    VariantSiteManifest(
        path=PKG + "engine/engine.py",
        sites={
            "graphs.get": ((0, "key"),),
            "_launch_window": ((1, "key"),),
            "_launch_mixed": ((0, "key"),),
        },
    ),
    VariantSiteManifest(
        path=PKG + "aot/warmup.py",
        sites={
            "graphs.get": ((0, "key"),),
            "_run_padding": ((1, "key"),),
        },
    ),
)
