"""Engine configuration.

Counterpart of ``dynamo_exp_tpu/engine/config.py``, trimmed to the
fields the port reads (the KV-pressure, tiering, chaining, speculation,
G3 and observability knobs keep the JAX package's defaults). Of the
JAX package's env table it keeps ``DYN_KV_STORE`` (``env_overrides``),
which the CLI reads; a config built in code reads no environment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from ..models.config import ModelConfig
from ..models.llama import check_tp

ATTENTION_IMPLS = ("auto", "kernel", "reference")

# What tensor parallelism (tp > 1) does not serve yet, by the ROADMAP
# item that brings it (Queue 1 item 7's follow-ups). The KV tiers,
# disaggregation, leases and reclaim are served at any tp: a page off
# the card is the whole page (``engine/tp.py``'s page moves).
TP_LATER = {
    "graphs": "ROADMAP Queue 1 item 7(b)",  # CUDA graphs, --prewarm
}
# The engine's sequence-parallel degree stays 1: the JAX engine lays its
# mesh with ``sp`` but none of its dispatches uses that axis. Ring
# prefill over sp ranks is a model-level function of the port.
SP_ONLY_ONE = ("the engine serves sp=1 only; ring-attention prefill over sp ranks is "
               "models.llama.forward_ring_prefill on parallel.rank_layout(sp=...) ranks")


def refuse_under_tp(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not served under tp > 1 yet; see {TP_LATER[item]}")

_TRUTHY = frozenset({"1", "true", "on", "yes"})
_FALSY = frozenset({"0", "false", "no", "off"})

# The deployment environment the CLI reads (run.py), as one validated
# table of (env name, config attr). Only ``DYN_KV_STORE`` is taken: a
# directory path arms the G3 persistent tier, a falsy spelling leaves
# it off, a truthy one raises (the knob needs a path, not "1"). An
# engine built in code reads no environment, so a stray variable never
# overrides the arguments it was given.
_ENV_KNOBS: tuple[tuple[str, str], ...] = (("DYN_KV_STORE", "kv_store_dir"),)
# Env-name families this table owns: any OTHER name under these
# prefixes is a typo (DYN_KV_STOR=<dir> must fail loudly, not silently
# serve without the tier) — except names owned by other modules.
_ENV_FAMILIES = ("DYN_KV_",)
_ENV_EXEMPT = frozenset({
    "DYN_KV_DEFAULT_BW_BPS",  # telemetry.fleet: link-bandwidth prior
})


def env_overrides() -> dict[str, str]:
    """The ``EngineConfig`` fields the ``DYN_KV_*`` environment sets.
    An unknown name in the owned families, or a malformed value, raises
    ``ValueError`` naming the accepted spellings."""
    accepted = {name for name, _ in _ENV_KNOBS} | _ENV_EXEMPT
    for name in os.environ:
        if name not in accepted and name.startswith(_ENV_FAMILIES):
            raise ValueError(
                f"unknown engine env knob {name!r}; accepted: "
                f"{', '.join(sorted(accepted))}"
            )
    out = {}
    for name, attr in _ENV_KNOBS:
        raw = os.environ.get(name, "").strip()
        low = raw.lower()
        if low in _TRUTHY:
            raise ValueError(
                f"{name}={raw!r} must be a directory path (or a "
                f"falsy spelling to disable), not a bare flag"
            )
        if raw and low not in _FALSY:
            out[attr] = raw
    return out


@dataclass
class EngineConfig:
    model: ModelConfig
    max_decode_slots: int = 8  # rows that can hold a sequence at once
    page_size: int = 16  # tokens per KV page (also the reuse-hash block)
    num_pages: int = 512  # global page pool size
    max_model_len: int = 2048  # per-sequence token capacity
    # Parallelism within this engine replica (the JAX defaults): ``tp``
    # ranks, one process each, hold a megatron shard of the model and
    # of the KV pools (``engine/tp.py``); ``sp`` is accepted at 1 only.
    tp: int = 1
    sp: int = 1
    # Up to ``prefill_batch`` prompts share one dispatch; each is fed
    # ``prefill_chunk`` tokens at a time so decode interleaves.
    prefill_batch: int = 8
    prefill_chunk: int = 512
    # Decode steps per pure-decode dispatch: the host syncs once per
    # window (a row may overshoot its stop by up to window-1 discards).
    decode_window: int = 8
    # Keep one decode window in flight: dispatch window N+1 straight from
    # window N's carry on the device (tokens, positions) while the host
    # still consumes window N. False forces dispatch -> sync -> consume.
    chained_decode: bool = True
    # Flat-stream alignment of each row's query span for the ragged
    # kernel's mixed shape: every q_tile slice belongs to one row.
    ragged_q_tile: int = 8
    kv_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    default_max_tokens: int = 256
    eos_token_ids: list[int] = field(default_factory=list)
    # Refcounted reuse of KV pages across sequences: full pages attached
    # while still being filled, and partial tails copied before their
    # first write. False is the private-copy baseline: no cross-sequence
    # reuse at all (token streams are the same either way).
    prefix_sharing: bool = True
    # "kernel": the ragged CUDA kernel (on a CUDA device; on the CPU its
    # wrapper computes the plain version); "reference": the plain
    # PyTorch attention; "auto": the kernel on CUDA, the plain version
    # on the CPU.
    attention_impl: str = "auto"
    # G2 host-memory KV tier: number of host pages (0 disables offload).
    # Device-evicted pages spill here (pinned memory on a CUDA engine)
    # and are injected back on a prefix match instead of recomputed.
    host_cache_pages: int = 0
    # KV-pressure preemption: once an ACTIVE row has been hard-stalled
    # (cannot feed its next token: the pool is dry) this long, the
    # lowest-priority / youngest ACTIVE sequence releases its pages and
    # requeues as a deterministic continuation. Negative disables it.
    preempt_stall_grace_s: float = 0.5
    # A sequence preempted this many times is exempt from further
    # preemption (no re-prefill live-lock).
    max_preemptions_per_seq: int = 2
    # Footprint-packed admission: admit the first waiting sequence whose
    # lifetime KV forecast (prompt + max_tokens, minus its resident
    # prefix) fits the free pages; never refuses what first-fit would
    # admit (engine/tiering.select_packed_index).
    kv_packing: bool = True
    packing_scan_limit: int = 16  # waiting-queue prefix scanned per pass
    packing_max_defers: int = 64  # bypasses before a seq becomes a barrier
    # G2 -> G1 prefetch of waiting prompts' host-resident prefixes ahead
    # of admission (needs host_cache_pages > 0).
    kv_prefetch: bool = True
    prefetch_depth: int = 4  # waiting sequences scanned per pass
    # Free + parked pages prefetch never consumes (decode growth wins).
    prefetch_reserve_pages: int = 4
    # Proactive cold-tail offload: once a row has been hard-stalled this
    # long, swap the coldest eligible row's pages out to the host tier
    # instead of preempting (bytes kept, resume token-identical).
    # Negative disables; needs a host tier; must be below
    # preempt_stall_grace_s to fire first.
    proactive_offload_grace_s: float = 0.0
    # Port only (the JAX package's programs are always compiled): run
    # each decode window through a CUDA graph per window key
    # (engine/graphs.py). None is True on a CUDA device and False on the
    # CPU, which has no graphs; True on the CPU raises. False runs every
    # window eagerly (the same padding and kernels), for comparison.
    # Under tp > 1, None is False (eager: gloo collectives cannot be
    # captured) and True raises.
    cuda_graphs: bool | None = None
    # Speculative decoding: "off", or a drafter name from the spec/
    # registry ("ngram" = prompt lookup, no second model).
    spec_mode: str = "off"
    # Initial per-row draft length; the adaptive controller moves it
    # within [spec_min_draft, spec_max_draft] from the rolling
    # acceptance rate (spec_adaptive=False pins it).
    spec_draft_len: int = 4
    spec_min_draft: int = 1
    spec_max_draft: int = 8
    spec_adaptive: bool = True
    # Prompt-lookup drafter: trailing n-gram widths tried, longest first.
    spec_ngram: int = 3
    spec_ngram_min: int = 1
    # Miss backoff: after this many empty proposals in a row the row is
    # not probed until its context grows by spec_retry_tokens.
    spec_miss_limit: int = 4
    spec_retry_tokens: int = 32
    # Per-dispatch profiling (telemetry/dispatch.py): host gap, in-flight
    # time and first-use captures per dispatch kind, stamped at the
    # loop's own dispatch and consume points (no added host sync). Off
    # only to measure its cost.
    profile_dispatches: bool = True
    # Flight recorder (telemetry/flight.py): a bounded ring of loop
    # events dumped on a watchdog stall, SIGUSR1 or a loop crash.
    flight_events: bool = True
    # Dump target; empty resolves to $DYN_FLIGHT_DUMP or a per-process
    # file under the temp directory (telemetry.flight.default_dump_path).
    flight_dump_path: str = ""
    # Watchdog: dump the flight ring and a slot/page snapshot when the
    # loop has made no progress for this long while work is queued. A
    # first-use CUDA graph capture counts as progress. <= 0 disables.
    watchdog_stall_s: float = 30.0
    # KV handoff lease TTL (disaggregation and live migration): pages
    # extracted for the wire, or a decode-side prefix pinned for a
    # suffix-only transfer, stay held this long awaiting the confirm;
    # the loop's reaper then reclaims them (the JAX default).
    kv_lease_ttl_s: float = 30.0
    # KV conservation auditor: run the page manager's counter-delta
    # ledger check (and the G3 store's) every loop cycle, as pure host
    # integer arithmetic with no host sync; a violation bumps
    # ``kv_ledger_violations`` (dynamo_kv_ledger_violations_total),
    # records a ``ledger_violation`` flight event and dumps a flight
    # snapshot once per episode. Off only to measure its cost.
    kv_ledger_check: bool = True
    # G3 persistent KV tier (kv/persistent.py). Empty disables. Pages
    # LRU-demoted out of the G2 host pool land here as checksummed,
    # crash-recoverable files keyed by the same chained block hashes; a
    # restarted process boot-scans the directory and re-attaches
    # surviving prefixes. Needs a host tier (host_cache_pages > 0):
    # demotion rides its eviction path. The CLI arms it from
    # DYN_KV_STORE=<dir> (env_overrides).
    kv_store_dir: str = ""
    # Store capacity in pages, LRU-evicted beyond it. <= 0 with a
    # kv_store_dir set is rejected at construction.
    kv_store_pages: int = 4096
    # Seeded StorageChaos schedule (tests and the smoke only).
    kv_store_chaos: object = None

    def __post_init__(self):
        if self.kv_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unsupported kv_dtype: {self.kv_dtype!r}")
        check_tp(self.model, self.tp)
        if self.sp != 1:
            raise NotImplementedError(f"sp={self.sp}: {SP_ONLY_ONE}")
        if self.tp > 1 and self.cuda_graphs:
            raise refuse_under_tp("cuda_graphs=True", "graphs")
        if self.kv_store_dir and self.kv_store_pages <= 0:
            raise ValueError(
                f"kv_store_dir={self.kv_store_dir!r} needs "
                f"kv_store_pages > 0 (got {self.kv_store_pages})"
            )
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, "
                f"got {self.attention_impl!r}"
            )
        if self.spec_max_draft < self.spec_min_draft or self.spec_min_draft < 1:
            raise ValueError(
                f"bad spec draft bounds [{self.spec_min_draft}, "
                f"{self.spec_max_draft}]"
            )
        self.spec_draft_len = min(
            max(self.spec_draft_len, self.spec_min_draft), self.spec_max_draft
        )

    @property
    def kv_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.kv_dtype == "bfloat16" else torch.float32

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_model_len + self.page_size - 1) // self.page_size

