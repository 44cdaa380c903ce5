"""Adaptive speculation control: per-row draft length and miss backoff.

Counterpart of ``dynamo_exp_tpu/spec/controller.py``. A rolling (EWMA)
acceptance rate moves each row's draft length between
``spec_min_draft`` and ``spec_max_draft`` (doubling while acceptance
stays high, halving when it collapses), and a row whose lookups keep
returning nothing is not probed again until its context has grown by
``spec_retry_tokens``; meanwhile it decodes as a plain row and may
chain. None of this touches which tokens come out, only how many
positions one dispatch verifies.
"""

from __future__ import annotations

from dataclasses import dataclass

from .drafter import build_drafter

# EWMA weight of the newest dispatch's acceptance rate.
_ALPHA = 0.5
# Grow the draft length while the rolling acceptance stays above this…
_GROW_AT = 0.75
# …and shrink it once acceptance falls below this.
_SHRINK_AT = 0.3


@dataclass
class _RowState:
    draft_len: int
    ewma: float = 0.0
    samples: int = 0
    miss_streak: int = 0
    # Context length at which a missed-out row re-probes (0 = active).
    retry_at_len: int = 0


class SpecManager:
    """Host-side speculation state for one engine: the drafter plus one
    :class:`_RowState` per live request. Single-writer (engine loop
    thread), like everything else that schedules work."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.drafter = build_drafter(cfg.spec_mode, cfg)
        self._rows: dict[str, _RowState] = {}

    def _state(self, seq) -> _RowState:
        st = self._rows.get(seq.request_id)
        if st is None:
            st = _RowState(draft_len=self.cfg.spec_draft_len)
            self._rows[seq.request_id] = st
        return st

    # ------------------------------------------------------------- querying
    def wants_draft(self, seq) -> bool:
        """Whether the row should be probed this round. False while the
        row is backed off after repeated lookup misses — the engine then
        treats it as a plain decode row (and may chain over it)."""
        st = self._state(seq)
        return not st.retry_at_len or len(seq.tokens) >= st.retry_at_len

    def propose(self, seq) -> list[int]:
        """Draft tokens for the row (possibly []), advancing the miss
        backoff. Call only when :meth:`wants_draft` is True."""
        st = self._state(seq)
        st.retry_at_len = 0
        drafts = self.drafter.propose(seq.tokens, st.draft_len)
        if drafts:
            st.miss_streak = 0
        else:
            st.miss_streak += 1
            if st.miss_streak >= self.cfg.spec_miss_limit:
                st.miss_streak = 0
                st.retry_at_len = len(seq.tokens) + self.cfg.spec_retry_tokens
        return drafts

    # ------------------------------------------------------------- feedback
    def record(self, seq, proposed: int, accepted: int) -> None:
        """Fold one verify dispatch's outcome into the row's rolling
        acceptance and adapt its draft length."""
        if proposed <= 0:
            return
        st = self._state(seq)
        rate = accepted / proposed
        st.ewma = rate if st.samples == 0 else (
            (1.0 - _ALPHA) * st.ewma + _ALPHA * rate
        )
        st.samples += 1
        if not self.cfg.spec_adaptive:
            return
        if st.ewma >= _GROW_AT and st.draft_len < self.cfg.spec_max_draft:
            st.draft_len = min(st.draft_len * 2, self.cfg.spec_max_draft)
        elif st.ewma <= _SHRINK_AT and st.draft_len > self.cfg.spec_min_draft:
            st.draft_len = max(st.draft_len // 2, self.cfg.spec_min_draft)

    # -------------------------------------------------------------- hygiene
    def draft_len(self, seq) -> int:
        return self._state(seq).draft_len

    def retain(self, live_request_ids) -> None:
        """Drop state for finished requests (called opportunistically by
        the engine when the table outgrows the slot envelope)."""
        live = set(live_request_ids)
        for rid in [r for r in self._rows if r not in live]:
            del self._rows[rid]

    def __len__(self) -> int:
        return len(self._rows)
