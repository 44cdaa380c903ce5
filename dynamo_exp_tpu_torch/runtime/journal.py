"""Replay journal for resumable generation.

Counterpart of ``dynamo_exp_tpu/runtime/journal.py``. The router keeps,
per request in flight, what it needs to rebuild the generation
elsewhere: the prompt token ids, the sampling parameters **with the
seed pinned** (the engines' samplers are counter-based: every draw is
keyed by (seed, absolute token position), so a pinned seed makes the
stream a pure function of the request), and every emitted completion
token with its sequence index. When the stream breaks mid-decode, the
router dispatches a **continuation request**: prompt + journaled tokens
as ``token_ids`` (one re-prefill on the surviving worker), the budget
reduced by what was delivered, and ``resume_offset`` marking the
journaled tail. Greedy continuations are token-identical to an
unbroken run; sampled ones replay the pinned seed.

On the way out the journal deduplicates by sequence index: tokens at
already-journaled indices are trimmed (``dynamo_tokens_deduplicated_total``),
so the stream the client sees has no gap and no duplicate.
"""

from __future__ import annotations

import random
from typing import Any

from ..telemetry import get_telemetry


class ReplayJournal:
    """Per-request token journal + continuation builder."""

    def __init__(self, request: dict, prompt: list[int]):
        # The seed-pinned request actually dispatched (and the base of
        # every continuation).
        self.request = request
        self.prompt = prompt
        # Journaled completion tokens; a token's sequence index IS its
        # list index.
        self.tokens: list[int] = []
        self.recoveries = 0
        self.finished = False
        # Current physical stream's emission cursor: the journal offset
        # where it began and how many tokens it has produced so far.
        self._stream_base = 0
        self._stream_pos = 0

    # ------------------------------------------------------------ build
    @classmethod
    def for_request(
        cls, request: Any, rng: random.Random
    ) -> "ReplayJournal | None":
        """A journal for ``request``, or None when the request is not
        journalable (not an engine-level dict with ``token_ids``).

        Sampled requests without an explicit seed get one pinned here —
        journaling the "RNG seed path" means choosing it at the frontend,
        where the continuation can repeat it verbatim."""
        if not isinstance(request, dict):
            return None
        token_ids = request.get("token_ids")
        if not isinstance(token_ids, list) or not token_ids:
            return None
        if any(not isinstance(t, int) for t in token_ids):
            return None
        req = dict(request)
        so = dict(req.get("sampling_options") or {})
        if (so.get("temperature") or 0.0) > 0.0 and so.get("seed") is None:
            so["seed"] = rng.getrandbits(31)
            req["sampling_options"] = so
        return cls(req, list(token_ids))

    # ----------------------------------------------------------- record
    @property
    def next_index(self) -> int:
        return len(self.tokens)

    def record(self, frame: dict) -> dict | None:
        """Journal one engine frame on its way to the caller.

        Returns the frame to emit (possibly trimmed of duplicate-index
        tokens, possibly usage-fixed), or None when nothing of it
        survives deduplication."""
        if not isinstance(frame, dict):
            return frame
        toks = frame.get("token_ids") or []
        if toks:
            start = self._stream_base + self._stream_pos
            self._stream_pos += len(toks)
            # Tokens at indices below the journal head were already
            # delivered by a previous incarnation of the stream.
            overlap = min(max(len(self.tokens) - start, 0), len(toks))
            fresh = toks[overlap:]
            self.tokens.extend(fresh)
            if overlap:
                get_telemetry().tokens_deduplicated.inc(overlap)
                if not fresh and not frame.get("finish_reason"):
                    return None
                frame = {**frame, "token_ids": fresh}
                # Per-token payloads stay index-aligned with token_ids;
                # pre-detokenized ``text`` (Backend-level frames) can't
                # be split by token and is dropped with the duplicates —
                # journaling is meant to sit *below* the detokenizer.
                for key in ("logprobs", "top_logprobs"):
                    if isinstance(frame.get(key), list):
                        frame[key] = frame[key][overlap:]
                frame.pop("text", None)
        if frame.get("finish_reason"):
            self.finished = True
            if self.recoveries:
                # A continuation's engine saw prompt+journal as prompt
                # and only its own tokens as completion; report the
                # client's view instead.
                frame = {**frame}
                if frame.get("prompt_tokens") is not None:
                    frame["prompt_tokens"] = len(self.prompt)
                if frame.get("completion_tokens") is not None:
                    frame["completion_tokens"] = len(self.tokens)
        return frame

    # ------------------------------------------------------ continuation
    def begin_continuation(self) -> None:
        """A replacement stream was dispatched: it emits from the
        journal head (its engine re-prefilled everything journaled)."""
        self._stream_base = len(self.tokens)
        self._stream_pos = 0

    def continuation_request(self) -> dict:
        """The re-dispatch payload: prompt + journaled tokens re-enter as
        ``token_ids`` (one batched prefill on the new worker), the token
        budget shrinks by what was delivered, and ``resume_offset``
        marks the journaled tail for telemetry/accounting."""
        req = dict(self.request)
        req["token_ids"] = self.prompt + self.tokens
        req["resume_offset"] = len(self.tokens)
        sc = dict(req.get("stop_conditions") or {})
        if sc.get("max_tokens") is not None:
            sc["max_tokens"] = max(sc["max_tokens"] - len(self.tokens), 1)
        if sc.get("min_tokens"):
            sc["min_tokens"] = max(sc["min_tokens"] - len(self.tokens), 0)
        req["stop_conditions"] = sc
        return req

    def synthetic_finish(self) -> dict | None:
        """When the stream died *between* the final token and its finish
        frame, the budget may already be spent — finishing locally beats
        re-prefilling the whole sequence to generate zero tokens."""
        sc = self.request.get("stop_conditions") or {}
        max_tokens = sc.get("max_tokens")
        if max_tokens is not None and len(self.tokens) >= max_tokens:
            self.finished = True
            return {
                "finish_reason": "length",
                "prompt_tokens": len(self.prompt),
                "completion_tokens": len(self.tokens),
            }
        return None
