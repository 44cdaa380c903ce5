"""Drafters: cheap guesses at a row's next few tokens.

Counterpart of ``dynamo_exp_tpu/spec/drafter.py``. A drafter proposes up
to ``max_len`` continuation tokens for one sequence from host state
alone. The engine verifies every proposal through the target model and
keeps only the prefix the target itself would have emitted, so a
drafter can be wrong without changing the output stream; a bad drafter
only wastes verify work, which the adaptive controller throttles.

The registry is the pluggable seam: a draft model registers here with
the same ``propose(tokens, max_len)`` surface.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Sequence


class Drafter(ABC):
    """One sequence's draft-token source. Stateless with respect to the
    sequence: ``tokens`` is always the row's full prompt+generated
    context, so preemption/failover continuations (which rebuild the
    context as a fresh prompt) need no drafter bookkeeping."""

    name: str = "abstract"

    @abstractmethod
    def propose(self, tokens: Sequence[int], max_len: int) -> list[int]:
        """Up to ``max_len`` guessed continuation tokens ([] = no
        proposal this round — the row takes a normal decode window)."""


class NgramDrafter(Drafter):
    """Prompt-lookup speculation: match the context's trailing n-gram
    against an earlier occurrence in the same context (prompt AND
    generated tokens) and propose what followed it.

    Tries the longest configured n first (a longer match is stronger
    evidence) and prefers the most recent prior occurrence (locality:
    generation usually continues the nearest pattern). Linear reverse
    scan per proposal — O(context) with tiny constants, which is noise
    next to a verify dispatch; an indexed variant slots in behind the
    same interface if host time ever shows up.
    """

    name = "ngram"

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"bad n-gram range [{ngram_min}, {ngram_max}]"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, tokens: Sequence[int], max_len: int) -> list[int]:
        L = len(tokens)
        if max_len <= 0:
            return []
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if L <= n:
                continue
            tail = tokens[L - n :]
            # Most recent occurrence strictly before the tail itself.
            for start in range(L - n - 1, -1, -1):
                if tokens[start : start + n] == tail:
                    cont = tokens[start + n : start + n + max_len]
                    if cont:
                        return list(cont)
                    break  # match flush against the tail: longer n won't help
        return []


class StaticDrafter(Drafter):
    """Always proposes a fixed continuation (tests/benchmarks: pin the
    acceptance rate by construction)."""

    name = "static"

    def __init__(self, continuation: Sequence[int]):
        self.continuation = list(continuation)

    def propose(self, tokens: Sequence[int], max_len: int) -> list[int]:
        return self.continuation[:max_len]


# name -> factory(EngineConfig) -> Drafter. ``register_drafter`` is the
# extension hook: a draft-model drafter registers itself here and is
# then reachable via EngineConfig.spec_mode / run.py --spec.
_REGISTRY: dict[str, Callable[[object], Drafter]] = {}


def register_drafter(name: str, factory: Callable[[object], Drafter]) -> None:
    _REGISTRY[name] = factory


def registered_drafters() -> list[str]:
    return sorted(_REGISTRY)


def build_drafter(name: str, cfg) -> Drafter:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r}; registered: {registered_drafters()}"
        ) from None
    return factory(cfg)


register_drafter(
    "ngram",
    lambda cfg: NgramDrafter(
        ngram_max=cfg.spec_ngram, ngram_min=cfg.spec_ngram_min
    ),
)
