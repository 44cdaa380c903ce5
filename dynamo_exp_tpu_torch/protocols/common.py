"""Engine-facing request/response types.

Trimmed counterpart of ``dynamo_exp_tpu/protocols/common.py`` with the
same dict wire shape: ``to_dict`` drops unset (None) fields, and
``from_dict`` accepts what the JAX package's types emit. Plain
dataclasses, so the port needs nothing beyond torch and numpy.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import asdict, dataclass, field, fields


PRIORITY_LOW = 0
PRIORITY_NORMAL = 1
PRIORITY_HIGH = 2

_PRIORITY_NAMES = {"low": PRIORITY_LOW, "normal": PRIORITY_NORMAL, "high": PRIORITY_HIGH}
_NAME_BY_PRIORITY = {v: k for k, v in _PRIORITY_NAMES.items()}


def parse_priority(raw) -> int:
    """A request's priority class as 0/1/2 (low/normal/high): the class
    names (any case) or their integers; ``None`` is ``normal``; anything
    else raises ``ValueError`` (a 400 at the HTTP edge)."""
    if raw is None:
        return PRIORITY_NORMAL
    if isinstance(raw, bool):  # bool is an int subclass; reject explicitly
        raise ValueError(f"invalid priority: {raw!r}")
    if isinstance(raw, int) and raw in _PRIORITY_NAMES.values():
        return raw
    if isinstance(raw, str):
        name = raw.strip().lower()
        if name in _PRIORITY_NAMES:
            return _PRIORITY_NAMES[name]
        if name.lstrip("-").isdigit():
            return parse_priority(int(name))
    raise ValueError(f"invalid priority: {raw!r} (expected 0..2 or low/normal/high)")


def priority_name(priority: int) -> str:
    """The class name of a priority (``"low"``, ``"normal"``, ``"high"``)."""
    return _NAME_BY_PRIORITY.get(priority, str(priority))


class FinishReason(str, enum.Enum):
    EOS = "eos"
    STOP = "stop"
    LENGTH = "length"
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        return {
            FinishReason.EOS: "stop",
            FinishReason.STOP: "stop",
            FinishReason.LENGTH: "length",
            FinishReason.CANCELLED: "stop",
            FinishReason.ERROR: "error",
        }[self]


def _drop_none(d):
    if isinstance(d, dict):
        return {k: _drop_none(v) for k, v in d.items() if v is not None}
    return d


def _known(cls, d: dict) -> dict:
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class StopConditions:
    """When to stop generating."""

    max_tokens: int | None = None
    stop: list[str] = field(default_factory=list)  # hidden stop strings
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: int | None = None
    ignore_eos: bool = False

    def apply_defaults(self, max_tokens_default: int | None) -> None:
        if self.max_tokens is None:
            self.max_tokens = max_tokens_default

    @classmethod
    def from_dict(cls, d: dict) -> "StopConditions":
        return cls(**_known(cls, d))


@dataclass
class SamplingOptions:
    """How to pick the next token."""

    n: int = 1
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    repetition_penalty: float | None = None
    seed: int | None = None
    logprobs: int | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingOptions":
        return cls(**_known(cls, d))


@dataclass
class BackendInput:
    """The preprocessed request handed to an engine: token ids in,
    token ids out."""

    token_ids: list[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    annotations: list[str] = field(default_factory=list)
    # Router hint: estimated prefix-cache overlap blocks on the chosen
    # worker (the disaggregated decode engine subtracts them from the
    # prefill it weighs).
    estimated_prefix_hit_num_blocks: int | None = None
    # A continuation (failover replay or KV-pressure preemption): the
    # last ``resume_offset`` entries of ``token_ids`` are journaled
    # completion tokens being re-prefilled, not prompt; a penalized
    # request rebuilds its penalty counts over them.
    resume_offset: int | None = None
    priority: int = 1

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    def copy(self) -> "BackendInput":
        return copy.deepcopy(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BackendInput":
        d = _known(cls, d)
        return cls(
            token_ids=[int(t) for t in d["token_ids"]],
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions") or {}),
            sampling_options=SamplingOptions.from_dict(
                d.get("sampling_options") or {}
            ),
            annotations=list(d.get("annotations") or []),
            estimated_prefix_hit_num_blocks=(
                int(d["estimated_prefix_hit_num_blocks"])
                if d.get("estimated_prefix_hit_num_blocks") is not None else None
            ),
            resume_offset=(
                int(d["resume_offset"]) if d.get("resume_offset") is not None else None
            ),
            priority=int(d.get("priority", 1)),
        )


@dataclass
class LLMEngineOutput:
    """One streamed step from an engine (token level)."""

    token_ids: list[int] = field(default_factory=list)
    text: str | None = None
    finish_reason: FinishReason | None = None
    # Usage accounting, set on the final frame.
    prompt_tokens: int | None = None
    completion_tokens: int | None = None
    # Per-token logprobs aligned with token_ids (only when the request
    # asked): the chosen token's, and the top-N alternatives as
    # {token id: logprob} (N = the request's top_logprobs).
    logprobs: list[float] | None = None
    top_logprobs: list[dict[int, float]] | None = None

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "LLMEngineOutput":
        d = _known(cls, d)
        if d.get("finish_reason") is not None:
            d["finish_reason"] = FinishReason(d["finish_reason"])
        if d.get("top_logprobs"):
            # JSON (the request plane) turns the token-id keys into
            # strings; the JAX model's validation turns them back.
            d["top_logprobs"] = [
                None if tops is None else {int(t): lp for t, lp in tops.items()}
                for tops in d["top_logprobs"]
            ]
        return cls(**d)
