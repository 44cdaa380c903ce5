"""OpenAI-compatible API types: chat completions, completions, models.

Counterpart of ``dynamo_exp_tpu/protocols/openai.py`` as plain
dataclasses instead of pydantic models. ``from_dict`` type-checks a
request body from the field annotations with pydantic's lax rules (an
integer field takes ``5``, ``5.0``, ``"5"`` and ``true``; a boolean
takes ``"yes"`` and ``0``; a string takes only a string; a union tries
every member strictly, then every member laxly, in order) and raises
``ValueError`` where the JAX model raises ``ValidationError`` (itself a
``ValueError``), so the same bodies get the same 400. ``to_dict`` drops
unset (None) fields as ``model_dump(exclude_none=True)`` does; models
that allow extra fields keep them and dump them last.
"""

from __future__ import annotations

import dataclasses
import math
import time
import types
import typing
import uuid
from dataclasses import dataclass, field
from typing import Any, Literal, Union

from .common import SamplingOptions, StopConditions

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_INT_MAX = 1 << 63


class _Invalid(ValueError):
    pass


def _to_int(v: Any, strict: bool, path: str) -> int:
    if isinstance(v, bool):
        if strict:
            raise _Invalid(f"{path}: expected an integer, got {v!r}")
        return int(v)
    if isinstance(v, int):
        return v
    if strict:
        raise _Invalid(f"{path}: expected an integer, got {v!r}")
    if isinstance(v, float):
        if not math.isfinite(v) or v != int(v) or abs(v) >= _INT_MAX:
            raise _Invalid(f"{path}: expected an integer, got {v!r}")
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            pass
        try:
            return _to_int(float(s), False, path)
        except ValueError:
            pass
    raise _Invalid(f"{path}: expected an integer, got {v!r}")


def _to_float(v: Any, strict: bool, path: str) -> float:
    if isinstance(v, bool):
        if strict:
            raise _Invalid(f"{path}: expected a number, got {v!r}")
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if not strict and isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise _Invalid(f"{path}: expected a number, got {v!r}")


def _to_bool(v: Any, strict: bool, path: str) -> bool:
    if isinstance(v, bool):
        return v
    if not strict:
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str):
            s = v.strip().lower()
            if s in _TRUE:
                return True
            if s in _FALSE:
                return False
    raise _Invalid(f"{path}: expected a boolean, got {v!r}")


def _coerce(tp: Any, v: Any, strict: bool, path: str) -> Any:
    """``v`` as the annotation ``tp``, or raise ``_Invalid``."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return v
    if tp is type(None):
        if v is None:
            return None
        raise _Invalid(f"{path}: expected null, got {v!r}")
    if origin in (Union, types.UnionType):
        members = typing.get_args(tp)
        for mode in (True, False):
            for m in members:
                try:
                    return _coerce(m, v, mode, path)
                except _Invalid:
                    pass
        raise _Invalid(f"{path}: {v!r} matches none of {tp}")
    if origin is Literal:
        if v in typing.get_args(tp):
            return v
        raise _Invalid(f"{path}: expected one of {typing.get_args(tp)}, got {v!r}")
    if origin is list:
        if not isinstance(v, list):
            raise _Invalid(f"{path}: expected a list, got {v!r}")
        (item,) = typing.get_args(tp)
        return [_coerce(item, x, strict, f"{path}.{i}") for i, x in enumerate(v)]
    if origin is dict:
        if not isinstance(v, dict):
            raise _Invalid(f"{path}: expected an object, got {v!r}")
        kt, vt = typing.get_args(tp)
        return {
            _coerce(kt, k, strict, path): _coerce(vt, x, strict, f"{path}.{k}")
            for k, x in v.items()
        }
    if tp is str:
        if isinstance(v, str):
            return v
        raise _Invalid(f"{path}: expected a string, got {v!r}")
    if tp is int:
        return _to_int(v, strict, path)
    if tp is float:
        return _to_float(v, strict, path)
    if tp is bool:
        return _to_bool(v, strict, path)
    if isinstance(tp, type) and issubclass(tp, _Model):
        if isinstance(v, tp):
            return v
        if isinstance(v, dict):
            return tp._validate(v, path)
        raise _Invalid(f"{path}: expected an object, got {v!r}")
    raise TypeError(f"no coercion for {tp!r}")


def _dump(v: Any, exclude_none: bool) -> Any:
    if isinstance(v, _Model):
        return v.to_dict(exclude_none)
    if isinstance(v, list):
        return [_dump(x, exclude_none) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x, exclude_none) for k, x in v.items()}
    return v


class _Model:
    """Dataclass mix-in: validated ``from_dict`` and ``to_dict``."""

    _allow_extra = False

    @classmethod
    def _hints(cls) -> dict[str, Any]:
        hints = cls.__dict__.get("_hints_cache")
        if hints is None:
            names = [f.name for f in dataclasses.fields(cls)]
            all_hints = typing.get_type_hints(cls)
            hints = {n: all_hints[n] for n in names}
            cls._hints_cache = hints
        return hints

    @classmethod
    def _validate(cls, d: dict, path: str):
        kw: dict[str, Any] = {}
        required = {
            f.name
            for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        }
        for name, tp in cls._hints().items():
            where = f"{path}.{name}" if path else name
            if name in d:
                kw[name] = _coerce(tp, d[name], False, where)
            elif name in required:
                raise _Invalid(f"{where}: field required")
        obj = cls(**kw)
        if cls._allow_extra:
            obj._extra = {k: v for k, v in d.items() if k not in kw}
        return obj

    @classmethod
    def from_dict(cls, d: Any):
        """Validate a decoded JSON body; raises ``ValueError``."""
        if not isinstance(d, dict):
            raise _Invalid(f"expected a JSON object, got {type(d).__name__}")
        return cls._validate(d, "")

    def to_dict(self, exclude_none: bool = True) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None and exclude_none:
                continue
            out[f.name] = _dump(v, exclude_none)
        for k, v in getattr(self, "_extra", {}).items():
            if v is None and exclude_none:
                continue
            out[k] = _dump(v, exclude_none)
        return out


@dataclass
class Extensions(_Model):
    """Framework extension field (the reference calls this ``nvext``)."""

    ignore_eos: bool | None = None
    annotations: list[str] = field(default_factory=list)
    greedy_sampling: bool | None = None
    priority: str | int | None = None


@dataclass
class ChatMessage(_Model):
    _allow_extra = True

    role: str
    content: str | list[dict[str, Any]] | None = None
    name: str | None = None
    tool_calls: list[dict[str, Any]] | None = None
    tool_call_id: str | None = None

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        return "".join(
            part.get("text", "") for part in self.content if isinstance(part, dict)
        )


@dataclass
class StreamOptions(_Model):
    include_usage: bool = False


class _RequestMixin:
    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def request_priority(self) -> str | int | None:
        """Raw priority class: body field wins over the nvext one."""
        if self.priority is not None:
            return self.priority
        return self.nvext.priority if self.nvext else None

    def annotations(self) -> list[str]:
        return list(self.nvext.annotations) if self.nvext else []

    def _ignore_eos(self) -> bool:
        return bool(self.ignore_eos or (self.nvext and self.nvext.ignore_eos))


@dataclass
class ChatCompletionRequest(_Model, _RequestMixin):
    _allow_extra = True

    model: str
    messages: list[ChatMessage]
    stream: bool = False
    stream_options: StreamOptions | None = None
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    n: int = 1
    stop: str | list[str] | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    repetition_penalty: float | None = None
    seed: int | None = None
    logprobs: bool | None = None
    top_logprobs: int | None = None
    user: str | None = None
    tools: list[dict[str, Any]] | None = None
    tool_choice: Any | None = None
    min_tokens: int | None = None
    ignore_eos: bool | None = None
    priority: str | int | None = None
    nvext: Extensions | None = None

    def extract_stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_tokens or self.max_completion_tokens,
            stop=self.stop_list(),
            min_tokens=self.min_tokens,
            ignore_eos=self._ignore_eos(),
        )

    def extract_sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            n=self.n,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.repetition_penalty,
            seed=self.seed,
            # logprobs=true alone means "chosen-token logprob only"
            # (top_logprobs=0), not "no logprobs".
            logprobs=(self.top_logprobs or 0) if self.logprobs else None,
        )


@dataclass
class CompletionRequest(_Model, _RequestMixin):
    _allow_extra = True

    model: str
    prompt: str | list[str] | list[int] | list[list[int]]
    stream: bool = False
    stream_options: StreamOptions | None = None
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    n: int = 1
    stop: str | list[str] | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    seed: int | None = None
    logprobs: int | None = None
    echo: bool = False
    user: str | None = None
    min_tokens: int | None = None
    ignore_eos: bool | None = None
    priority: str | int | None = None
    nvext: Extensions | None = None

    def extract_stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_tokens,
            stop=self.stop_list(),
            min_tokens=self.min_tokens,
            ignore_eos=self._ignore_eos(),
        )

    def extract_sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            n=self.n,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            seed=self.seed,
            logprobs=self.logprobs,
        )


@dataclass
class Usage(_Model):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclass
class ChatChoiceDelta(_Model):
    role: str | None = None
    content: str | None = None
    tool_calls: list[dict[str, Any]] | None = None


@dataclass(kw_only=True)
class ChatStreamChoice(_Model):
    index: int = 0
    delta: ChatChoiceDelta
    finish_reason: str | None = None
    logprobs: Any | None = None


@dataclass(kw_only=True)
class ChatCompletionChunk(_Model):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int
    model: str
    choices: list[ChatStreamChoice]
    usage: Usage | None = None
    # Cumulative completion-token count through this chunk (the JAX
    # package's resumable-stream dedupe key; carried, not deduped here).
    seq_index: int | None = None


@dataclass(kw_only=True)
class ChatChoice(_Model):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: Any | None = None


@dataclass(kw_only=True)
class ChatCompletionResponse(_Model):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int
    model: str
    choices: list[ChatChoice]
    usage: Usage | None = None


@dataclass
class CompletionChoice(_Model):
    index: int = 0
    text: str = ""
    finish_reason: str | None = None
    logprobs: Any | None = None


@dataclass(kw_only=True)
class CompletionChunk(_Model):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int
    model: str
    choices: list[CompletionChoice]
    usage: Usage | None = None
    seq_index: int | None = None


@dataclass(kw_only=True)
class CompletionResponse(CompletionChunk):
    pass


@dataclass
class ModelInfo(_Model):
    id: str
    object: Literal["model"] = "model"
    created: int = 0
    owned_by: str = "organization"


@dataclass
class ModelList(_Model):
    object: Literal["list"] = "list"
    data: list[ModelInfo] = field(default_factory=list)


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now_unix() -> int:
    return int(time.time())
