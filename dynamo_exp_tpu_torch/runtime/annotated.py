"""``Annotated`` stream envelope: data / event / comment / error frames.

Counterpart of ``dynamo_exp_tpu/runtime/annotated.py``: the SSE stream
to HTTP clients is a sequence of Annotated frames, so errors and
out-of-band events travel in-band with the data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generic, TypeVar

T = TypeVar("T")

EVENT_ERROR = "error"


@dataclass
class Annotated(Generic[T]):
    data: T | None = None
    id: str | None = None
    event: str | None = None
    comment: list[str] = field(default_factory=list)

    @classmethod
    def from_data(cls, data: T) -> "Annotated[T]":
        return cls(data=data)

    @classmethod
    def from_error(cls, message: str) -> "Annotated[T]":
        return cls(event=EVENT_ERROR, comment=[message])

