"""``Annotated`` stream envelope: data / event / comment / error frames.

Counterpart of ``dynamo_exp_tpu/runtime/annotated.py``: every response
stream crossing the request plane, and the SSE stream to HTTP clients,
is a sequence of Annotated frames, so errors and out-of-band events
travel in-band with the data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Generic, TypeVar

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

    def is_error(self) -> bool:
        return self.event == EVENT_ERROR

    def error_message(self) -> str | None:
        if not self.is_error():
            return None
        return "; ".join(self.comment) or "unknown error"

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.data is not None:
            out["data"] = self.data
        if self.id is not None:
            out["id"] = self.id
        if self.event is not None:
            out["event"] = self.event
        if self.comment:
            out["comment"] = self.comment
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Annotated[Any]":
        return cls(
            data=d.get("data"),
            id=d.get("id"),
            event=d.get("event"),
            comment=list(d.get("comment", [])),
        )
