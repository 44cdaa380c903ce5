"""Request templates: server-side defaults for incoming OpenAI requests.

Counterpart of ``dynamo_exp_tpu/protocols/request_template.py``: a JSON
file of defaults (``model``, ``temperature``, ``max_completion_tokens``)
applied to any request that leaves those fields unset, so that clients
can POST minimal bodies against a curated deployment. Explicit client
values always win. ``run.py --request-template <file>`` hands one to the
HTTP service.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class RequestTemplate:
    model: str = ""
    temperature: float | None = None
    max_completion_tokens: int | None = None

    @classmethod
    def load(cls, path: str) -> "RequestTemplate":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(
            model=data.get("model", ""),
            temperature=data.get("temperature"),
            max_completion_tokens=data.get("max_completion_tokens"),
        )

    def apply(self, request: dict) -> dict:
        """Fill the unset fields of an OpenAI request dict (in place, and
        returned)."""
        if self.model and not request.get("model"):
            request["model"] = self.model
        if self.temperature is not None and request.get("temperature") is None:
            request["temperature"] = self.temperature
        if (self.max_completion_tokens is not None and request.get("max_tokens") is None
                and request.get("max_completion_tokens") is None):
            request["max_completion_tokens"] = self.max_completion_tokens
        return request
