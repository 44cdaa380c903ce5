"""ServiceConfig: per-service configuration, env-overridable.

Counterpart of ``dynamo_exp_tpu/sdk/config.py``: a file (``-f
configs/agg.json``) whose top-level keys are service names, merged with
the ``DYN_SERVICE_CONFIG`` environment variable (JSON; its keys win),
handed to each service as attributes. The JAX package reads the file as
YAML through PyYAML, which the port does not import: the port reads
JSON, and a ``.yaml`` / ``.yml`` path raises naming the JSON form.
"""

from __future__ import annotations

import json
import os
from typing import Any

ENV_VAR = "DYN_SERVICE_CONFIG"


class ServiceConfig:
    def __init__(self, data: dict[str, dict[str, Any]] | None = None):
        self.data = data or {}

    @classmethod
    def load(cls, path: str | None = None) -> "ServiceConfig":
        data: dict[str, dict[str, Any]] = {}
        if path:
            if path.endswith((".yaml", ".yml")):
                raise ValueError(
                    f"{path}: the port reads JSON service configs only; write the same "
                    "keys as JSON (dynamo_exp_tpu_torch/examples/llm/configs/*.json)"
                )
            with open(path, encoding="utf-8") as f:
                data.update(json.load(f) or {})
        env = os.environ.get(ENV_VAR)
        if env:
            for svc, overrides in json.loads(env).items():
                data.setdefault(svc, {}).update(overrides)
        return cls(data)

    def get(self, service_name: str) -> dict[str, Any]:
        return dict(self.data.get(service_name, {}))

    def dumps(self) -> str:
        """Serialized form passed to child processes via the env var, so
        every service process sees the same merged view."""
        return json.dumps(self.data)

    def apply_to(self, instance: Any, service_name: str) -> None:
        """Set the service's config keys as attributes of its instance."""
        for key, value in self.get(service_name).items():
            setattr(instance, key, value)
