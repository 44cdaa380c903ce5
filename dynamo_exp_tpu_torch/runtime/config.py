"""Layered runtime configuration: defaults <- config file <- environment.

Counterpart of ``dynamo_exp_tpu/runtime/config.py``: a dataclass of
defaults, overridden by a JSON file (``DYN_RUNTIME_CONFIG``), then by
``DYN_RUNTIME_*`` environment variables; the fields the port reads
(the JAX config's thread-pool, broker and logging fields have no reader
here). The JAX package also reads YAML files through PyYAML, which the
port does not import: a ``.yaml`` path raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any


@dataclass
class RuntimeConfig:
    """Process-level runtime settings."""

    # Control-plane (coordinator) address. Empty => "static" mode: no
    # discovery, endpoints wired explicitly.
    coordinator_endpoint: str = ""
    # TCP response-plane bind host (the address handed to peers).
    response_host: str = "127.0.0.1"
    response_port: int = 0  # 0 = ephemeral
    # Lease TTL for discovery registrations, seconds.
    lease_ttl_s: float = 10.0

    ENV_PREFIX = "DYN_RUNTIME_"

    @classmethod
    def from_settings(cls, config_path: str | None = None) -> "RuntimeConfig":
        values: dict[str, Any] = {}
        path = config_path or os.environ.get("DYN_RUNTIME_CONFIG")
        if path and Path(path).exists():
            if path.endswith((".yaml", ".yml")):
                raise ValueError(f"{path}: the port reads JSON runtime configs only")
            values.update(json.loads(Path(path).read_text()))
        for f in dataclasses.fields(cls):
            env_name = cls.ENV_PREFIX + f.name.upper()
            if env_name in os.environ:
                raw = os.environ[env_name]
                if f.type in ("int", int):
                    values[f.name] = int(raw)
                elif f.type in ("float", float):
                    values[f.name] = float(raw)
                else:
                    values[f.name] = raw
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in known})

    @property
    def is_static(self) -> bool:
        return not self.coordinator_endpoint
