"""ModelDeploymentCard: everything a frontend needs to serve a model.

Counterpart of ``dynamo_exp_tpu/model_card.py``, the HF-directory path
only (``from_local_path``): context length, the chat template and special tokens from ``tokenizer_config.json``, and the EOS
ids. GGUF cards and card publication are not ported (ROADMAP Queue 1
item 9(e)/(f)).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any


def _eos_list(eos) -> list[int]:
    return [int(e) for e in eos] if isinstance(eos, list) else [int(eos)]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class ModelDeploymentCard:
    display_name: str
    model_path: str = ""
    context_length: int = 4096
    # Jinja chat template + special tokens from tokenizer_config.json.
    chat_template: str | None = None
    bos_token: str | None = None
    eos_token: str | None = None
    eos_token_ids: list[int] = field(default_factory=list)
    # Where the frontend should load the tokenizer from.
    tokenizer_path: str = ""

    @classmethod
    def from_local_path(
        cls, path: str, display_name: str | None = None
    ) -> "ModelDeploymentCard":
        """Build a card from a HF-style model directory."""
        if path.endswith(".gguf"):
            raise NotImplementedError(
                "GGUF model cards are not ported; see ROADMAP Queue 1 item 9(f)"
            )
        name = display_name or os.path.basename(os.path.normpath(path))
        card = cls(display_name=name, model_path=path, tokenizer_path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            model_config = _read_json(cfg_path)
            card.context_length = int(
                model_config.get("max_position_embeddings", card.context_length)
            )
            eos = model_config.get("eos_token_id")
            if eos is not None:
                card.eos_token_ids = _eos_list(eos)
        tok_cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg_path):
            tok_cfg = _read_json(tok_cfg_path)
            card.chat_template = _select_chat_template(tok_cfg)
            card.bos_token = _token_str(tok_cfg.get("bos_token"))
            card.eos_token = _token_str(tok_cfg.get("eos_token"))
        gen_cfg_path = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_cfg_path) and not card.eos_token_ids:
            eos = _read_json(gen_cfg_path).get("eos_token_id")
            if eos is not None:
                card.eos_token_ids = _eos_list(eos)
        return card


def _select_chat_template(tok_cfg: dict) -> str | None:
    """tokenizer_config.json may hold one template or a named list
    (``[{"name": "default", "template": ...}, {"name": "tool_use", ...}]``)."""
    tpl = tok_cfg.get("chat_template")
    if tpl is None:
        return None
    if isinstance(tpl, str):
        return tpl
    if isinstance(tpl, list):
        by_name = {t.get("name"): t.get("template") for t in tpl if isinstance(t, dict)}
        return by_name.get("default") or next(iter(by_name.values()), None)
    return None


def _token_str(value: Any) -> str | None:
    """Token entries are either strings or AddedToken dicts."""
    if value is None:
        return None
    if isinstance(value, str):
        return value
    if isinstance(value, dict):
        return value.get("content")
    return str(value)
