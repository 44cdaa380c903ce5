"""ModelDeploymentCard: everything a frontend needs to serve a model.

Counterpart of ``dynamo_exp_tpu/model_card.py``: from an HF directory
(``from_local_path``) the context length, KV block size, config.json,
the chat template and special tokens from ``tokenizer_config.json``, and
the EOS ids; from a bare ``.gguf`` (``from_gguf``) the same out of its
metadata; the card's JSON (``to_json`` / ``from_json``) and its
publication heartbeat (``stamp``, ``is_expired``) as a worker publishes
it (``local_model.py``) and an ingress reads it (``http/discovery.py``),
in the JAX card's fields and order. The tokenizer travels as a path
(``tokenizer_path``), not as bytes.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Any

# How stale a card's last_published may be before ingress treats it as a
# dead worker's leftover. Workers re-publish every CARD_MAX_AGE_S / 3.
CARD_MAX_AGE_S = 300.0


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
    kv_cache_block_size: int = 16
    # Raw HF config.json contents (architecture, dims, eos ids, ...).
    model_config: dict[str, Any] = field(default_factory=dict)
    # Jinja chat template + special tokens from tokenizer_config.json.
    chat_template: str | None = None
    bos_token: str | None = None
    eos_token: str | None = None
    eos_token_ids: list[int] = field(default_factory=list)
    # Where the frontend should load the tokenizer from.
    tokenizer_path: str = ""
    model_type: str = "chat"  # "chat" | "completion" | "backend"
    migration_limit: int = 0
    # Publication heartbeat: None means never advertised (a local card).
    last_published: float | None = None
    revision: int = 0

    @property
    def slug(self) -> str:
        return self.display_name.replace("/", "--")

    def stamp(self) -> None:
        """Mark the card as freshly advertised (call just before put)."""
        self.last_published = time.time()
        self.revision += 1

    def is_expired(self, max_age_s: float = CARD_MAX_AGE_S, now: float | None = None) -> bool:
        """Stale last_published: the publishing worker is likely gone.
        Never-published cards are not expired."""
        if self.last_published is None:
            return False
        return (now if now is not None else time.time()) - self.last_published > max_age_s

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "ModelDeploymentCard":
        # Unknown keys are dropped, so the format can grow mid-rollout.
        d = json.loads(text)
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_gguf(
        cls, path: str, display_name: str | None = None, gguf=None
    ) -> "ModelDeploymentCard":
        """Build a card from a bare ``.gguf``, which carries its own
        tokenizer (``tokenizer.ggml.*``) and often a chat template
        (``tokenizer.chat_template``). Pass an already parsed
        ``GGUFFile`` as ``gguf`` to read the metadata once."""
        if gguf is None:
            from .models.gguf import GGUFFile

            gguf = GGUFFile.parse(path)
        md = gguf.metadata
        name = display_name or md.get("general.name") or os.path.basename(path)
        card = cls(display_name=name, model_path=path, tokenizer_path=path)
        ctx = md.get(f"{md.get('general.architecture', 'llama')}.context_length")
        if ctx:
            card.context_length = int(ctx)
        eos = md.get("tokenizer.ggml.eos_token_id")
        if eos is not None:
            card.eos_token_ids = [int(eos)]
        tpl = md.get("tokenizer.chat_template")
        if isinstance(tpl, str) and tpl:
            card.chat_template = tpl
        tokens = md.get("tokenizer.ggml.tokens")
        bos = md.get("tokenizer.ggml.bos_token_id")
        if tokens:
            if bos is not None and bos < len(tokens):
                card.bos_token = tokens[bos]
            if eos is not None and eos < len(tokens):
                card.eos_token = tokens[eos]
        return card

    @classmethod
    def from_local_path(
        cls, path: str, display_name: str | None = None
    ) -> "ModelDeploymentCard":
        """Build a card from a HF-style model directory (or a .gguf)."""
        if path.endswith(".gguf"):
            return cls.from_gguf(path, display_name)
        name = display_name or os.path.basename(os.path.normpath(path))
        card = cls(display_name=name, model_path=path, tokenizer_path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            card.model_config = _read_json(cfg_path)
            card.context_length = int(
                card.model_config.get("max_position_embeddings", card.context_length)
            )
            eos = card.model_config.get("eos_token_id")
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
