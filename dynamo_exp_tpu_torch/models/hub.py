"""Model source resolution: a local directory, a GGUF file, or a hub id.

Counterpart of ``dynamo_exp_tpu/models/hub.py``, its local-cache case
only. A HuggingFace hub id (``org/name``) resolves to the snapshot that
is already in the local hub cache, read with the standard library: the
cache is ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``; the repository ``models--org--name`` names
its revision in ``refs/main`` and keeps it under ``snapshots/<rev>``.
The port does not download (the machines it serves on have no network;
the JAX package's download branch is ROADMAP Queue 1 item 9(f)): an id
that is not in the cache raises, saying how to seed it.
"""

from __future__ import annotations

import os


def looks_like_hub_id(name: str) -> bool:
    """'org/model' shaped, not an existing local path."""
    if os.path.exists(name):
        return False
    parts = name.split("/")
    return len(parts) == 2 and all(p and not p.startswith(".") for p in parts)


def hub_cache_dir() -> str:
    """The hub cache, read from the environment at call time."""
    cache = os.environ.get("HF_HUB_CACHE")
    if cache:
        return cache
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def resolve_model_path(name_or_path: str) -> str:
    """A local directory or ``.gguf`` file is itself; a hub id is its
    cached snapshot directory."""
    if os.path.isdir(name_or_path) or name_or_path.endswith(".gguf"):
        return name_or_path
    if not looks_like_hub_id(name_or_path):
        raise FileNotFoundError(
            f"{name_or_path!r} is neither a local path nor an org/model HuggingFace id"
        )
    repo = os.path.join(hub_cache_dir(), "models--" + name_or_path.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main"), encoding="utf-8") as f:
            rev = f.read().strip()
    except OSError:
        rev = ""
    snap = os.path.join(repo, "snapshots", rev)
    if rev and os.path.isdir(snap):
        return snap
    raise FileNotFoundError(
        f"{name_or_path!r} is not in the HuggingFace hub cache at {hub_cache_dir()}, and "
        "the port does not download: seed the cache (HF_HUB_CACHE or HF_HOME) or pass a "
        "local --model-path"
    )
