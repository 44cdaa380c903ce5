"""The port's hub-cache resolution and GGUF model card against the JAX
package's, on the CPU.

``models/hub.resolve_model_path`` gives the JAX package's answers on its
pre-seeded cache layout (``tests/test_hub_gguf.py``:
``models--org--name/refs/main`` -> ``snapshots/<rev>``), through
``HF_HOME`` and through ``HF_HUB_CACHE``, with the network off; an id
that is not in the cache raises in the port, which does not download
(the JAX package is not asked: it would). ``run`` serves a hub id from
the cache. ``ModelDeploymentCard.from_gguf`` reads a GGUF's name,
context length, EOS, chat template and BOS/EOS strings as the JAX card
does.
"""

import dataclasses
import os

import pytest

from dynamo_exp_tpu.model_card import ModelDeploymentCard as JCard
from dynamo_exp_tpu.models import hub as jhub
from dynamo_exp_tpu_torch import run
from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
from dynamo_exp_tpu_torch.models import hub
from dynamo_exp_tpu_torch.models.gguf import write_gguf

from .fixtures import build_tiny_model_dir

REV = "0123456789abcdef0123456789abcdef01234567"
NAMES = ["org/model", "/tmp", "model-only", "a/b/c", "./relative/path", "org/.hidden",
         "org/", "test-org/tiny-model"]


def seed_cache(root, repo_id="test-org/tiny-model", model_dir=None):
    """The hub cache's layout for ``repo_id``: refs/main naming a
    snapshot (the fixture's model directory, or one config.json)."""
    repo = root / ("models--" + repo_id.replace("/", "--"))
    snap = repo / "snapshots" / REV
    snap.parent.mkdir(parents=True)
    if model_dir is None:
        snap.mkdir()
        (snap / "config.json").write_text("{}")
    else:
        build_tiny_model_dir(str(snap))
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(REV)
    return snap


def test_looks_like_hub_id_and_passthrough_equal_the_jax_package(tmp_path):
    assert [hub.looks_like_hub_id(n) for n in NAMES] == [jhub.looks_like_hub_id(n) for n in NAMES]
    d = tmp_path / "m"
    d.mkdir()
    g = tmp_path / "w.gguf"
    g.write_bytes(b"GGUF")
    for p in (str(d), str(g), str(tmp_path / "absent.gguf")):
        assert hub.resolve_model_path(p) == jhub.resolve_model_path(p) == p
    for mod in (hub, jhub):
        with pytest.raises(FileNotFoundError, match="neither a local path"):
            mod.resolve_model_path("not-a-model-or-path")


@pytest.mark.parametrize("env", ["HF_HOME", "HF_HUB_CACHE"])
def test_cached_hub_id_resolves_as_in_the_jax_package(tmp_path, monkeypatch, env):
    root = tmp_path / "hub"
    snap = seed_cache(root)
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv(env, str(tmp_path if env == "HF_HOME" else root))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")  # the JAX package must not reach the network
    got = hub.resolve_model_path("test-org/tiny-model")
    assert got == jhub.resolve_model_path("test-org/tiny-model") == str(snap)
    assert hub.hub_cache_dir() == str(root)


def test_uncached_hub_id_raises_without_downloading(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    with pytest.raises(FileNotFoundError, match="does not download"):
        hub.resolve_model_path("test-org/absent")
    repo = tmp_path / "hub" / "models--test-org--broken"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(REV)  # names a snapshot that is not there
    with pytest.raises(FileNotFoundError, match="not in the HuggingFace hub cache"):
        hub.resolve_model_path("test-org/broken")
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hub.hub_cache_dir() == str(tmp_path / ".cache" / "huggingface" / "hub")


def test_run_serves_a_cached_hub_id(tmp_path, monkeypatch):
    snap = seed_cache(tmp_path / "hub", model_dir=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    opts = run.parse_args(["in=http", "out=cuda", "--device", "cpu", "--model-path",
                           "test-org/tiny-model", "--random-weights", "--max-decode-slots", "2",
                           "--page-size", "8", "--max-model-len", "64", "--kv-dtype", "float32"])
    engine, mdc = run.build_cuda_engine(opts)
    engine.stop()
    assert opts.model_path == str(snap) and mdc.model_path == str(snap)
    assert run.tokenizer_registrable(str(snap))


def test_gguf_card_equals_the_jax_card(tmp_path):
    tpl = "{% for m in messages %}<|{{ m.role }}|>{{ m.content }}{% endfor %}<|assistant|>"
    md = {"general.architecture": "qwen2", "general.name": "tiny-gguf-chat",
          "qwen2.context_length": 512, "tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "a"],
          "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0], "tokenizer.ggml.bos_token_id": 1,
          "tokenizer.ggml.eos_token_id": 2, "tokenizer.chat_template": tpl}
    path = str(tmp_path / "model.gguf")
    for name, drop in (("full", []), ("bare", ["general.name", "tokenizer.chat_template",
                                               "qwen2.context_length"])):
        write_gguf(path, {k: v for k, v in md.items() if k not in drop}, {})
        for display in (None, "served-name"):
            got = dataclasses.asdict(ModelDeploymentCard.from_local_path(path, display))
            want = dataclasses.asdict(JCard.from_gguf(path, display))
            assert got == {k: want[k] for k in got}, name
    assert got["display_name"] == "served-name" and got["chat_template"] is None
    assert ModelDeploymentCard.from_gguf(path).display_name == os.path.basename(path)
