"""Tokenizer rebuilt from a GGUF file's embedded metadata.

Counterpart of ``dynamo_exp_tpu/gguf_tokenizer.py``. A bare ``.gguf``
carries its tokenizer under ``tokenizer.ggml.*``: the token strings,
unigram scores or BPE merges, token types and special-token ids. Where
the JAX package builds HF ``tokenizers`` objects from them, the port
builds the ``tokenizer.json``-shaped spec that its own
:class:`~dynamo_exp_tpu_torch.tokenizer.Backend` reads:

- ``llama`` (and ``replit``): SentencePiece as a Unigram model with byte
  fallback, the ``Prepend("▁")`` / ``Replace(" ", "▁")`` normalizer and
  the ``Replace`` / ``ByteFallback`` / ``Fuse`` / ``Strip`` decoder chain;
- ``gpt2``: byte-level BPE over the vocabulary and the merge pairs,
  ``ByteLevel`` without a prefix space.

Special tokens are bos, eos, unk and every CONTROL token. BOS is added
when ``tokenizer.ggml.add_bos_token`` says so; without the key, as
llama.cpp does, for ``llama`` / ``replit`` vocabularies and not for
``gpt2``.
"""

from __future__ import annotations

# tokenizer.ggml.token_type values (llama.cpp's enum).
TOKEN_NORMAL = 1
TOKEN_UNKNOWN = 2
TOKEN_CONTROL = 3
TOKEN_USER_DEFINED = 4
TOKEN_UNUSED = 5
TOKEN_BYTE = 6


def _build_unigram(tokens, scores, unk_id: int | None) -> dict:
    """SentencePiece as a Unigram spec, with its normalizer and decoder."""
    if scores is None:
        raise ValueError("llama-model GGUF tokenizer is missing tokenizer.ggml.scores")
    return {
        "model": {"type": "Unigram", "unk_id": unk_id if unk_id is not None else 0,
                  "byte_fallback": True,
                  "vocab": [[t, float(s)] for t, s in zip(tokens, scores)]},
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
    }


def _build_bpe(tokens, merges) -> dict:
    """Byte-level BPE spec over the vocabulary and the merges."""
    if merges is None:
        raise ValueError("gpt2-model GGUF tokenizer is missing tokenizer.ggml.merges")
    return {
        "model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(tokens)},
                  "merges": [m.partition(" ")[::2] for m in merges]},
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
        "decoder": {"type": "ByteLevel"},
    }


def add_special_tokens(spec: dict, tokens: list[str], ids) -> None:
    """Mark ``ids``' tokens special, as HF's ``add_special_tokens``
    does: an added token takes the model's id of its content."""
    vocab = spec["model"]["vocab"]
    if not isinstance(vocab, dict):  # Unigram's [piece, score] list; a repeat keeps its last id
        vocab = {p: i for i, (p, _) in enumerate(vocab)}
    added = []
    for i in sorted(set(ids)):
        if i < len(tokens):
            added.append({"id": vocab[tokens[i]], "content": tokens[i], "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True})
    spec["added_tokens"] = added


def bos_template(bos: str, bos_id: int) -> dict:
    """The post-processor that puts BOS in front of a sequence."""
    return {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}}],
        "special_tokens": {bos: {"id": bos, "ids": [bos_id], "tokens": [bos]}},
    }


def tokenizer_backend_from_gguf(gguf):
    """The :class:`~dynamo_exp_tpu_torch.tokenizer.Backend` of a parsed
    ``GGUFFile`` (or any object with a ``metadata`` dict)."""
    from .tokenizer import Backend

    md = gguf.metadata
    model = md.get("tokenizer.ggml.model")
    tokens = md.get("tokenizer.ggml.tokens")
    if model is None or tokens is None:
        raise ValueError("GGUF has no embedded tokenizer (tokenizer.ggml.model/tokens missing)")
    token_type = md.get("tokenizer.ggml.token_type")
    unk_id = md.get("tokenizer.ggml.unknown_token_id")
    if unk_id is None and token_type is not None:
        unk = [i for i, t in enumerate(token_type) if t == TOKEN_UNKNOWN]
        unk_id = unk[0] if unk else None
    if model in ("llama", "replit"):
        spec = _build_unigram(tokens, md.get("tokenizer.ggml.scores"), unk_id)
    elif model == "gpt2":
        spec = _build_bpe(tokens, md.get("tokenizer.ggml.merges"))
    else:
        raise ValueError(f"unsupported GGUF tokenizer model {model!r}")
    bos_id = md.get("tokenizer.ggml.bos_token_id")
    special = {bos_id, md.get("tokenizer.ggml.eos_token_id"), unk_id} - {None}
    if token_type is not None:
        special.update(i for i, t in enumerate(token_type) if t == TOKEN_CONTROL)
    add_special_tokens(spec, tokens, special)
    if bos_id is not None and bos_id >= len(tokens):
        raise ValueError(f"GGUF bos_token_id {bos_id} out of range for vocab of {len(tokens)}")
    default_add_bos = model in ("llama", "replit")
    if md.get("tokenizer.ggml.add_bos_token", default_add_bos) and bos_id is not None:
        spec["post_processor"] = bos_template(tokens[bos_id], bos_id)
    return Backend(spec)


def tokenizer_from_gguf(path: str):
    """The serving :class:`~dynamo_exp_tpu_torch.tokenizer.Tokenizer` of
    a ``.gguf`` file, its EOS from the metadata."""
    from .models.gguf import GGUFFile
    from .tokenizer import Tokenizer

    gguf = GGUFFile.parse(path)
    backend = tokenizer_backend_from_gguf(gguf)
    eos = gguf.metadata.get("tokenizer.ggml.eos_token_id")
    return Tokenizer(backend, [int(eos)] if eos is not None else [])
