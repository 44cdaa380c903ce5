"""Tokenizer with incremental streaming detokenization, in pure Python.

Counterpart of ``dynamo_exp_tpu/tokenizer.py``. Where the JAX package
wraps HuggingFace ``tokenizers``, the port reads ``tokenizer.json`` and
runs the byte-level BPE itself, so it needs no package beyond the
standard library. What it reads:

- ``model``: BPE with ``vocab`` and ``merges`` (``"a b"`` strings or
  ``[a, b]`` pairs), ``ignore_merges``; no dropout, no subword
  prefix/suffix, no byte fallback;
- ``added_tokens``: split out of the text before pre-tokenization
  (leftmost-longest, with ``lstrip``/``rstrip``); the ``special`` ones
  are skipped by ``decode(skip_special_tokens=True)``;
- ``normalizer``: none or NFC;
- ``pre_tokenizer``: ``ByteLevel(use_regex=True)`` (GPT-2's pattern) or
  ``Sequence[Split(Regex, Isolated), ByteLevel(use_regex=False)]``
  (Llama-3's and Qwen2's layout), without ``add_prefix_space``;
- ``post_processor``: none, ``ByteLevel``, or ``TemplateProcessing``
  (its ``single`` template, applied when ``add_special_tokens``);
- ``decoder``: ``ByteLevel`` (GPT-2's byte<->unicode table).

Python's ``re`` has no ``\\p{L}``/``\\p{N}`` and its ``\\s`` also takes
U+001C..U+001F, so a pattern's ``\\p{L}``, ``\\p{N}``, ``\\s`` and
``\\S`` are rewritten once, at load, into explicit character classes
built from ``unicodedata`` and Unicode's White_Space list. Any other
layout raises ``NotImplementedError`` naming the ROADMAP item that
brings it (SentencePiece ``tokenizer.model``, GGUF, Unigram, WordPiece:
Queue 1 item 9(f)).
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from dataclasses import dataclass
from typing import Sequence

REPLACEMENT_CHAR = "�"
LATER = "ROADMAP Queue 1 item 9(f)"

# GPT-2's pre-tokenizer pattern (HF ByteLevel(use_regex=True)).
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
# Unicode White_Space: what Oniguruma's \s takes (HF's regex engine).
_WHITE_SPACE = [
    (0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
    (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
    (0x3000, 0x3000),
]
_class_cache: dict[str, str] = {}


@dataclass
class Encoding:
    ids: list[int]


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable unicode character table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_ENCODER = _bytes_to_unicode()
BYTE_DECODER = {c: b for b, c in BYTE_ENCODER.items()}


def _ranges_body(ranges) -> str:
    return "".join(
        f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges
    )


def _class_body(name: str) -> str:
    """Character-class body (no brackets) for ``L``, ``N`` or ``s``."""
    if not _class_cache:
        runs: dict[str, list[list[int]]] = {"L": [], "N": []}
        for cp in range(0x110000):
            major = unicodedata.category(chr(cp))[0]
            if major in runs:
                r = runs[major]
                if r and r[-1][1] == cp - 1:
                    r[-1][1] = cp
                else:
                    r.append([cp, cp])
        for k, r in runs.items():
            _class_cache[k] = _ranges_body(r)
        _class_cache["s"] = _ranges_body(_WHITE_SPACE)
    return _class_cache[name]


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern as one Python's ``re`` reads the same way:
    ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` become explicit classes;
    any other ``\\p``/``\\P`` class raises."""
    out: list[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP":
                m = re.match(r"\{(\w+)\}", pattern[i + 2 :])
                if nxt == "P" or not m or m.group(1) not in ("L", "N"):
                    raise NotImplementedError(
                        f"pre-tokenizer pattern class {pattern[i:i + 8]!r}; see {LATER}"
                    )
                body = _class_body(m.group(1))
                out.append(body if in_class else f"[{body}]")
                i += 2 + m.end()
                continue
            if nxt in "sS":
                body = _class_body("s")
                if nxt == "S":
                    if in_class:
                        raise NotImplementedError(f"\\S inside a class; see {LATER}")
                    out.append(f"[^{body}]")
                else:
                    out.append(body if in_class else f"[{body}]")
                i += 2
                continue
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1 : i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1 : i + 2] == "]":  # a leading ']' is literal
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _unsupported(what: str, value) -> NotImplementedError:
    return NotImplementedError(
        f"tokenizer.json {what} {json.dumps(value)[:120]} is not supported by "
        f"the port's byte-level BPE; see {LATER}"
    )


class ByteLevelBPE:
    """The encode/decode backend read from one ``tokenizer.json``."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise _unsupported("model", model.get("type"))
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise _unsupported(f"model.{key}", model[key])
        if model.get("byte_fallback"):
            raise _unsupported("model.byte_fallback", True)
        self.vocab: dict[str, int] = dict(model.get("vocab") or {})
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = rank
        self.id_to_token: dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.added: dict[str, dict] = {}
        self.special_ids: set[int] = set()
        for t in spec.get("added_tokens") or []:
            if t.get("single_word"):
                raise _unsupported("added token single_word", t["content"])
            self.added[t["content"]] = t
            self.id_to_token[t["id"]] = t["content"]
            if t.get("special"):
                self.special_ids.add(t["id"])
        self.added_ids = {t["content"]: t["id"] for t in self.added.values()}
        self._added_re = (
            re.compile(
                "|".join(
                    re.escape(c) for c in sorted(self.added, key=len, reverse=True)
                )
            )
            if self.added
            else None
        )
        self._normalize = self._read_normalizer(spec.get("normalizer"))
        self._split_re = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        self._template = self._read_post_processor(spec.get("post_processor"))
        dec = spec.get("decoder")
        if dec is None or dec.get("type") != "ByteLevel":
            raise _unsupported("decoder", dec)
        self._cache: dict[str, list[int]] = {}

    # ------------------------------------------------------------ layout
    @staticmethod
    def _read_normalizer(norm):
        if norm is None:
            return None
        if norm.get("type") == "NFC":
            return lambda s: unicodedata.normalize("NFC", s)
        raise _unsupported("normalizer", norm)

    @staticmethod
    def _read_pre_tokenizer(pre) -> re.Pattern:
        """The pattern that splits text into pre-tokens."""
        if pre is None or pre.get("add_prefix_space"):
            raise _unsupported("pre_tokenizer", pre)
        if pre.get("type") == "ByteLevel" and pre.get("use_regex", True):
            return re.compile(translate_pattern(GPT2_PATTERN))
        if pre.get("type") == "Sequence":
            seq = pre.get("pretokenizers") or []
            if (
                len(seq) == 2
                and seq[0].get("type") == "Split"
                and "Regex" in (seq[0].get("pattern") or {})
                and seq[0].get("behavior") == "Isolated"
                and not seq[0].get("invert", False)
                and seq[1].get("type") == "ByteLevel"
                and not seq[1].get("use_regex", True)
                and not seq[1].get("add_prefix_space")
            ):
                return re.compile(translate_pattern(seq[0]["pattern"]["Regex"]))
        raise _unsupported("pre_tokenizer", pre)

    def _read_post_processor(self, post) -> list | None:
        """The ``single`` template as a list of ids and ``None`` (the
        sequence), or None when the post-processor adds no tokens."""
        if post is None or post.get("type") == "ByteLevel":
            return None
        if post.get("type") == "Sequence":
            tpls = [self._read_post_processor(p) for p in post.get("processors", [])]
            tpls = [t for t in tpls if t is not None]
            if len(tpls) > 1:
                raise _unsupported("post_processor", post)
            return tpls[0] if tpls else None
        if post.get("type") == "TemplateProcessing":
            out: list = []
            for piece in post["single"]:
                if "Sequence" in piece:
                    out.append(None)
                else:
                    name = piece["SpecialToken"]["id"]
                    out.extend(post["special_tokens"][name]["ids"])
            return out
        raise _unsupported("post_processor", post)

    # ------------------------------------------------------------ encode
    def _split_added(self, text: str) -> list[str | int]:
        """Text pieces and added-token ids, in order."""
        if self._added_re is None:
            return [text]
        out: list[str | int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            s, e = m.span()
            tok = self.added[m.group(0)]
            if tok.get("lstrip"):
                while s > pos and text[s - 1].isspace():
                    s -= 1
            if tok.get("rstrip"):
                while e < len(text) and text[e].isspace():
                    e += 1
            out.append(text[pos:s])
            out.append(tok["id"])
            pos = e
        out.append(text[pos:])
        return out

    def _pre_tokenize(self, text: str) -> list[str]:
        pieces, pos = [], 0
        for m in self._split_re.finditer(text):
            s, e = m.span()
            if s > pos:
                pieces.append(text[pos:s])
            if e > s:
                pieces.append(text[s:e])
            pos = e
        if pos < len(text):
            pieces.append(text[pos:])
        return pieces

    def _bpe(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            parts = [c for c in word if c in self.vocab]
            ranks = self.ranks
            while len(parts) > 1:
                best, best_rank = None, None
                for i in range(len(parts) - 1):
                    r = ranks.get((parts[i], parts[i + 1]))
                    if r is not None and (best_rank is None or r < best_rank):
                        best, best_rank = i, r
                if best is None:
                    break
                a, b = parts[best], parts[best + 1]
                merged, i = [], 0
                while i < len(parts):
                    if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                        merged.append(a + b)
                        i += 2
                    else:
                        merged.append(parts[i])
                        i += 1
                parts = merged
            ids = [self.vocab[p] for p in parts]
        if len(self._cache) >= 100_000:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        for piece in self._split_added(text):
            if isinstance(piece, int):
                ids.append(piece)
                continue
            if not piece:
                continue
            if self._normalize is not None:
                piece = self._normalize(piece)
            for word in self._pre_tokenize(piece):
                mapped = "".join(BYTE_ENCODER[b] for b in word.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        if add_special_tokens and self._template is not None:
            out: list[int] = []
            for t in self._template:
                out.extend(ids if t is None else [t])
            ids = out
        return ids

    # ------------------------------------------------------------ decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        buf = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and int(i) in self.special_ids):
                continue
            try:
                buf.extend(BYTE_DECODER[c] for c in tok)
            except KeyError:  # an added token written as plain text
                buf.extend(tok.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    def token_to_id(self, token: str) -> int | None:
        if token in self.added_ids:
            return self.added_ids[token]
        return self.vocab.get(token)

    def vocab_size(self) -> int:
        return len(set(self.vocab) | set(self.added))


class Tokenizer:
    """Encode/decode facade over :class:`ByteLevelBPE`."""

    def __init__(self, backend: ByteLevelBPE, eos_token_ids: list[int] | None = None):
        self._t = backend
        self.eos_token_ids = eos_token_ids or []

    @classmethod
    def from_pretrained(cls, path: str) -> "Tokenizer":
        """Load from a model directory holding ``tokenizer.json``, or
        from the file itself."""
        tok_json = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        model_dir = os.path.dirname(tok_json)
        if not (tok_json.endswith(".json") and os.path.isfile(tok_json)):
            if os.path.exists(os.path.join(path, "tokenizer.model")) or path.endswith(".gguf"):
                raise NotImplementedError(
                    f"{path}: SentencePiece and GGUF tokenizers are not ported; see {LATER}"
                )
            raise FileNotFoundError(f"no tokenizer.json at {path}")
        with open(tok_json, encoding="utf-8") as f:
            backend = ByteLevelBPE(json.load(f))
        return cls(backend, _eos_ids_from_config(model_dir, backend))

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        return Encoding(ids=self._t.encode(text, add_special_tokens))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._t.decode(ids, skip_special_tokens)

    @property
    def vocab_size(self) -> int:
        return self._t.vocab_size()

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer.

    Decoding token by token is wrong for byte-level vocabularies: a
    token may be half of a multi-byte character. Keep a window of ids,
    decode ``prefix..read`` and ``prefix..end``, and emit only the
    well-formed difference.
    """

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_id: int) -> str | None:
        """Feed one token id; returns newly-finalized text, or None."""
        self._ids.append(int(token_id))
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset], self._skip
        )
        new_text = self._tok.decode(self._ids[self._prefix_offset :], self._skip)
        if new_text.endswith(REPLACEMENT_CHAR):
            # Partial multi-byte character: hold until complete.
            return None
        if len(new_text) <= len(prefix_text):
            return None
        text = new_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return text


def _eos_ids_from_config(model_dir: str, backend: ByteLevelBPE) -> list[int]:
    """EOS token id(s) from generation_config.json / config.json, else
    the literal ``</s>``-style token of the vocabulary."""
    for fname in ("generation_config.json", "config.json"):
        p = os.path.join(model_dir, fname)
        if not os.path.exists(p):
            continue
        try:
            with open(p) as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        eos = cfg.get("eos_token_id")
        if eos is None:
            continue
        return [int(e) for e in eos] if isinstance(eos, list) else [int(eos)]
    for candidate in ("</s>", "<|endoftext|>", "<|eot_id|>"):
        tid = backend.token_to_id(candidate)
        if tid is not None:
            return [tid]
    return []
