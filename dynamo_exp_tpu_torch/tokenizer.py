"""Tokenizer with incremental streaming detokenization, in pure Python.

Counterpart of ``dynamo_exp_tpu/tokenizer.py``. Where the JAX package
wraps HuggingFace ``tokenizers``, the port reads ``tokenizer.json`` and
runs the BPE itself, so it needs no package beyond the standard library.
It reads the two BPE layouts published checkpoints ship (:class:`BPE`):

- byte-level (GPT-2, Llama-3, Qwen2): ``pre_tokenizer``
  ``ByteLevel(use_regex=True)`` (GPT-2's pattern) or
  ``Sequence[Split(Regex, Isolated), ByteLevel(use_regex=False)]``,
  without ``add_prefix_space``; ``decoder`` ``ByteLevel`` (GPT-2's
  byte<->unicode table);
- SentencePiece-style (Llama-2, Mistral, Gemma, Phi-3): a
  ``Prepend("▁")`` / ``Replace(" ", "▁")`` normalizer and no
  pre-tokenizer, or a ``Metaspace`` pre-tokenizer; ``model.byte_fallback``
  (``<0xNN>`` tokens for characters outside the vocabulary) and
  ``unk_token`` / ``fuse_unk``; a decoder of ``Replace``,
  ``ByteFallback``, ``Fuse``, ``Strip`` and ``Metaspace`` steps.

Both: ``model`` BPE with ``vocab`` and ``merges`` (``"a b"`` strings or
``[a, b]`` pairs) and ``ignore_merges``, no dropout, no subword
prefix/suffix; ``added_tokens`` split out before pre-tokenization
(leftmost-longest, with ``lstrip``/``rstrip``; ``normalized`` ones
matched by their normalized content in the normalized text), the
``special`` ones skipped by ``decode(skip_special_tokens=True)``;
``normalizer`` none, NFC, ``Prepend``, ``Replace`` or a ``Sequence`` of
them; ``post_processor`` none, ``ByteLevel``, or ``TemplateProcessing``
(its ``single`` template, applied when ``add_special_tokens``).

Python's ``re`` has no ``\\p{L}``/``\\p{N}`` and its ``\\s`` also takes
U+001C..U+001F, so a pattern's ``\\p{L}``, ``\\p{N}``, ``\\s`` and
``\\S`` are rewritten once, at load, into explicit character classes
built from ``unicodedata`` and Unicode's White_Space list. Any other
layout raises ``NotImplementedError`` naming the ROADMAP item that
brings it (a bare SentencePiece ``tokenizer.model``, GGUF, Unigram,
WordPiece and the other normalizers: Queue 1 item 9(f)).
"""

from __future__ import annotations

import heapq
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
        f"the port's BPE; see {LATER}"
    )


def _string_pattern(spec: dict, what: str) -> str:
    """A ``Replace`` step's ``{"String": s}`` pattern (a regex one raises)."""
    pattern = spec.get("pattern") or {}
    if "String" not in pattern:
        raise _unsupported(what, spec)
    return pattern["String"]


def _byte_fallback(tokens: list[str]) -> list[str]:
    """HF's ``ByteFallback`` decoder: each run of ``<0xNN>`` tokens
    becomes its bytes as UTF-8, or one U+FFFD a byte if they are not
    valid UTF-8."""
    out: list[str] = []
    run = bytearray()
    for tok in tokens + [""]:
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                run.append(int(tok[3:5], 16))
                continue
            except ValueError:
                pass
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(REPLACEMENT_CHAR * len(run))
            run = bytearray()
        out.append(tok)
    return out[:-1]


class BPE:
    """The encode/decode backend read from one ``tokenizer.json``: a BPE
    model in one of two layouts.

    - Byte-level (GPT-2, Llama-3, Qwen2): the ``ByteLevel`` decoder; text
      is split by the pre-tokenizer's pattern and each piece's UTF-8
      bytes are mapped to GPT-2's printable characters before BPE.
    - SentencePiece-style (Llama-2, Mistral, Gemma, Phi-3): spaces
      become ``▁`` through a ``Replace`` / ``Prepend`` normalizer or a
      ``Metaspace`` pre-tokenizer, BPE runs on the characters themselves,
      and a character outside the vocabulary falls back to its UTF-8
      bytes as ``<0xNN>`` tokens (``model.byte_fallback``) or to
      ``unk_token``. The decoder is a ``Sequence`` of ``Replace``,
      ``ByteFallback``, ``Fuse``, ``Strip`` and ``Metaspace`` steps.

    Merges are applied as HF's ``Word::merge_all`` applies them: the
    lowest-ranked pair first, the leftmost among equals, one merge at a
    time, so even a merge list whose new pairs outrank older ones
    tokenizes as ``tokenizers`` does."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise _unsupported("model", model.get("type"))
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise _unsupported(f"model.{key}", model[key])
        self.vocab: dict[str, int] = dict(model.get("vocab") or {})
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.unk_id = self.vocab.get(model["unk_token"]) if model.get("unk_token") else None
        self.fuse_unk = bool(model.get("fuse_unk", False))
        # (left id, right id) -> (rank, merged id), as HF keys its merges.
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            if a in self.vocab and b in self.vocab and a + b in self.vocab:
                self.merges.setdefault((self.vocab[a], self.vocab[b]), (rank, self.vocab[a + b]))
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
        dec = spec.get("decoder")
        self.byte_level = dec is not None and dec.get("type") == "ByteLevel"
        self._normalize = self._read_normalizer(spec.get("normalizer"))
        # Added tokens are split out of the raw text by their content, or,
        # when marked ``normalized``, out of each normalized piece by
        # their normalized content, as HF's added vocabulary matches them.
        self._added_by = {False: {}, True: {}}
        for c, t in self.added.items():
            norm = bool(t.get("normalized"))
            key = self._normalize(c) if norm and self._normalize is not None else c
            self._added_by[norm][key] = t
        self._added_re = {norm: self._alternation(list(by)) for norm, by in self._added_by.items()}
        if self.byte_level:
            if self.byte_fallback:
                raise _unsupported("model.byte_fallback", True)
            self._split_re = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        else:
            self._decoders = self._read_decoders(dec)
            self._metaspace = self._read_metaspace(spec.get("pre_tokenizer"))
        self._template = self._read_post_processor(spec.get("post_processor"))
        self._cache: dict[str, list[int]] = {}

    @staticmethod
    def _alternation(words: list[str]) -> re.Pattern | None:
        """Leftmost-longest matching of ``words`` (longest listed first)."""
        if not words:
            return None
        return re.compile("|".join(re.escape(w) for w in sorted(words, key=len, reverse=True)))

    # ------------------------------------------------------------ layout
    @classmethod
    def _read_normalizer(cls, norm):
        """A function of a text piece, or None: NFC, ``Prepend``,
        ``Replace`` (a string pattern) or a ``Sequence`` of them."""
        if norm is None:
            return None
        kind = norm.get("type")
        if kind == "NFC":
            return lambda s: unicodedata.normalize("NFC", s)
        if kind == "Prepend":
            pre = norm["prepend"]
            return lambda s: pre + s if s else s
        if kind == "Replace":
            old, new = _string_pattern(norm, "normalizer"), norm["content"]
            return lambda s: s.replace(old, new)
        if kind == "Sequence":
            steps = [cls._read_normalizer(n) for n in norm.get("normalizers") or []]

            def run(s):
                for step in steps:
                    s = step(s) if step else s
                return s
            return run
        raise _unsupported("normalizer", norm)

    @staticmethod
    def _read_pre_tokenizer(pre) -> re.Pattern:
        """The byte-level layouts' pattern that splits text into pieces."""
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

    @staticmethod
    def _read_metaspace(pre) -> tuple[str, str, bool] | None:
        """The SentencePiece layouts' pre-tokenizer: none (the normalizer
        did the work; the piece is one word) or ``Metaspace`` as
        (replacement, prepend scheme, split)."""
        if pre is None:
            return None
        if pre.get("type") == "Metaspace":
            scheme = pre.get("prepend_scheme")
            if scheme is None:  # older files: add_prefix_space
                scheme = "always" if pre.get("add_prefix_space", True) else "never"
            if scheme in ("always", "first", "never"):
                return pre.get("replacement", "▁"), scheme, bool(pre.get("split", True))
        raise _unsupported("pre_tokenizer", pre)

    @staticmethod
    def _read_decoders(dec) -> list[tuple]:
        """The SentencePiece layouts' decoder steps, in order."""
        sequence = dec is not None and dec.get("type") == "Sequence"
        steps = (dec.get("decoders") or []) if sequence else [dec]
        out = []
        for d in steps:
            kind = (d or {}).get("type")
            if kind == "Replace":
                out.append((kind, _string_pattern(d, "decoder"), d["content"]))
            elif kind in ("ByteFallback", "Fuse"):
                out.append((kind,))
            elif kind == "Strip":
                out.append((kind, d["content"], int(d.get("start", 0)), int(d.get("stop", 0))))
            elif kind == "Metaspace":
                scheme = d.get("prepend_scheme")
                if scheme is None:
                    scheme = "always" if d.get("add_prefix_space", True) else "never"
                out.append((kind, d.get("replacement", "▁"), scheme != "never"))
            else:
                raise _unsupported("decoder", dec)
        return out

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
    def _split_added(self, text: str, normalized: bool) -> list[str | int]:
        """Text pieces and added-token ids, in order."""
        added_re = self._added_re[normalized]
        if added_re is None:
            return [text]
        out: list[str | int] = []
        pos = 0
        for m in added_re.finditer(text):
            s, e = m.span()
            tok = self._added_by[normalized][m.group(0)]
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

    def _pre_tokenize(self, text: str, first: bool) -> list[str]:
        """The words of one normalized piece; ``first``: the piece starts
        the input (``Metaspace``'s ``first`` prepend scheme)."""
        if self.byte_level:
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
            return ["".join(BYTE_ENCODER[b] for b in w.encode("utf-8")) for w in pieces]
        if self._metaspace is None:
            return [text]
        rep, scheme, split = self._metaspace
        text = text.replace(" ", rep)
        if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
            text = rep + text
        if not split:
            return [text]
        words = re.split(f"(?={re.escape(rep)})", text)  # each ▁ opens a word
        return [w for w in words if w]

    def _symbols(self, word: str) -> list[int]:
        """A word's first symbols: one id a character; outside the
        vocabulary, its UTF-8 bytes as ``<0xNN>`` tokens (byte fallback)
        when they all exist, else ``unk_token`` (runs fused with
        ``fuse_unk``), else nothing."""
        ids: list[int] = []
        unk = False
        for c in word:
            i = self.vocab.get(c)
            if i is None and self.byte_fallback:
                fb = [self.vocab.get(f"<0x{b:02X}>") for b in c.encode("utf-8")]
                if None not in fb:
                    ids.extend(fb)
                    unk = False
                    continue
            if i is None:
                if self.unk_id is not None and not (unk and self.fuse_unk):
                    ids.append(self.unk_id)
                unk = self.unk_id is not None
                continue
            ids.append(i)
            unk = False
        return ids

    def _merge(self, ids: list[int]) -> list[int]:
        """Apply the merges to a word's symbols (see the class docstring)."""
        n = len(ids)
        if n < 2:
            return ids
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        ids = list(ids)
        while heap:
            rank, i, new = heapq.heappop(heap)
            j = nxt[i]
            if ids[i] < 0 or j < 0 or self.merges.get((ids[i], ids[j]), (0, None))[1] != new:
                continue  # a stale entry: a side of the pair was merged since
            ids[i], ids[j] = new, -1
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            for a, b in ((prv[i], i), (i, nxt[i])):
                if a >= 0 and b >= 0:
                    m = self.merges.get((ids[a], ids[b]))
                    if m is not None:
                        heapq.heappush(heap, (m[0], a, m[1]))
        return [i for i in ids if i >= 0]

    def _bpe(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._merge(self._symbols(word))
        if len(word) <= 256:  # one-word layouts pass whole texts
            if len(self._cache) >= 100_000:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        first = True  # the next piece starts the input
        for raw in self._split_added(text, normalized=False):
            if isinstance(raw, str) and raw and self._normalize is not None:
                raw = self._normalize(raw)
            parts = [raw] if isinstance(raw, int) else self._split_added(raw, normalized=True)
            for part in parts:
                if isinstance(part, int):
                    ids.append(part)
                elif part:
                    for word in self._pre_tokenize(part, first):
                        ids.extend(self._bpe(word))
                first = False
        if add_special_tokens and self._template is not None:
            out: list[int] = []
            for t in self._template:
                out.extend(ids if t is None else [t])
            ids = out
        return ids

    # ------------------------------------------------------------ decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = [
            self.id_to_token[int(i)] for i in ids
            if int(i) in self.id_to_token
            and not (skip_special_tokens and int(i) in self.special_ids)
        ]
        if self.byte_level:
            buf = bytearray()
            for tok in toks:
                try:
                    buf.extend(BYTE_DECODER[c] for c in tok)
                except KeyError:  # an added token written as plain text
                    buf.extend(tok.encode("utf-8"))
            return buf.decode("utf-8", errors="replace")
        for step in self._decoders:  # HF's decode_chain, step by step
            kind = step[0]
            if kind == "Replace":
                toks = [t.replace(step[1], step[2]) for t in toks]
            elif kind == "ByteFallback":
                toks = _byte_fallback(toks)
            elif kind == "Fuse":
                toks = ["".join(toks)]
            elif kind == "Strip":
                _, ch, lead, trail = step
                toks = [_strip(t, ch, lead, trail) for t in toks]
            else:  # Metaspace: the first token loses its replacements
                _, rep, prepended = step
                toks = [t.replace(rep, "" if (k == 0 and prepended) else " ")
                        for k, t in enumerate(toks)]
        return "".join(toks)

    def token_to_id(self, token: str) -> int | None:
        if token in self.added_ids:
            return self.added_ids[token]
        return self.vocab.get(token)

    def vocab_size(self) -> int:
        return len(set(self.vocab) | set(self.added))


def _strip(tok: str, ch: str, lead: int, trail: int) -> str:
    """HF's ``Strip`` decoder: up to ``lead`` leading and ``trail``
    trailing ``ch`` characters off one token."""
    a = 0
    while a < min(lead, len(tok)) and tok[a] == ch:
        a += 1
    b = len(tok)
    while len(tok) - b < trail and b > a and tok[b - 1] == ch:
        b -= 1
    return tok[a:b]


class Tokenizer:
    """Encode/decode facade over :class:`BPE`."""

    def __init__(self, backend: BPE, eos_token_ids: list[int] | None = None):
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
            backend = BPE(json.load(f))
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


def _eos_ids_from_config(model_dir: str, backend: BPE) -> list[int]:
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
