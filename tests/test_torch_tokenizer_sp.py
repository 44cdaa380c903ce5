"""The port's tokenizer on SentencePiece-style BPE ``tokenizer.json``
files against the JAX package's tokenizer (HuggingFace ``tokenizers``),
on the CPU.

One BPE is trained here with ``tokenizers`` (``▁`` for spaces, a small
alphabet so CJK and emoji fall back to ``<0xNN>`` byte tokens, which sit
in the model's vocabulary as in Llama-2's file), then written in the
layouts published checkpoints ship:

- ``llama2``: ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizer, no
  pre-tokenizer, ``Replace`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip(" ", 1, 0)`` decoder, ``<s>`` template (Llama-2, Mistral,
  Phi-3);
- ``gemma``: ``Replace(" ", "▁")`` alone, no ``Strip``;
- ``metaspace_first``: a ``Metaspace(prepend_scheme="first",
  split=False)`` pre-tokenizer with the ``llama2`` decoder (newer
  Llama-2 and Mistral conversions);
- ``metaspace_split``: ``Metaspace(prepend_scheme="always", split=True)``
  both ways (the pre-tokenizer and the decoder).

Each carries a special added token and a non-special one matched after
normalization. Encode ids, decode text and ``DecodeStream`` pieces must
equal the JAX ``Tokenizer``'s exactly, on a corpus with leading and
doubled spaces, CJK and emoji, and on seeded random id sequences (which
split byte-fallback characters).
"""

import json

import numpy as np
import pytest

from dynamo_exp_tpu.tokenizer import Tokenizer as JTokenizer
from dynamo_exp_tpu_torch.tokenizer import Tokenizer

from .fixtures import TRAIN_TEXT
from .test_torch_tokenizer import CORPUS

BYTES = [f"<0x{b:02X}>" for b in range(256)]
SP_CORPUS = CORPUS + [
    " leading space", "doubled  spaces  here", "   three", "日本語のテキスト 🎉 ok",
    "mixed 中文 and ascii", "emoji 👍🏽 modifier", "<|user|> hi <tool>x", "a<tool>b <tool> c",
    "▁already marked", "tab\tand\nnewline",
]
_REPLACE = {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}
_LLAMA2_DECODER = {"type": "Sequence", "decoders": [
    _REPLACE, {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
_SPACES = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
LAYOUTS = {
    "llama2": dict(
        normalizer={"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"}, _SPACES]},
        pre_tokenizer=None, decoder=_LLAMA2_DECODER),
    "gemma": dict(
        normalizer=_SPACES, pre_tokenizer=None,
        decoder={"type": "Sequence", "decoders": [
            _REPLACE, {"type": "ByteFallback"}, {"type": "Fuse"}]}),
    "metaspace_first": dict(
        normalizer=None,
        pre_tokenizer={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                       "split": False},
        decoder=_LLAMA2_DECODER),
    "metaspace_split": dict(
        normalizer=None,
        pre_tokenizer={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                       "split": True},
        decoder={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": True}),
}


@pytest.fixture(scope="module")
def sp_spec():
    """A trained SentencePiece-style BPE (the ``llama2`` layout's model
    and added tokens) as a ``tokenizer.json`` dict."""
    from tokenizers import AddedToken, models, pre_tokenizers, trainers
    from tokenizers import Tokenizer as HFTokenizer

    tok = HFTokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    trainer = trainers.BpeTrainer(vocab_size=900, special_tokens=["<unk>", "<s>", "</s>"] + BYTES,
                                  limit_alphabet=60)
    tok.train_from_iterator(TRAIN_TEXT * 3 + CORPUS, trainer)
    spec = json.loads(tok.to_str())
    # Byte tokens live in the model's vocabulary, not among added tokens.
    spec["added_tokens"] = [t for t in spec["added_tokens"] if t["content"] not in BYTES]
    spec["model"]["byte_fallback"] = True
    tok = HFTokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens([AddedToken("<|user|>", normalized=False)])
    tok.add_tokens([AddedToken("<tool>", normalized=True, special=False)])
    return json.loads(tok.to_str())


@pytest.fixture(params=sorted(LAYOUTS))
def pair(request, sp_spec, tmp_path):
    spec = dict(sp_spec, **LAYOUTS[request.param])
    bos = spec["model"]["vocab"]["<s>"]
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [bos], "tokens": ["<s>"]}},
    }
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    (tmp_path / "config.json").write_text(json.dumps({"eos_token_id": 2}))
    return JTokenizer.from_pretrained(str(tmp_path)), Tokenizer.from_pretrained(str(tmp_path))


def test_sp_encode_ids_equal(pair):
    jtok, tok = pair
    fallback = 0
    for text in SP_CORPUS:
        for special in (True, False):
            want = jtok.encode(text, add_special_tokens=special)
            assert tok.encode(text, add_special_tokens=special).ids == want.ids, (text, special)
            fallback += any(t.startswith("<0x") for t in want.tokens)
    assert fallback > 0  # CJK and emoji fell back to bytes


def test_sp_vocab_size_and_eos_equal(pair):
    jtok, tok = pair
    assert tok.vocab_size == jtok.vocab_size
    assert tok.eos_token_ids == jtok.eos_token_ids == [2]


def _random_ids(vocab: int, seed: int, n: int = 200):
    rs = np.random.RandomState(seed)
    return [list(map(int, rs.randint(0, vocab, size=rs.randint(1, 16)))) for _ in range(n)]


def test_sp_decode_text_equal(pair):
    jtok, tok = pair
    seqs = _random_ids(jtok.vocab_size, 0)
    for text in SP_CORPUS:
        ids = jtok.encode(text).ids
        seqs += [ids, ids[1:], ids[:-1], ids[2:-2]]
    n_bytes = 0
    for ids in seqs:
        for skip in (True, False):
            want = jtok.decode(ids, skip_special_tokens=skip)
            assert tok.decode(ids, skip_special_tokens=skip) == want, (ids, skip)
            n_bytes += "�" in want or "<0x" in want  # cut runs (literal without ByteFallback)
    assert n_bytes > 0


def test_sp_decode_stream_pieces_equal(pair):
    """Streaming across byte-fallback runs that make up one character:
    a piece is held until the character is whole."""
    jtok, tok = pair
    seqs = _random_ids(jtok.vocab_size, 1, n=60)
    seqs += [jtok.encode(t, add_special_tokens=False).ids for t in SP_CORPUS]
    held = 0
    for ids in seqs:
        js, ts = jtok.decode_stream(), tok.decode_stream()
        want = [js.step(i) for i in ids]
        assert [ts.step(i) for i in ids] == want, ids
        held += want.count(None)
    assert held > 0
