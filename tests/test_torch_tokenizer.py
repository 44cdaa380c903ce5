"""The port's pure-Python byte-level BPE against the JAX package's
tokenizer (HuggingFace ``tokenizers``), on the CPU.

Two layouts: the fixture's ``ByteLevel(use_regex=True)`` (GPT-2's
pattern) and one trained here with Llama-3's ``Split`` pattern, its
``ByteLevel(use_regex=False)``, ``ignore_merges`` and a BOS template.
Encode ids, decode text and ``DecodeStream`` pieces must be equal,
exactly, on a fixed corpus and on seeded random id sequences (which
split multi-byte characters).
"""

import json
import os

import numpy as np
import pytest

from dynamo_exp_tpu.tokenizer import Tokenizer as JTokenizer
from dynamo_exp_tpu_torch.tokenizer import Tokenizer, translate_pattern

from .fixtures import TRAIN_TEXT

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

CORPUS = [
    "hello world, this is a test",
    "I'm can't we've they'll she'd IT'S DON'T",
    "abc123456789 x 12345 0.5e10",
    "line1\r\nline2\n\n  spaces   here  ",
    "café naïve 日本語 emoji ☃ snowman 🎉👍🏽",
    "<|user|>hi</s><|assistant|>yo <s>",
    "<|eot_id|>hi<|begin_of_text|> there<|eot_id|>",
    "tabs\t\tand\x1cctrl\x0b\x85end",
    "x \x1c!? y\x1f\x1e z",
    "  leading",
    "trailing   ",
    "",
    "Ünïcödé ΑΒΓ абв ١٢٣ ½ ²³ ſtraße",
    "x <tool>  y",
    "?!...\n\n\r\n  -- ==> ",
]


@pytest.fixture(scope="module")
def llama3_dir(tmp_path_factory):
    from tokenizers import (
        AddedToken,
        Regex,
        decoders,
        models,
        pre_tokenizers,
        processors,
        trainers,
    )
    from tokenizers import Tokenizer as HFTokenizer

    tok = HFTokenizer(models.BPE(unk_token=None, ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [
            pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
        ]
    )
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=700,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(TRAIN_TEXT * 3 + CORPUS, trainer)
    tok.add_tokens([AddedToken("<tool>", lstrip=True, rstrip=True, special=False)])
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", 0)]
    )
    path = tmp_path_factory.mktemp("llama3-tok")
    tok.save(str(path / "tokenizer.json"))
    with open(path / "generation_config.json", "w") as f:
        json.dump({"eos_token_id": [1, 2]}, f)
    return str(path)


@pytest.fixture(params=["gpt2_bytelevel", "llama3_split"])
def pair(request, tiny_model_dir, llama3_dir):
    d = tiny_model_dir if request.param == "gpt2_bytelevel" else llama3_dir
    return JTokenizer.from_pretrained(d), Tokenizer.from_pretrained(d)


def test_encode_ids_equal(pair):
    jtok, tok = pair
    for text in CORPUS:
        for special in (True, False):
            want = jtok.encode(text, add_special_tokens=special)
            got = tok.encode(text, add_special_tokens=special)
            assert got.ids == want.ids, (text, special)


def test_vocab_size_and_eos_equal(pair):
    jtok, tok = pair
    assert tok.vocab_size == jtok.vocab_size
    assert tok.eos_token_ids == jtok.eos_token_ids


def _random_ids(vocab: int, seed: int, n: int = 200):
    rs = np.random.RandomState(seed)
    return [list(map(int, rs.randint(0, vocab, size=rs.randint(1, 16)))) for _ in range(n)]


def test_decode_text_equal_on_random_ids(pair):
    jtok, tok = pair
    seqs = _random_ids(jtok.vocab_size, 0)
    # Multi-byte characters split across byte tokens.
    snow = jtok.encode("☃日本🎉", add_special_tokens=False).ids
    seqs += [snow, snow[:-1], snow[1:], [snow[0]] * 3]
    n_replaced = 0
    for ids in seqs:
        for skip in (True, False):
            want = jtok.decode(ids, skip_special_tokens=skip)
            assert tok.decode(ids, skip_special_tokens=skip) == want, (ids, skip)
            n_replaced += "�" in want
    assert n_replaced > 0  # the corpus does split characters


def test_decode_stream_pieces_equal(pair):
    jtok, tok = pair
    for ids in _random_ids(jtok.vocab_size, 1, n=60):
        js, ts = jtok.decode_stream(), tok.decode_stream()
        assert [ts.step(i) for i in ids] == [js.step(i) for i in ids], ids


def test_pattern_translation_reads_unicode_classes():
    import re

    pat = re.compile(translate_pattern(r"\p{L}+|\p{N}+|\s+(?!\S)|[^\s\p{L}\p{N}]+"))
    # U+001C is not White_Space (Python's own \s would take it).
    assert pat.findall("aé日 12٣  \x1c!") == ["aé日", "12٣", " ", "\x1c!"]


@pytest.mark.parametrize(
    "edit,match",
    [
        (lambda d: d["model"].update(type="WordLevel"), "WordLevel"),
        (lambda d: d.update(pre_tokenizer={"type": "Metaspace", "replacement": "▁"}), "Metaspace"),
        (lambda d: d.update(normalizer={"type": "NFKC"}), "NFKC"),
        (lambda d: d.update(decoder={"type": "WordPiece"}), "WordPiece"),
        (lambda d: d.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    ],
)
def test_unsupported_layouts_raise(tiny_model_dir, tmp_path, edit, match):
    with open(os.path.join(tiny_model_dir, "tokenizer.json")) as f:
        spec = json.load(f)
    edit(spec)
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match=match) as err:
        Tokenizer.from_pretrained(str(tmp_path))
    assert "ROADMAP Queue 1 item 9(f)" in str(err.value)


def test_sentencepiece_directory_raises(tmp_path):
    """A ``tokenizer.model`` that is not a SentencePiece model raises
    (the port loads a valid one: ``test_torch_tokenizer_unigram.py``)."""
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="not a sentencepiece model"):
        Tokenizer.from_pretrained(str(tmp_path))
