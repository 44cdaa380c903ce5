"""The port's Unigram model and its three sources against the JAX
package's tokenizers (HuggingFace ``tokenizers``), on the CPU.

Both packages read the same files: a GGUF with an embedded ``llama``
(Unigram) or ``gpt2`` (byte-level BPE) vocabulary written by each
package's ``write_gguf``, a hand-encoded SentencePiece ``tokenizer.model``
(``chip_smoke.sp_model_bytes``, the JAX tests' recipe with the pad id
off), and a
``tokenizer.json`` whose ``model.type`` is ``Unigram``. Encode ids,
decode text and ``DecodeStream`` pieces must be equal, on fixed texts
and on a ``hypothesis`` corpus of vocabularies with score ties and
texts with characters outside the vocabulary and runs of them, with
and without the ``<0xNN>`` pieces of byte fallback. Also: BOS by the
``add_bos_token`` key and its llama.cpp default when absent,
``tokenizer_config.json``'s ``add_bos_token`` in a ``tokenizer.model``
directory, and byte-level ``add_prefix_space``.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke as cs
from dynamo_exp_tpu import sp_model as jsp
from dynamo_exp_tpu.gguf_tokenizer import tokenizer_backend_from_gguf as j_from_gguf
from dynamo_exp_tpu.models.gguf import GGUFFile as JGGUFFile
from dynamo_exp_tpu.models.gguf import write_gguf as j_write_gguf
from dynamo_exp_tpu.tokenizer import Tokenizer as JTokenizer
from dynamo_exp_tpu_torch import sp_model
from dynamo_exp_tpu_torch.gguf_tokenizer import (
    TOKEN_BYTE,
    TOKEN_CONTROL,
    TOKEN_NORMAL,
    TOKEN_UNKNOWN,
    tokenizer_backend_from_gguf,
)
from dynamo_exp_tpu_torch.models.gguf import GGUFFile, write_gguf
from dynamo_exp_tpu_torch.tokenizer import Backend, Tokenizer

from .fixtures import build_tiny_model_dir

BYTES = [f"<0x{b:02X}>" for b in range(256)]
TEXTS = [
    "hello world", "the test", "hello the world test", "", " ", "  doubled  spaces ",
    "hellothe", "wor ld", "日本語 ☃🎉 and ascii", "ααα βββ", "x<s>y</s> z", "<unk> hi",
    "lowlow helo", "tab\tand\nnewline", "▁already marked",
]


def _fixture_pieces():
    """The JAX tests' SP-style vocabulary: specials, words, ASCII."""
    pieces = [("<unk>", 0.0), ("<s>", 0.0), ("</s>", 0.0)]
    words = ["▁hello", "▁world", "▁test", "▁the", "lo", "wor", "ld", "he"]
    pieces += [(w, -float(i + 1)) for i, w in enumerate(words)]
    pieces += [(chr(c), -20.0) for c in range(ord(" "), ord("~") + 1)]
    return pieces


def _llama_md(pieces, types=None, **extra) -> dict:
    md = {
        "general.architecture": "llama",
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": [p for p, _ in pieces],
        "tokenizer.ggml.scores": [float(s) for _, s in pieces],
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }
    if types is not None:
        md["tokenizer.ggml.token_type"] = types
    md.update(extra)
    return md


def _both_from_file(path):
    return j_from_gguf(JGGUFFile.parse(path)), tokenizer_backend_from_gguf(GGUFFile.parse(path))


def _assert_same(jb, tb, texts):
    """ids (with and without specials), decode (both skip modes) and
    DecodeStream pieces equal."""
    jtok, ttok = JTokenizer(jb), Tokenizer(tb)
    for text in texts:
        for add in (True, False):
            want = jb.encode(text, add_special_tokens=add).ids
            assert tb.encode(text, add) == want, (text, add)
        for skip in (True, False):
            assert ttok.decode(want, skip) == jtok.decode(want, skip), (text, want)
        js, ts = jtok.decode_stream(), ttok.decode_stream()
        assert [ts.step(i) for i in want] == [js.step(i) for i in want], (text, want)


# ------------------------------------------------------------ fixed files
@pytest.mark.parametrize("with_bytes", [False, True], ids=["unk", "byte_fallback"])
def test_llama_gguf_unigram_equals_jax(tmp_path, with_bytes):
    pieces = _fixture_pieces() + ([(b, 0.0) for b in BYTES] if with_bytes else [])
    types = [TOKEN_UNKNOWN, TOKEN_CONTROL, TOKEN_CONTROL] + [TOKEN_NORMAL] * (
        len(pieces) - 3 - 256 * with_bytes) + [TOKEN_BYTE] * (256 * with_bytes)
    path = str(tmp_path / "u.gguf")
    write_gguf(path, _llama_md(pieces, types), {})
    jb, tb = _both_from_file(path)
    _assert_same(jb, tb, TEXTS)
    ids = tb.encode("日本語 ☃", False)
    assert (ids.count(0) == 0) == with_bytes  # byte pieces, else one fused unk a run
    # the JAX writer's file reads the same in the port
    jpath = str(tmp_path / "j.gguf")
    j_write_gguf(jpath, _llama_md(pieces, types), {})
    assert GGUFFile.parse(jpath).metadata == JGGUFFile.parse(path).metadata


def test_gpt2_gguf_bpe_equals_jax(tmp_path):
    """The fixture's byte-level BPE written as a ``gpt2`` GGUF vocabulary
    (the JAX tests' recipe): no BOS without the key."""
    model_dir = build_tiny_model_dir(str(tmp_path / "m"))
    with open(os.path.join(model_dir, "tokenizer.json")) as f:
        tj = json.load(f)
    tokens = [t for t, _ in sorted(tj["model"]["vocab"].items(), key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m) for m in tj["model"]["merges"]]
    path = str(tmp_path / "t.gguf")
    write_gguf(path, {
        "general.architecture": "llama", "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.bos_token_id": 0, "tokenizer.ggml.eos_token_id": 1,
    }, {})
    jb, tb = _both_from_file(path)
    _assert_same(jb, tb, TEXTS + ["café naïve emoji ☃ snowman", "<s>hello</s>"])
    assert tb.encode("hello world")[0] != 0


@pytest.mark.parametrize("key", [None, True, False], ids=["absent", "true", "false"])
@pytest.mark.parametrize("model", ["llama", "gpt2"])
def test_add_bos_token_and_its_default(tmp_path, key, model):
    """Without ``add_bos_token`` a ``llama`` vocabulary adds BOS and a
    ``gpt2`` one does not (llama.cpp's default, kept on purpose)."""
    pieces = _fixture_pieces()
    md = _llama_md(pieces)
    if model == "gpt2":
        md["tokenizer.ggml.model"] = "gpt2"
        md["tokenizer.ggml.merges"] = ["h e", "l o"]
        del md["tokenizer.ggml.scores"]
    if key is not None:
        md["tokenizer.ggml.add_bos_token"] = key
    path = str(tmp_path / "b.gguf")
    write_gguf(path, md, {})
    jb, tb = _both_from_file(path)
    want = jb.encode("hello world").ids
    assert tb.encode("hello world") == want
    assert (want[0] == 1) == (key if key is not None else model == "llama")


def test_bos_out_of_range_raises(tmp_path):
    md = _llama_md(_fixture_pieces(), **{"tokenizer.ggml.bos_token_id": 5000})
    with pytest.raises(ValueError, match="out of range"):
        tokenizer_backend_from_gguf(SimpleNamespace(metadata=md))
    with pytest.raises(ValueError, match="no embedded tokenizer"):
        tokenizer_backend_from_gguf(SimpleNamespace(metadata={"general.architecture": "llama"}))


# ------------------------------------------------------------ SentencePiece
def _sp_pieces():
    fx = _fixture_pieces()
    return ([("<unk>", 0.0, jsp.SP_UNKNOWN), ("<s>", 0.0, jsp.SP_CONTROL),
             ("</s>", 0.0, jsp.SP_CONTROL)] + [(p, s, jsp.SP_NORMAL) for p, s in fx[3:]]
            + [(b, 0.0, jsp.SP_BYTE) for b in BYTES[:200]])


def test_sentencepiece_model_equals_jax(tmp_path):
    path = str(tmp_path / "tokenizer.model")
    with open(path, "wb") as f:
        f.write(cs.sp_model_bytes(_sp_pieces()))
    assert sp_model.parse_sentencepiece_model(path) == jsp.parse_sentencepiece_model(path)
    assert sp_model.parse_sentencepiece_model(path)[1] == {"unk": 0, "bos": 1, "eos": 2}
    for add_bos in (True, False):
        _assert_same(jsp.tokenizer_backend_from_sp(path, add_bos=add_bos),
                     sp_model.tokenizer_backend_from_sp(path, add_bos=add_bos), TEXTS)


@pytest.mark.parametrize("add_bos", [None, True, False], ids=["absent", "true", "false"])
def test_tokenizer_model_directory_honours_add_bos_token(tmp_path, add_bos):
    with open(tmp_path / "tokenizer.model", "wb") as f:
        f.write(cs.sp_model_bytes(_sp_pieces()))
    if add_bos is not None:
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"add_bos_token": add_bos}))
    jtok, tok = JTokenizer.from_pretrained(str(tmp_path)), Tokenizer.from_pretrained(
        str(tmp_path))
    ids = tok.encode("hello test").ids
    assert ids == jtok.encode("hello test").ids
    assert (ids[0] == 1) == (add_bos is not False)
    assert tok.decode(ids) == "hello test" and tok.eos_token_ids == jtok.eos_token_ids == [2]


# ------------------------------------------------------------ tokenizer.json
def test_unigram_tokenizer_json_equals_jax(tmp_path):
    """A ``tokenizer.json`` whose model is Unigram (HF's own
    serialisation of the GGUF-built tokenizer) loads in the port."""
    pieces = _fixture_pieces() + [(b, 0.0) for b in BYTES]
    jb = j_from_gguf(SimpleNamespace(metadata=_llama_md(pieces)))
    (tmp_path / "tokenizer.json").write_text(jb.to_str())
    assert json.loads(jb.to_str())["model"]["type"] == "Unigram"
    _assert_same(jb, Tokenizer.from_pretrained(str(tmp_path))._t, TEXTS)


@pytest.mark.parametrize("layout", ["byte_level", "split"])
def test_byte_level_add_prefix_space_equals_jax(tmp_path, layout):
    from tokenizers import Regex
    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers import pre_tokenizers

    model_dir = build_tiny_model_dir(str(tmp_path / "m"))
    hf = HFTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    if layout == "byte_level":
        hf.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    else:
        hf.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(r"\s*[A-Za-z]+|\s*[0-9]+|[^\sA-Za-z0-9]+|\s+"),
                                 "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=False)])
    (tmp_path / "tokenizer.json").write_text(hf.to_str())
    _assert_same(hf, Tokenizer.from_pretrained(str(tmp_path))._t,
                 TEXTS + ["hello world, this is a test", "<|user|>hi<|assistant|>yo"])


# ------------------------------------------------------------ hypothesis
_ALPHA = "ab▁c日"


@st.composite
def _vocab_and_texts(draw):
    """A vocabulary of short pieces over a small alphabet (``日`` and
    the text's ``x``/``é`` are outside it or only reachable by bytes),
    some of its single characters, scores from a few values so that
    paths tie, ``<unk>`` first; with
    or without the byte pieces of byte fallback; texts of the alphabet
    and characters outside it."""
    pieces = draw(st.lists(st.text(_ALPHA, min_size=2, max_size=3), min_size=3, max_size=24,
                           unique=True))
    singles = draw(st.lists(st.sampled_from(_ALPHA), max_size=5, unique=True))
    pieces = ["<unk>"] + singles + pieces
    scores = draw(st.lists(st.sampled_from([-1.0, -2.0, -2.5, -3.0, 0.0]),
                           min_size=len(pieces), max_size=len(pieces)))
    byte_pieces = draw(st.sampled_from([[], BYTES, [f"<0x{b:02X}>" for b in "xé".encode()]]))
    pieces += [b for b in byte_pieces if b not in pieces]
    scores += [draw(st.sampled_from([-1.0, -4.0]))] * (len(pieces) - len(scores))
    texts = draw(st.lists(st.text(_ALPHA + " xé", max_size=14), min_size=1, max_size=4))
    return pieces, scores, texts


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_vocab_and_texts())
def test_unigram_hypothesis_corpus_equals_jax(case):
    pieces, scores, texts = case
    md = _llama_md(list(zip(pieces, scores)), [TOKEN_UNKNOWN] + [TOKEN_NORMAL] * (len(pieces) - 1),
                   **{"tokenizer.ggml.bos_token_id": 0, "tokenizer.ggml.eos_token_id": 0})
    jb = j_from_gguf(SimpleNamespace(metadata=md))
    _assert_same(jb, tokenizer_backend_from_gguf(SimpleNamespace(metadata=md)), texts)
    rs = np.random.RandomState(len(pieces))
    ids = [int(i) for i in rs.randint(0, len(pieces), size=12)]
    assert Tokenizer(tokenizer_backend_from_gguf(SimpleNamespace(metadata=md))).decode(
        ids) == JTokenizer(jb).decode(ids)


def test_unigram_tie_takes_the_earliest_start():
    """Equal totals: the path whose last piece starts earliest wins, as
    HF's lattice keeps the first candidate it meets."""
    spec = {"model": {"type": "Unigram", "unk_id": 0,
                      "vocab": [["<unk>", 0.0], ["a", -1.0], ["b", -1.0], ["ab", -2.0]]},
            "decoder": {"type": "Fuse"}}
    assert Backend(spec).encode("ab") == [3]  # "ab" (starts at 0) ties "a"+"b"
    spec["model"]["vocab"][3][1] = -2.0 + 2.0**-40
    assert Backend(spec).encode("ab") == [3]
    spec["model"]["vocab"][3][1] = -2.0 - 2.0**-40
    assert Backend(spec).encode("ab") == [1, 2]
