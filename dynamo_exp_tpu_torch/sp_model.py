"""SentencePiece ``tokenizer.model`` without the sentencepiece library.

Counterpart of ``dynamo_exp_tpu/sp_model.py``: a model directory that
ships only ``tokenizer.model`` (no ``tokenizer.json``) serves. The file
is a protobuf ``ModelProto``, read here with a minimal wire-format
reader (varints and length-delimited fields are all it needs); its
pieces feed the Unigram spec that ``gguf_tokenizer.py`` builds, since
SentencePiece is the Unigram model.

ModelProto layout (sentencepiece.proto):
  field 1: repeated SentencePiece { 1: piece (string),
                                    2: score (float),
                                    3: type  (enum) }
  field 2: TrainerSpec  { 40: unk_id, 41: bos_id, 42: eos_id, 43: pad_id }
"""

from __future__ import annotations

import struct

# SentencePiece piece types.
SP_NORMAL = 1
SP_UNKNOWN = 2
SP_CONTROL = 3
SP_USER_DEFINED = 4
SP_UNUSED = 5
SP_BYTE = 6

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire in (_WIRE_I64, _WIRE_I32, _WIRE_LEN):
            if wire == _WIRE_LEN:
                size, pos = _read_varint(buf, pos)
            else:
                size = 8 if wire == _WIRE_I64 else 4
            val = buf[pos : pos + size]
            if len(val) != size:
                raise ValueError("truncated protobuf field")
            pos += size
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(path: str):
    """``(pieces, special_ids)`` of a ``tokenizer.model``: ``pieces`` is
    ``[(piece, score, type), ...]`` in id order; ``special_ids`` maps
    ``"unk"`` / ``"bos"`` / ``"eos"`` / ``"pad"`` to the ids the
    TrainerSpec sets (a negative id, which turns one off, is left out)."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: list[tuple[str, float, int]] = []
    special_ids: dict[str, int] = {}
    try:
        for field, wire, val in _fields(buf):
            if field == 1 and wire == _WIRE_LEN:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, SP_NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1 and w2 == _WIRE_LEN:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == _WIRE_I32:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == _WIRE_VARINT:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wire == _WIRE_LEN:  # TrainerSpec
                ids = {40: "unk", 41: "bos", 42: "eos", 43: "pad"}
                for f2, w2, v2 in _fields(val):
                    # A negative id is a varint of 2^64 - |x|: off.
                    if f2 in ids and w2 == _WIRE_VARINT and v2 < 1 << 31:
                        special_ids[ids[f2]] = v2
    except ValueError as e:
        raise ValueError(f"{path}: not a sentencepiece model ({e})") from None
    if not pieces:
        raise ValueError(f"{path} contains no sentencepiece pieces")
    return pieces, special_ids


def tokenizer_backend_from_sp(path: str, add_bos: bool = True):
    """The Unigram :class:`~dynamo_exp_tpu_torch.tokenizer.Backend` of a
    ``tokenizer.model``: CONTROL and UNKNOWN pieces special, BOS put in
    front with ``add_bos`` when the TrainerSpec has one."""
    from .gguf_tokenizer import _build_unigram, add_special_tokens, bos_template
    from .tokenizer import Backend

    pieces, special_ids = parse_sentencepiece_model(path)
    tokens = [p for p, _, _ in pieces]
    unk_id = special_ids.get("unk")
    if unk_id is None:
        unk = [i for i, (_, _, t) in enumerate(pieces) if t == SP_UNKNOWN]
        unk_id = unk[0] if unk else 0
    spec = _build_unigram(tokens, [s for _, s, _ in pieces], unk_id)
    add_special_tokens(spec, tokens,
                       [i for i, (_, _, t) in enumerate(pieces) if t in (SP_CONTROL, SP_UNKNOWN)])
    bos_id = special_ids.get("bos")
    if add_bos and bos_id is not None:
        spec["post_processor"] = bos_template(tokens[bos_id], bos_id)
    return Backend(spec)
