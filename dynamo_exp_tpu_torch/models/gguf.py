"""GGUF checkpoints: parse, map to ``ModelConfig``, load into ``Llama``.

Counterpart of ``dynamo_exp_tpu/models/gguf.py``: a reader of the public
GGUF v2/v3 container (header, typed metadata, tensor index, aligned data
section), written with the standard library and numpy. The file is
mapped read-only; tensors decode one at a time.

Tensor encodings: F32, F16, BF16 and Q8_0 (blocks of 34 bytes: an f16
scale, then 32 int8 values), each decoded to float32 as the JAX reader
decodes it. Any other encoding raises, naming the tensor.

:func:`load_params_from_gguf` fills the port's :class:`~.llama.Llama`
one tensor at a time, as ``models/loader.load_params`` does for
safetensors, so only one dequantized tensor is ever on the host (the JAX
package builds its whole stacked float32 tree there). GGUF keeps HF's
``[out, in]`` layout, which is the port's, so nothing is transposed; a
llama-architecture file's q/k rows are un-permuted from llama.cpp's rope
order. Mixtral ships under the llama architecture with stacked
``ffn_{gate,up,down}_exps`` tensors, which are the port's ``[E, ...]``
expert weights as they stand.

:func:`write_gguf` writes F32 tensors (the tests' files) and tensors
already encoded by the caller (:class:`Encoded`).
"""

from __future__ import annotations

import mmap
import struct
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .config import ModelConfig
from .llama import Llama, model_dtype, tp_full_shape, tp_slice
from .loader import check_loadable

MAGIC = b"GGUF"
DEFAULT_ALIGNMENT = 32

# Metadata value types (GGUF spec).
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL = range(8)
T_STRING, T_ARRAY, T_U64, T_I64, T_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
    T_I64: "<q", T_F64: "<d",
}

# ggml tensor encodings this reader decodes.
GGML_F32, GGML_F16, GGML_Q8_0, GGML_BF16 = 0, 1, 8, 30
_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q8_0: "Q8_0", GGML_BF16: "BF16"}
Q8_0_BLOCK = 32  # values a block; 2 + 32 bytes


@dataclass
class TensorInfo:
    name: str
    dims: tuple[int, ...]  # ne order: fastest-varying first
    ggml_type: int
    offset: int  # relative to the data section

    @property
    def shape(self) -> tuple[int, ...]:
        """Row-major shape: the GGUF dims reversed."""
        return tuple(reversed(self.dims))

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated GGUF file")
        self.pos += n
        return b

    def scalar(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self) -> str:
        return self.take(self.scalar("<Q")).decode("utf-8")

    def value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == T_BOOL:
            return bool(self.scalar("<B"))
        if vtype == T_STRING:
            return self.string()
        if vtype == T_ARRAY:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            return [self.value(etype) for _ in range(count)]
        raise ValueError(f"unknown GGUF metadata type {vtype}")


class GGUFFile:
    """A parsed GGUF: ``metadata`` and the tensor index, tensors decoded
    on demand from the mapped file."""

    def __init__(self, metadata: dict, tensors: dict[str, TensorInfo], data, alignment: int):
        self.metadata = metadata
        self.tensors = tensors
        self._data = data
        self.alignment = alignment

    @classmethod
    def parse(cls, path: str) -> "GGUFFile":
        # mmap, not read(): pages fault in on demand and stay evictable.
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        r = _Reader(buf)
        if r.take(4) != MAGIC:
            raise ValueError(f"{path} is not a GGUF file")
        version = r.scalar("<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = r.scalar("<Q")
        n_kv = r.scalar("<Q")
        metadata = {}
        for _ in range(n_kv):
            key = r.string()
            metadata[key] = r.value(r.scalar("<I"))
        tensors: dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = r.string()
            dims = tuple(r.scalar("<Q") for _ in range(r.scalar("<I")))
            ggml_type = r.scalar("<I")
            tensors[name] = TensorInfo(name, dims, ggml_type, r.scalar("<Q"))
        align = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        data_start = (r.pos + align - 1) // align * align
        return cls(metadata, tensors, memoryview(buf)[data_start:], align)

    def tensor(self, name: str) -> np.ndarray:
        """One tensor decoded to float32, in its row-major shape (a view
        of the mapping for F32)."""
        info = self.tensors.get(name)
        if info is None:
            raise KeyError(f"GGUF tensor {name!r} not present")
        n, off, t = info.n_elements, info.offset, info.ggml_type
        if t == GGML_F32:
            return np.frombuffer(self._data, np.float32, n, off).reshape(info.shape)
        if t == GGML_F16:
            raw = np.frombuffer(self._data, np.float16, n, off)
            return raw.astype(np.float32).reshape(info.shape)
        if t == GGML_BF16:
            raw = np.frombuffer(self._data, np.uint16, n, off)
            return (raw.astype(np.uint32) << 16).view(np.float32).reshape(info.shape)
        if t == GGML_Q8_0:
            n_blocks = n // Q8_0_BLOCK
            blocks = np.frombuffer(self._data, np.uint8, n_blocks * 34, off).reshape(n_blocks, 34)
            scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
            qs = blocks[:, 2:].view(np.int8).astype(np.float32)
            return (qs * scales).reshape(info.shape)
        raise ValueError(
            f"tensor {name!r}: unsupported GGUF encoding {_TYPE_NAMES.get(t, t)} "
            "(supported: F32/F16/BF16/Q8_0)"
        )


# ------------------------------------------------------------------ mapping
def config_from_gguf(g: GGUFFile) -> ModelConfig:
    """The file's ``<arch>.*`` metadata as a ``ModelConfig`` (llama,
    qwen2, qwen3): qwen2's QKV bias and qwen3's q/k norms are read from
    the tensors, qwen3's head dim from ``attention.key_length``, and a
    llama-architecture file with ``expert_count`` is a mixtral."""
    md = g.metadata
    a = md.get("general.architecture", "llama")
    if a not in ("llama", "qwen2", "qwen3"):
        raise ValueError(f"unsupported GGUF architecture {a!r}")
    vocab = md.get(f"{a}.vocab_size")
    if vocab is None:
        tokens = md.get("tokenizer.ggml.tokens")
        vocab = len(tokens) if tokens else 32000
    heads = md[f"{a}.attention.head_count"]
    if f"{a}.attention.key_length" in md:
        head_dim = int(md[f"{a}.attention.key_length"])
    elif f"{a}.rope.dimension_count" in md:
        head_dim = int(md[f"{a}.rope.dimension_count"])
    else:
        head_dim = None
    return ModelConfig(
        vocab_size=int(vocab),
        hidden_size=int(md[f"{a}.embedding_length"]),
        intermediate_size=int(md[f"{a}.feed_forward_length"]),
        num_layers=int(md[f"{a}.block_count"]),
        num_experts=int(md.get(f"{a}.expert_count", 0) or 0),
        num_experts_per_tok=int(md.get(f"{a}.expert_used_count", 2) or 2),
        num_heads=int(heads),
        num_kv_heads=int(md.get(f"{a}.attention.head_count_kv", heads)),
        head_dim=head_dim,
        rope_theta=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_norm_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(md.get(f"{a}.context_length", 4096)),
        tie_word_embeddings="output.weight" not in g.tensors,
        attention_bias="blk.0.attn_q.bias" in g.tensors,
        qk_norm="blk.0.attn_q_norm.weight" in g.tensors,
        model_type=a,
    )


def _unpermute_rope(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Invert llama.cpp's q/k permutation: GGUF stores
    ``w.reshape(H, 2, hd // 2, in).swapaxes(1, 2)`` of the HF weight."""
    out, inner = w.shape
    hd = out // n_heads
    return w.reshape(n_heads, hd // 2, 2, inner).transpose(1, 2).reshape(out, inner)


def gguf_tensor_names(cfg: ModelConfig) -> dict[str, tuple[int | None, str]]:
    """GGUF tensor name -> (layer index or None, the port's attribute)."""
    out: dict[str, tuple[int | None, str]] = {
        "token_embd.weight": (None, "embed"),
        "output_norm.weight": (None, "final_norm"),
    }
    if not cfg.tie_word_embeddings:
        out["output.weight"] = (None, "lm_head")
    per_layer = {
        "attn_norm.weight": "attn_norm",
        "attn_q.weight": "wq",
        "attn_k.weight": "wk",
        "attn_v.weight": "wv",
        "attn_output.weight": "wo",
        "ffn_norm.weight": "mlp_norm",
    }
    if cfg.attention_bias:
        per_layer.update({"attn_q.bias": "bq", "attn_k.bias": "bk", "attn_v.bias": "bv"})
    if cfg.qk_norm:
        per_layer.update({"attn_q_norm.weight": "q_norm", "attn_k_norm.weight": "k_norm"})
    suffix = "_exps" if cfg.is_moe else ""
    per_layer.update({f"ffn_gate{suffix}.weight": "w_gate", f"ffn_up{suffix}.weight": "w_up",
                      f"ffn_down{suffix}.weight": "w_down"})
    if cfg.is_moe:
        per_layer["ffn_gate_inp.weight"] = "router"
    for i in range(cfg.num_layers):
        for name, attr in per_layer.items():
            out[f"blk.{i}.{name}"] = (i, attr)
    return out


@torch.no_grad()
def load_params_from_gguf(
    path: str, cfg: ModelConfig | None = None, gguf: GGUFFile | None = None, device="cuda",
    rank: int = 0, tp: int = 1,
) -> tuple[Llama, ModelConfig]:
    """The model of a GGUF file on ``device`` in the config's dtype,
    filled one decoded tensor at a time; with ``tp > 1``, rank
    ``rank``'s shard, sliced from each decoded tensor. Pass an already
    parsed ``GGUFFile`` as ``gguf`` to read the metadata once."""
    g = gguf if gguf is not None else GGUFFile.parse(path)
    if cfg is None:
        cfg = config_from_gguf(g)
    check_loadable(cfg)
    # llama.cpp permutes q/k only for the llama architecture (qwen's rope
    # is NEOX-style); keyed on the file's architecture, as mixtral ships
    # under llama.
    permuted = g.metadata.get("general.architecture", "llama") == "llama"
    heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}
    model = Llama(cfg, device=device, tp=tp, rank=rank)
    dt = model_dtype(cfg)
    for name, (li, attr) in gguf_tensor_names(cfg).items():
        if name not in g.tensors:
            raise KeyError(f"{path}: GGUF has no tensor {name!r}")
        dst = getattr(model if li is None else model.layers[li], attr)
        with warnings.catch_warnings():
            # An F32 tensor is a read-only view of the mapping, only ever read.
            warnings.filterwarnings("ignore", message=".*not writable.*")
            src = torch.from_numpy(g.tensor(name))
        full = tp_full_shape(dst.shape, attr, tp)
        if list(src.shape) != full:
            raise ValueError(
                f"{path}: tensor {name!r} has shape {list(src.shape)}, the model wants "
                f"{full}"
            )
        if permuted and attr in heads:
            src = _unpermute_rope(src, heads[attr])
        dst.copy_(tp_slice(src, attr, rank, tp).to(dt))
    return model, cfg


# ------------------------------------------------------------------- writer
@dataclass
class Encoded:
    """A tensor the caller has already encoded: its ggml type, its
    row-major shape and its raw bytes."""

    ggml_type: int
    shape: tuple[int, ...]
    data: bytes | np.ndarray


def _pstr(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pval(v) -> bytes:
    if isinstance(v, bool):
        return struct.pack("<IB", T_BOOL, int(v))
    if isinstance(v, int):
        return struct.pack("<Iq", T_I64, v)
    if isinstance(v, float):
        return struct.pack("<If", T_F32, v)
    if isinstance(v, str):
        return struct.pack("<I", T_STRING) + _pstr(v)
    if isinstance(v, list):
        if v and isinstance(v[0], str):
            body, etype = b"".join(_pstr(x) for x in v), T_STRING
        elif v and any(isinstance(x, (float, np.floating)) for x in v):
            # Any float makes a float array, or scores such as [0, -1.5]
            # would truncate to integers.
            body, etype = np.asarray(v, "<f4").tobytes(), T_F32
        else:
            body, etype = np.asarray(v, "<i8").tobytes(), T_I64
        return struct.pack("<IIQ", T_ARRAY, etype, len(v)) + body
    raise TypeError(f"unsupported metadata value {v!r}")


def write_gguf(
    path: str, metadata: dict, tensors: dict, alignment: int = DEFAULT_ALIGNMENT
) -> None:
    """A GGUF v3 file: ``metadata`` typed as the JAX writer types it
    (ints I64, floats F32), each tensor a row-major numpy array written
    as F32 or an :class:`Encoded` written as it is. Dims are written
    reversed, per the spec."""
    head = bytearray(MAGIC + struct.pack("<IQQ", 3, len(tensors), len(metadata)))
    for k, v in metadata.items():
        head += _pstr(k) + _pval(v)
    blobs = []
    offset = 0
    for name, t in tensors.items():
        if not isinstance(t, Encoded):
            arr = np.ascontiguousarray(t, np.float32)
            t = Encoded(GGML_F32, arr.shape, arr)
        dims = tuple(reversed(t.shape))
        head += _pstr(name) + struct.pack("<I", len(dims))
        head += b"".join(struct.pack("<Q", d) for d in dims)
        head += struct.pack("<IQ", t.ggml_type, offset)
        data = np.ascontiguousarray(t.data) if isinstance(t.data, np.ndarray) else t.data
        blob = memoryview(data).cast("B")
        pad = (-len(blob)) % alignment
        blobs.append((blob, pad))
        offset += len(blob) + pad
    head += b"\0" * ((-len(head)) % alignment)
    with open(path, "wb") as f:
        f.write(head)
        for blob, pad in blobs:
            f.write(blob)
            f.write(b"\0" * pad)
