"""Load HF safetensors checkpoints into the port's :class:`~.llama.Llama`.

Counterpart of ``dynamo_exp_tpu/models/loader.py``. The JAX package
reads checkpoints through the ``safetensors`` package; the machine with
the card has none, so the format is read here with the standard library
and numpy: each file is a little-endian u64 header length, a JSON header
(``{name: {"dtype", "shape", "data_offsets"}}`` and an optional
``__metadata__``), then the raw little-endian tensor bytes. Every file is
mapped read-only with ``np.memmap`` and each tensor is a view of the
mapping; tensors are copied one by one onto the device in the model's
dtype, so no second host copy of the model is ever held. ``BF16`` is
read as 16-bit integers and viewed as ``torch.bfloat16`` (bit-exact);
``F16`` and ``F32`` are read as they are.

HF stores every linear weight ``[out, in]``, which is already the port's
layout (``F.linear``). Unlike the JAX loader (``loader.py:69-71``, which
transposes to ``x @ W``), nothing here is transposed. The tensor names
are the JAX loader's: gemma2 and gemma3 carry four norms a layer
(``post_attention_layernorm`` norms the attention's output there, and
``pre_feedforward_layernorm`` is the FFN's input norm), gemma3 the q/k
norms of qwen3, and phi3 packs q, k and v into ``qkv_proj`` and gate and
up into ``gate_up_proj``, which are split by rows on the way in.
"""

from __future__ import annotations

import json
import os
import struct
import warnings

import numpy as np
import torch

from .config import ModelConfig
from .llama import Llama, check_supported, model_dtype

_ITEM = "ROADMAP Queue 1 item"
# model_type -> why the port cannot serve it yet (the JAX package's
# SUPPORTED_MODEL_TYPES beyond the dense families).
UNSUPPORTED_MODEL_TYPES = {
    "mixtral": f"{_ITEM} 7 (MoE)",
    "qwen2_moe": f"{_ITEM} 7 (MoE)",
    "qwen3_moe": f"{_ITEM} 7 (MoE)",
}
SUPPORTED_MODEL_TYPES = (
    "llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2", "gemma3_text", "phi3",
)

# safetensors dtype -> (numpy type the bytes are read as, torch type).
_DTYPES = {
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped read-only; its header checked
    against the file when opened."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} overruns the file ({size} bytes)")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ValueError(f"{path}: header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        header.pop("__metadata__", None)
        self._base = 8 + n
        data_len = size - self._base
        self.tensors: dict[str, tuple[str, tuple[int, ...], int]] = {}
        for name, info in header.items():
            try:
                dtype, shape = info["dtype"], tuple(int(d) for d in info["shape"])
                begin, end = (int(o) for o in info["data_offsets"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"{path}: tensor {name!r}: malformed entry {info!r}") from None
            if dtype not in _DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r}: dtype {dtype} is not supported "
                    f"({', '.join(_DTYPES)})"
                )
            if not 0 <= begin <= end <= data_len:
                raise ValueError(
                    f"{path}: tensor {name!r}: data_offsets [{begin}, {end}] overrun the "
                    f"file's {data_len} data bytes"
                )
            itemsize = np.dtype(_DTYPES[dtype][0]).itemsize
            if any(d < 0 for d in shape) or int(np.prod(shape)) * itemsize != end - begin:
                raise ValueError(
                    f"{path}: tensor {name!r}: shape {list(shape)} x {itemsize} bytes != "
                    f"its span of {end - begin} bytes"
                )
            self.tensors[name] = (dtype, shape, begin)
        self._map = np.memmap(path, dtype=np.uint8, mode="r") if data_len else None

    def get(self, name: str) -> torch.Tensor:
        """The tensor on the host: a view of the mapping, not a copy."""
        dtype, shape, begin = self.tensors[name]
        np_type, torch_type = _DTYPES[dtype]
        count = int(np.prod(shape))
        arr = np.frombuffer(self._map, dtype=np_type, count=count, offset=self._base + begin)
        with warnings.catch_warnings():
            # The mapping is read-only and the view is only ever read.
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(arr)
        return t.view(torch_type).reshape(shape)

    def close(self) -> None:
        self._map = None


def _open_safetensors(path: str) -> tuple[list[SafetensorsFile], dict[str, int]]:
    """Every ``*.safetensors`` in ``path``, sorted, and the index of the
    file holding each tensor name."""
    names = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no .safetensors under {path}")
    files = [SafetensorsFile(os.path.join(path, f)) for f in names]
    index: dict[str, int] = {}
    for i, sf in enumerate(files):
        for name in sf.tensors:
            if name in index:
                raise ValueError(f"tensor {name!r} is in both {files[index[name]].path} and {sf.path}")
            index[name] = i
    return files, index


def check_loadable(cfg: ModelConfig) -> None:
    """Raise for a model type the port cannot serve, naming its ROADMAP
    item."""
    if cfg.model_type in UNSUPPORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported to dynamo_exp_tpu_torch yet; "
            f"see {UNSUPPORTED_MODEL_TYPES[cfg.model_type]}"
        )
    if cfg.model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"unsupported model_type {cfg.model_type!r}; supported: {SUPPORTED_MODEL_TYPES}"
        )
    check_supported(cfg)


def hf_tensor_names(cfg: ModelConfig) -> dict[str, tuple[int | None, str | tuple[str, ...]]]:
    """HF tensor name -> (layer index or None, the port's attribute), or,
    for a packed tensor (phi3), the attributes it stacks by rows, in
    order (:func:`model_tensor` gives the stacked tensor)."""
    out: dict[str, tuple[int | None, str | tuple[str, ...]]] = {
        "model.embed_tokens.weight": (None, "embed"),
        "model.norm.weight": (None, "final_norm"),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = (None, "lm_head")
    per_layer: dict[str, str | tuple[str, ...]] = {
        "input_layernorm.weight": "attn_norm",
        "self_attn.q_proj.weight": "wq",
        "self_attn.k_proj.weight": "wk",
        "self_attn.v_proj.weight": "wv",
        "self_attn.o_proj.weight": "wo",
        "post_attention_layernorm.weight": "mlp_norm",
        "mlp.gate_proj.weight": "w_gate",
        "mlp.up_proj.weight": "w_up",
        "mlp.down_proj.weight": "w_down",
    }
    if cfg.post_norms:  # gemma2/3: the attention's and the FFN's outputs normed too
        per_layer.update({
            "post_attention_layernorm.weight": "post_attn_norm",
            "pre_feedforward_layernorm.weight": "mlp_norm",
            "post_feedforward_layernorm.weight": "post_ffn_norm",
        })
    if cfg.model_type == "phi3":  # [(H + 2 Hkv) hd, D] and [2 I, D]
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "mlp.gate_proj", "mlp.up_proj"):
            del per_layer[f"{name}.weight"]
        per_layer["self_attn.qkv_proj.weight"] = ("wq", "wk", "wv")
        per_layer["mlp.gate_up_proj.weight"] = ("w_gate", "w_up")
    if cfg.attention_bias:  # qwen2: bias on q/k/v, none on o
        per_layer.update({
            "self_attn.q_proj.bias": "bq",
            "self_attn.k_proj.bias": "bk",
            "self_attn.v_proj.bias": "bv",
        })
    if cfg.qk_norm:  # qwen3, gemma3: per-head q/k RMSNorm
        per_layer.update({"self_attn.q_norm.weight": "q_norm", "self_attn.k_norm.weight": "k_norm"})
    for i in range(cfg.num_layers):
        for hf, attr in per_layer.items():
            out[f"model.layers.{i}.{hf}"] = (i, attr)
    return out


def model_tensor(model: Llama, li: int | None, attr: str | tuple[str, ...]) -> torch.Tensor:
    """The tensor a checkpoint holds for one :func:`hf_tensor_names`
    entry: the attribute, or the packed attributes stacked by rows."""
    owner = model if li is None else model.layers[li]
    if isinstance(attr, str):
        return getattr(owner, attr)
    return torch.cat([getattr(owner, a) for a in attr])


@torch.no_grad()
def load_params(
    path: str, cfg: ModelConfig | None = None, device="cuda"
) -> tuple[Llama, ModelConfig]:
    """The model of an HF checkpoint directory (``config.json`` and
    ``*.safetensors``) on ``device``, in the config's dtype. Every
    tensor the model needs must be there with the model's shape;
    tensors it does not need (``rotary_emb.inv_freq``, a tied
    ``lm_head``) are skipped, as in the JAX loader."""
    if cfg is None:
        cfg = ModelConfig.from_pretrained(path)
    check_loadable(cfg)
    files, index = _open_safetensors(path)
    try:
        model = Llama(cfg, device=device)
        dt = model_dtype(cfg)
        for name, (li, attr) in hf_tensor_names(cfg).items():
            if name not in index:
                raise KeyError(f"{path}: checkpoint has no tensor {name!r}")
            src = files[index[name]].get(name)
            owner = model if li is None else model.layers[li]
            dsts = [getattr(owner, a) for a in ((attr,) if isinstance(attr, str) else attr)]
            want = [sum(d.shape[0] for d in dsts), *dsts[0].shape[1:]]
            if list(src.shape) != want:
                raise ValueError(
                    f"{files[index[name]].path}: tensor {name!r} has shape "
                    f"{list(src.shape)}, the model wants {want}"
                )
            row = 0
            for dst in dsts:  # a packed tensor's parts, by rows
                part = src[row : row + dst.shape[0]]
                dst.copy_(part if part.dtype == dt else part.to(dt))
                row += dst.shape[0]
    finally:
        for sf in files:
            sf.close()
    return model, cfg


def save_safetensors(path: str, tensors: dict[str, torch.Tensor], metadata=None) -> None:
    """Write ``tensors`` (``bfloat16`` / ``float16`` / ``float32``) as
    one safetensors file: the header padded with spaces to 8 bytes, the
    tensors packed without gaps, wider types first so every tensor is
    aligned to its item size (the layout of the ``safetensors``
    package's writer). Tensors are copied to the host one at a time.
    The writer the tests and ``chip_smoke.py`` make checkpoints with."""
    codes = {v[1]: k for k, v in _DTYPES.items()}
    order = sorted(tensors, key=lambda k: -tensors[k].element_size())
    header: dict = {"__metadata__": {str(k): str(v) for k, v in (metadata or {}).items()}}
    off = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-(8 + len(head)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            f.write(raw.numpy().tobytes())
