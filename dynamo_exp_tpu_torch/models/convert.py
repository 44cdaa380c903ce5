"""Weights from the JAX package's parameter layout.

``params_from_jax`` takes the JAX package's parameter pytree as numpy
arrays — stacked ``[L, ...]`` layer weights in ``x @ W`` layout — and
returns the port's :class:`~.llama.Llama` with ``[out, in]`` weights, so
both packages compute the same logits from the same weights. With
``tp > 1`` it returns rank ``rank``'s shard: the part of each weight
the JAX package's ``param_shardings`` puts on that rank of a tp mesh.
It reads plain numpy only; the port never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .llama import Llama, model_dtype, tp_slice

# JAX layer key -> transpose? (matrices are [in, out] there; a stacked
# expert weight [E, in, out] swaps its last two dims the same way, and
# the router [D, E] becomes [E, D])
_LAYER_KEYS = {
    "attn_norm": False,
    "wq": True,
    "wk": True,
    "wv": True,
    "wo": True,
    "mlp_norm": False,
    "w_gate": True,
    "w_up": True,
    "w_down": True,
    "bq": False,
    "bk": False,
    "bv": False,
    "q_norm": False,
    "k_norm": False,
    "post_attn_norm": False,
    "post_ffn_norm": False,
    "router": True,
    "shared_gate": True,
    "shared_up": True,
    "shared_down": True,
    "shared_router": False,
}


def _tensor(a, dtype: torch.dtype, device, transpose: bool, name: str = "",
            rank: int = 0, tp: int = 1) -> torch.Tensor:
    # bfloat16 arrays (ml_dtypes) widen to float32 exactly on the way in.
    t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    if transpose:
        t = t.transpose(-1, -2)
    return tp_slice(t, name, rank, tp).to(device=device, dtype=dtype).contiguous()


@torch.no_grad()
def params_from_jax(
    np_params: dict, cfg: ModelConfig, device="cuda", rank: int = 0, tp: int = 1
) -> Llama:
    """The port's model (rank ``rank``'s shard of it at ``tp > 1``) from
    the JAX package's parameters (numpy)."""
    dt = model_dtype(cfg)
    model = Llama(cfg, device=device, tp=tp, rank=rank)
    shard = {"rank": rank, "tp": tp}
    model.embed.copy_(_tensor(np_params["embed"], dt, device, False, "embed", **shard))
    model.final_norm.copy_(_tensor(np_params["final_norm"], dt, device, False))
    if model.lm_head is not None:
        model.lm_head.copy_(_tensor(np_params["lm_head"], dt, device, True, "lm_head", **shard))
    layers = np_params["layers"]
    unknown = set(layers) - set(_LAYER_KEYS)
    if unknown:
        raise NotImplementedError(f"layer weights not ported: {sorted(unknown)}")
    for name, transpose in _LAYER_KEYS.items():
        stacked = layers.get(name)
        if stacked is None:
            continue
        for li, layer in enumerate(model.layers):
            dst = getattr(layer, name)
            if dst is None:
                raise ValueError(f"{name} given but {cfg.model_type} has no such weight")
            dst.copy_(_tensor(stacked[li], dt, device, transpose, name, **shard))
    return model
