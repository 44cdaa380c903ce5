"""Weights from the JAX package's parameter layout.

``params_from_jax`` takes the JAX package's parameter pytree as numpy
arrays — stacked ``[L, ...]`` layer weights in ``x @ W`` layout — and
returns the port's :class:`~.llama.Llama` with ``[out, in]`` weights, so
both packages compute the same logits from the same weights. With
``tp > 1`` it returns rank ``rank``'s shard: the part of each weight
the JAX package's ``param_shardings`` puts on that rank of a tp mesh.
``vision_from_jax`` does the same for the vision tower
(``models/vision.py``): the JAX package's flattened-patch matrix
becomes the patch convolution's weight, and every ``x @ W`` matrix
becomes ``[out, in]``. It reads plain numpy only; the port never
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .llama import Llama, model_dtype, tp_slice
from .vision import VisionConfig, VisionTower

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


# JAX vision layer key -> transpose? (the stacked [L, in, out] matrices)
_VISION_LAYER_KEYS = {
    "ln1": False, "ln1_b": False, "ln2": False, "ln2_b": False,
    "wq": True, "wq_b": False, "wk": True, "wk_b": False,
    "wv": True, "wv_b": False, "wo": True, "wo_b": False,
    "w1": True, "w1_b": False, "w2": True, "w2_b": False,
}


@torch.no_grad()
def vision_from_jax(np_params: dict, cfg: VisionConfig, device="cuda",
                    dtype=torch.float32) -> VisionTower:
    """The port's vision tower (and projector, where ``np_params`` has
    one) from the JAX package's vision parameters (numpy)."""
    tower = VisionTower(cfg, device=device, dtype=dtype)
    p, c, h = cfg.patch_size, cfg.num_channels, cfg.hidden_size
    # [(p*p*C), h] in (row, col, channel) patch order -> conv [h, C, p, p].
    patch = np.asarray(np_params["patch_embed"], np.float32).reshape(p, p, c, h)
    tower.patch_embed.copy_(_tensor(patch.transpose(3, 2, 0, 1), dtype, device, False))
    for name in ("cls_embed", "pos_embed", "pre_ln", "pre_ln_b", "post_ln", "post_ln_b"):
        getattr(tower, name).copy_(_tensor(np_params[name], dtype, device, False))
    for name, transpose in _VISION_LAYER_KEYS.items():
        for li, layer in enumerate(tower.layers):
            getattr(layer, name).copy_(_tensor(np_params[name][li], dtype, device, transpose))
    if "proj1" in np_params:
        if tower.proj1 is None:
            tower._alloc_projector(np.shape(np_params["proj1"])[1])
        for name, transpose in (("proj1", True), ("proj1_b", False), ("proj2", True),
                                ("proj2_b", False)):
            getattr(tower, name).copy_(_tensor(np_params[name], dtype, device, transpose))
    return tower
