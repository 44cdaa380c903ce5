"""CLIP-style vision tower in PyTorch: the multimodal encode path.

Counterpart of ``dynamo_exp_tpu/models/vision.py``. The ViT is an
``nn.Module``: a patch convolution (stride = kernel = patch), [CLS] and
position embeddings, a pre-LN, then pre-LN encoder blocks with
``quick_gelu`` (a Python loop over ``tower.layers`` where JAX scans).
Real HF ``CLIPVisionModel`` safetensors load directly, through the
port's own reader (``models/loader.py``): the tensor names transformers
writes, with linear weights ``[out, in]`` as HF stores them (the JAX
loader transposes them to ``x @ W``; ``models/convert.py``
``vision_from_jax`` carries the JAX layout over).

The output seam matches LLaVA: ``last_hidden_state`` (no post-LN, as
HF returns it) or the layer ``feature_layer`` names, patch features
selected by dropping [CLS], then the two-layer ``multi_modal_projector``
maps them to the LM hidden size, consumed as soft tokens through
``llama.forward_ragged(token_embeds=...)``. The tower's attention and
products are plain torch ops (XLA in JAX, not Pallas).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # Projector to the LM hidden size (LLaVA multi_modal_projector);
    # None = tower only.
    projector_dim: int | None = None
    # Which encoder layer feeds the projector: -1 = final, -2 = the HF
    # LLaVA default (vision_feature_layer, the penultimate layer).
    feature_layer: int = -1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf_config(cls, cfg: dict) -> "VisionConfig":
        """Accepts a CLIPVisionConfig dict, or a full multimodal
        config.json carrying ``vision_config`` (LLaVA-style)."""
        projector_dim = None
        feature_layer = -1
        if "vision_config" in cfg:
            projector_dim = (
                cfg.get("text_config", {}).get("hidden_size")
                or cfg.get("hidden_size")
            )
            feature_layer = cfg.get("vision_feature_layer", -2)
            cfg = cfg["vision_config"]
        return cls(
            hidden_size=cfg.get("hidden_size", 768),
            intermediate_size=cfg.get("intermediate_size", 3072),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            image_size=cfg.get("image_size", 224),
            patch_size=cfg.get("patch_size", 32),
            num_channels=cfg.get("num_channels", 3),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            hidden_act=cfg.get("hidden_act", "quick_gelu"),
            projector_dim=projector_dim,
            feature_layer=feature_layer,
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "VisionConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


# CLIP ViT-L/14 at 336 pixels: LLaVA-1.5's tower, its vision_feature_layer
# -2 and a projector into a 4096-wide LM.
CLIP_VIT_L_336 = VisionConfig(
    hidden_size=1024, intermediate_size=4096, num_layers=24, num_heads=16,
    image_size=336, patch_size=14, projector_dim=4096, feature_layer=-2,
)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class VisionLayer(nn.Module):
    """One pre-LN encoder block; linear weights are [out, in]."""

    def __init__(self, cfg: VisionConfig, dtype, device):
        super().__init__()
        h, ffn = cfg.hidden_size, cfg.intermediate_size
        for name, shape in (
            ("ln1", (h,)), ("ln1_b", (h,)), ("ln2", (h,)), ("ln2_b", (h,)),
            ("wq", (h, h)), ("wq_b", (h,)), ("wk", (h, h)), ("wk_b", (h,)),
            ("wv", (h, h)), ("wv_b", (h,)), ("wo", (h, h)), ("wo_b", (h,)),
            ("w1", (ffn, h)), ("w1_b", (ffn,)), ("w2", (h, ffn)), ("w2_b", (h,)),
        ):
            setattr(self, name, _param(shape, dtype, device))


class VisionTower(nn.Module):
    """The tower's weights (and the projector's, when
    ``cfg.projector_dim`` is set). Construction allocates them
    uninitialised on ``device``; fill them with
    :func:`init_vision_params`, :func:`load_vision_params` or
    ``models.convert.vision_from_jax``."""

    def __init__(self, cfg: VisionConfig, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        h, p, c = cfg.hidden_size, cfg.patch_size, cfg.num_channels
        self.patch_embed = _param((h, c, p, p), dtype, device)  # HF's conv weight
        self.cls_embed = _param((h,), dtype, device)
        self.pos_embed = _param((cfg.num_patches + 1, h), dtype, device)
        self.pre_ln = _param((h,), dtype, device)
        self.pre_ln_b = _param((h,), dtype, device)
        # Loaded, not applied: last_hidden_state carries no post-LN.
        self.post_ln = _param((h,), dtype, device)
        self.post_ln_b = _param((h,), dtype, device)
        self.layers = nn.ModuleList(
            VisionLayer(cfg, dtype, device) for _ in range(cfg.num_layers)
        )
        self.proj1 = self.proj1_b = self.proj2 = self.proj2_b = None
        if cfg.projector_dim:
            self._alloc_projector(cfg.projector_dim)

    def _alloc_projector(self, d: int) -> None:
        dt, dev = self.pre_ln.dtype, self.pre_ln.device
        self.proj1 = _param((d, self.cfg.hidden_size), dt, dev)
        self.proj1_b = _param((d,), dt, dev)
        self.proj2 = _param((d, d), dt, dev)
        self.proj2_b = _param((d,), dt, dev)


@torch.no_grad()
def init_projector_params(tower: VisionTower, projector_dim: int,
                          generator: torch.Generator) -> None:
    """A fresh multi_modal_projector into ``projector_dim`` (attached to
    a tower-only checkpoint without re-initialising the tower):
    normal / sqrt(fan_in) matrices, zero biases, as the JAX package."""
    if tower.proj1 is None or tower.proj1.shape[0] != projector_dim:
        tower._alloc_projector(projector_dim)
    h = tower.cfg.hidden_size
    for w, fan_in in ((tower.proj1, h), (tower.proj2, projector_dim)):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * fan_in**-0.5)
    tower.proj1_b.zero_()
    tower.proj2_b.zero_()


@torch.no_grad()
def init_vision_params(cfg: VisionConfig, generator: torch.Generator, device="cuda",
                       dtype=torch.float32) -> VisionTower:
    """A random tower (and projector when ``cfg.projector_dim`` is set)
    from ``generator`` (which must live on ``device``): the JAX
    package's scheme (normal / sqrt(fan_in) matrices, 0.02 for the
    [CLS] and position embeddings, ones and zeros for the norms, zero
    biases), not its bits."""
    tower = VisionTower(cfg, device=device, dtype=dtype)
    h, ffn = cfg.hidden_size, cfg.intermediate_size

    def fill(w, scale):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * scale)

    fill(tower.patch_embed, (cfg.patch_size**2 * cfg.num_channels) ** -0.5)
    fill(tower.cls_embed, 0.02)
    fill(tower.pos_embed, 0.02)
    for w in (tower.pre_ln, tower.post_ln):
        w.fill_(1.0)
    for b in (tower.pre_ln_b, tower.post_ln_b):
        b.zero_()
    for layer in tower.layers:
        for name in ("wq", "wk", "wv", "wo", "w1"):
            fill(getattr(layer, name), h**-0.5)
        fill(layer.w2, ffn**-0.5)
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
        for name in ("ln1_b", "ln2_b", "wq_b", "wk_b", "wv_b", "wo_b", "w1_b", "w2_b"):
            getattr(layer, name).zero_()
    if cfg.projector_dim:
        init_projector_params(tower, cfg.projector_dim, generator)
    return tower


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


@torch.no_grad()
def vision_forward(tower: VisionTower, cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] float pixels -> last_hidden_state [B, 1+P, hidden]
    (HF CLIPVisionModel semantics: no post-LN on the sequence), or the
    output of the layer ``cfg.feature_layer`` names."""
    fl = cfg.feature_layer
    if fl == 0 or fl < -cfg.num_layers or fl > cfg.num_layers:
        raise ValueError(
            f"vision feature_layer {fl} selects the embeddings, which "
            "this tower does not expose (supported: -num_layers..-1, "
            "1..num_layers)"
        )
    B = pixels.shape[0]
    p, h, nh, hd = cfg.patch_size, cfg.hidden_size, cfg.num_heads, cfg.head_dim
    grid = cfg.image_size // p
    eps = cfg.layer_norm_eps
    img = pixels[:, : grid * p, : grid * p, :].permute(0, 3, 1, 2)
    x = F.conv2d(img.to(tower.patch_embed.dtype), tower.patch_embed, stride=p)
    x = x.flatten(2).transpose(1, 2)  # [B, P, h], patches row-major
    cls = tower.cls_embed.expand(B, 1, h)
    x = torch.cat([cls, x], dim=1) + tower.pos_embed[None]
    x = _ln(x, tower.pre_ln, tower.pre_ln_b, eps)
    T = x.shape[1]
    # HF hidden_states[k] (k >= 1) is layer k-1's output; negative
    # indices line up directly for k <= num_layers.
    want = fl - 1 if fl > 0 else cfg.num_layers + fl
    for li, layer in enumerate(tower.layers):
        y = _ln(x, layer.ln1, layer.ln1_b, eps)
        q = F.linear(y, layer.wq, layer.wq_b).view(B, T, nh, hd).transpose(1, 2)
        k = F.linear(y, layer.wk, layer.wk_b).view(B, T, nh, hd).transpose(1, 2)
        v = F.linear(y, layer.wv, layer.wv_b).view(B, T, nh, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, h)
        x = x + F.linear(o, layer.wo, layer.wo_b)
        y = _ln(x, layer.ln2, layer.ln2_b, eps)
        x = x + F.linear(_act(F.linear(y, layer.w1, layer.w1_b), cfg.hidden_act),
                         layer.w2, layer.w2_b)
        if li == want:
            return x
    raise AssertionError("unreachable: feature_layer was checked above")


def select_patch_features(hidden: torch.Tensor) -> torch.Tensor:
    """LLaVA default feature selection: drop [CLS]."""
    return hidden[:, 1:, :]


@torch.no_grad()
def project_features(tower: VisionTower, cfg: VisionConfig, feats: torch.Tensor) -> torch.Tensor:
    """multi_modal_projector: linear -> gelu -> linear into LM hidden."""
    if tower.proj1 is None:
        raise ValueError("vision params carry no projector (projector_dim unset)")
    x = F.gelu(F.linear(feats, tower.proj1, tower.proj1_b))
    return F.linear(x, tower.proj2, tower.proj2_b)


@torch.no_grad()
def encode_image(tower: VisionTower, cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, C] -> soft tokens [B, P, lm_hidden] (tower,
    select, projector): the whole encode-worker hot path."""
    hidden = vision_forward(tower, cfg, pixels)
    return project_features(tower, cfg, select_patch_features(hidden))


# ------------------------------------------------------------- HF loading
@torch.no_grad()
def load_vision_params(path: str, cfg: VisionConfig | None = None, device="cuda",
                       dtype=torch.float32) -> tuple[VisionTower, VisionConfig]:
    """Load a HF ``CLIPVisionModel`` (or LLaVA ``vision_tower.*``)
    safetensors checkpoint. Returns (tower, cfg); the projector is
    loaded when the checkpoint has one (and ``cfg.projector_dim`` then
    set from it)."""
    from dataclasses import replace

    from .loader import _open_safetensors

    if cfg is None:
        cfg = VisionConfig.from_pretrained(path)
    files, index = _open_safetensors(path)
    try:
        def find(name: str) -> str | None:
            for prefix in ("", "vision_tower."):
                if prefix + name in index:
                    return prefix + name
            return None

        def get(name: str) -> torch.Tensor:
            full = find(name)
            if full is None:
                raise KeyError(name)
            return files[index[full]].get(full)

        proj = find("multi_modal_projector.linear_1.weight")
        cfg = replace(cfg, projector_dim=get("multi_modal_projector.linear_1.weight").shape[0]
                      if proj is not None else None)
        tower = VisionTower(cfg, device=device, dtype=dtype)
        vp = "vision_model."
        pairs = [
            (tower.patch_embed, "embeddings.patch_embedding.weight"),
            (tower.cls_embed, "embeddings.class_embedding"),
            (tower.pos_embed, "embeddings.position_embedding.weight"),
            (tower.pre_ln, "pre_layrnorm.weight"),
            (tower.pre_ln_b, "pre_layrnorm.bias"),
            (tower.post_ln, "post_layernorm.weight"),
            (tower.post_ln_b, "post_layernorm.bias"),
        ]
        per_layer = {
            "ln1": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
            "ln2": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
            "wq": "self_attn.q_proj.weight", "wq_b": "self_attn.q_proj.bias",
            "wk": "self_attn.k_proj.weight", "wk_b": "self_attn.k_proj.bias",
            "wv": "self_attn.v_proj.weight", "wv_b": "self_attn.v_proj.bias",
            "wo": "self_attn.out_proj.weight", "wo_b": "self_attn.out_proj.bias",
            "w1": "mlp.fc1.weight", "w1_b": "mlp.fc1.bias",
            "w2": "mlp.fc2.weight", "w2_b": "mlp.fc2.bias",
        }
        for i, layer in enumerate(tower.layers):
            for attr, name in per_layer.items():
                pairs.append((getattr(layer, attr), f"encoder.layers.{i}.{name}"))
        for dst, name in pairs:
            dst.copy_(get(vp + name))
        if proj is not None:
            for dst, name in ((tower.proj1, "linear_1.weight"), (tower.proj1_b, "linear_1.bias"),
                              (tower.proj2, "linear_2.weight"), (tower.proj2_b, "linear_2.bias")):
                dst.copy_(get("multi_modal_projector." + name))
    finally:
        for f in files:
            f.close()
    return tower, cfg
