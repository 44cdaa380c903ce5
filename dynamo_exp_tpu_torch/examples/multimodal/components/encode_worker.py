"""EncodeWorker: image -> embedding service of the multimodal graph.

Counterpart of ``examples/multimodal/components/encode_worker.py``: a
CLIP-style vision tower and a multi-modal projector on their own card,
streaming image features to the LLM worker. The tower is the port's
``models/vision.py``: real HF CLIPVisionModel safetensors load
directly; without a checkpoint a random tower of the same architecture
is used. Either way the features exit through the real seam: soft
tokens consumed by ``models/llama.forward_ragged(token_embeds=...)``.
"""

from __future__ import annotations

import base64
import logging

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_exp_tpu_torch.sdk import async_on_start, endpoint, service

logger = logging.getLogger(__name__)


class VisionEncoder:
    """CLIP-style ViT + multi-modal projector on ``device``."""

    # CLIP training-time channel statistics (HF CLIPImageProcessor
    # defaults): real checkpoints expect normalized pixels.
    _MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    _STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    def __init__(
        self,
        lm_hidden_size: int,
        model_path: str = "",
        image_size: int = 32,
        patch: int = 8,
        seed: int = 0,
        device="cuda",
        cfg=None,
        dtype=torch.float32,
    ):
        """``cfg`` (a ``VisionConfig``) sizes a random tower in place of
        the small default; ``model_path`` loads a checkpoint instead."""
        from dataclasses import replace

        from dynamo_exp_tpu_torch.models.vision import (
            VisionConfig,
            init_projector_params,
            init_vision_params,
            load_vision_params,
        )

        self.device = torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if model_path:
            self.tower, self.cfg = load_vision_params(model_path, device=self.device,
                                                      dtype=dtype)
            if self.tower.proj1 is None:
                # Tower-only checkpoint (plain CLIPVisionModel): attach a
                # fresh projector into the LM hidden size.
                self.cfg = replace(self.cfg, projector_dim=lm_hidden_size)
                init_projector_params(self.tower, lm_hidden_size, gen)
        else:
            self.cfg = cfg or VisionConfig(
                hidden_size=64,
                intermediate_size=128,
                num_layers=2,
                num_heads=4,
                image_size=image_size,
                patch_size=patch,
                projector_dim=lm_hidden_size,
            )
            self.tower = init_vision_params(self.cfg, gen, self.device, dtype)

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] float32 in [0, 1] -> [1, S, S, 3] normalized pixels
        on the device: a bilinear resize to the tower raster when the
        image has another size (the whole image contributes, never a
        crop), then per-channel mean/std normalization."""
        s = self.cfg.image_size
        img = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)
        if tuple(img.shape[:2]) != (s, s):
            img = F.interpolate(img.permute(2, 0, 1)[None], size=(s, s), mode="bilinear",
                                align_corners=False, antialias=True)[0].permute(1, 2, 0)
        mean = torch.from_numpy(self._MEAN).to(self.device)
        std = torch.from_numpy(self._STD).to(self.device)
        return ((img - mean) / std)[None]

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """Preprocessed pixels [B, S, S, 3] -> soft tokens [B, P, lm_hidden]
        on the device."""
        from dynamo_exp_tpu_torch.models.vision import encode_image

        return encode_image(self.tower, self.cfg, pixels)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1] -> [n_patches, lm_hidden] soft
        tokens (float32, on the host)."""
        return self.encode(self.preprocess(image))[0].float().cpu().numpy()


def decode_image(request: dict) -> np.ndarray:
    """Accept {"pixels": [[...]] } (nested lists) or {"image_b64",
    "shape"} (raw float32 bytes): no image library needed."""
    if "pixels" in request:
        return np.asarray(request["pixels"], np.float32)
    raw = base64.b64decode(request["image_b64"])
    return np.frombuffer(raw, np.float32).reshape(request["shape"])


@service(dynamo={"namespace": "multimodal"}, resources={"gpu": 1})
class EncodeWorker:
    lm_hidden_size: int = 2048
    model_path: str = ""  # HF CLIPVisionModel / LLaVA checkpoint dir
    image_size: int = 32
    patch: int = 8
    device: str = "cuda"  # the CPU tests set "cpu"

    def __init__(self):
        self.encoder = None
        self.encoded = 0

    @async_on_start
    async def build(self) -> None:
        self.encoder = VisionEncoder(
            self.lm_hidden_size,
            model_path=self.model_path,
            image_size=self.image_size,
            patch=self.patch,
            device=self.device,
        )

    @endpoint()
    async def encode(self, request: dict):
        image = decode_image(request)
        features = self.encoder(image)
        self.encoded += 1
        yield {
            "image_features": features.tolist(),
            "n_patches": int(features.shape[0]),
        }
