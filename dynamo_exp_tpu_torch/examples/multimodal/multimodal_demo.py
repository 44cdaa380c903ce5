"""Multimodal demo graph: EncodeWorker -> soft-token prefill.

Counterpart of the root ``examples/multimodal/multimodal_demo.py``: the
encode worker feeds image features to the LLM side, which prefixes them
to the prompt. The LLM side drives the model layer directly: image
patch embeddings followed by the prompt's token embeddings go through
one ``forward_ragged(token_embeds=...)`` dispatch (on the card, the
ragged mixed kernel), then one greedy token.

    python -m dynamo_exp_tpu_torch.sdk.serve \\
        dynamo_exp_tpu_torch.examples.multimodal.multimodal_demo:VisionChat \\
        --start-coordinator
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dynamo_exp_tpu_torch.sdk import async_on_start, depends, endpoint, service

from .components.encode_worker import EncodeWorker

logger = logging.getLogger(__name__)

PAGE_SIZE = 16
Q_TILE = 8  # the ragged kernel's tile: the flat stream is padded to it


def soft_token_prefill(model, cfg, features: torch.Tensor, prompt: list[int], *,
                       attn_impl: str = "auto", reserve: int = 0):
    """Prefill [image patches] + [prompt embeddings] as one row of one
    mixed dispatch. ``features`` [P, D] lie on the model's device.
    Returns (logits [V] of the last position, k_cache, v_cache, page
    table [1, Pmax], T): the pools hold the prefix's K/V, and the table
    has pages for ``reserve`` more positions, so that many decode steps
    can follow (``llama.forward`` at T=1).

    The stream is padded to a multiple of ``Q_TILE`` with position -1;
    padding writes no page."""
    from dynamo_exp_tpu_torch.models.llama import forward_ragged, init_kv_cache

    dev = model.embed.device
    ids = torch.tensor(prompt, dtype=torch.long, device=dev)
    x = torch.cat([features.to(model.embed.dtype), model.embed[ids]], dim=0)
    T = x.shape[0]
    n = -(-T // Q_TILE) * Q_TILE
    embeds = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=dev)
    embeds[:T] = x
    positions = torch.full((n,), -1, dtype=torch.int32, device=dev)
    positions[:T] = torch.arange(T, dtype=torch.int32, device=dev)
    pmax = -(-(T + reserve) // PAGE_SIZE)
    k, v = init_kv_cache(cfg, num_pages=pmax + 1, page_size=PAGE_SIZE, device=dev)
    table = torch.arange(1, pmax + 1, dtype=torch.int32, device=dev)[None]
    logits, k, v = forward_ragged(
        model, cfg, torch.zeros(n, dtype=torch.long, device=dev), positions,
        torch.zeros(n, dtype=torch.int32, device=dev), table, k, v,
        torch.tensor([T - 1], device=dev), attn_impl=attn_impl, q_tile=Q_TILE,
        token_embeds=embeds,
    )
    return logits[0], k, v, table, T


@service(dynamo={"namespace": "multimodal"}, resources={"gpu": 1})
class VisionChat:
    """Consumes encoded image features as a soft-token prefix."""

    encoder = depends(EncodeWorker, endpoint="encode")

    preset: str = "tiny"
    device: str = "cuda"  # the CPU tests set "cpu"

    def __init__(self):
        self.model = None
        self.cfg = None

    @async_on_start
    async def build(self) -> None:
        from dynamo_exp_tpu_torch.models import PRESETS, init_params

        self.cfg = PRESETS[self.preset]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.model = init_params(self.cfg, gen, self.device)

    @endpoint()
    async def generate(self, request: dict):
        stream = await self.encoder.generate(
            {"pixels": request["pixels"], "shape": request.get("shape")}
        )
        features = None
        async for item in stream:
            features = np.asarray(item["image_features"], np.float32)
        prompt = list(request.get("token_ids", []))
        feats = torch.from_numpy(features[:, : self.cfg.hidden_size]).to(self.model.embed.device)
        logits, *_ = soft_token_prefill(self.model, self.cfg, feats, prompt)
        yield {"n_image_tokens": int(feats.shape[0]), "next_token": int(logits.argmax())}
