"""Token sampling: greedy / temperature / top-k / top-p, penalties, stops.

Counterpart of ``dynamo_exp_tpu/ops/sampling.py``. Sampling parameters
are per-row vectors, so one batch serves a heterogeneous continuous
batch. Seeded draws are counter-based per row: a row's draw depends on
``(seed, position)`` and its own logits only, never on the batch it
rides in. The random bits are ``jax.random``'s own (threefry, in
:mod:`.prng`), so a seeded stream equals the JAX package's.
"""

from __future__ import annotations

import torch

from . import prng


def _mask_logits(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B] float32
    top_k: torch.Tensor,  # [B] int; <=0 disables
    top_p: torch.Tensor,  # [B] float32; >=1 disables
) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p mass masked to -inf."""
    B, V = logits.shape
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: threshold at the k-th largest logit.
    k = torch.clamp(torch.where(top_k <= 0, V, top_k), 1, V).long()
    kth = torch.gather(sorted_logits, 1, (k - 1)[:, None])
    neg_inf = torch.full_like(scaled, float("-inf"))
    masked = torch.where(scaled < kth, neg_inf, scaled)

    # top-p (nucleus): keep the smallest sorted prefix whose cumulative
    # probability reaches p; a sorted logit is kept while the mass
    # *before* it is still < p. The top token always survives.
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < torch.clamp(top_p, 0.0, 1.0)[:, None]
    keep_sorted[:, 0] = True
    min_kept = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).min(dim=-1, keepdim=True).values
    return torch.where(scaled < min_kept, neg_inf, masked)


def sample_tokens_seeded(
    logits: torch.Tensor,  # [B, V] float32
    seeds: torch.Tensor,  # [B] int per-row sampling seed
    positions: torch.Tensor,  # [B] int absolute position of the fed token
    temperature: torch.Tensor,  # [B] float32; <=0 means greedy
    top_k: torch.Tensor,  # [B] int; <=0 disables
    top_p: torch.Tensor,  # [B] float32; >=1 disables
) -> torch.Tensor:
    """Counter-based per-row sampling, as the JAX package's: row ``r``
    draws ``categorical(fold_in(PRNGKey(seeds[r]), positions[r]),
    masked logits)``, independent of batch composition and of which
    dispatch shape carried the row. Inactive rows (position -1) draw at
    position 0; rows with temperature <= 0 take the argmax. Whole-batch
    tensor code, no host sync. Returns [B] int32."""
    greedy = torch.argmax(logits, dim=-1)
    masked = _mask_logits(logits, temperature, top_k, top_p)
    key = prng.fold_in(prng.prng_key(seeds), torch.clamp(positions, min=0))
    sampled = prng.categorical(key, masked)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def apply_penalties(
    logits: torch.Tensor,  # [B, V]
    output_counts: torch.Tensor,  # [B, V] int counts of generated tokens
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
    repetition_penalty: torch.Tensor,  # [B]; 1.0 disables
) -> torch.Tensor:
    """OpenAI-style frequency/presence penalties + HF repetition penalty."""
    counts = output_counts.to(logits.dtype)
    seen = counts > 0
    logits = logits - counts * frequency_penalty[:, None]
    logits = logits - seen.to(logits.dtype) * presence_penalty[:, None]
    rep = torch.where(
        repetition_penalty <= 0.0,
        torch.ones_like(repetition_penalty),
        repetition_penalty,
    )[:, None]
    return torch.where(
        seen, torch.where(logits > 0, logits / rep, logits * rep), logits
    )


def stop_token_hit(
    tokens: torch.Tensor,  # [B] int sampled token ids
    stop_sets: torch.Tensor,  # [B, S] int, -1 padded (never matches)
) -> torch.Tensor:
    """Per-row stop detection: True where the sampled token is in the
    row's (padded) stop set."""
    return (tokens[:, None] == stop_sets).any(dim=-1)
