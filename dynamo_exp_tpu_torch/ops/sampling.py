"""Token sampling: greedy / temperature / top-k / top-p, penalties, stops.

Counterpart of ``dynamo_exp_tpu/ops/sampling.py``. Sampling parameters
are per-row vectors, so one batch serves a heterogeneous continuous
batch. Seeded draws are counter-based per row: a row's draw depends on
``(seed, position)`` and its own logits only, never on the batch it
rides in. The random bits come from a ``torch.Generator`` keyed by
(seed, position) and are not ``jax.random``'s threefry bits, so a
seeded stream differs from the JAX package's (a known difference).
"""

from __future__ import annotations

import torch


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


_MASK64 = (1 << 64) - 1


def _draw_key(seed: int, position: int) -> int:
    """Generator seed of one draw: the row's seed and the absolute
    position of the fed token packed into 64 bits, then mixed
    (splitmix64's finaliser). The mixing matters: the CPU generator
    keeps only the low 32 bits of its seed, which unmixed would be the
    position alone."""
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (max(int(position), 0) & 0xFFFFFFFF)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def sample_tokens_seeded(
    logits: torch.Tensor,  # [B, V] float32
    seeds: torch.Tensor,  # [B] int per-row sampling seed
    positions: torch.Tensor,  # [B] int absolute position of the fed token
    temperature: torch.Tensor,  # [B] float32; <=0 means greedy
    top_k: torch.Tensor,  # [B] int; <=0 disables
    top_p: torch.Tensor,  # [B] float32; >=1 disables
) -> torch.Tensor:
    """Counter-based per-row sampling: row ``r``'s draw is a Gumbel-max
    over its masked logits with noise from a ``torch.Generator`` seeded
    by ``(seeds[r], positions[r])`` — independent of batch composition
    and of which dispatch shape carried the row. Rows with temperature
    <= 0 take the argmax. Returns [B] int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temperature.tolist()
    if not any(t > 0.0 for t in temps):
        return greedy
    masked = _mask_logits(logits, temperature, top_k, top_p)
    out = greedy.clone()
    V = logits.shape[1]
    tiny = torch.finfo(torch.float32).tiny
    for r, (t, seed, pos) in enumerate(
        zip(temps, seeds.tolist(), positions.tolist())
    ):
        if t <= 0.0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_draw_key(seed, pos))
        u = torch.rand(V, generator=gen, device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        out[r] = torch.argmax(masked[r] + gumbel).to(torch.int32)
    return out


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
