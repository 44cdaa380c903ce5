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


def sample_tokens_seeded_multi(
    logits: torch.Tensor,  # [B, T, V] float32
    seeds: torch.Tensor,  # [B] int per-row sampling seed
    positions: torch.Tensor,  # [B, T] int absolute position of each fed token
    temperature: torch.Tensor,  # [B] float32; <=0 means greedy
    top_k: torch.Tensor,  # [B] int; <=0 disables
    top_p: torch.Tensor,  # [B] float32; >=1 disables
) -> torch.Tensor:
    """One draw per (row, offset) of a T-wide dispatch, each keyed by
    ``(seeds[b], positions[b, t])`` exactly as :func:`sample_tokens_seeded`
    keys a decode step feeding that position, so a verify pass draws
    what the step-by-step window would. Returns [B, T] int32."""
    B, T, V = logits.shape

    def rep(x):
        return x.repeat_interleave(T)

    toks = sample_tokens_seeded(
        logits.reshape(B * T, V), rep(seeds), positions.reshape(-1),
        rep(temperature), rep(top_k), rep(top_p),
    )
    return toks.reshape(B, T)


def spec_accept_length(
    targets: torch.Tensor,  # [B, T] target-model tokens per position
    drafts: torch.Tensor,  # [B, T-1] draft tokens (-1 padded)
    n_drafts: torch.Tensor,  # [B] int true draft count per row
) -> torch.Tensor:
    """Tokens one verify dispatch emits per row: the longest prefix where
    the target's token equals the draft fed at the next position, plus
    the first correction (or bonus) token, so always >= 1. Returns [B]
    int32."""
    K = drafts.shape[1]
    idx = torch.arange(K, device=targets.device)[None, :]
    match = (targets[:, :K] == drafts) & (idx < n_drafts[:, None])
    accepted = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    return (accepted + 1).to(torch.int32)


def spec_verify_tokens(
    logits: torch.Tensor,  # [B, T, V] float32 target logits per fed position
    drafts: torch.Tensor,  # [B, T-1] draft tokens fed at offsets 1..T-1
    n_drafts: torch.Tensor,  # [B] int true draft count per row
    seeds: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B, T] int absolute fed positions (-1 pad)
    temperature: torch.Tensor,  # [B] float32; <=0 greedy
    top_k: torch.Tensor,  # [B] int
    top_p: torch.Tensor,  # [B] float32
    counts: torch.Tensor,  # [B, V] int32 penalty counts at dispatch
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
    repetition_penalty: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full sampler's verify pass: a target token for every position
    of a speculative span, with the penalty counts threaded as the
    decode window threads them: each step's logits are shaped by the
    counts of every token emitted before it, and a step's token counts
    only while the row is alive (all earlier drafts accepted), so a
    rejected draft leaves no trace in the counts. Greedy, seeded and
    penalized rows share the path. Returns (targets [B, T], n_emit [B],
    new counts [B, V]); targets at offsets >= n_emit are teacher-forced
    garbage the caller discards. A Python loop where JAX scans."""
    B, T, V = logits.shape
    drafts_pad = torch.cat(
        [drafts.to(torch.int64), torch.full((B, 1), -1, dtype=torch.int64, device=drafts.device)],
        dim=1,
    )
    rows = torch.arange(B, device=logits.device)
    counts = counts.clone()
    alive = positions[:, 0] >= 0  # pad rows never emit or count
    tgts, emits = [], []
    for i in range(T):
        shaped = apply_penalties(
            logits[:, i], counts, frequency_penalty, presence_penalty, repetition_penalty
        )
        tgt = sample_tokens_seeded(shaped, seeds, positions[:, i], temperature, top_k, top_p)
        counts.index_put_((rows, tgt.long()), alive.to(torch.int32), accumulate=True)
        emits.append(alive)
        alive = alive & (i < n_drafts) & (tgt.long() == drafts_pad[:, i])
        tgts.append(tgt)
    n_emit = torch.stack(emits, dim=1).to(torch.int32).sum(dim=1)
    return torch.stack(tgts, dim=1), n_emit.to(torch.int32), counts


# Top-N alternatives reported beside every chosen token's logprob; the
# host slices each request's top_logprobs out of them (the JAX
# package's static width).
TOP_LOGPROBS = 5


def token_logprobs(
    logits: torch.Tensor,  # [B, V] raw model logits
    chosen: torch.Tensor,  # [B] int sampled token ids
    top_n: int = TOP_LOGPROBS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen logprob [B], top-N ids [B, N] int32, top-N logprobs
    [B, N]) of the model distribution (before penalties and
    temperature), OpenAI's logprobs semantics."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    chosen_lp = torch.gather(lp, 1, chosen.long()[:, None])[:, 0]
    top_lp, top_ids = torch.topk(lp, top_n, dim=-1)
    return chosen_lp, top_ids.to(torch.int32), top_lp
