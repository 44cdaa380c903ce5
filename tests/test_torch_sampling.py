"""Port parity: the sampler against the JAX package's, on the CPU.

- greedy, ``_mask_logits`` (temperature, top-k, top-p), ``apply_penalties``
  and ``stop_token_hit`` take the same numpy inputs on both sides.
  ``_mask_logits`` compares the kept set exactly and the kept logits at
  atol=rtol=1e-6 (one float32 division each); penalties are elementwise
  float32 and compare at the same bound.
- seeded draws equal the JAX package's ``sample_tokens_seeded`` on the
  same numpy logits, token for token, over a batch that mixes greedy,
  temperature, top-k and top-p rows (the threefry bits themselves are
  held to ``jax.random`` in ``test_torch_prng.py``). The contract holds
  too: a row's draw depends only on its seed, its position and its own
  logits, never on the batch it rides in; it stays inside the
  top-k/top-p set; and temperature 0 is the argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.ops import sampling as js
from dynamo_exp_tpu_torch.ops import sampling as ts

TIGHT = dict(atol=1e-6, rtol=1e-6)


def _logits(seed, B=6, V=64):
    return np.random.RandomState(seed).standard_normal((B, V)).astype(np.float32) * 3


def test_greedy_matches_jax():
    lg = _logits(0)
    B = lg.shape[0]
    args_np = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
    want = np.asarray(
        js.sample_tokens_seeded(
            jnp.asarray(lg), jnp.arange(B), jnp.arange(B), *map(jnp.asarray, args_np)
        )
    )
    got = ts.sample_tokens_seeded(
        torch.from_numpy(lg), torch.arange(B), torch.arange(B),
        *(torch.from_numpy(a) for a in args_np),
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), lg.argmax(-1))


def test_mask_logits_matches_jax():
    lg = _logits(1)
    temp = np.array([1.0, 0.7, 1.3, 0.5, 2.0, 1e-9], np.float32)
    top_k = np.array([0, 5, 1, 64, 10, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.3, 0.0, 0.5], np.float32)
    want = np.asarray(js._mask_logits(*(jnp.asarray(a) for a in (lg, temp, top_k, top_p))))
    got = ts._mask_logits(
        torch.from_numpy(lg), torch.from_numpy(temp),
        torch.from_numpy(top_k.astype(np.int64)), torch.from_numpy(top_p),
    ).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_allclose(got[kept], want[kept], **TIGHT)
    assert kept[2].sum() == 1 and kept[4].sum() == 1  # top_k=1, top_p=0


def test_apply_penalties_and_stop_hit_match_jax():
    lg = _logits(2)
    rs = np.random.RandomState(3)
    counts = rs.randint(0, 3, size=lg.shape).astype(np.int32)
    freq = np.array([0.0, 0.5, 0.0, 1.0, 0.2, 0.0], np.float32)
    pres = np.array([0.0, 0.0, 0.7, 0.3, 0.2, 0.0], np.float32)
    rep = np.array([1.0, 1.0, 1.3, 0.8, 1.1, 0.0], np.float32)
    want = np.asarray(
        js.apply_penalties(*(jnp.asarray(a) for a in (lg, counts, freq, pres, rep)))
    )
    got = ts.apply_penalties(
        *(torch.from_numpy(a) for a in (lg, counts, freq, pres, rep))
    ).numpy()
    np.testing.assert_allclose(got, want, **TIGHT)

    toks = np.array([3, 7, 5, 0, 9, 12], np.int32)
    stops = np.full((6, 4), -1, np.int32)
    stops[0, :2] = [3, 4]
    stops[1, 0] = 8
    stops[4, 3] = 9
    want_hit = np.asarray(js.stop_token_hit(jnp.asarray(toks), jnp.asarray(stops)))
    got_hit = ts.stop_token_hit(torch.from_numpy(toks), torch.from_numpy(stops)).numpy()
    np.testing.assert_array_equal(got_hit, want_hit)
    assert got_hit.tolist() == [True, False, False, False, True, False]


def _draw(logits, seeds, positions, temp, top_k, top_p):
    return ts.sample_tokens_seeded(
        torch.from_numpy(logits), torch.tensor(seeds), torch.tensor(positions),
        torch.tensor(temp, dtype=torch.float32), torch.tensor(top_k),
        torch.tensor(top_p, dtype=torch.float32),
    ).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_draw_depends_only_on_seed_and_position(seed):
    rs = np.random.RandomState(seed)
    V = 50
    row = rs.standard_normal(V).astype(np.float32)
    others = rs.standard_normal((7, V)).astype(np.float32)
    alone = _draw(row[None], [11], [40], [0.8], [0], [1.0])[0]
    # The same row at every batch index, next to other rows with other
    # seeds, positions and sampling options: the same draw each time.
    for at in range(8):
        batch = np.insert(others, at, row, axis=0)
        seeds = list(rs.randint(0, 1 << 30, size=8))
        positions = list(rs.randint(0, 4000, size=8))
        temp = list(rs.uniform(0.0, 1.5, size=8))
        seeds[at], positions[at], temp[at] = 11, 40, 0.8
        top_k, top_p = [0] * 8, [1.0] * 8
        assert _draw(batch, seeds, positions, temp, top_k, top_p)[at] == alone
    # Another position or seed is another draw (over a flat distribution,
    # a fixed token for 20 keys would be a broken key).
    flat = np.zeros((1, V), np.float32)
    by_pos = {_draw(flat, [11], [p], [1.0], [0], [1.0])[0] for p in range(20)}
    by_seed = {_draw(flat, [s], [40], [1.0], [0], [1.0])[0] for s in range(20)}
    assert len(by_pos) > 5 and len(by_seed) > 5


def test_seeded_draw_respects_masks_and_greedy_rows():
    rs = np.random.RandomState(4)
    lg = rs.standard_normal((4, 32)).astype(np.float32)
    top5 = set(np.argsort(-lg[1])[:5].tolist())
    for pos in range(30):
        toks = _draw(lg, [1, 2, 3, 4], [pos] * 4, [0.0, 1.0, 1.0, 0.9], [0, 5, 1, 0],
                     [1.0, 1.0, 1.0, 0.0])
        assert toks[0] == int(lg[0].argmax())  # temperature 0: greedy
        assert toks[1] in top5
        assert toks[2] == int(lg[2].argmax())  # top_k = 1
        assert toks[3] == int(lg[3].argmax())  # top_p = 0 keeps the top token


def test_seeded_draws_equal_the_jax_sampler():
    """240 (seed, position) pairs in batches of 8 that mix greedy,
    temperature, top-k and top-p rows: every token equals the JAX
    package's draw on the same numpy inputs."""
    rs = np.random.RandomState(5)
    B, V = 8, 97
    temp = np.array([0.8, 0.0, 1.0, 0.7, 1.3, 0.0, 0.5, 1.0], np.float32)
    top_k = np.array([0, 0, 5, 0, 20, 3, 0, 1], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.9, 0.8, 1.0, 0.95, 1.0], np.float32)
    n_sampled = 0
    for _ in range(30):
        lg = (rs.standard_normal((B, V)) * 2).astype(np.float32)
        seeds = rs.randint(0, 2**31 - 1, size=B).astype(np.int32)
        positions = rs.randint(-1, 1 << 20, size=B).astype(np.int32)
        want = np.asarray(
            js.sample_tokens_seeded(
                *(jnp.asarray(a) for a in (lg, seeds, positions, temp, top_k, top_p))
            )
        )
        got = ts.sample_tokens_seeded(
            *(torch.from_numpy(a) for a in (lg, seeds, positions, temp, top_k, top_p))
        )
        np.testing.assert_array_equal(got.numpy(), want)
        n_sampled += int((temp > 0).sum())
    assert n_sampled >= 180 and 30 * B >= 200
