"""Port parity: ``ops/prng.py`` against ``jax.random``, bit for bit.

Over seeds {0, 1, 1234, 2^31-1} x positions {0, 1, 4095, 2^31-1}:
``fold_in(PRNGKey(seed), position)``'s key words, ``jax.random.bits``
and float32 ``jax.random.uniform`` (also at minval = tiny, the Gumbel
sampler's range) are equal bit for bit. The Gumbel noise goes through
``log`` twice, and the two frameworks' float32 ``log`` may differ in the
last bit: it is held at one float32 ulp of its value.
"""

import jax
import numpy as np
import pytest
import torch

from dynamo_exp_tpu_torch.ops import prng

SEEDS = [0, 1, 1234, 2**31 - 1]
POSITIONS = [0, 1, 4095, 2**31 - 1]
N = 777  # odd, so no even split of the counters is assumed


def _keys(seed, pos):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
    tkey = prng.fold_in(prng.prng_key(torch.tensor([seed])), torch.tensor([pos]))
    return jkey, tkey


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pos", POSITIONS)
def test_keys_bits_and_uniforms_bit_equal_jax(seed, pos):
    jkey, tkey = _keys(seed, pos)
    want_key = np.asarray(jax.random.key_data(jkey)).astype(np.int64)
    np.testing.assert_array_equal(torch.stack(tkey)[:, 0].numpy(), want_key)
    np.testing.assert_array_equal(
        prng.random_bits(tkey, N)[0].numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, (N,))),
    )
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        want = np.asarray(jax.random.uniform(jkey, (N,), minval=lo))
        got = prng.uniform(tkey, N, minval=lo)[0].numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want_g = np.asarray(jax.random.gumbel(jkey, (N,)))
    got_g = prng.gumbel(tkey, N)[0].numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=2.0**-23, atol=2.0**-23)


def test_batched_keys_match_one_key_at_a_time():
    """A [B] batch of (seed, position) pairs hashes each row alone."""
    seeds = torch.tensor(SEEDS * 4)
    pos = torch.tensor([p for p in POSITIONS for _ in SEEDS])
    bits = prng.random_bits(prng.fold_in(prng.prng_key(seeds), pos), 64)
    for r in range(len(seeds)):
        _, one = _keys(int(seeds[r]), int(pos[r]))
        assert torch.equal(bits[r], prng.random_bits(one, 64)[0])


def test_categorical_matches_jax_on_a_flat_distribution():
    """On equal logits the draw is the argmax of the noise alone."""
    for seed in SEEDS:
        for pos in POSITIONS:
            jkey, tkey = _keys(seed, pos)
            lg = np.zeros(1000, np.float32)
            want = int(jax.random.categorical(jkey, lg))
            assert int(prng.categorical(tkey, torch.from_numpy(lg)[None])[0]) == want
