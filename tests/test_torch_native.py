"""The port's host C++ block hash (``native/blockhash.cpp`` through
``native/__init__.py``) against its Python mirror (``tokens.py``'s
``py_*`` functions) and the JAX package's hashes, on hypothesis-drawn
token lists, block sizes, seeds and parents. Tolerance: none; the hashes
are integers and must be bit-equal (the router's wire and the G3 store's
page keys depend on it)."""

import os

from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu import native as jnative
from dynamo_exp_tpu import tokens as jtokens
from dynamo_exp_tpu_torch import native, tokens

U64 = (1 << 64) - 1
TOKENS = st.lists(st.integers(0, (1 << 32) - 1), max_size=200)
SEEDS = st.one_of(st.just(tokens.DEFAULT_HASH_SEED), st.integers(0, U64))


def test_library_builds_from_the_checkout():
    assert native.native_available()
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(path).endswith("_build")


@settings(max_examples=200, deadline=None)
@given(TOKENS, SEEDS)
def test_block_hash_is_the_mirror_and_jax(toks, seed):
    got = tokens.compute_block_hash(toks, seed)
    assert got == tokens.py_compute_block_hash(toks, seed)
    assert got == jtokens.compute_block_hash(toks, seed) == jnative._py_block_hash(toks, seed)


@settings(max_examples=200, deadline=None)
@given(st.one_of(st.none(), st.integers(0, U64)), st.integers(0, U64), SEEDS)
def test_chain_hash_is_the_mirror_and_jax(parent, local, seed):
    got = tokens.chain_hash(parent, local, seed)
    assert got == tokens.py_chain_hash(parent, local, seed)
    assert got == jtokens.chain_hash(parent, local, seed)


@settings(max_examples=200, deadline=None)
@given(TOKENS, st.integers(1, 33), SEEDS)
def test_sequence_hashes_are_the_mirror_and_jax(toks, block, seed):
    got = tokens.compute_block_hashes_for_seq(toks, block, seed)
    assert len(got) == len(toks) // block
    assert got == tokens.py_block_hashes_for_seq(toks, block, seed)
    assert got == jtokens.compute_block_hashes_for_seq(toks, block, seed)


@settings(max_examples=100, deadline=None)
@given(TOKENS, st.integers(1, 16), st.integers(0, U64))
def test_sequence_hashes_chain_onto_a_parent(toks, block, parent):
    got = native.seq_hashes(toks, block, tokens.DEFAULT_HASH_SEED, parent=parent)
    assert got == jnative.seq_hashes(toks, block, tokens.DEFAULT_HASH_SEED, parent=parent)


def test_calls_are_counted():
    before = dict(native.CALLS)
    tokens.compute_block_hashes_for_seq(list(range(64)), 16)
    tokens.compute_block_hash([1, 2, 3])
    tokens.chain_hash(None, 5)
    assert native.CALLS["seq_hashes"] == before["seq_hashes"] + 1
    assert native.CALLS["block_hash"] == before["block_hash"] + 1
    assert native.CALLS["chain_hash"] == before["chain_hash"] + 1
