"""Speculative decoding: deterministic draft and verify.

Counterpart of ``dynamo_exp_tpu/spec/`` (pure Python, copied so the
port imports nothing of the JAX package):

- :mod:`.drafter`: the :class:`Drafter` interface and its registry; the
  built-in ``ngram`` drafter is prompt-lookup speculation (match the
  row's trailing n-gram against its own context, propose what followed
  it), so no second model is needed.
- :mod:`.controller`: :class:`SpecManager`, the per-row adaptive
  controller (draft length from a rolling acceptance rate, backoff for
  rows whose lookups keep missing).
- the engine's verify span (``engine/engine.py``): the row's last token
  and its drafts ride one mixed dispatch; the target token at each
  position, drawn by ``(sample_seed, absolute position)``, decides
  acceptance on the device, and pages past the accepted prefix are
  rewound.

Every draw is keyed by seed and position, so with speculation on every
stream is token-identical to the run without it.
"""

from .controller import SpecManager
from .drafter import (
    Drafter,
    NgramDrafter,
    StaticDrafter,
    build_drafter,
    register_drafter,
    registered_drafters,
)

__all__ = [
    "Drafter",
    "NgramDrafter",
    "SpecManager",
    "StaticDrafter",
    "build_drafter",
    "register_drafter",
    "registered_drafters",
]
