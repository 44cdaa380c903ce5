"""dynamo_exp_tpu_torch: the PyTorch/CUDA port of the serving engine.

A package of its own beside ``dynamo_exp_tpu`` (the JAX reference). It
imports ``torch`` and numpy, never JAX and never the JAX package: what
it needs from JAX-free modules there (configs, protocol types, block
hashing, the prefix index) it keeps as its own trimmed copies, at the
mirrored module paths. Plain tensor code is PyTorch; the one TPU
kernel on the serving path (ragged paged attention) is a hand-written
CUDA kernel for Hopper under ``csrc/``.

Entry points run on the card unless the caller passes ``device="cpu"``
(the CPU tests do); asking for CUDA on a host without one raises.
"""
