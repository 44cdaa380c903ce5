"""``chip_smoke.py``'s phase 9 rehearsed on the CPU at a small size: the
checkpoint written, loaded through ``run.main_async(--model-path)``
bit-equal and served as the in-memory weights are; the warm boot
through ``run.build_cuda_engine(--model-path <dir> --random-weights
--prewarm --compile-cache-dir)`` (the dir's config.json the preset's
width at ``warm_layers`` layers, here TINY's own 2) and
the eager engine give equal tokens and launch counts in turns; a second
process boots against the same cache directory with no kernel build
(``device="cpu"``, TINY widths, a vocabulary of 2,048; no graphs on the
CPU)."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)


def test_smoke_phase9_on_cpu():
    sh = cs.Phase9(device="cpu", prompt_lens=(5, 20, 40, 33), max_tokens=6, chain_tokens=12,
                   loader_layers=2, preset="tiny", warm_layers=2, second_preset="tiny")
    out = cs.phase9(torch, np, pkg, tra, "cpu", sh=sh, mcfg=SMALL)
    a, b, c = out["a"], out["b"], out["c"]
    assert a["shards"] == 2 and a["bytes"] > 0 and len(a["tokens"]) == 4
    report = b["report"]
    assert report["variants"] > 0 and report["graphs"] == 0 and report["builds"] == 0
    assert [r["kind"] for r in b["bursts"]["5"]] == ["graphed", "eager", "eager", "graphed"]
    assert c["report"]["builds"] == 0
