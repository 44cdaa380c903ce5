"""``chip_smoke.py``'s phase 22 rehearsed on the CPU at the tiny preset:
(a) phase 5's burst on a fresh engine with the sync-warning recorder on
(the CPU raises no sync warning, so no site; the check that every site
in a hot-path zone is a waived lint line refuses a planted one); (b) a
tiny CLIP tower's soft tokens and an 8-token prompt through one
``soft_token_prefill`` dispatch (one attention call a layer), layer 0
against the plain version, ``token_embeds = embed[ids]`` bit-equal,
greedy tokens equal on a rerun; (c) the ring prefill over 2 spawned
gloo ranks against one single-rank ``forward_ragged`` dispatch (logits
atol 2e-3 + rtol 1e-3, K/V atol 1e-5). On the CPU the kernel wrappers
compute their plain versions and no kernel is counted."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.models.vision import VisionConfig
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SH = cs.Phase22(device="cpu", preset="tiny", prompt_lens=(5, 20, 40, 33), max_tokens=6,
                vision=VisionConfig(hidden_size=32, intermediate_size=64, num_layers=3,
                                    num_heads=4, image_size=32, patch_size=8,
                                    feature_layer=-2),
                vision_dtype="float32", lm_layers=2, decode_tokens=4, ring_tokens=64,
                ring_timeout_s=120.0)


def test_smoke_phase22_on_cpu():
    out = cs.phase22(torch, np, pkg, tra, "cpu", sh=SH, mcfg=replace(TINY, dtype="float32"))
    a, b, c = out["a"], out["b"], out["c"]
    assert a["sites"] == {} and a["allowlist_lines"] >= 5
    assert b["tokens"] == 16 + 8 and b["layer0_err"] == 0.0
    assert len(b["greedy"]) == SH.decode_tokens + 1
    assert b["logit_err"] <= 1e-5 * max(b["logit_scale"], 1.0)
    for r in c["ranks"]:
        assert r["rotations"] == SH.ring_layers
        # At the tiny width every layer's K/V meet atol 1e-5 outright.
        assert max(max(e) for e in r["kv_err_kernel"]) <= 1e-5
    for k in ("designs_a", "designs_b", "designs_c"):
        assert set(out[k]) == {"mixed_tc_bf16", "mixed_f32", "decode_split"}
        assert not any(out[k].values())  # the CPU launches no kernel


def test_sync_sites_outside_the_allowlist_fail_the_check():
    lines, _ = cs.lint_sync_lines()
    waived = sorted(lines)[0]
    assert cs.check_sync_sites({waived: 3})["hot"] == {waived: 3}
    assert cs.check_sync_sites({("torch/cuda/streams.py", 1): 1})["hot"] == {}
    with pytest.raises(AssertionError, match="does not waive"):
        cs.check_sync_sites({("dynamo_exp_tpu_torch/engine/engine.py", 1): 1})
