"""``chip_smoke.py``'s phase 15 rehearsed on the CPU at a small size
(TINY widths, a vocabulary of 2,048): (a) a conversation's pages demoted
G1 -> G2 -> G3, a hard kill, a reboot over the store that restores every
page from G3 with the evicted bytes and the G1 hit's tokens, then a G2
hit; (b) at float32, a bit flipped in one stored page's read, torn writes
and an ENOSPC contained with the fault-free tokens; (c) ``DYN_KV_STORE``
across two ``run in=http --device cpu`` processes, and a misspelled knob
refused; (d) two engines behind the chaos planes and ``PushRouter``: the
scripted faults inject the same list twice, every stream is whole, the
breaker opens and closes, and a float32 stream cut mid-way equals the
uninterrupted one. On the CPU the kernel wrappers compute their plain
versions. Tolerances: the phase's own (float32 ties within
``chip_smoke.F32_TIE`` in logprob; everything else exact)."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)
SMALL_F32 = replace(SMALL, num_layers=4, dtype="float32")


def test_smoke_phase15_on_cpu():
    sh = cs.Phase15(device="cpu", prompt_lens=(16, 24, 32, 40, 48, 64, 80, 96), num_pages=10, host_pages=12,
                    store_pages=256, hit_tokens=8, f32_len=64, f32_churn=3, f32_pages=8,
                    f32_host_pages=3, flip_at=2, chat_chars=(300, 900),
                    chat_tokens=6, chaos_tokens=20, cut_at=8, chaos_pages=64,
                    process_timeout_s=120.0)
    out = cs.phase15(torch, np, pkg, tra, "cpu", sh=sh, mcfg=SMALL, f32_cfg=SMALL_F32)
    a, b, c, d = out["a"], out["b"], out["c"], out["d"]
    assert a["adopted"] >= 6 and a["evictors"] >= 2 and len(a["tokens"]) == sh.hit_tokens
    assert set(a["ttft"]) == {"cold", "G1 hit", "G2 hit", "G3 hit"}
    assert b["torn"] == 2 and not b["ties"]
    assert c["persist"] == c["restored"] > 0 and c["store_pages"] > 0
    assert d["states"] == ["OPEN", "CLOSED"] and d["recovered"] >= 2 and not d["ties"]
    assert d["injected"][0].endswith(":error")
