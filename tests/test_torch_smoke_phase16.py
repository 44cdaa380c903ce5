"""``chip_smoke.py``'s phase 16 rehearsed on the CPU at a small size:
(a) a tiny mixtral through ``run.build_cuda_engine(--model-path <dir>
--random-weights)``: phase 5's prompts (the longest decoding longer),
then its first ids ending inside two of its pages, admitted while it
decodes: every stream whole, each sharer copied its shared tail, a
rerun token-identical; (b) tiny qwen3_moe, qwen2_moe and mixtral
configs written as config.json: the MoE FFN's grouped products against
their plain version (on the CPU both are the per-expert loop, so the
logits are equal), the FFN at a decode batch and a chunk; (c) a float32
dense model with prefix sharing on and off: the same tokens; (d) the
tiny mixtral with drafts of each row's continuation, so verify spans
run the MoE layers. On the CPU the kernel wrappers compute their plain
versions and nothing is timed. Tolerances: the phase's own (float32
ties within ``chip_smoke.F32_TIE`` in logprob; everything else
exact)."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY, TINY_MOE
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

MOE = replace(TINY_MOE, vocab_size=2048, max_position_embeddings=512)
_HF = dict(vocab_size=2048, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
           torch_dtype="bfloat16")
CHECK = {
    "qwen3_moe": {**_HF, "model_type": "qwen3_moe", "head_dim": 16, "num_experts": 16,
                  "num_experts_per_tok": 8, "moe_intermediate_size": 32,
                  "norm_topk_prob": True},
    "qwen2_moe": {**_HF, "model_type": "qwen2_moe", "num_experts": 12,
                  "num_experts_per_tok": 4, "moe_intermediate_size": 40,
                  "shared_expert_intermediate_size": 96, "norm_topk_prob": False},
    "mixtral": cs.hf_config(MOE),
}
F32 = replace(TINY, vocab_size=2048, max_position_embeddings=512, num_layers=4,
              dtype="float32")


def test_smoke_phase16_on_cpu():
    sh = cs.Phase16(device="cpu", layers=2, prompt_lens=(5, 20, 40, 33, 12, 7, 60, 90),
                    max_tokens=6, long_tokens=40, share_lens=(37, 75), check_layers=2,
                    check_len=64, decode_rows=8, chunk=32, f32_layers=4)
    out = cs.phase16(torch, np, pkg, tra, "cpu", sh=sh, mcfg=MOE, check_cfgs=CHECK,
                     f32_cfg=F32)
    a, b, c = out["a"], out["b"], out["c"]
    assert a["cow_copies"] >= 2 and a["guarded"] > 0
    assert [len(t) for t in a["tokens"]] == [6] * 7 + [40] + [6, 6]
    assert set(b) == {"qwen3_moe", "qwen2_moe", "mixtral"}
    for r in b.values():
        assert r["max_abs_err"] == 0.0 and r["argmax_agreement"] == 1.0
        assert set(r["ffn"]) == {8, 32} and all(v["ms"] is None for v in r["ffn"].values())
    assert c["cow_copies"] >= 1 and not c["ties"]
    d = out["d"]
    assert d["verify_rows"] > 0 and d["accepted"] > 0 and d["spec_graph_replays"] is None
