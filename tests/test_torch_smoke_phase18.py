"""``chip_smoke.py``'s phase 18 rehearsed on the CPU at a small size:
``python -m dynamo_exp_tpu_torch.run in=batch:... --tp 2 --device cpu
--dist-backend gloo`` in subprocesses, each rank a process. (a) A bf16
llama at TINY's widths: 8 prompts admitted together and a rerun in new
processes give the same tokens, both ranks' digests equal; (b) float32:
tp=2 gives the tp=1 engine's greedy tokens in this process on the same
seed-0 weights, up to a float32 tie; (c) qwen2_moe (its shared expert)
at tiny widths: a rerun's tokens identical. On the CPU no kernel
launches; the card's run asserts them."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
import dynamo_exp_tpu_torch.models  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY, ModelConfig
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

DENSE = replace(TINY, vocab_size=512, head_dim=16, rope_theta=1e6,
                rms_norm_eps=float(np.float32(1e-5)), model_type="llama")
MOE = ModelConfig.from_hf_config({
    "model_type": "qwen2_moe", "vocab_size": 512, "hidden_size": 64,
    "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_experts": 6, "num_experts_per_tok": 3,
    "moe_intermediate_size": 40, "shared_expert_intermediate_size": 96,
    "norm_topk_prob": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 512, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16"})


def test_smoke_phase18_on_cpu():
    sh = cs.Phase18(device="cpu", prompt_lens=(5, 9, 17, 30, 12, 24, 8, 40), max_tokens=6,
                    moe_prompt_len=10, timeout_s=240)
    out = cs.phase18(torch, np, pkg, tra, "cpu", sh=sh, dense=DENSE,
                     f32=replace(DENSE, dtype="float32"), moe=MOE)
    assert out["backend"] == "gloo" and out["cards"] == 0
    assert [r["rank"] for r in out["a"]["ranks"]] == [0, 1]
    assert out["a"]["comm"]["calls"]["all_reduce"] > 0
    assert out["b"]["lp_err"] <= 1e-4
