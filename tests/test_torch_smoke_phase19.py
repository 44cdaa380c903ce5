"""``chip_smoke.py``'s phase 19 rehearsed on the CPU at a small size:
``python -m dynamo_exp_tpu_torch.sdk.serve`` serving the agg_router
graph (KV routing) with ``device: cpu`` on worker slots ``0,0`` and the
planner CLI beside it, then the agg graph at float32. (a) 8 chats
admitted together, twice: [DONE], usage, identical reruns; (b) the
planner adds a second CudaWorker under load, both serve the second
wave, and it removes one once idle: exactly one add and one remove, no
restart; (c) the graph's greedy tokens equal a ``TorchEngine``'s on the
same weights, up to a float32 tie. The kernel-launch checks are the
card's only."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=1024, hidden_size=128, intermediate_size=256, num_layers=2,
                max_position_embeddings=1024)
# Each decode window slowed by 0.2 s: a wave (two rounds of 4 rows here)
# outlasts the planner's 1 s rounds. On the card wave 1 ends long before
# the second worker is up; on a loaded CPU it may end after, and the
# planner then averages the first worker's last rows with the new one's
# idle samples: the scale-down threshold of 0.1 keeps that from reading
# as a fleet to shrink.
SH = cs.Phase19(device="cpu", prompt_lens=(24, 40, 56, 72, 32, 48, 64, 80), max_tokens=8,
                num_pages=56, slots=4, max_model_len=288, wave=8, wave_lens=(160, 190),
                wave_tokens=40, metric_s=0.2, adjust_s=1.0, kv_down=0.1, f32_layers=2,
                f32_tokens=8,
                window_delay_s=0.2, boot_s=120.0, scale_s=60.0)


def test_smoke_phase19_on_cpu():
    out = cs.phase19(torch, np, pkg, tra, "cpu", sh=SH, mcfg=SMALL)
    b = out["b"]
    assert b["load_to_add_s"] > 0 and b["add_to_visible_s"] > 0
    assert len(b["designs"]) == 2
    assert out["c"]["lp_err"] <= 1e-3
