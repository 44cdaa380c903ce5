"""``chip_smoke.py``'s phase 21 rehearsed on the CPU at a small size: (a)
the simulator's calibration bridge (each seed's ``overload_burst``
through a live ``TorchEngine`` behind the real ``AdmissionController``
and through ``ClusterSim`` with the same config: completed and shed
counts equal, preemptions within 2) and the service-time fit from the
spans the engine recorded, replayed by ``llmctl sim --trace-in
--fit-spans``; (b) ``llmctl tune --top-k 1`` in a subprocess (the tiny
preset, ``--device cpu``; one candidate, since on the CPU a step's time
grows with its rows and the ranking of the card's three is not the
CPU's): rc 0, one journal line a trial, the candidate served live, the
artifact loads; the contrasting pair ranks
the same in the sim and on the engine (tau 1.0); (c) a boot from the
tuned artifact with ``prewarm_engine``: no build, no capture under
traffic, a rerun's tokens equal (the rehearsal's prewarm leaves out the
mixed keys past 1,024 tokens, which its burst never reaches). On the CPU
the kernel wrappers compute their plain versions and no kernel is
counted."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SH = cs.Phase21(device="cpu", preset="tiny", kv_dtype="float32",
                prompt_lens=(5, 20, 40, 33, 12, 7, 60, 90), max_tokens=6,
                tune_max_model_len=128, timeout_s=300.0, prewarm_max_tokens=1024, top_k=1)


def test_smoke_phase21_on_cpu():
    out = cs.phase21(torch, np, pkg, tra, "cpu", sh=SH, mcfg=TINY,
                     small=replace(TINY, num_layers=4))
    cal = out["calibration"]["seeds"]
    assert [r["seed"] for r in cal] == [0, 1, 2]
    for r in cal:
        assert r["sim"]["completed"] == r["live"]["completed"]
        assert r["sim"]["shed"] == r["live"]["shed"]
    fit = out["fit"]
    assert fit["prefill_token_s"] > 0 and fit["itl_s"] > 0
    assert fit["sim_ttft_p50_s"] > 0 and fit["live_ttft_p50_s"] > 0
    tune = out["tune"]
    assert len(tune["goodput"]) == 1 and tune["top1"] and tune["pair_tau"] == 1.0
    boot = out["boot"]
    assert boot["builds"] == 0 and not any(boot["captures"].values())
    assert len(boot["list_hash"]) == 64
    for k in ("designs_a", "designs_b", "designs_c"):
        assert set(out[k]) == {"mixed_tc_bf16", "mixed_f32", "decode_split"}
        assert not any(out[k].values())  # the CPU launches no kernel
