"""``chip_smoke.py``'s phase 8 rehearsed on the CPU at a small size:
chained turns with the sync guard, speculation with continuation drafts
and ngram, the float32 identities and HTTP logprobs all run to their
end and hold their checks (``device="cpu"``, TINY widths, a vocabulary
of 2,048)."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)


def test_smoke_phase8_on_cpu():
    sh = cs.Phase8(device="cpu", prompt_lens=(5, 20, 40, 33), max_tokens=20, f32_tokens=24,
                   repeat_block=8, repeat_times=4, http_tokens=6, lp_prompt_len=24)
    out = cs.phase8(torch, np, pkg, tra, "cpu", logit_err=0.05, sh=sh, mcfg=SMALL,
                    f32_mcfg=replace(SMALL, dtype="float32"))
    a, b, c, d = out["a"], out["b"], out["c"], out["d"]
    assert a["guard"]["guarded"] > 0 and not a["guard"]["errors"]
    assert [r["dispatches"]["chained"] > 0 for r in a["runs"]] == [False, True, True, False]
    assert b["static"]["metrics"]["spec_accepted_tokens"] > 0
    assert all(v["lp_err"] <= 1e-5 for v in c["bursts"].values())
    assert d["entries"] == 2 * sh.http_tokens and d["plain_err"] <= d["tol"]
