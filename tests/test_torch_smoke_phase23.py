"""``chip_smoke.py``'s phase 23 rehearsed on the CPU at a small size: the
KV tiers at tp=2 over gloo CPU ranks. (a) ``run.py --tp 2
--host-cache-pages`` under pressure: every stream completes, rows swap
out and back in, both ranks' page moves and digests agree, a rerun's
tokens are the run's; float32 tp=2 with the tier gives the tp=1
engine's tokens. (b) each degree's G3 store read by a restarted engine
of the other: persist prefix hits and the writer's tokens. (c) a tp=1
prefill worker feeds a tp=2 decode worker over the TCP plane (the
decode worker's local tokens, no fallback, no checksum failure), and a
suffix-only transfer skips the pinned prefix. (d) SIGTERM to a
``run.py --tp 2`` worker mid-stream migrates its streams' KV to a tp=1
survivor and every stream completes. On the CPU the kernel wrappers
compute their plain versions and no kernel is counted."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, hidden_size=256, intermediate_size=512,
                max_position_embeddings=1024)
SH = cs.Phase23(device="cpu", prompt_lens=(16, 32, 48, 64, 16, 80, 48, 32), max_tokens=16,
                host_pages=128, disagg_lens=(40, 64, 96), disagg_tokens=4, prefix_tokens=32,
                suffix_tokens=16, num_pages=256, slots=8, reclaim_streams=4,
                reclaim_prompt=64, reclaim_tokens=160, reclaim_after_tokens=8,
                timeout_s=300.0)


def test_smoke_phase23_on_cpu(monkeypatch):
    monkeypatch.setenv("DYN_RUNTIME_LEASE_TTL_S", "2")
    out = cs.phase23(torch, np, pkg, tra, "cpu", sh=SH, mcfg=SMALL)
    a, b, c, d = out["a"], out["b"], out["c"], out["d"]
    assert all(t["swapped_out"] > 0 and t["swapped_in"] > 0 for t in a["tiers"][:2])
    assert a["moves"][0]["page_gather"]["bytes"] > 0
    assert min(b["hits"]) > 0
    assert c["remote"] == len(SH.disagg_lens) + 1
    assert c["skipped"] == SH.prefix_tokens // cs.PS and c["recv_bytes"] > 0
    assert d["summary"]["migrated_pages"] > 0 and d["seeded"] == d["summary"]["migrated_pages"]
    for k in ("designs_a", "designs_b", "designs_c", "designs_d"):
        assert not any(v for key, v in out[k].items() if key != "grouped_mm")
