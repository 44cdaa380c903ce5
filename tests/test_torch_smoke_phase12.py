"""``chip_smoke.py``'s phase 12 rehearsed on the CPU at a small size:
the port's coordinator CLI, a prefill worker and a decode worker
process (``PrefillWorker`` / ``DisaggDecodeEngine`` around ``TorchEngine``
with ``--device cpu``, spawned as on the card), the HTTP ingress in this
process, at SMALL widths. (a) a burst of remote and local prompts: every
stream finishes at full length, exactly the long prompts went remote,
the decode worker prefilled only the short ones, the bytes sent equal
the pages shipped times a page's bytes, no checksum failure, every
lease confirmed; lone requests through the pair give a direct engine's
tokens; (b) a suffix-only transfer skips the resident prefix; (c) a
lease nobody confirms is reaped after its TTL (1 s here) and the free
pages come back; (d) a worker SIGTERMed mid-stream migrates its
streams' KV to the survivor, which attaches it for the continuations.
The kernel-launch checks are the card's only."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, hidden_size=256, intermediate_size=512, num_layers=4,
                max_position_embeddings=1024)
SH = cs.Phase12(device="cpu", num_pages=256, slots=4, max_model_len=512, max_local=64,
                max_queue=8, remote_lens=(80, 128), remote_n=4, local_lens=(16, 48), local_n=2,
                max_tokens=4, lone_n=2, prefix_tokens=64, suffix_tokens=32, wave=2,
                lease_ttl_s=1.0, reap_by_s=10.0, reclaim_streams=4, reclaim_prompt=64,
                reclaim_tokens=160, reclaim_after_tokens=8)


def test_smoke_phase12_on_cpu(monkeypatch):
    monkeypatch.setenv("DYN_RUNTIME_LEASE_TTL_S", "2")
    out = cs.phase12(torch, np, pkg, tra, "cpu", sh=SH, mcfg=SMALL)
    assert out["a"]["dec"]["remote"] == SH.remote_n
    assert out["b"]["skip"] == SH.prefix_tokens // cs.PS
    assert out["c"]["reaped_after_s"] >= SH.lease_ttl_s
    d = out["d"]
    assert d["migrated_pages"] > 0 and d["hits"] >= d["migrated_pages"]
    assert d["recoveries"] == d["still"] > 0
    assert d["prefill"] < d["sigkill_floor"]
    assert all(st["audit"]["ok"] for st in out["finals"])
