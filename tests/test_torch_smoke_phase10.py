"""``chip_smoke.py``'s phase 10 rehearsed on the CPU at a small size:
``run.main_async(in=http out=cuda --device cpu)`` with admission bounds,
SLO targets and a trace file, at TINY widths (a vocabulary of 2,048).
(a) overload probes give 429, 429, admitted, admitted, 503, 503 with
``Retry-After`` and the shed counter equals the client's count; (b) a
deadline behind a full pool answers 200 ``error`` with no text, a lone
stream's deadline falls inside its decode and its text is the start of
the same request's without one, a generous deadline changes nothing;
(c) requests by status, TTFT samples, goodput and violations against
the trace file's root spans, a flight dump with every dispatch, no
watchdog dump; (d) telemetry on, off, off, on with equal tokens and
launch counts. The CPU has no CUDA graphs, so the captures-by-kind check
is the card's only; each window's consume is slowed by 100 ms so that,
as on the card, the pool stays busy longer than the deadlines and the
TTFT target."""

import time
from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.engine import TorchEngine
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)


def test_smoke_phase10_on_cpu(monkeypatch):
    consume = TorchEngine._consume_windowed

    def slow(self, pending):
        time.sleep(0.1)
        return consume(self, pending)

    monkeypatch.setattr(TorchEngine, "_consume_windowed", slow)
    # The sleeps bound the pool's busy time from below whatever the
    # host's load: the 8 streams hold it for >= 0.7 s after their first
    # frames (the TTFT target and both deadlines sit inside that), the
    # lone stream decodes for >= 1.2 s. ITL is not held on the CPU.
    sh = cs.Phase10(device="cpu", prompt_lens=(5, 20, 40, 33, 12, 7, 60, 25), stream_tokens=64,
                    probe_tokens=4, slo_ttft_ms=400.0, slo_itl_ms=1e4, deadline_s=0.08,
                    decode_tokens=96, decode_deadline_s=0.5, burst_tokens=6)
    out = cs.phase10(torch, np, pkg, tra, "cpu", sh=sh, mcfg=SMALL)
    assert [p[1] for p in out["probes"]] == [429, 429, "admitted", "admitted", 503, 503]
    assert out["goodput"] > 0 and out["violations"]["ttft"] > 0
    assert out["scrape_bytes"] > 0 and out["families"] == 63  # 59 telemetry + 4 HTTP
    d = out["d"]
    assert d["events"] > 0 and d["guarded"] > 0
