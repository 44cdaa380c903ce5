"""``chip_smoke.py``'s phase 13 rehearsed on the CPU at a small size:
``run.main_async(in=http out=cuda --device cpu)`` under KV pressure with
a host tier, ``--trace-file``, ``--profiler-port`` and
``DYN_WORKLOAD_REF``, at TINY widths (a vocabulary of 2,048). (a) every
request's offline anatomy sums to its root span, some request stalled,
the live exemplars agree with the offline anatomy (dominant component,
the engine's share) and ``dynamo_request_seconds`` holds the engine's
totals; (b) the live digest equals the trace file's and a second run's;
(c) drift low after the matching burst, high after an unlike one, the
gauge equal to ``metrics()``; (d) ``capture_trace`` and the listener
each write a trace (the kernel names are the card's only) and no graph
is captured meanwhile; (e)
``llmctl`` on the phase's trace file and flight dump. The drift burst
is cut to the CPU's context (prompts of 90-100 tokens, 2 tokens each, 32
of them) so that it stands as far from the reference as the card's
16-32-token burst stands from phase 5's prompts."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra
from dynamo_exp_tpu_torch.telemetry import COMPONENTS
from dynamo_exp_tpu_torch.telemetry.fingerprint import DRIFT_ALERT_THRESHOLD

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)
LENS, TOKENS = (8, 20, 40, 33, 64, 17, 50, 70), 24


def test_smoke_phase13_on_cpu():
    need = cs.pages_needed(LENS, TOKENS)
    sh = cs.Phase13(device="cpu", prompt_lens=LENS, max_tokens=TOKENS,
                    num_pages=int(need * 0.89), host_pages=128, drift_n=32, drift_lens=(90, 100),
                    drift_tokens=2, profile_lens=(8, 20), profile_tokens=6, profile_lead_s=0.3,
                    profile_ms=4000)
    out = cs.phase13(torch, np, pkg, tra, "cpu", sh=sh, mcfg=SMALL)
    a = out["a"]
    assert a["swapped_out"] + a["preempted"] > 0
    assert a["tap_calls"] > 0 and a["live_err"] <= cs.LIVE_OFFLINE_S
    assert a["sum_err"] <= cs.ROUND_S * (len(COMPONENTS) + 1)
    assert out["drift_low"] < DRIFT_ALERT_THRESHOLD < out["drift_high"]
    assert set(out["profile"]) == {"capture_trace", "--profiler-port listener"}
