#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dynamo_exp_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. the card's name and power limit, the torch and CUDA versions;
2. build the ragged attention kernels from ``dynamo_exp_tpu_torch/csrc``
   (one nvcc per source, all started together, sm_90a) and load them;
   print each kernel's registers and spills;
3. hold both kernel entry points against their plain PyTorch version on
   the card at the llama-8b attention shapes (H=32, Hkv=8, D=128, page
   size 16): the mixed shape (q_tile=8) with ragged spans, page-boundary
   lengths, 1-token rows and an empty tile, and the decode shape
   (q_tile=1) with inactive rows, which must be exact zeros; once with
   bf16 pools (the main path's: the tensor-core mixed kernel and the
   split-KV decode kernel) and once with float32 pools at a tight
   tolerance (the 3xTF32 tensor-core mixed kernel and the split-KV
   decode kernel); the bf16 kernels are also held, at a tolerance set by
   bf16's rounding, against the plain version on float32 copies of the
   same inputs; each live row of the float32 mixed batch run alone
   equals the same row in the batch, bit for bit (batch invariance);
   the mixed shape also on a stream padded to its token bucket as the
   engine pads it (a run of 50 tiles of the scratch row at position
   -1), on both dtypes: equal to the plain version, exact zeros at every
   padding token; time both mixed kernels and the bf16 decode kernel, the plain
   version and, as a yardstick only, one ``scaled_dot_product_attention``
   call over the gathered pages; then (``check_windowed``) all three
   designs at gemma2-9b's sliding layers (H=16, Hkv=8, D=256, window
   4,096, softcap 50, scale 256^-0.5) and at mistral-7b's window (H=32,
   Hkv=8, D=128, window 4,096), on mixed rows of 300-6,000 tokens (past
   the window and inside it) and decode rows of up to 6,000, both pool
   dtypes, at the same tolerances, each float32 mixed row alone
   bit-equal to the batch, timed beside the plain version, the bound
   (the keys each query sees) and SDPA with the window mask, or under a
   softcap (which SDPA cannot compute) one compiled ``flex_attention``
   call with the softcap as its ``score_mod``;
4. llama-8b's logits through the kernel agree with the plain path on a
   short prompt;
5. the main path: ``TorchEngine`` serving llama-8b at full width and
   depth (random bf16 weights from a seed) answers 8 concurrent requests
   (prompts of 64 to 2048 tokens, 32 tokens each, seven greedy and one
   seeded at temperature 0.8); every request finishes with ``length``
   and 32 tokens, both entry points' launch counters rose during the
   run, the bf16 mixed dispatches went through the tensor-core kernel
   and the decode steps through the split-KV kernel, and a rerun of the
   same requests gives the same tokens; the model is then freed;
6. the entry point a user calls: ``run.main_async(in=http out=cuda)``
   in this process serves a model directory written here (the
   llama-8b preset's config.json, read back equal to the preset; a
   Llama-3-layout byte-level BPE tokenizer.json of 128,256 entries
   with merges learned from README.md; a Llama-3-style chat template;
   EOS 128009) with the same seeded random weights. A stdlib client
   sends (a) phase 5's requests as 8 streaming ``/v1/completions``,
   admitted together, and again after the prefix cache is dropped;
   (b) 2 streaming chats; (c) a unary completion; (d) (c) again with a
   stop string cut from (c)'s text; and a lone greedy request, also
   served straight by a ``TorchEngine`` on the same weights. Every
   stream ends with ``[DONE]``; finish reasons and usage are checked,
   the rerun's text is identical, (d)'s text is (c)'s up to the stop
   string, the lone request's HTTP text equals its direct tokens
   decoded, and every attention launch of the phase went through the
   tensor-core mixed and the split-KV decode kernels. Printed: TTFT at
   the edge (p50, max), the mean gap between content frames, tokens/s
   and wall time of (a) beside phase 5's, and the host's encode time;
7. KV pressure, with a G2 host tier of 1024 pages (pinned memory) fed by
   the copy stream's side CUDA streams. (a) phase 5's 8 requests at 128
   tokens each (466 pages of 16 at their end) on a 416-page pool,
   llama-8b at full width and depth, bf16: all finish ``length`` with
   128 tokens, rows were swapped out or preempted, the page audit is
   clean with no page held, both bf16 kernels ran; printed: wall,
   tokens/s, swaps, preemptions and the copy streams' pages, bytes and
   GB/s each way (CUDA events). (b) the 2048-token prompt three times:
   cold, a G1 hit, then, after 4 other 2048-token prompts evicted its
   pages to the host tier, a G2 hit: the host tier's bytes and the
   injected pages' bytes equal (on the card) what the pages held when
   they were evicted, and the G1 and G2 hits give the same tokens. (c)
   llama-8b's width at 4 layers with float32 weights and pools: the
   pressured burst of (a) gives each request's tokens run alone on the
   same engine, through the float32 mixed kernel and the split-KV
   decode kernel.

8. chaining, speculation and logprobs. (a) phase 5's prompts, all
   greedy, at 128 tokens, llama-8b bf16 full depth, 1096 pages (no
   pressure): ``chained_decode`` off, on, on, off; every row finishes
   with 128 tokens, equal in all four runs, the chained runs chained,
   every chained dispatch of the first chained run ran under
   ``torch.cuda.set_sync_debug_mode("error")`` (the engine instance's
   dispatch wrapped from outside), the page audit is clean; printed per
   run: wall, tokens/s, chained / windowed / mixed dispatches, loop CPU
   seconds, wasted steps (``--profile``: the device idle share of a
   chained and an unchained run). (b) (a)'s burst with speculation, a
   drafter proposing each row's (a) continuation (verify spans of 9
   tokens, mostly accepted), then ``ngram`` on a prompt built to
   repeat: verify rows were accepted through the tensor-core mixed
   kernel; printed: proposed / accepted / emitted, tokens equal to
   (a)'s and, at the first divergence, the logit gap (not asserted at
   bf16). (c) llama-8b's width at 4 layers, float32: a greedy and a
   seeded burst with logprobs; chained, unchained, speculation (ngram
   and continuation drafts) and each request alone give equal tokens
   (the last three score positions in other batch shapes, so a row may
   part at a float32 tie: two greedy candidates within 1e-4 in
   logprob; it is compared up to there), chained and unchained equal
   logprobs (atol 1e-5), through the float32 mixed and split-KV kernels. (d) over HTTP (``run.main_async``):
   a streaming chat with ``top_logprobs: 5`` and a streaming legacy
   completion with ``logprobs: 5``: one entry per token in every
   content frame, chosen logprobs <= 0 and the top-1 (greedy), and the
   completion's logprobs within 4x phase 4's logit error of
   log_softmax of the plain path's logits at the same positions.

9. real checkpoints and warm boot. (a) seeded random weights at
   llama-8b's width and 4 layers (bf16, about 3.9 GB) written as two
   safetensors shards (``models.loader.save_safetensors``) beside phase
   6's config.json and tokenizer, served through ``run.main_async(in=http
   out=cuda --model-path <dir>)`` without ``--random-weights``: the
   weights on the card are bit-equal to the in-memory ones, phase 5's
   burst over HTTP gives the in-memory weights' tokens (HTTP text and
   the loaded engine's tokens against an in-memory engine's, same batch
   shape); printed: write and load seconds, GB/s read; the directory is
   deleted. (b) ``run.build_cuda_engine(--preset llama-8b --prewarm
   --compile-cache-dir <tmp> --spec ngram)`` at full width and depth:
   every window and mixed variant (112 and 80 keys, verify spans too)
   captured as a CUDA graph before traffic (printed: variants, graphs and
   seconds of each kind, the graph pool's bytes, one kernel build into
   the cache directory); then phase 8 (a)'s greedy burst and phase 5's
   burst (speculation set aside) and a speculation burst (8 rows, each
   a block of 64 random ids repeated 4 times, 128 tokens, the n-gram
   drafter) through it and through an eager engine on the same weights
   (``cuda_graphs=False``), in turns (graphed, eager, eager, graphed):
   tokens bit-equal, launch counts equal, every mixed dispatch of a
   graphed run replayed (verify spans from verify-span graphs), no
   graph captured after the prewarm; printed: wall, tokens/s,
   loop-thread CPU seconds, replays and dispatches of each run, and each
   mixed dispatch's flat tokens before and after padding to its bucket
   (``--profile``: the device idle share, graphed and eager). (c) a new
   process boots ``--preset llama-1b --prewarm`` against the same cache
   directory: ``builds: 0`` (no nvcc).

10. the observable, overload-protected edge: ``run.main_async(in=http
   out=cuda)`` serving llama-8b at full width and depth (random weights
   from seed 0, no prewarm: first-use captures under traffic) with
   ``--max-inflight 10 --shed-watermark 6 --slo-ttft-ms 1000
   --slo-itl-ms 100 --trace-file``. (a) phase 5's 8 prompts as streams of
   256 tokens hold the edge at 8 in flight; probes low, normal, high,
   high, high, low get 429, 429, admitted, admitted, 503, 503 (each
   refusal with ``Retry-After``); every admitted request finishes at
   full length; ``dynamo_requests_shed_total{priority,code}`` equals
   the client's count; the in-flight gauge returns to 0. (b) behind a
   full pool, ``timeout_s`` 0.5 gets the JAX service's answer (200,
   ``finish_reason`` ``error``, no text) and
   ``dynamo_deadline_exceeded_total{stage=engine_admission}`` +1; a lone
   1024-token stream with ``timeout_s`` 3 finishes ``error`` mid-decode
   (``{stage=decode}`` +1) with text equal to the same request's
   without a deadline at that length; ``timeout_s`` 600 changes
   nothing; page audits clean. (c) requests by status, TTFT samples,
   goodput + violations (against the trace file's root spans),
   ``dynamo_compile_seconds`` counts (= graphs captured by kind), a
   ``dump_all`` flight dump holding every dispatch, no watchdog dump,
   both bf16 kernels launched; printed: the scrape's bytes and
   families. (d) phase 5's burst straight to ``TorchEngine`` with
   telemetry on, off, off, on (``flight_events``,
   ``profile_dispatches``): tokens and launch counts bit-equal, equal
   flight events in the two "on" runs, every dispatch of the "on" runs
   under ``torch.cuda.set_sync_debug_mode("error")``; printed: walls
   (``--profile``: idle shares).

11. the distributed runtime plane and the KV-aware router: the port's
   coordinator (its CLI, a subprocess), two worker processes (spawned;
   each runs ``run.main_async(in=dyn://smoke.llm.generate out=cuda
   --random-weights --num-pages 2048 --max-decode-slots 8 --kv-dtype
   bfloat16)``, llama-8b at full width and depth from seed 0, no
   prewarm, and writes its launch counters, prefix hits and computed
   prefill tokens to a file every 0.25 s) and the ingress in this
   process (``run.main_async(in=http out=dyn://… --router-mode kv``,
   then ``round-robin``; no ``--model-path``: the model arrives through
   the ``ModelWatcher``). Phases 5-10's engines are freed first. (a) the
   model is listed and both instances are in discovery within 60 s of
   the second worker's start; (b) 16 groups of a 1024-token prefix and
   4 suffixes of 64-256 tokens, 32 greedy tokens each, in two waves (each
   group's first request, then the other 48 at once), once under kv and
   once under round-robin on other groups: every stream finishes
   ``length`` at 32 tokens, the kv decisions' overlap blocks (the
   ``kv-hit-rate`` subject) equal the prefix-hit pages the chosen
   workers attached, kv computes fewer prefill tokens than
   round-robin, and each worker launched the tensor-core mixed and the
   split-KV decode kernels; (c) phase 6's lone greedy request, sent
   twice under round-robin (each worker serves it once), gives phase
   6's direct engine's tokens bit for bit; (d) 8 streams of 256 tokens
   (logprobs 1) under round-robin, one worker SIGKILLed while they
   stream: every stream finishes at full length with ``seq_index``
   strictly rising to 256 = its logprob entries, the ingress's
   ``dynamo_request_recoveries_total`` equals the streams on the killed
   worker and ``dynamo_tokens_deduplicated_total`` the client's
   duplicate indices (0), and after the lease TTL the model is still
   listed with one instance. Printed: boot to registration, both
   prefill totals, wave 2's TTFT p50 / p95 in each mode, the ingress's
   block-hash time per 1024 and 2048 tokens, the phase's wall. The
   survivor drains on SIGTERM; every process the phase started is
   stopped.

12. disaggregated prefill/decode and spot reclaim, llama-8b at full
   width and depth (seed 0, 2048 pages of 16 in each worker, no
   prewarm). A direct ``TorchEngine`` first serves (a)'s lone prompts
   and (b)'s prompts, each alone (the reference), and is freed. Then the
   port's coordinator (its CLI), a prefill worker process
   (``TorchEngine`` + ``PrefillWorker`` on ``prefill_queue_name``,
   ``kv_lease_ttl_s`` 3) and a decode worker process (``TorchEngine`` +
   ``KvPageReceiver`` + ``DisaggConfigWatcher`` +
   ``DisaggDecodeEngine``, ``max_local_prefill_length`` 1024,
   ``max_prefill_queue_size`` 8, served on
   ``dyn://smoke12.disagg.generate`` with ``register_llm``), wired as
   the SDK components wire theirs, each writing its counters to a file
   every 0.25 s; the ingress (``in=http out=dyn://…``) in this process.
   (a) 16 greedy prompts of 1280-2048 tokens and 8 of 64-256, 32 tokens
   each, at once over HTTP: all finish ``length`` with exact usage;
   exactly 16 remote prefills, no fallback; the decode worker computed
   the local prompts' prefill tokens only and injected the remote
   prompts' pages; bytes sent = received = pages x ``kv_page_nbytes``;
   no wire checksum failure or failed transfer; leases granted =
   confirmed, none active; the prefill worker launched the bf16 mixed
   kernel, the decode worker both bf16 kernels. 4 lone greedy requests
   through the pair (token level), each alone, are bit-equal to the
   direct engine. (b) a 1024-token prefix + 512-token suffix alone,
   then 8 requests with that prefix and new suffixes, one at a time:
   64 blocks skipped each, only the suffixes' pages shipped, tokens
   equal to the direct engine's (the full-transfer tokens, as (a)'s
   lone requests show). (c) a ``RemotePrefillRequest`` put straight on
   the queue whose ``return_addr`` reads frames and never acks: the
   prefill worker's ``dynamo_kv_lease_reclaims_total`` grows by its
   pages 3-10 s after the push and its free pages return. Both workers
   stop on SIGTERM with clean page audits. (d) two aggregated workers
   (``run.main_async(in=dyn://smoke12.agg.generate out=cuda)``, prefix
   sharing on) behind a ``round-robin`` ingress: 8 greedy streams of
   1024-token prompts, 256 tokens each (logprobs 1); once each has 32
   tokens one worker gets SIGTERM (the reclaim notice) and, once its
   triage has reported, SIGKILL (the grace window's end): it migrated
   pages; every stream finishes ``length`` at full usage with
   ``seq_index`` rising and no duplicate; recoveries = the streams it
   still held; the survivor seeded the migrated blocks and its prefix
   hits on the continuations cover them; the continuations computed
   fewer prefill tokens than a SIGKILL failover's floor (their prompts
   and the tokens streamed at the notice). Printed: transfer bandwidth
   and the ledger's learned link bandwidth, extract and inject times
   per page, remote and local TTFT p50 / p95, the triage's seconds and
   pages, tokens equal to an uninterrupted run (not asserted at bf16),
   the phase's wall. Phase 11 also runs ``python -m
   dynamo_exp_tpu_torch.llmctl`` in subprocesses after its waves:
   ``http list`` lists the model, ``top --json`` both workers. In (a)
   the two workers record spans under ``DYN_TRACE_FILE`` (one file a
   process) and the ingress to a file beside it: each remote request's
   trace, read back with ``timeline.load_spans``, spans the ingress, the
   prefill and the decode process, has transfer hops and a
   ``kv_transfer`` anatomy component above 0; the median component
   shares of remote against local requests are printed. In (d)
   ``llmctl reclaim <victim> --grace-s 30`` flips the victim to
   ``reclaiming`` before the SIGTERM.

13. request anatomy, the workload fingerprint and drift, the profiler
   and ``llmctl``, llama-8b at full width and depth over HTTP
   (``run.main_async``, bf16, seed 0) with ``--trace-file``,
   ``--profiler-port`` and ``DYN_WORKLOAD_REF`` pinned to a
   fingerprint built beforehand from the planned burst's lengths,
   under phase 7 (a)'s KV pressure (8 slots, 416 pages, 1024 host
   pages; phase 5's eight prompts, 128 tokens each). (a) every
   request's ``anatomy_from_spans`` components sum to its root
   ``http_request`` span's duration (within the 6-decimal rounding of
   the terms), some request has a nonzero ``swap_stall``, the live
   exemplar ring (``metrics()["anatomy_slow"]``) and the offline
   anatomy name the same dominant component for each request and agree
   on the engine's share (every component but ``other``) within 1e-5 s,
   and ``dynamo_request_seconds{component}`` on ``/metrics`` equals the
   engine's ``anatomy_totals``; during (a) the anatomy and fingerprint
   taps run under ``torch.cuda.set_sync_debug_mode("error")``. (b) the live
   fingerprint's digest equals ``fingerprint_from_spans`` on the trace
   file, and a second run of the burst (new prompts of the same
   lengths) hashes the same. (c) ``dynamo_workload_drift_score`` is
   below ``DRIFT_ALERT_THRESHOLD`` after the matching burst, above it
   after 16 prompts of 16-32 tokens with 8 tokens each, and equal to
   ``metrics()["workload_drift_score"]``. (d) after the graphs of a
   small burst are captured and a short first trace has started CUPTI
   (timed: seconds), ``capture_trace`` around a run of that
   burst and a capture through the ``--profiler-port`` listener around
   another (each with new prompts of the same lengths, sent one by
   one) each write a trace naming both bf16 kernels, and no graph
   is captured while they record; their kernel counts are printed
   beside the launch counters' delta. (e) ``llmctl trace <id> --why``, ``slow``,
   ``fingerprint --json --ref``, ``flight --why`` and ``audit`` on the
   phase's own trace file and flight dump exit 0 and name the request
   (or the digest). Printed: anatomy shares, the taps' seconds against
   the burst's wall, the drift scores, the digests.

14. the gemma2 family, head dim 256, through both bf16 kernels. (a)
   ``TorchEngine`` serving the ``gemma2-9b`` preset at full width and
   depth (42 layers, hidden 3584, 16/8 heads of 256, ffn 14336, vocab
   256000, a 4,096 window on even layers, softcaps 50 / 30, random bf16
   weights from seed 0, 9.24 B parameters): 8 requests admitted
   together (prompts of 4,500 and 6,000 tokens, past the window, and six
   of 64-1,024; 32 tokens each, one seeded at temperature 0.8): all
   finish ``length``, a rerun on a new engine is token-identical, both
   bf16 kernels launched; printed: TTFT, tokens/s, wall. (b) 4 layers of
   gemma2-9b's width and of mistral-7b's (D=128, a window on every
   layer): one 4,500-token prompt's logits (every 64th position before
   the window, every one past it) through the kernels and the plain
   versions, within 5 % of the logit scale (phase 4's bound); argmax
   agreement printed. (c) ``run.main_async(in=http out=cuda
   --model-path <dir> --random-weights)`` on a gemma2 directory written
   here (the preset's config.json, read back equal; a 256,000-entry
   SentencePiece-BPE tokenizer.json in Gemma's layout, byte fallback
   included; Gemma's chat template): 8 streaming chats at once, one of
   README text past the window: ``[DONE]``, finish reasons, exact
   ``usage``, both bf16 kernels; a lone greedy request's HTTP text
   equals a direct engine's tokens decoded.

15. the G3 persistent KV tier and the chaos planes. (a) llama-8b at
   full width and depth, bf16, G1 160 pages, G2 256, a G3 store in a
   fresh temporary directory (at most 1,024 pages: 2 GiB): phase 5's
   2,048-token prompt cold, then as a G1 hit (its 128 pages' bytes
   saved on the card), then 2,048-token prompts until all 128 pages
   went G1 -> G2 -> G3 through the demotion write-through; a hard kill
   (no drain, no seal); a new ``TorchEngine`` over the directory (the
   same weight tensors): ``boot_scan`` adopted the pages, the rerun's
   ``persist`` hits are its 128 pages, the injected bytes equal the
   saved ones, its tokens the G1 hit's, the page audit and the G3
   ledger are clean with no ledger violation, and its dispatches and
   in-loop ledger checks ran under ``torch.cuda.set_sync_debug_mode(
   "error")``; then a G2 hit after other prompts pushed the pages out of
   G1. Printed: pages demoted and the G3 write GB/s, boot-scan seconds
   and pages, the G3 read and G3 -> G1 restore GB/s, TTFT cold, as a G1,
   G2 and G3 hit. The hashes went through the C++ library
   (``native/blockhash.cpp``). (b) llama-8b's width at 4 layers,
   float32: a 512-token conversation stored in G3 (a graceful stop); a
   ``StorageChaos`` bit flip in the read of its sixth page: that page
   quarantined, ``kv_store_checksum_failures`` 1, five pages restored and
   the rest re-prefilled; two torn writes quarantined by the next
   ``boot_scan``; an ENOSPC: ``kv_store_degraded`` 1, served G2-only;
   every run's tokens equal the fault-free run's (float32 ties within
   ``F32_TIE``). (c) ``python -m dynamo_exp_tpu_torch.run in=http
   out=cuda --model-path <dir> --random-weights --host-cache-pages N``
   with ``DYN_KV_STORE=<dir>`` (llama-8b, the model directory of phase
   6's layout): chats 1, 2, 3 and chat 1 again (a G2 hit), then SIGTERM
   (drain and seal); a second process over the directory answers chat 1
   with the same text, ``dynamo_kv_prefix_hits_total{kind="persist"}``
   equal to the first process's G2 hits and ``dynamo_kv_store_pages`` >
   0 on ``/metrics``; ``DYN_KV_PACKNG=1`` exits non-zero naming the
   accepted spellings. (d) two ``TorchEngine``s sharing llama-8b's
   weights (bf16, full depth) served as two instances on the in-process
   transport wrapped in ``ChaosRequestPlane`` and ``ChaosDiscovery``,
   behind ``PushRouter`` with the journal: a seeded script (a crash at
   stream start, a crash at token 16, a partition of one instance
   healed after one wave, a discovery watch flap) over 8 greedy
   requests and a seeded one, run twice: every stream whole (32 tokens)
   and gapless (each frame's tokens start where the client's stream
   ends, by the index the worker set before the journal saw the frame:
   no gap, no duplicate), recoveries counted, the
   partitioned instance's breaker opened and closed, ``injected`` equal
   in both runs, both page ledgers clean; at float32 (4 layers) a
   stream cut at token 16 equals the uninterrupted one (ties within
   ``F32_TIE``).

Phases 5-10 run with CUDA graphs of every dispatch (the engine's default
on a card): each window and mixed key is captured at its first dispatch
(or by phase 9's prewarm) and replayed after; the launch counters add a
graph's recorded launches at each replay, so they count what an eager
run counts, launch for launch (phase 9 (b) checks that). Every mixed
stream is padded to its token bucket, graphed or eager.

Phase 3 also holds the mixed kernels on phase 8's verify spans (9
queries a row: two q tiles, the second mostly padding) and times both
there. The float32 mixed kernel's bound is at 3xTF32's rate (494.7 / 3
TFLOP/s); its bound at float32's 67 TFLOP/s outside the tensor cores is
printed beside it (``bound_ms_ffma``). The kernels' line has one entry
per kernel design (the
bf16 mixed, split-KV decode and float32 mixed kernels), with its
launches in the main path of its dtype (phase 5; phase 7 (c) for
float32), over HTTP (phase 6), under KV pressure (phase 7 (a), (c)),
in phase 8 (a)-(d) and phase 9 (a) (the loaded checkpoint) and (b) (a
graphed phase 8 (a) burst after the warm boot, and the graphed
speculation burst: ``launches_warm_boot_spec``), and phase 10's HTTP
traffic (``launches_edge``) and telemetry turns
(``launches_telemetry_turns``, one run), and phase 11's two worker
processes (``launches_cluster``, summed), and phase 12's prefill worker,
decode worker and two reclaim workers (``launches_disagg_prefill``,
``launches_disagg_decode``, ``launches_reclaim``), and phase 13's
observed HTTP burst (``launches_observability``), and phase 14's engine
(``launches_gemma2``), HTTP (``launches_gemma2_http``) and 4-layer
checks (``launches_window_logits``), and phase 15's G3 engines
(``launches_g3``: (a) and (b)) and chaos-plane engines
(``launches_chaos``: (d)); both mixed entries also carry the
verify spans' timing (``verify_*``), and every entry phase 3's windowed
cases in its own dtype (``gemma2_d256_softcap_window``,
``mistral_d128_window``; the decode design also ``*_f32``; a softcap
case's ``library_ms`` is one ``flex_attention`` call compiled with
``torch.compile``, with the softcap as its ``score_mod`` and the window
as its block mask, since SDPA has no softcap; null where it cannot run).

The last three lines of standard output are the card's name and power
limit, the kernels' JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12  # TF32 tensor cores, dense
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
# float32-accurate products as 3xTF32 (three TF32 products each): the
# float32 mixed kernel's rate.
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3

# llama-8b attention shapes.
H, HKV, D, PS = 32, 8, 128, 16
PROMPT_LENS = (64, 160, 320, 512, 768, 1024, 1536, 2048)
MAX_TOKENS = 32
SEEDED = 5  # index of the request sampled at temperature 0.8
SEEDED_OPTIONS = {"temperature": 0.8, "seed": 1234}
# Mixed dispatch spans (q_len, kv_len): prefill chunks of 512 at several
# offsets, a short prompt, decode tokens at page boundaries and mid-page.
MIXED_SPANS = [
    (512, 512), (512, 1024), (512, 2048), (64, 64), (1, 17), (1, 1),
    (16, 32), (1, 2049), (1, 1536),
]
# Verify spans of phase 8 (b): every row of phase 5 feeding its last
# token and 8 drafts (9 queries: two q tiles, the second 7/8 padding)
# at its 64th generated token.
VERIFY_SPANS = [(9, n + 64 + 8) for n in PROMPT_LENS]
# Decode rows: the main path's lengths at its 16th token, two inactive.
DECODE_LENGTHS = [n + 16 for n in PROMPT_LENS]
DECODE_LENGTHS[1] = DECODE_LENGTHS[6] = 0
# Tolerances (atol, rtol) by pool dtype: see check_kernels.
TOL = {"bfloat16": (2e-2, 2.0**-7), "float32": (1e-4, 0.0)}
# Phase 7: phase 5's prompts at 128 tokens each need 466 pages of 16 at
# the burst's end; the pool holds about 0.89 of that, the host tier 1024
# pages (2 GiB pinned at llama-8b's 2 MiB a page).
PRESSURE_TOKENS = 128
PRESSURE_PAGES = 416
HOST_PAGES = 1024
F32_LAYERS = 4  # phase 7 (c): llama-8b's width, 4 layers, float32


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1
def device_info(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    return name, smi


# ------------------------------------------------------------ phase 2
def build(tra) -> float:
    t0 = time.perf_counter()
    path = tra.build_kernel(force=True)
    tra.load_kernel()
    dt = time.perf_counter() - t0
    srcs = ", ".join(os.path.basename(f) for f in tra.KERNEL_SOURCES)
    log(f"[build] {os.path.relpath(path, HERE)} from {srcs} in {dt:.1f} s "
        f"(nvcc sm_90a, one process per source)")
    # ptxas: "Compiling entry function '<mangled name>'", then its
    # spills, then its registers; one line per kernel instantiation,
    # named by its kernel and (mangled) template arguments.
    name = spill = None
    for line in tra.build_log().splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"[a-z_]+_kernel(I\w*?E)?(?=E?v)", line.split("'")[1])
            name = found.group(0) if found else line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"[build] {name}: {regs}; {spill}")
            name = None
    return dt


# ------------------------------------------------------------ phase 3
def flat_batch(torch, np, seed, spans, q_tile, dtype, device, pad_to=0, shape=(H, HKV, D)):
    """A q_tile-aligned flat stream over a scrambled page pool, one
    empty tile at the end, owned by the scratch row ``len(spans)``, then,
    up to ``pad_to`` tokens, more such tiles (the engine's stream padded
    to its token bucket), at attention shape ``shape`` (H, Hkv, D).
    Returns (q, k, v, table, row_of, positions)."""
    n_heads, n_kv, hd = shape
    rs = np.random.RandomState(seed)
    pmax = max(-(-max(kv, 1) // PS) for _, kv in spans)
    pages = sum(-(-max(kv, 1) // PS) for _, kv in spans) + 8
    k = torch.from_numpy(rs.standard_normal((pages, PS, n_kv * hd)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((pages, PS, n_kv * hd)).astype(np.float32))
    perm = rs.permutation(pages)
    table = np.zeros((len(spans) + 1, pmax), np.int32)
    used, row_of, positions = 0, [], []
    for r, (q_len, kv_len) in enumerate(spans):
        n = -(-max(kv_len, 1) // PS)
        table[r, :n] = perm[used : used + n]
        used += n
        pad = (-q_len) % q_tile
        row_of += [r] * (q_len + pad)
        positions += list(range(kv_len - q_len, kv_len)) + [-1] * pad
    tail = max(q_tile, pad_to - len(row_of))
    row_of += [len(spans)] * tail
    positions += [-1] * tail
    q = torch.from_numpy(rs.standard_normal((len(row_of), n_heads, hd)).astype(np.float32))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            i32(table), i32(row_of), i32(positions))


def timed(torch, fn, reps, flush):
    """Mean device ms of ``fn`` over ``reps`` launches, each after an
    L2 flush (the engine finds a layer's KV cold), timed by CUDA events.
    A spin kernel of about 0.5 ms after the flush keeps the card busy
    while the host enqueues ``fn``, so the events time the device work
    and not the wrapper's Python."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def bound(torch, q, k, table, row_of, positions, peak=BF16_FLOP_PER_S, window=None):
    """Least time for the attention function on these inputs: each
    input byte it needs read once (q, the K/V tokens of every row that
    some query of the row sees: its causal context, from its earliest
    query's window start under a sliding ``window``; their page-table
    entries and the per-token indices), the output written once, against
    the flops of QK and PV over the keys each query sees, at the card's
    rate ``peak`` for the inputs' type (bf16 tensor cores; float32
    outside them). A softcap's tanh is not counted. Returns (ms, "bytes"
    | "operations", bytes, flops)."""
    n_heads, hd = q.shape[1], q.shape[2]
    n_kv = k.shape[2] // hd
    win = window or 1 << 62
    pos = positions.long().cpu()
    rows = row_of.long().cpu()
    live = pos >= 0
    span = {}  # row -> (first key any query sees, last key + 1)
    for r, p in zip(rows[live].tolist(), pos[live].tolist()):
        lo, hi = span.get(r, (1 << 62, 0))
        span[r] = (min(lo, max(0, p - win + 1)), max(hi, p + 1))
    tokens = sum(hi - lo for lo, hi in span.values())
    pages = sum(-(-hi // PS) - lo // PS for lo, hi in span.values())
    el = q.element_size()
    nbytes = (
        2 * q.numel() * el  # q in, out
        + 2 * tokens * n_kv * hd * el  # K and V of the keys some query sees
        + pages * 4 + 2 * rows.numel() * 4
    )
    seen = torch.clamp(pos[live] + 1, max=win)  # keys each query sees
    flops = 4 * n_heads * hd * int(seen.sum())  # QK and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def sdpa_inputs(torch, q, k, v, table, row_of, positions, window=None):
    """The same attention as one padded dense batch for
    ``scaled_dot_product_attention``: per row its queries [R, H, Tq, D]
    and its gathered pages [R, Hkv, S, D], with a causal position mask
    (and the sliding ``window``'s). Padding queries attend to key 0
    (their output is ignored)."""
    n_heads, hd = q.shape[1], q.shape[2]
    n_kv = k.shape[2] // hd
    rows = row_of.long().cpu().tolist()
    pos = positions.long().cpu().tolist()
    by_row: dict[int, list[int]] = {}
    for i, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            by_row.setdefault(r, []).append(i)
    R = len(by_row)
    Tq = max(len(ix) for ix in by_row.values())
    S = table.shape[1] * PS
    dev = q.device
    qd = torch.zeros(R, n_heads, Tq, hd, dtype=q.dtype, device=dev)
    qpos = torch.zeros(R, Tq, dtype=torch.long, device=dev)
    rsel = []
    for j, (r, ix) in enumerate(sorted(by_row.items())):
        ixt = torch.tensor(ix, device=dev)
        qd[j, :, : len(ix)] = q[ixt].transpose(0, 1)
        qpos[j, : len(ix)] = positions[ixt].long()
        rsel.append(r)
    t = table[torch.tensor(rsel, device=dev).long()].long()
    kd = k[t].reshape(R, S, n_kv, hd).transpose(1, 2).contiguous()
    vd = v[t].reshape(R, S, n_kv, hd).transpose(1, 2).contiguous()
    kv_pos = torch.arange(S, device=dev)[None, None, None, :]
    mask = kv_pos <= qpos[:, None, :, None]
    if window:
        mask &= kv_pos > qpos[:, None, :, None] - window
    return qd, kd, vd, mask


def close(torch, got, want, what) -> float:
    """Assert finite output within atol + rtol * |want| (``TOL`` for
    the dtype); return the max abs error."""
    atol, rtol = TOL[str(want.dtype).removeprefix("torch.")]
    g, w = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(g).all(), f"{what}: bad output"
    diff = (g - w).abs()
    excess = float((diff - (atol + rtol * w.abs())).max())
    assert excess <= 0, f"{what}: kernel and plain differ beyond tolerance by {excess}"
    return float(diff.max())


def close_to_f32(torch, got, plain, q, k, v, what) -> tuple[float, float]:
    """Read a bf16 kernel's output against the plain version on float32
    copies of the same q, k and v. The kernel rounds each unnormalised
    probability p_j to bf16 before PV (relative error at most 2^-8) and
    the output to bf16 (at most 2^-8 of it); the rest (float32 sums in
    another order, exp2.approx) is below 2^-12 of the weights. So
    element by element |got - want| <= 2^-8 |want| + (2^-8 + 2^-12)
    sum_j P_j |v_j|, where P is the normalised softmax; the plain
    version with |v| gives that sum. Dropping one 32-token chunk of a
    2,049-token row moves its outputs by up to about 2e-2: several
    times this limit (about 3e-3 there), and near the bf16 tolerance of
    ``close``, which may pass it. Returns (max abs error, max of error / limit); the
    caller asserts the latter is at most 1."""
    f32 = (q.float(), k.float(), v.float())
    want = plain(*f32)
    reach = plain(f32[0], f32[1], f32[2].abs())
    limit = 2.0**-8 * want.abs() + (2.0**-8 + 2.0**-12) * reach
    diff = (got.float() - want).abs()
    ratio = float((diff / limit.clamp_min(1e-30)).max())
    log(f"[kernel] {what} against float32 plain: max abs err {float(diff.max()):.3e}, "
        f"max err / limit {ratio:.3f} (limit 2^-8 |want| + (2^-8 + 2^-12) P|v|)")
    return float(diff.max()), ratio


def check_case(torch, call, plain, q, k, v, zeros, what) -> tuple:
    """One kernel call against the plain version: within ``close``'s
    tolerance, exact zeros where ``zeros`` selects, and for bf16 pools
    within ``close_to_f32``'s limit (read first, asserted last, so a
    failing run prints both readings). Returns (max abs error, the
    float32 reading or None)."""
    got = call()
    torch.cuda.synchronize()
    tight = close_to_f32(torch, got, plain, q, k, v, what) if q.dtype == torch.bfloat16 else None
    err = close(torch, got, plain(), what)
    assert (got[zeros] == 0).all(), f"{what}: empty tiles / inactive rows are not exact zeros"
    assert tight is None or tight[1] <= 1.0, (
        f"{what}: kernel and float32 plain differ beyond bf16 rounding")
    return err, tight


def mixed_case(torch, np, tra, dt, spans=MIXED_SPANS, what="mixed", pad_to=0,
               shape=(H, HKV, D), attn=None) -> tuple:
    """The mixed shape, q_tile = 8, one empty tile at the end (and
    scratch-row tiles up to ``pad_to``), against the plain version with
    ``dt`` pools, at attention shape ``shape`` with ``attn`` (window,
    softcap, sm_scale) passed to both. Returns (max abs err, the float32
    reading, the inputs, the call, the plain call, the (row_of,
    positions) the plain call reads)."""
    dev = torch.device("cuda", 0)
    q, k, v, table, row_of, pos = flat_batch(torch, np, 0, spans, 8, dt, dev, pad_to, shape)
    kw = dict(attn or {}, num_kv_heads=shape[1])

    def call():
        return tra.ragged_paged_attention(q, k, v, table, row_of, pos, q_tile=8, **kw)

    def plain(q=q, k=k, v=v):
        return tra.ragged_paged_attention_ref(q, k, v, table, row_of, pos, **kw)

    zeros = pos < 0  # padding slots, the empty tile and the bucket's padding
    err, tight = check_case(torch, call, plain, q, k, v, zeros, f"{what} {dt}")
    return err, tight, (q, k, v, table), call, plain, (row_of, pos)


def decode_case(torch, np, tra, dt, lengths=DECODE_LENGTHS, what="decode",
                shape=(H, HKV, D), attn=None) -> tuple:
    """The decode shape, q_tile = 1, rows of ``lengths`` (0: inactive);
    as mixed_case."""
    dev = torch.device("cuda", 0)
    spans = [(1, max(n, 1)) for n in lengths]
    q, k, v, table, _, _ = flat_batch(torch, np, 1, spans, 1, dt, dev, shape=shape)
    B = len(lengths)
    q, table = q[:B].contiguous(), table[:B].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    kw = dict(attn or {}, num_kv_heads=shape[1])

    def call():
        return tra.ragged_decode_attention(q, k, v, table, lens, **kw)

    def plain(q=q, k=k, v=v):
        return tra.ragged_paged_attention_ref(q, k, v, table, rows, lens - 1, **kw)

    err, tight = check_case(torch, call, plain, q, k, v, lens == 0, f"{what} {dt}")
    return err, tight, (q, k, v, table), call, plain, (rows, lens - 1)


def check_rows_alone(torch, tra, inputs, rows, pos, batch_out, attn=None) -> int:
    """Batch invariance, bit for bit: each live row of a flat batch run
    alone (its tokens, positions and page-table row, the same pools)
    gives what it gives in the batch, where it fell in other runs of q
    tiles, warps and horizons. Returns the rows checked."""
    q, k, v, table = inputs
    kw = dict(attn or {}, num_kv_heads=k.shape[2] // q.shape[2])
    n = 0
    for r in sorted(set(rows.tolist())):
        idx = (rows == r).nonzero()[:, 0]
        if bool((pos[idx] < 0).all()):  # the empty tile
            continue
        alone = tra.ragged_paged_attention(
            q[idx].contiguous(), k, v, table[r : r + 1].contiguous(),
            torch.zeros_like(rows[idx]), pos[idx].contiguous(), q_tile=8, **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone, batch_out[idx]), (
            f"row {r} alone differs from the same row in the batch")
        n += 1
    return n


def check_kernels(torch, np, tra, flush) -> dict:
    """Kernel against plain version at the main path's shapes, with
    float32 pools and then with bf16 pools (the main path's), which are
    also timed.

    Tolerance: the kernel follows the TPU kernel's numerics (q and K in
    float32 for QK, unnormalised probabilities rounded to the pool dtype
    before PV, the softmax sum from the unrounded ones); the plain
    version rounds q to the pool dtype and the normalised probabilities.
    With float32 pools neither rounds, so the two differ only in
    summation order: atol 1e-4, rtol 0 (dropping or masking one 32-token
    chunk of a 2048-token row moves an output element by about 1e-3).
    With bf16 pools both round the output to bf16, so the two differ by
    a few bf16 ulps: atol 2e-2 (the JAX suite's bf16 bound) + rtol 2^-7,
    one bf16 ulp of the output's own size. That bound is loose beside
    the kernel's own rounding, so the bf16 kernels are also held against
    the plain version on float32 copies (``close_to_f32``)."""
    F = torch.nn.functional
    def verify_case(torch, np, tra, dt):
        return mixed_case(torch, np, tra, dt, VERIFY_SPANS, "verify")

    cases = {
        "ragged_paged_attention":
            (mixed_case, 8, f"mixed q_tile=8 rows={len(MIXED_SPANS)}"),
        "ragged_decode_attention":
            (decode_case, 1, f"decode q_tile=1 lengths={DECODE_LENGTHS}"),
        # Phase 8's verify spans through the same mixed kernels.
        "ragged_paged_attention_verify":
            (verify_case, 8, f"verify spans (9 queries, 2 q tiles) q_tile=8 {VERIFY_SPANS}"),
    }
    results = {}

    def measure(inputs, call, plain, rows, pos, reps, plain_reps, peak):
        """(kernel ms, plain ms, SDPA ms, bound ms, bound_by, bytes, flops)."""
        q, k, v, table = inputs
        qd, kd, vd, mask = sdpa_inputs(torch, q, k, v, table, rows, pos)
        ms = timed(torch, call, reps, flush)
        plain_ms = timed(torch, plain, plain_reps, flush)
        lib_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), reps, flush)
        return (ms, plain_ms, lib_ms) + bound(torch, q, k, table, rows, pos, peak)

    for entry, (case, q_tile, what) in cases.items():
        err32, _, inputs32, call32, plain32, (rows32, pos32) = case(
            torch, np, tra, torch.float32)
        if q_tile == 8:
            # The float32 mixed design (csrc/ragged_attention.cu), timed
            # on its own inputs, its bound at the 3xTF32 rate; the bound
            # at the rate of float32 outside the tensor cores beside it.
            if entry == "ragged_paged_attention":
                n_rows = check_rows_alone(torch, tra, inputs32, rows32, pos32, call32())
                log(f"[kernel] {what} float32: each of the {n_rows} live rows run alone "
                    f"equals the same row in the batch, bit for bit")
            ms, plain_ms, lib_ms, b_ms, b_by, nbytes, flops = measure(
                inputs32, call32, plain32, rows32, pos32, 10, 3, F32_3XTF32_FLOP_PER_S)
            ffma_ms, ffma_by = bound(torch, inputs32[0], inputs32[1], inputs32[3], rows32,
                                     pos32, F32_FLOP_PER_S)[:2]
            log(f"[kernel] {what} float32 (mixed_f32) N={inputs32[0].shape[0]}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop at 3xTF32's "
                f"{F32_3XTF32_FLOP_PER_S / 1e12:.1f} TFLOP/s; {ffma_ms:.4f} ms by {ffma_by} "
                f"at float32's {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s outside the tensor cores)")
            results[entry + "_f32"] = dict(
                max_abs_err=err32, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_ms_ffma=ffma_ms,
            )
        del inputs32, call32, plain32
        err, (err_f32, ratio), inputs, call, plain, (rows, pos) = case(
            torch, np, tra, torch.bfloat16)
        q = inputs[0]
        ms, plain_ms, lib_ms, b_ms, b_by, nbytes, flops = measure(
            inputs, call, plain, rows, pos, 20 if q_tile == 8 else 50,
            3 if q_tile == 8 else 5, BF16_FLOP_PER_S)
        log(f"[kernel] {what} N={q.shape[0]}: max_abs_err float32 {err32:.3e} "
            f"(atol, rtol {TOL['float32']}), bf16 {err:.3e} (atol, rtol "
            f"{TOL['bfloat16']}; against float32 plain {err_f32:.3e}, {ratio:.3f} of "
            f"its limit), empty tiles / inactive rows exact zeros; bf16 "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop)")
        results[entry] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        )
    # The engine pads each mixed stream to its token bucket with tiles
    # of the scratch row at position -1: the mixed spans (1,656 slots
    # with the empty tile) padded to 2,048, a run of 50 such tiles.
    n = sum(-(-q // 8) * 8 for q, _ in MIXED_SPANS) + 8
    bucket = 1 << (n - 1).bit_length()
    for dt in (torch.float32, torch.bfloat16):
        err, tight, *_ = mixed_case(torch, np, tra, dt, what="padded", pad_to=bucket)
        log(f"[kernel] mixed q_tile=8 padded to its bucket ({n} -> {bucket} slots, "
            f"{(bucket - n) // 8 + 1} tiles of the scratch row) {dt}: max abs err {err:.3e}"
            + (f", {tight[1]:.3f} of the bf16 limit" if tight else "")
            + "; every padding token exact zeros")
        results[f"padded_{str(dt).removeprefix('torch.')}"] = err
    return results


# Phase 3's windowed and softcapped cases: (attention shape (H, Hkv, D),
# the kernels' window / softcap / scale arguments). gemma2-9b's sliding
# layers (a 4,096 window, scores capped at 50, query_pre_attn_scalar
# 256) at head dim 256, and mistral-7b's 4,096 window at head dim 128.
WINDOW_CASES = {
    "gemma2_d256_softcap_window": ((16, 8, 256), dict(window=4096, softcap=50.0,
                                                       sm_scale=256**-0.5)),
    "mistral_d128_window": ((32, 8, 128), dict(window=4096)),
}
# Mixed rows past the window (prefill chunks of 512 at 5,120 and 6,000,
# a 64-token chunk at 4,500, decode tokens at 5,500 and 6,000, a verify
# span across the window's length) and inside it.
WINDOW_MIXED_SPANS = [(512, 5120), (512, 6000), (64, 4500), (1, 5500), (1, 6000),
                      (16, 1024), (1, 4096), (1, 300), (9, 4105)]
WINDOW_DECODE_LENGTHS = [6000, 5000, 4097, 4096, 2000, 300, 0, 5500]


def check_windowed(torch, np, tra, flush) -> dict:
    """``WINDOW_CASES`` through all three designs: the mixed shape on
    ``WINDOW_MIXED_SPANS`` and the decode shape on
    ``WINDOW_DECODE_LENGTHS``, with float32 and bf16 pools, held to the
    plain version as ``check_kernels`` holds them (float32 at atol 1e-4;
    bf16 at atol 2e-2 + rtol 2^-7 and within bf16 rounding of float32
    copies), each float32 mixed row alone bit-equal to the batch; timed
    by CUDA events after an L2 flush beside the plain version, the bound
    (the keys each query sees) and one library call on the gathered
    pages: ``scaled_dot_product_attention`` with the causal and window
    mask, or, under a softcap (which SDPA cannot compute),
    ``flex_attention`` (``flex_ms``). Returns {case: {entry: numbers}}."""
    F = torch.nn.functional
    out = {}
    for case, (shape, attn) in WINDOW_CASES.items():
        res = out[case] = {}
        for entry, make in (
            ("mixed", lambda dt: mixed_case(torch, np, tra, dt, WINDOW_MIXED_SPANS,
                                            f"{case} mixed", shape=shape, attn=attn)),
            ("decode", lambda dt: decode_case(torch, np, tra, dt, WINDOW_DECODE_LENGTHS,
                                              f"{case} decode", shape=shape, attn=attn)),
        ):
            for dt in (torch.float32, torch.bfloat16):
                err, tight, inputs, call, plain, (rows, pos) = make(dt)
                q, k, v, table = inputs
                if entry == "mixed" and dt == torch.float32:
                    n_rows = check_rows_alone(torch, tra, inputs, rows, pos, call(), attn)
                    log(f"[kernel] {case} mixed float32: each of the {n_rows} live rows run "
                        f"alone equals the same row in the batch, bit for bit")
                bf16 = dt == torch.bfloat16
                peak = BF16_FLOP_PER_S if bf16 else F32_3XTF32_FLOP_PER_S
                if entry == "decode":
                    peak = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S  # CUDA cores
                reps = 20 if entry == "mixed" else 50
                ms = timed(torch, call, reps, flush)
                plain_ms = timed(torch, plain, 3, flush)
                lib_ms, lib = None, "sdpa"
                qd, kd, vd, mask = sdpa_inputs(torch, q, k, v, table, rows, pos,
                                               attn.get("window"))
                if not attn.get("softcap"):
                    lib_ms = timed(torch, lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=mask, enable_gqa=True), reps, flush)
                else:
                    lib = "flex_attention"
                    lib_ms = flex_ms(torch, qd, kd, vd, mask, attn, reps, flush)
                del qd, kd, vd, mask
                b_ms, b_by, nbytes, flops = bound(torch, q, k, table, rows, pos, peak,
                                                  attn.get("window"))
                design = ("decode_split" if entry == "decode"
                          else "mixed_tc_bf16" if bf16 else "mixed_f32")
                name = f"{entry} {str(dt).removeprefix('torch.')} ({design})"
                log(f"[kernel] {case} {name} H/Hkv/D {shape} {attn}: max abs err {err:.3e}"
                    + (f" (against float32 plain {tight[0]:.3e}, {tight[1]:.3f} of its limit)"
                       if tight else "")
                    + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib} "
                    + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none (see above)")
                    + f", bound {b_ms:.4f} ms by {b_by} ({nbytes} B, {flops} flop)")
                res[f"{entry}_{str(dt).removeprefix('torch.')}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by)
                del inputs, call, plain, q, k, v, table
        torch.cuda.empty_cache()
    return out


def flex_ms(torch, qd, kd, vd, mask, attn: dict, reps: int, flush) -> float | None:
    """One ``torch.nn.attention.flex_attention`` call, compiled with
    ``torch.compile``, on ``sdpa_inputs``' gathered pages: the softcap as
    its ``score_mod``, the causal and window mask as its block mask, the
    kernels' query scale; timed as ``timed`` times the kernels. A
    yardstick where SDPA cannot compute the case (a softcap); None, with
    the reason printed, where flex_attention cannot run."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        cap = float(attn["softcap"])
        dense = mask[:, 0] if mask.dim() == 4 else mask
        R, Tq, S = dense.shape

        def score_mod(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        def mask_mod(b, h, q_idx, kv_idx):
            return dense[b, q_idx, kv_idx]

        block = create_block_mask(mask_mod, R, None, Tq, S, device=qd.device)
        fn = torch.compile(flex_attention)
        scale = attn.get("sm_scale")

        def call():
            return fn(qd, kd, vd, score_mod=score_mod, block_mask=block, scale=scale,
                      enable_gqa=True)

        call()  # compile outside the timing
        torch.cuda.synchronize()
        return timed(torch, call, reps, flush)
    except Exception as e:  # noqa: BLE001 - a yardstick, not a check
        log(f"[kernel] flex_attention cannot run this case on the card: {type(e).__name__}: "
            f"{str(e)[:300]}")
        return None


# ------------------------------------------------------------ engine helpers
async def serve(engine, requests):
    """Submit every request at once (admitted together) and collect
    (tokens, finish_reason, ttft_s) per request."""
    t0 = time.perf_counter()

    async def collect(stream):
        toks, finish, ttft = [], None, None
        async for item in stream:
            if item.get("token_ids") and ttft is None:
                ttft = time.perf_counter() - t0
            toks.extend(item.get("token_ids", []))
            finish = item.get("finish_reason", finish)
        return toks, finish, ttft

    # Queued before the loop thread starts, so admitted together.
    streams = [engine.submit(r) for r in requests]
    engine.start()
    out = await asyncio.wait_for(
        asyncio.gather(*(collect(s) for s in streams)), timeout=600
    )
    return out, time.perf_counter() - t0


def run_engine(engine, requests):
    try:
        return asyncio.run(serve(engine, requests))
    finally:
        engine.stop()


# ------------------------------------------------------------ phase 4
def check_full_logits(torch, np, pkg, model, mcfg):
    """llama-8b at full width: one 64-token prompt and a decode step
    through forward_ragged, kernel against plain attention."""
    llama = pkg.models.llama
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(1)
    n = 64
    toks = torch.tensor(rs.randint(3, mcfg.vocab_size, size=n), device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)
    logits = {}
    for impl in ("kernel", "reference"):
        kc, vc = llama.init_kv_cache(mcfg, 8, PS, torch.bfloat16, device=dev)
        lg, _, _ = llama.forward_ragged(
            model, mcfg, toks, pos, rows, table, kc, vc, last, attn_impl=impl, q_tile=8,
        )
        logits[impl] = lg
        del kc, vc
    a, b = logits["kernel"], logits["reference"]
    assert a.shape == (1, mcfg.vocab_size) and torch.isfinite(a).all()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    log(f"[full] llama-8b logits, 64-token prompt: kernel vs plain max abs err "
        f"{err:.4e} (logit scale {scale:.3f}), argmax {int(a.argmax())} vs {int(b.argmax())}")
    # bf16 activations through 32 layers: the two attention numerics
    # (see check_kernels) differ by bf16 ulps per layer.
    assert err <= 0.05 * scale, f"full logits differ: {err} > 5% of {scale}"
    return err, scale


def profile(torch, engine, requests):
    """``--profile`` only: one more pass of the main path under
    torch.profiler. Prints device time by kernel and the device's busy
    share of the wall time (the union of kernel intervals over the span
    from the first to the last kernel)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = run_engine(engine, requests)
        torch.cuda.synchronize()
    assert all(f == "length" for _, f, _ in out)
    report_profile(prof, wall, "[profile]")


def report_profile(prof, wall: float, tag: str, top: int = 15) -> None:
    """Print a trace's device busy / idle share (the union of kernel
    intervals over the span from the first to the last kernel) and its
    device time by kernel."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            d = by_name.setdefault(e.name, [0.0, 0])
            d[0] += e.time_range.end - e.time_range.start
            d[1] += 1
    total = sum(v[0] for v in by_name.values())
    log(f"{tag} wall {wall:.3f} s traced; device busy {busy / 1e6:.3f} s of "
        f"{span / 1e6:.3f} s kernel span ({100 * busy / max(span, 1):.1f} %), idle "
        f"{100 * (1 - busy / max(span, 1)):.1f} %; kernel time {total / 1e6:.3f} s")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"{tag} {100 * us / max(total, 1):5.1f} % {us / 1e3:10.3f} ms "
            f"{n:6d} x  {name[:110]}")


# ------------------------------------------------------------ phase 5
def phase5_prompts(np, vocab: int, lens) -> list[list[int]]:
    """The main path's prompts: seeded random token ids."""
    rs = np.random.RandomState(7)
    return [[int(t) for t in rs.randint(3, vocab, size=n)] for n in lens]


def main_path(torch, np, pkg, tra):
    mcfg = pkg.models.LLAMA_8B
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = pkg.models.init_params(mcfg, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[engine] llama-8b: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
        f"H {mcfg.num_heads}/Hkv {mcfg.num_kv_heads} x {mcfg.head_dim_}, ffn "
        f"{mcfg.intermediate_size}, vocab {mcfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params bf16, random from seed 0 in {time.perf_counter() - t0:.1f} s")

    logit_err, logit_scale = check_full_logits(torch, np, pkg, model, mcfg)

    requests = [
        {
            "token_ids": ids,
            "stop_conditions": {"max_tokens": MAX_TOKENS, "ignore_eos": True},
            "sampling_options": SEEDED_OPTIONS if i == SEEDED else {},
        }
        for i, ids in enumerate(phase5_prompts(np, mcfg.vocab_size, PROMPT_LENS))
    ]
    max_len = max(PROMPT_LENS) + MAX_TOKENS + PS
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
        num_pages=8 * (-(-max_len // PS)), kv_dtype="bfloat16",
    )

    def engine():
        return pkg.engine.TorchEngine(ecfg, model=model, device="cuda")

    eng = engine()
    log(f"[engine] attention_impl={ecfg.attention_impl} -> {eng.attn_impl}, "
        f"slots {ecfg.max_decode_slots}, page {ecfg.page_size}, pages {ecfg.num_pages}, "
        f"prefill_chunk {ecfg.prefill_chunk}, decode_window {ecfg.decode_window}")
    torch.cuda.synchronize()
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    launches = dict(tra.LAUNCHES)
    designs = dict(tra.KERNEL_LAUNCHES)
    metrics = eng.metrics()
    pool_mib = eng.graphs.pool_bytes() / 2**20
    del eng
    free(torch, "cuda")

    for i, (toks, finish, _) in enumerate(out):
        assert finish == "length", f"request {i} finished {finish!r}"
        assert len(toks) == MAX_TOKENS, f"request {i} gave {len(toks)} tokens"
        assert all(0 <= t < mcfg.vocab_size for t in toks)
    assert launches["ragged_paged_attention"] > 0, launches
    assert launches["ragged_decode_attention"] > 0, launches
    # bf16 pools: every mixed call went through the tensor-core kernel.
    assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
    assert designs["mixed_f32"] == 0, designs
    assert designs["decode_split"] == launches["ragged_decode_attention"], designs
    disp = metrics["dispatches"]
    ttfts = sorted(t for _, _, t in out)
    total = sum(len(t) for t, _, _ in out)
    log(f"[engine] 8 requests (prompts {list(PROMPT_LENS)}, {MAX_TOKENS} tokens each, "
        f"request {SEEDED} seeded at T=0.8): all finished 'length' with {MAX_TOKENS} tokens")
    log(f"[engine] launches {launches}, by kernel {designs}; dispatches {disp}; decode steps "
        f"{metrics['decode_steps']} (wasted {metrics['decode_wasted_steps']}); graphs "
        f"captured at first use {graph_line(metrics)}, pool {pool_mib:.1f} MiB; "
        f"per mixed dispatch {launches['ragged_paged_attention'] / max(disp['mixed'], 1):.1f}, "
        f"per windowed step {launches['ragged_decode_attention'] / max(disp['windowed'] * ecfg.decode_window, 1):.1f}")

    rerun, wall2 = run_engine(engine(), requests)
    assert [t for t, _, _ in rerun] == [t for t, _, _ in out], "rerun gave other tokens"
    log("[engine] rerun of the same requests: identical tokens (greedy and seeded)")
    if "--profile" in sys.argv:
        profile(torch, engine(), requests)
    rerun_ttfts = sorted(t for _, _, t in rerun)
    stats = dict(
        wall_s=wall, rerun_wall_s=wall2, completion_tokens=total,
        tokens_per_s=total / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
        ttft_max_s=ttfts[-1], rerun_tokens_per_s=total / wall2,
        rerun_ttft_p50_s=rerun_ttfts[len(rerun_ttfts) // 2],
        rerun_ttft_max_s=rerun_ttfts[-1], launches=launches,
        mixed_dispatches=disp["mixed"], windowed_dispatches=disp["windowed"],
        tokens=[t for t, _, _ in out], logit_err=logit_err, logit_scale=logit_scale,
    )
    # Phase 6 builds its own llama-8b behind the HTTP server.
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------ phase 6
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# Llama-3.1's 256 special tokens: these 11 names, then reserved ones.
LLAMA3_SPECIALS = [
    "<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
    "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>",
]
N_SPECIAL = 256
EOT_OFFSET = 9  # <|eot_id|>: 128009 for llama-8b
CHAT_TEMPLATE = (
    "{{- bos_token }}"
    "{%- for message in messages %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    " + message['content'] | trim + '<|eot_id|>' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{%- endif %}"
)
CHATS = [
    [{"role": "system", "content": "You are a terse assistant."},
     {"role": "user", "content": "Name three uses of paged attention."}],
    [{"role": "user", "content": "Ünïcödé, 日本語 and emoji ☃ in one prompt."}],
]
UNARY_PROMPT = "The quick brown fox"
LONE_PROMPT_LEN = 300


def learn_merges(word_counts: dict[str, int], n_merges: int) -> list[tuple[str, str]]:
    """Byte-level BPE training, deterministic: merge the most frequent
    pair (the smallest pair among equal counts) until ``n_merges`` or
    no pair occurs twice. ``word_counts`` maps byte-level words to
    counts; pair counts are updated only in the words a merge touches."""
    import heapq
    from collections import defaultdict

    words = [list(w) for w in word_counts]
    counts = list(word_counts.values())
    pairs: dict[tuple[str, str], int] = defaultdict(int)
    where: dict[tuple[str, str], set[int]] = defaultdict(set)
    for i, syms in enumerate(words):
        for p in zip(syms, syms[1:]):
            pairs[p] += counts[i]
            where[p].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < n_merges:
        negc, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -negc:
            continue  # stale entry
        if -negc < 2:
            break
        merges.append(pair)
        a, b = pair
        touched = set()
        for i in where.pop(pair, ()):
            syms, c = words[i], counts[i]
            for p in zip(syms, syms[1:]):
                pairs[p] -= c
                touched.add(p)
            new, j = [], 0
            while j < len(syms):
                if j + 1 < len(syms) and syms[j] == a and syms[j + 1] == b:
                    new.append(a + b)
                    j += 2
                else:
                    new.append(syms[j])
                    j += 1
            words[i] = new
            for p in zip(new, new[1:]):
                pairs[p] += c
                where[p].add(i)
                touched.add(p)
        pairs.pop(pair, None)
        for p in touched:
            if pairs.get(p, 0) > 0:
                heapq.heappush(heap, (-pairs[p], p))
    return merges


def tokenizer_spec(tokmod, vocab_size: int, text: str, n_merges: int = 1500) -> dict:
    """A Llama-3-layout byte-level BPE ``tokenizer.json`` of exactly
    ``vocab_size`` entries: the 256 byte symbols; merges learned from
    ``text``; deterministic filler entries (whole and split CJK
    characters, so random ids decode to partial UTF-8 too, then words
    of learned pieces) up to ``vocab_size - 256``; Llama-3's special
    tokens in the last 256 ids."""
    import random
    import re as _re

    enc = tokmod.BYTE_ENCODER
    n_regular = vocab_size - N_SPECIAL
    pat = _re.compile(tokmod.translate_pattern(LLAMA3_PATTERN))
    word_counts: dict[str, int] = {}
    for w in pat.findall(text):
        bw = "".join(enc[b] for b in w.encode("utf-8"))
        word_counts[bw] = word_counts.get(bw, 0) + 1
    merges = learn_merges(word_counts, min(n_merges, (n_regular - 256) // 2))
    vocab: dict[str, int] = {}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < n_regular:
            vocab[tok] = len(vocab)

    for b in range(256):
        add(enc[b])
    for a, b in merges:
        add(a + b)
    n_cjk = min(2000, (n_regular - len(vocab)) // 8)
    for k in range(n_cjk):
        raw = chr(0x4E00 + 7 * k).encode("utf-8")
        for piece in (raw, raw[:2], b" " + raw):
            add("".join(enc[x] for x in piece))
    pieces = [a + b for a, b in merges] or [enc[b] for b in range(ord("a"), ord("z") + 1)]
    rng = random.Random(0)
    while len(vocab) < n_regular:
        word = "".join(rng.choice(pieces) for _ in range(rng.randint(1, 3)))
        add(("Ġ" if rng.random() < 0.6 else "") + word)
    specials = LLAMA3_SPECIALS + [
        f"<|reserved_special_token_{i}|>" for i in range(3, 3 + N_SPECIAL - len(LLAMA3_SPECIALS))
    ]
    added = [
        {"id": n_regular + i, "content": name, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, name in enumerate(specials)
    ]
    bos = specials[0]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_regular], "tokens": [bos]}}},
        ]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }


def write_model_dir(path: str, tokmod, mcfg, text: str) -> str:
    """config.json of ``mcfg`` (read back equal to it), the tokenizer
    of ``tokenizer_spec``, a Llama-3-style chat template and EOS
    ``<|eot_id|>`` in generation_config.json. No weights: the server
    runs with --random-weights."""
    os.makedirs(path, exist_ok=True)
    bos = mcfg.vocab_size - N_SPECIAL
    cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": mcfg.model_type,
        "vocab_size": mcfg.vocab_size, "hidden_size": mcfg.hidden_size,
        "intermediate_size": mcfg.intermediate_size,
        "num_hidden_layers": mcfg.num_layers, "num_attention_heads": mcfg.num_heads,
        "num_key_value_heads": mcfg.num_kv_heads, "rope_theta": mcfg.rope_theta,
        "rms_norm_eps": mcfg.rms_norm_eps,
        "max_position_embeddings": mcfg.max_position_embeddings,
        "tie_word_embeddings": mcfg.tie_word_embeddings,
        "attention_bias": mcfg.attention_bias, "torch_dtype": mcfg.dtype,
        "bos_token_id": bos,
        # The preset's MoE routing default (unused by a dense model), so
        # that the file reads back equal to the preset.
        "norm_topk_prob": mcfg.norm_topk_prob,
    }
    if mcfg.head_dim:
        cfg["head_dim"] = mcfg.head_dim
    files = {
        "config.json": cfg,
        "generation_config.json": {"bos_token_id": bos, "eos_token_id": bos + EOT_OFFSET},
        "tokenizer_config.json": {"bos_token": LLAMA3_SPECIALS[0],
                                  "eos_token": "<|eot_id|>",
                                  "chat_template": CHAT_TEMPLATE},
        "tokenizer.json": tokenizer_spec(tokmod, mcfg.vocab_size, text),
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return path


async def sse_request(client, url: str, body: dict) -> dict:
    """One streaming request: its text, finish reason, usage, the time
    it was sent, the arrival time of every content frame, and whether
    it ended with [DONE]."""
    sent = time.perf_counter()
    text, frames, finish, usage, done = [], [], None, None, False
    async for f in client.sse_frames(url, body):
        assert f.event != "error", f"stream error: {f.comment}"
        if f.data == "[DONE]":
            done = True
            break
        usage = f.data.get("usage") or usage
        for c in f.data["choices"]:
            piece = c["text"] if "text" in c else (c.get("delta") or {}).get("content")
            if piece:
                text.append(piece)
                frames.append(time.perf_counter())
            finish = c.get("finish_reason") or finish
    return dict(text="".join(text), frames=frames, sent=sent, finish=finish,
                usage=usage, done=done)


async def burst(client, eng, url: str, bodies: list[dict], reset_cache: bool) -> tuple:
    """Send ``bodies`` at once with the engine's admission held until
    every one is queued, so the batch's schedule is phase 5's (all
    admitted together); ``reset_cache`` first drops the prefix cache a
    previous burst left. Returns (results, wall seconds, CPU seconds of
    this thread, where the server and the client run, and of the
    engine's loop thread)."""
    cpu0 = time.thread_time()
    with eng.hold_admission():
        if reset_cache:
            eng.reset_prefix_cache()
        tasks = [asyncio.ensure_future(sse_request(client, url, b)) for b in bodies]
        while eng.queued() < len(bodies) and not any(t.done() for t in tasks):
            await asyncio.sleep(0.001)
    out = await asyncio.gather(*tasks)
    wall = time.perf_counter() - min(r["sent"] for r in out)
    return out, wall, time.thread_time() - cpu0, eng.loop_cpu_seconds()


async def direct_burst(eng, requests: list[dict]) -> tuple:
    """``burst``'s requests straight into the same engine (no HTTP, no
    tokenizer): each result holds its tokens and the arrival times of
    the engine's outputs that carried tokens."""

    async def collect(stream, sent):
        tokens, frames = [], []
        async for item in stream:
            if item.get("token_ids"):
                tokens += item["token_ids"]
                frames.append(time.perf_counter())
        return dict(tokens=tokens, frames=frames, sent=sent,
                    usage={"completion_tokens": len(tokens)})

    cpu0 = time.thread_time()
    with eng.hold_admission():
        eng.reset_prefix_cache()
        sent = time.perf_counter()
        streams = [eng.submit(r) for r in requests]
    out = await asyncio.gather(*(collect(s, sent) for s in streams))
    return out, time.perf_counter() - sent, time.thread_time() - cpu0, eng.loop_cpu_seconds()


def edge_stats(results: list[dict], wall: float, edge_cpu: float, loop_cpu: float) -> dict:
    ttft = sorted(r["frames"][0] - r["sent"] for r in results)
    gaps = [b - a for r in results for a, b in zip(r["frames"], r["frames"][1:])]
    tokens = sum(r["usage"]["completion_tokens"] for r in results)
    return dict(ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
                frame_gap_mean_s=sum(gaps) / max(len(gaps), 1), frames=sum(
                    len(r["frames"]) for r in results), completion_tokens=tokens,
                tokens_per_s=tokens / wall, wall_s=wall, edge_cpu_s=edge_cpu,
                loop_cpu_s=loop_cpu)


def streamed_text(tok, ids: list[int]) -> str:
    """What the backend emits for ``ids``: the DecodeStream pieces (a
    partial UTF-8 character at the very end is never emitted)."""
    ds = tok.decode_stream()
    return "".join(p for p in (ds.step(i) for i in ids) if p)


def http_path(torch, np, pkg, tra, phase5_tokens, *, device="cuda", mcfg=None,
              prompt_lens=PROMPT_LENS, max_tokens=MAX_TOKENS, seeded=SEEDED) -> dict:
    """Phase 6: the port's real entry point. ``run.main_async(in=http
    out=cuda)`` serves a model directory written here (llama-8b's
    config, a 128,256-entry tokenizer, a chat template) with seeded
    random weights, in this process; a stdlib client sends (a) phase
    5's requests as streaming completions, twice, (b) two streaming
    chats, (c) a unary completion, (d) (c) again with a stop string cut
    from (c)'s text, and a lone greedy request; the kernels' launch
    counts are read there, so they hold only what HTTP requests ran.
    Then the lone request is served straight by a ``TorchEngine`` on the
    same weights, and (a) goes in turns straight into the engine and
    over HTTP."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        t_write = time.perf_counter() - t0
        assert pkg.models.ModelConfig.from_pretrained(model_dir) == mcfg
        t0 = time.perf_counter()
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        t_load = time.perf_counter() - t0
        assert tok.vocab_size == mcfg.vocab_size
        eot = mcfg.vocab_size - N_SPECIAL + EOT_OFFSET
        assert tok.eos_token_ids == [eot], tok.eos_token_ids
        log(f"[http] model dir: config.json of the preset, tokenizer.json of "
            f"{tok.vocab_size} entries (written in {t_write:.2f} s, loaded in "
            f"{t_load:.2f} s), EOS {eot}")
        max_len = max(prompt_lens) + max_tokens + PS
        argv = [
            "in=http", "out=cuda", "--device", device, "--model-path", model_dir,
            "--model-name", "llama-8b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max_len), "--num-pages", str(8 * -(-max_len // PS)),
            "--kv-dtype", "bfloat16", "--max-tokens", str(max_tokens),
        ]
        stats = asyncio.run(asyncio.wait_for(
            _drive_http(torch, np, pkg, tra, tok, run.parse_args(argv), client,
                        phase5_tokens, device, mcfg, prompt_lens, max_tokens, seeded),
            timeout=900))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return stats


async def _drive_http(torch, np, pkg, tra, tok, opts, client, phase5_tokens, device,
                      mcfg, prompt_lens, max_tokens, seeded) -> dict:
    from dynamo_exp_tpu_torch import run

    t0 = time.perf_counter()
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    served = ready.result()
    base = f"http://127.0.0.1:{served.port}"
    models = (await client.request(base + "/v1/models")).json()
    assert [m["id"] for m in models["data"]] == ["llama-8b"], models
    eng = served.torch_engine
    log(f"[http] run.main_async(in=http out=cuda --device {device}) listening on "
        f"{base} in {time.perf_counter() - t0:.1f} s; engine {eng.attn_impl} attention, "
        f"{eng.cfg.num_pages} pages")
    try:
        return await _traffic(torch, np, pkg, tra, tok, client, base, eng, opts.model_path,
                              phase5_tokens, device, mcfg, prompt_lens, max_tokens,
                              seeded)
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server


async def _traffic(torch, np, pkg, tra, tok, client, base, eng, model_dir, phase5_tokens,
                   device, mcfg, prompt_lens, max_tokens, seeded) -> dict:
    from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_exp_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_exp_tpu_torch.protocols.openai import ChatCompletionRequest

    cmpl, chat = base + "/v1/completions", base + "/v1/chat/completions"
    prompts = phase5_prompts(np, mcfg.vocab_size, prompt_lens)
    bodies = [
        {"model": "llama-8b", "prompt": ids, "max_tokens": max_tokens, "stream": True,
         "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True},
         **(SEEDED_OPTIONS if i == seeded else {})}
        for i, ids in enumerate(prompts)
    ]
    if device == "cuda":
        torch.cuda.synchronize()
    tra.reset_launches()
    # Only HTTP requests from here to the read of the launch counts.
    # (a), twice.
    a_out, *a_times = await burst(client, eng, cmpl, bodies, reset_cache=False)
    per_burst = dict(tra.LAUNCHES)
    for i, (r, ids) in enumerate(zip(a_out, prompts)):
        assert r["done"], f"(a) request {i} did not end with [DONE]"
        assert r["finish"] == "length", f"(a) request {i} finished {r['finish']!r}"
        assert r["usage"] == {"prompt_tokens": len(ids), "completion_tokens": max_tokens,
                              "total_tokens": len(ids) + max_tokens}, r["usage"]
        assert r["text"], f"(a) request {i} gave no text"
    rerun, *rerun_times = await burst(client, eng, cmpl, bodies, reset_cache=True)
    assert [r["text"] for r in rerun] == [r["text"] for r in a_out], "(a) rerun differs"
    assert {k: v - per_burst[k] for k, v in tra.LAUNCHES.items()} == per_burst, (
        "(a) and its rerun launched the kernels a different number of times")
    after_bursts = dict(tra.LAUNCHES)
    same_as_phase5 = [
        r["text"] == streamed_text(tok, t) for r, t in zip(a_out, phase5_tokens or [])
    ]
    # (b) two streaming chats through the template.
    pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(model_dir, "llama-8b"), tok)
    t0 = time.perf_counter()
    chat_ids = [
        pre.preprocess_chat(
            ChatCompletionRequest.from_dict({"model": "llama-8b", "messages": m})
        ).token_ids
        for m in CHATS
    ]
    t_chat_pre = time.perf_counter() - t0
    b_out = await asyncio.gather(*(
        sse_request(client, chat, {"model": "llama-8b", "messages": m,
                                   "max_tokens": max_tokens, "stream": True,
                                   "stream_options": {"include_usage": True}})
        for m in CHATS))
    for r, ids in zip(b_out, chat_ids):
        assert r["done"] and r["finish"] in ("length", "stop"), r
        n = r["usage"]["completion_tokens"]
        assert r["usage"]["prompt_tokens"] == len(ids) and 0 < n <= max_tokens, r["usage"]
        assert n == max_tokens or r["finish"] == "stop", r
    # (c) unary, then (d) with a stop string cut from its text.
    c = await client.request(cmpl, "POST", {"model": "llama-8b", "prompt": UNARY_PROMPT,
                                            "max_tokens": max_tokens})
    assert c.status == 200, c.body
    c_choice = c.json()["choices"][0]
    c_text = c_choice["text"]
    assert c_choice["finish_reason"] in ("length", "stop") and c_text, c_choice
    stop = next(
        (c_text[i : i + 4] for i in range(len(c_text) // 3, len(c_text) - 4)
         if c_text[i : i + 4].strip() and "�" not in c_text[i : i + 4]),
        None)
    assert stop, f"no stop string in {c_text!r}"
    d = await sse_request(client, cmpl, {"model": "llama-8b", "prompt": UNARY_PROMPT,
                                         "max_tokens": max_tokens, "stop": [stop],
                                         "stream": True,
                                         "stream_options": {"include_usage": True}})
    assert d["done"] and d["finish"] == "stop", d
    assert d["text"] == c_text[: c_text.find(stop)], (d["text"], c_text, stop)
    # A lone greedy request, through HTTP.
    rs = np.random.RandomState(11)
    lone_len = min(LONE_PROMPT_LEN, max(prompt_lens))
    lone_ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=lone_len)]
    lone = await sse_request(client, cmpl, {
        "model": "llama-8b", "prompt": lone_ids, "max_tokens": max_tokens, "stream": True,
        "nvext": {"ignore_eos": True}})
    if device == "cuda":
        torch.cuda.synchronize()
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    rest = {k: v - after_bursts[k] for k, v in launches.items()}
    if device == "cuda":
        # Each burst, and the requests after them, reached both kernels.
        for counts in (per_burst, rest):
            assert counts["ragged_paged_attention"] > 0, counts
            assert counts["ragged_decode_attention"] > 0, counts
        assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
        assert designs["mixed_f32"] == 0, designs
        assert designs["decode_split"] == launches["ragged_decode_attention"], designs
    # ... and straight to a TorchEngine on the same weights.
    eng2 = pkg.engine.TorchEngine(eng.cfg, model=eng.model, device=device)
    try:
        stream = eng2.submit({"token_ids": lone_ids,
                              "stop_conditions": {"max_tokens": max_tokens,
                                                  "ignore_eos": True}})
        eng2.start()
        direct = [t async for item in stream for t in item.get("token_ids", [])]
    finally:
        eng2.stop()
    del eng2
    full = tok.decode(direct)
    assert len(direct) == max_tokens
    assert lone["text"] == streamed_text(tok, direct), (lone["text"], full)
    assert lone["text"] == full or (full.endswith("�") and full.startswith(lone["text"]))
    # What the edge costs: the same burst straight into the same engine
    # and over HTTP, in turns; the schedule (and the tokens) are equal.
    direct_requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == seeded else {}}
        for i, ids in enumerate(prompts)
    ]
    turns = [("http", edge_stats(rerun, *rerun_times))]
    for kind in ("direct", "http", "direct"):
        if kind == "http":
            res, *times = await burst(client, eng, cmpl, bodies, reset_cache=True)
            assert [r["text"] for r in res] == [r["text"] for r in a_out]
        else:
            res, *times = await direct_burst(eng, direct_requests)
            assert [streamed_text(tok, r["tokens"]) for r in res] == [
                r["text"] for r in a_out], "HTTP text is not the engine's tokens decoded"
        turns.append((kind, edge_stats(res, *times)))
    if "--profile" in sys.argv and device == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced, wall, _, _ = await burst(client, eng, cmpl, bodies, reset_cache=True)
            torch.cuda.synchronize()
        assert [r["text"] for r in traced] == [r["text"] for r in a_out]
        report_profile(prof, wall, "[profile http]", top=8)
    # Host cost of the edge's text work, on this run's prompts.
    texts = [tok.decode(ids) for ids in prompts]
    t0 = time.perf_counter()
    encoded = [tok.encode(t, add_special_tokens=False).ids for t in texts]
    t_encode = time.perf_counter() - t0
    return dict(
        a=edge_stats(a_out, *a_times), a_rerun=edge_stats(rerun, *rerun_times), turns=turns,
        launches=launches, designs=designs, per_burst=per_burst, rest=rest,
        same_as_phase5=same_as_phase5,
        chat_preprocess_s=t_chat_pre, chat_prompt_tokens=[len(i) for i in chat_ids],
        encode_s=t_encode, encode_chars=sum(len(t) for t in texts),
        encode_tokens=sum(len(e) for e in encoded), lone_text=lone["text"],
        lone_ids=lone_ids, lone_tokens=direct,
        stop=stop, b_finish=[r["finish"] for r in b_out],
    )

# ------------------------------------------------------------ phase 7
@dataclass
class Pressure:
    """Phase 7's sizes: the card's by default; the CPU tests rehearse it
    smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = PRESSURE_TOKENS
    num_pages: int = PRESSURE_PAGES
    host_pages: int = HOST_PAGES
    hit_tokens: int = MAX_TOKENS  # (b)'s requests


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def free(torch, device: str) -> None:
    """Release what deleted engines held (an engine and its graphs
    refer to each other, so their KV pools and graph pool wait for the
    collector)."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def graph_line(m: dict) -> str:
    """Graphs captured, and capture seconds, by kind (window / mixed)."""
    g = m["graphs"]
    if not g:
        return "none (no graphs)"
    return " / ".join(f"{kind} {g[kind]['captured']} in {g[kind]['capture_seconds']:.3f} s"
                      for kind in ("window", "mixed"))


def pages_needed(prompt_lens, max_tokens: int) -> int:
    """Pages of PS the burst holds at its end (the last sampled token
    has no KV)."""
    return sum(-(-(n + max_tokens - 1) // PS) for n in prompt_lens)


def pressure_requests(np, vocab: int, sh: Pressure) -> list[dict]:
    return [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == min(SEEDED, len(sh.prompt_lens) - 1) else {}}
        for i, ids in enumerate(phase5_prompts(np, vocab, sh.prompt_lens))
    ]


def pressure_engine(pkg, mcfg, model, kv_dtype: str, sh: Pressure):
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, num_pages=sh.num_pages,
        max_model_len=max(sh.prompt_lens) + sh.max_tokens + PS, kv_dtype=kv_dtype,
        host_cache_pages=sh.host_pages,
    )
    return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)


def seeded_model(torch, pkg, mcfg, device: str):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return pkg.models.init_params(mcfg, gen, torch.device(device))


def check_drained(eng, what: str) -> dict:
    """The engine is stopped: the page audit is clean and no page is
    held. Returns the audit's counts."""
    audit = eng.kv_audit()
    assert audit["ok"], f"{what}: page audit {audit['violations'][:5]}"
    assert audit["counts"]["active"] == 0, f"{what}: pages still held {audit['counts']}"
    return audit["counts"]


def copy_rates(c: dict) -> str:
    def rate(b, s):
        return f"{b / s / 1e9:.2f} GB/s" if s else "no timed copy"
    return (f"device->host {c.get('d2h_pages', 0)} pages, {c.get('d2h_bytes', 0)} B in "
            f"{c.get('d2h_s', 0) * 1e3:.3f} ms of copy = {rate(c.get('d2h_bytes', 0), c.get('d2h_s', 0))}; "
            f"host->device {c.get('h2d_pages', 0)} pages, {c.get('h2d_bytes', 0)} B in "
            f"{c.get('h2d_s', 0) * 1e3:.3f} ms = {rate(c.get('h2d_bytes', 0), c.get('h2d_s', 0))} "
            f"(host enqueue {c.get('h2d_host_s', 0) * 1e3:.3f} ms, uploads from pageable "
            f"memory {c.get('h2d_pageable', 0)})")


def copy_probe(torch, pkg, mcfg, counts=(42, 128), reps=3) -> dict:
    """The copy stream's two legs alone, at llama-8b bf16 pages (2 MiB a
    page, K and V) in batches of ``counts`` pages: device -> host
    through ``offload_batch`` and host (pinned) -> device through
    ``upload``. A spin kernel ahead of each leg's events holds its stream
    until the host has enqueued the copies, so the events time the
    transfer alone, not host gaps between the enqueues (the in-run
    readings of phase 7 include those). Returns {pages: (d2h GB/s, h2d
    GB/s)}, each the mean over ``reps``."""
    from dynamo_exp_tpu_torch.engine.offload import CopyStream, HostKvPool, pinned_empty

    dev = torch.device("cuda", 0)
    page = (mcfg.num_layers, PS, mcfg.num_kv_heads * mcfg.head_dim_)
    pool = HostKvPool(max(counts), page, torch.bfloat16, pin_memory=True)
    cs = CopyStream(pool, device=dev)
    out = {}
    try:
        for n in counts:
            k_b = torch.randn((page[0], n) + page[1:], device=dev).to(torch.bfloat16)
            v_b = -k_b
            k_h, v_h = (pinned_empty(k_b.shape, k_b.dtype, dev) for _ in range(2))
            k_h.copy_(k_b)
            v_h.copy_(v_b)
            d2h = h2d = 0.0
            for _ in range(reps):
                s0 = cs.stats()
                torch.cuda._sleep(20_000_000)
                ready = torch.cuda.Event()
                ready.record()
                assert cs.offload_batch(list(range(n)), k_b, v_b, ready=ready)
                cs.drain(timeout=60)
                assert cs.error is None and cs.pending == 0
                with torch.cuda.stream(cs.h2d):
                    torch.cuda._sleep(20_000_000)
                k_d, v_d = cs.upload(k_h, v_h)
                torch.cuda.synchronize()
                assert torch.equal(k_d, k_b) and torch.equal(v_d, v_b)
                s1 = cs.stats()
                d2h += (s1["d2h_bytes"] - s0["d2h_bytes"]) / (s1["d2h_s"] - s0["d2h_s"]) / 1e9
                h2d += (s1["h2d_bytes"] - s0["h2d_bytes"]) / (s1["h2d_s"] - s0["h2d_s"]) / 1e9
            assert all(torch.equal(pool.fetch(j)[0], k_h[:, j]) for j in range(n))
            out[n] = (d2h / reps, h2d / reps)
            del k_b, v_b, k_d, v_d
    finally:
        cs.stop()
    return out


def pressure_burst(torch, np, pkg, tra, smi: str, mcfg=None, sh: Pressure = Pressure()) -> dict:
    """Phase 7 (a) and (b): llama-8b at full width and depth, bf16."""
    mcfg = mcfg or pkg.models.LLAMA_8B
    cuda = sh.device == "cuda"
    model = seeded_model(torch, pkg, mcfg, sh.device)
    need = pages_needed(sh.prompt_lens, sh.max_tokens)
    requests = pressure_requests(np, mcfg.vocab_size, sh)

    # (a) the burst under a pool smaller than its need.
    eng = pressure_engine(pkg, mcfg, model, "bfloat16", sh)
    sync(torch, sh.device)
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    sync(torch, sh.device)
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    m, copies = eng.metrics(), eng.copy_stats()
    for i, (toks, finish, _) in enumerate(out):
        assert finish == "length", f"(a) request {i} finished {finish!r}"
        assert len(toks) == sh.max_tokens, f"(a) request {i} gave {len(toks)} tokens"
    assert m["swapped_out"] > 0 or m["preempted"] > 0, f"(a) no pressure: {m}"
    counts = check_drained(eng, "(a)")
    if cuda:
        assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
        assert designs["mixed_tc_bf16"] == launches["ragged_paged_attention"], designs
    total = sum(len(t) for t, _, _ in out)
    log(f"[pressure] (a) {smi}: {len(out)} requests (prompts {list(sh.prompt_lens)}, "
        f"{sh.max_tokens} tokens each) need {need} pages of {PS} at their end; pool "
        f"{sh.num_pages} pages ({sh.num_pages / need:.3f} of need), host tier "
        f"{sh.host_pages} pages: all finished 'length' with {sh.max_tokens} tokens in "
        f"{wall:.3f} s, {total / wall:.2f} tokens/s; swapped out {m['swapped_out']}, "
        f"swapped in {m['swapped_in']}, preempted {m['preempted']}, prefetched pages "
        f"{m['prefetched_pages']}, offload hits {m['offload_hits']}; pages moved: "
        f"{copy_rates(copies)}")
    log(f"[pressure] (a) launches {launches}, by kernel {designs}; dispatches "
        f"{m['dispatches']}; audit clean, pages {counts}")
    a = dict(wall_s=wall, tokens_per_s=total / wall, launches=launches, designs=designs,
             copies=copies, swapped_out=m["swapped_out"], swapped_in=m["swapped_in"],
             preempted=m["preempted"], need=need)
    del eng
    free(torch, sh.device)

    # (b) the longest prompt: cold, a G1 hit, then a G2 hit after other
    # traffic has evicted its pages to the host tier.
    eng = pressure_engine(pkg, mcfg, model, "bfloat16", sh)
    dev = eng.device
    prompt = requests[int(np.argmax(sh.prompt_lens))]["token_ids"]
    req = {"token_ids": prompt,
           "stop_conditions": {"max_tokens": sh.hit_tokens, "ignore_eos": True}}
    hashes = pkg.tokens.compute_block_hashes_for_seq(prompt, PS)
    run_engine(eng, [req])
    (g1, _, _), = run_engine(eng, [req])[0]
    pids = eng.kv.match_resident_hashes(hashes)
    assert len(pids) == len(hashes), "(b) the G1 run did not hit every prompt page"
    saved = {h: (eng.k_cache[:, p].clone(), eng.v_cache[:, p].clone())
             for h, p in zip(hashes, pids)}
    # Other prompts as long as it, enough to fill the pool once more.
    evictors = -(-sh.num_pages // pages_needed([len(prompt)], 4)) + 1
    rs = np.random.RandomState(13)
    for _ in range(evictors):
        other = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=len(prompt))]
        run_engine(eng, [{"token_ids": other,
                          "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}])
    assert eng.kv.match_resident_hashes(hashes) == [], "(b) the prompt's pages stayed resident"
    assert eng.host_pool.match_chain(hashes) == hashes, "(b) the host tier lost pages"
    for h in hashes:
        k_h, v_h = eng.host_pool.fetch(h)
        assert torch.equal(k_h.to(dev), saved[h][0]) and torch.equal(v_h.to(dev), saved[h][1]), (
            "(b) host-tier bytes differ from the device's at eviction")
    injected = {}
    apply_uploads = eng._apply_uploads

    def spy(seq):
        """The injected pages' bytes, read on the device right after the
        inject, before any forward."""
        ups = [(pid, h) for pid, h, _, _ in seq.pending_uploads]
        apply_uploads(seq)
        for pid, h in ups:
            injected[h] = (eng.k_cache[:, pid].clone(), eng.v_cache[:, pid].clone())

    eng._apply_uploads = spy
    hits0 = eng.kv.offload_hits
    (g2, _, _), = run_engine(eng, [req])[0]
    hits = eng.kv.offload_hits - hits0
    assert hits == len(hashes) and sorted(injected) == sorted(hashes), (hits, len(injected))
    for h in hashes:
        assert torch.equal(injected[h][0], saved[h][0]) and torch.equal(injected[h][1], saved[h][1]), (
            "(b) injected bytes differ from the bytes gathered at eviction")
    assert g2 == g1, "(b) the G2 hit gave other tokens than the G1 hit"
    check_drained(eng, "(b)")
    copies_b = eng.copy_stats()
    log(f"[pressure] (b) {smi}: {len(prompt)}-token prompt, G1 hit then G2 hit after "
        f"{evictors} other {len(prompt)}-token prompts: {hits} pages restored from the "
        f"host tier, bytes after injection equal the bytes gathered at eviction (and the "
        f"host tier's), {sh.hit_tokens} tokens equal between the G1 and G2 hits; pages "
        f"moved: {copy_rates(copies_b)}")
    del eng, model, saved, injected
    gc.collect()
    rates = {}
    if cuda:
        torch.cuda.empty_cache()
        rates = copy_probe(torch, pkg, mcfg)
        log(f"[pressure] copy stream alone, {smi}, llama-8b bf16 pages of 2 MiB (K+V), "
            f"events gated behind a spin kernel: " + "; ".join(
                f"{n} pages device->host {d:.2f} GB/s, host->device {h:.2f} GB/s"
                for n, (d, h) in rates.items())
            + " (host link nominal: PCIe Gen5 x16, 64 GB/s each way)")
    return dict(a=a, b_hits=hits, b_copies=copies_b, rates=rates)


def pressure_identity_f32(torch, np, pkg, tra, smi: str, mcfg=None,
                          sh: Pressure = Pressure()) -> dict:
    """Phase 7 (c): the pressured burst at float32 (llama-8b's width,
    F32_LAYERS layers, float32 weights and pools) gives each request's
    tokens run alone on the same engine."""
    from dataclasses import replace

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=F32_LAYERS, dtype="float32")
    cuda = sh.device == "cuda"
    model = seeded_model(torch, pkg, mcfg, sh.device)
    requests = pressure_requests(np, mcfg.vocab_size, sh)
    eng = pressure_engine(pkg, mcfg, model, "float32", sh)
    sync(torch, sh.device)
    tra.reset_launches()
    out, wall = run_engine(eng, requests)
    sync(torch, sh.device)
    launches, designs = dict(tra.LAUNCHES), dict(tra.KERNEL_LAUNCHES)
    m, copies = eng.metrics(), eng.copy_stats()
    assert m["swapped_out"] > 0 or m["preempted"] > 0, f"(c) no pressure: {m}"
    if cuda:
        assert designs["mixed_f32"] > 0 and designs["decode_split"] > 0, designs
        assert designs["mixed_tc_bf16"] == 0, designs
    check_drained(eng, "(c) burst")
    solo = [run_engine(eng, [r])[0][0][0] for r in requests]
    for i, ((toks, finish, _), want) in enumerate(zip(out, solo)):
        assert finish == "length" and len(toks) == sh.max_tokens, (i, finish, len(toks))
        assert toks == want, f"(c) request {i}: pressured tokens differ from its solo run"
    check_drained(eng, "(c) solo")
    log(f"[pressure] (c) {smi}: width {mcfg.hidden_size}, {mcfg.num_layers} layers, float32 "
        f"weights and pools; the pressured burst ({sh.num_pages} pages, host "
        f"{sh.host_pages}; swapped out {m['swapped_out']}, in {m['swapped_in']}, preempted "
        f"{m['preempted']}) in {wall:.3f} s gives each request's solo tokens; launches "
        f"{launches}, by kernel {designs}; pages moved: {copy_rates(copies)}")
    del eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(launches=launches, designs=designs, wall_s=wall, copies=copies,
                swapped_out=m["swapped_out"], preempted=m["preempted"])


# ------------------------------------------------------------ phase 8
CHAIN_TOKENS = 128  # (a), (b): phase 7's length, without pressure
F32_TOKENS = 48  # (c)
LP_TOP = 5  # (d): the largest top_logprobs served


@dataclass
class Phase8:
    """Phase 8's sizes: the card's by default; the CPU tests rehearse it
    smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = CHAIN_TOKENS
    f32_tokens: int = F32_TOKENS
    repeat_block: int = 64  # (b)'s ngram prompt: a block of random ids ...
    repeat_times: int = 8  # ... repeated
    http_tokens: int = MAX_TOKENS  # (d)
    lp_prompt_len: int = 512  # (d)'s completion prompt


def p8_engine(pkg, mcfg, model, kv_dtype: str, sh: Phase8, **kw):
    """Phase 5's engine shape (8 slots, a pool that holds every row's
    whole context: no pressure) with ``kw`` on top."""
    max_len = (max(*sh.prompt_lens, sh.repeat_block * sh.repeat_times)
               + max(sh.max_tokens, sh.f32_tokens) + PS)
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
        num_pages=8 * -(-max_len // PS), kv_dtype=kv_dtype, **kw,
    )
    return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)


def p8_burst(torch, eng, requests, device: str) -> dict:
    """Admit ``requests`` together and collect each stream's tokens and
    logprob packs; wall time, the loop thread's CPU seconds (read before
    the engine stops) and the engine's metrics."""

    async def collect(stream):
        r = dict(tokens=[], lps=[], tops=[], finish=None)
        async for item in stream:
            ids = item.get("token_ids", [])
            r["tokens"] += ids
            if item.get("logprobs"):
                r["lps"] += item["logprobs"]
                r["tops"] += item.get("top_logprobs") or [None] * len(ids)
            r["finish"] = item.get("finish_reason", r["finish"])
        return r

    async def go():
        streams = [eng.submit(r) for r in requests]
        t0 = time.perf_counter()
        eng.start()
        out = await asyncio.wait_for(asyncio.gather(*(collect(s) for s in streams)), 600)
        sync(torch, device)
        return out, time.perf_counter() - t0, eng.loop_cpu_seconds()

    try:
        out, wall, cpu = asyncio.run(go())
    finally:
        eng.stop()
    m = eng.metrics()
    n = sum(len(r["tokens"]) for r in out)
    pool = eng.graphs.pool_bytes() if eng.graphs is not None and device == "cuda" else 0
    return dict(out=out, tokens=[r["tokens"] for r in out], wall_s=wall, tokens_per_s=n / wall,
                loop_cpu_s=cpu, metrics=m, dispatches=dict(m["dispatches"]),
                wasted=m["decode_wasted_steps"], pool_bytes=pool)


def guard_chained_syncs(torch, eng, device: str) -> dict:
    """Wrap the engine instance's chained dispatch from outside: on the
    card each runs under ``torch.cuda.set_sync_debug_mode("error")``, so
    any host sync in it (a blocking copy, ``.item()``, ``nonzero``)
    raises and fails the run. Returns the tally of guarded dispatches."""
    tally = {"guarded": 0, "errors": []}
    dispatch = eng._dispatch_chained

    def guarded(pending):
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            nxt = dispatch(pending)
        except Exception as e:
            tally["errors"].append(repr(e))
            raise
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        tally["guarded"] += nxt is not None
        return nxt

    eng._dispatch_chained = guarded
    return tally


def greedy_requests(np, vocab: int, sh: Phase8, max_tokens: int, **so) -> list[dict]:
    return [
        {"token_ids": ids, "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
         "sampling_options": dict(so)}
        for ids in phase5_prompts(np, vocab, sh.prompt_lens)
    ]


def p8_line(r: dict) -> str:
    d = r["dispatches"]
    return (f"wall {r['wall_s']:.3f} s, {r['tokens_per_s']:.2f} tokens/s, dispatches "
            f"chained {d['chained']} / windowed {d['windowed']} / mixed {d['mixed']}, loop "
            f"CPU {r['loop_cpu_s']:.3f} s, wasted steps {r['wasted']}, graphs captured "
            f"{graph_line(r['metrics'])}, pool {r['pool_bytes'] / 2**20:.1f} MiB")


def chain_turns(torch, np, pkg, tra, smi: str, model, mcfg, sh: Phase8) -> dict:
    """(a) phase 5's prompts, all greedy (a seeded row would put the
    batch in two sampler partitions, which never chain, as in the JAX
    engine), at ``max_tokens`` each: unchained, chained, chained,
    unchained. Every run finishes every row with ``max_tokens`` tokens,
    equal across the four; the chained runs chain; every chained
    dispatch of the first chained run runs under sync debug mode
    "error"; the page audit is clean."""
    requests = greedy_requests(np, mcfg.vocab_size, sh, sh.max_tokens)
    runs, guard = [], None
    for chained in (False, True, True, False):
        eng = p8_engine(pkg, mcfg, model, "bfloat16", sh, chained_decode=chained)
        if chained and guard is None:
            guard = guard_chained_syncs(torch, eng, sh.device)
        sync(torch, sh.device)
        tra.reset_launches()
        r = p8_burst(torch, eng, requests, sh.device)
        r["designs"], r["chained_decode"] = dict(tra.KERNEL_LAUNCHES), chained
        for i, o in enumerate(r["out"]):
            assert o["finish"] == "length" and len(o["tokens"]) == sh.max_tokens, (
                f"(a) chained={chained} request {i}: {o['finish']}, {len(o['tokens'])} tokens")
        assert (r["dispatches"]["chained"] > 0) == chained, r["dispatches"]
        check_drained(eng, f"(a) chained={chained}")
        log(f"[chain] (a) {smi} chained_decode={chained}: {p8_line(r)}; launches by kernel "
            f"{r['designs']}")
        runs.append(r)
        del eng
        free(torch, sh.device)
    assert not guard["errors"] and guard["guarded"] > 0, guard
    for r in runs[1:]:
        assert r["tokens"] == runs[0]["tokens"], "(a) chained and unchained tokens differ"
    log(f"[chain] (a) tokens equal in all four runs; {guard['guarded']} chained dispatches ran "
        f"under torch.cuda.set_sync_debug_mode('error') without raising; audit clean")
    if "--profile" in sys.argv and sh.device == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        for chained in (False, True):
            eng = p8_engine(pkg, mcfg, model, "bfloat16", sh, chained_decode=chained)
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                r = p8_burst(torch, eng, requests, sh.device)
            assert r["tokens"] == runs[0]["tokens"]
            report_profile(prof, r["wall_s"], f"[profile chain={chained}]", top=6)
            del eng
            free(torch, sh.device)
    return dict(runs=runs, guard=guard, tokens=runs[0]["tokens"], designs=runs[1]["designs"])


def continuation_drafter(pkg, prompts, streams):
    """A drafter that proposes each row's own continuation from an
    earlier run (``streams`` after ``prompts``) while the row still
    agrees with that run (after a divergence it has nothing to offer),
    registered under "smoke-continuation" so ``spec_mode`` reaches it."""
    from dynamo_exp_tpu_torch.spec import Drafter, register_drafter

    table = [(list(p), list(s)) for p, s in zip(prompts, streams)]

    class Continuation(Drafter):
        name = "smoke-continuation"

        def propose(self, tokens, max_len):
            for p, s in table:
                if len(tokens) >= len(p) and tokens[:16] == p[:16] and tokens[: len(p)] == p:
                    i = len(tokens) - len(p)
                    return s[i : i + max_len] if tokens[len(p) :] == s[:i] else []
            return []

    register_drafter("smoke-continuation", lambda cfg: Continuation())
    return "smoke-continuation"


def logit_gap(torch, pkg, model, mcfg, prompt, want, got, device: str):
    """At the first position where ``got`` leaves ``want``: the context
    (prompt and ``want``'s common prefix) through one kernel forward;
    returns (index, logit of want's token minus got's, top-2 margin)."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    ctx = list(prompt) + list(want[:j])
    n, pad = len(ctx), (-len(ctx)) % 8
    pages = -(-n // PS)
    llama = pkg.models.llama
    kc, vc = llama.init_kv_cache(mcfg, pages, PS, model.embed.dtype, device)
    toks = torch.tensor(ctx + [0] * pad, device=device)
    pos = torch.tensor(list(range(n)) + [-1] * pad, dtype=torch.int32, device=device)
    rows = torch.zeros(n + pad, dtype=torch.int32, device=device)
    table = torch.arange(pages, dtype=torch.int32, device=device)[None]
    lg, _, _ = llama.forward_ragged(model, mcfg, toks, pos, rows, table, kc, vc,
                                    torch.tensor([n - 1], device=device), q_tile=8)
    top2 = torch.topk(lg[0], 2).values
    return j, float(lg[0, want[j]] - lg[0, got[j]]), float(top2[0] - top2[1])


def spec_path(torch, np, pkg, tra, smi: str, model, mcfg, sh: Phase8, base) -> dict:
    """(b) speculation at full width: (a)'s burst with a drafter that
    proposes each row's (a) continuation (long verify spans, mostly
    accepted), then ngram on a prompt built to repeat. Verify spans run
    and are accepted through the tensor-core mixed kernel; tokens equal
    to (a)'s are counted, not asserted (bf16: a verify pass scores a
    position in another batch shape than a window step)."""
    requests = greedy_requests(np, mcfg.vocab_size, sh, sh.max_tokens)
    prompts = [r["token_ids"] for r in requests]
    mode = continuation_drafter(pkg, prompts, base)
    sync(torch, sh.device)
    tra.reset_launches()
    eng = p8_engine(pkg, mcfg, model, "bfloat16", sh, spec_mode=mode,
                    spec_draft_len=8, spec_max_draft=8)
    st = p8_burst(torch, eng, requests, sh.device)
    del eng
    free(torch, sh.device)
    rs = np.random.RandomState(17)
    block = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=sh.repeat_block)]
    ngram_req = [{"token_ids": block * sh.repeat_times,
                  "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True}}]
    eng = p8_engine(pkg, mcfg, model, "bfloat16", sh, spec_mode="ngram")
    ng = p8_burst(torch, eng, ngram_req, sh.device)
    del eng
    free(torch, sh.device)
    sync(torch, sh.device)
    designs = dict(tra.KERNEL_LAUNCHES)
    for r in (st, ng):
        for o in r["out"]:
            assert o["finish"] == "length" and len(o["tokens"]) == sh.max_tokens, o["finish"]
    m, mn = st["metrics"], ng["metrics"]
    assert m["spec_row_dispatches"] > 0 and m["spec_accepted_tokens"] > 0, m
    assert mn["spec_row_dispatches"] > 0, mn
    if sh.device == "cuda":
        assert designs["mixed_tc_bf16"] > 0, designs
    equal = [sum(a == b for a, b in zip(t, w)) for t, w in zip(st["tokens"], base)]
    prefix = [next((i for i, (a, b) in enumerate(zip(t, w)) if a != b), len(t))
              for t, w in zip(st["tokens"], base)]
    gap = None
    first = next((i for i, p in enumerate(prefix) if p < sh.max_tokens), None)
    if first is not None:
        gap = logit_gap(torch, pkg, model, mcfg, prompts[first], base[first],
                        st["tokens"][first], sh.device)

    def spec_line(mm):
        return (f"verify rows {mm['spec_row_dispatches']} in {mm['spec_dispatches']} dispatches, "
                f"proposed {mm['spec_draft_tokens']} / accepted {mm['spec_accepted_tokens']} / "
                f"emitted {mm['spec_emitted_tokens']}")

    log(f"[spec] (b) {smi} drafts = each row's (a) continuation: {p8_line(st)}; "
        f"{spec_line(m)}; tokens equal to (a) {sum(equal)}/{sum(len(t) for t in base)}, "
        f"common prefix per row {prefix}"
        + (f"; first divergence row {first} at token {gap[0]}: logit of (a)'s token minus "
           f"the verify pass's {gap[1]:.4f} (top-2 margin there {gap[2]:.4f})"
           if gap else "; no divergence"))
    log(f"[spec] (b) {smi} ngram on a {sh.repeat_block}-token block repeated "
        f"{sh.repeat_times} times: {p8_line(ng)}; {spec_line(mn)}")
    log(f"[spec] (b) launches by kernel {designs}")
    return dict(static=st, ngram=ng, designs=designs, equal=equal, prefix=prefix, gap=gap)


# (c): two greedy candidates whose logprobs lie this close are a tie at
# float32. The same token's logprob moves by a few 1e-6 between the
# GEMM kernels of a batch of 8 and of 1 row at llama-8b's width (2.9e-6
# on an NVIDIA H100 80GB HBM3 at 700 W), so the order of two candidates
# closer than that is the GEMM's, not the model's.
F32_TIE = 1e-4


def divergences(want: list[dict], got: list[dict], tie: float = 0.0) -> tuple[list, list]:
    """Rows whose tokens differ, as (faults, ties): the first index, both
    tokens, both runs' logprobs of their own token and ``want``'s top-2
    margin there. A divergence is a tie when ``got``'s token is among
    ``want``'s top candidates there with a logprob within ``tie`` of
    ``want``'s token (the rows are compared no further: their contexts
    differ from there on)."""
    faults, ties = [], []
    for i, (w, g) in enumerate(zip(want, got)):
        if w["tokens"] == g["tokens"]:
            continue
        j = next(k for k, (a, b) in enumerate(zip(w["tokens"], g["tokens"])) if a != b)
        tops = w["tops"][j] if w["tops"] else None
        top = sorted((tops or {}).values(), reverse=True)
        desc = (f"row {i} at {j}: {w['tokens'][j]} (lp {w['lps'][j] if w['lps'] else None}) vs "
                f"{g['tokens'][j]} (lp {g['lps'][j] if g['lps'] else None}), top-2 margin "
                f"{top[0] - top[1] if len(top) > 1 else None}")
        tied = (tops is not None and g["tokens"][j] in tops
                and abs(w["lps"][j] - tops[g["tokens"][j]]) <= tie)
        (ties if tied else faults).append(desc)
    return faults, ties


def f32_identity(torch, np, pkg, tra, smi: str, sh: Phase8, mcfg=None) -> dict:
    """(c) llama-8b's width at 4 layers, float32 weights and pools: a
    greedy burst and a seeded burst (one sampler partition each, so
    they chain; two rows penalized), with logprobs (top 5). Chained,
    unchained, speculation by ngram and by each row's own continuation,
    and each request alone give equal tokens, up to a float32 tie
    (``divergences``); chained and unchained give equal tokens and
    logprobs (atol 1e-5)."""
    from dataclasses import replace

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=F32_LAYERS, dtype="float32")
    model = seeded_model(torch, pkg, mcfg, sh.device)
    prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
    bursts = {
        "greedy": [{} for _ in prompts],
        "seeded": [{"temperature": 0.8, "seed": 100 + i,
                    **({"presence_penalty": 0.5, "frequency_penalty": 0.3} if i % 3 == 0 else {})}
                   for i in range(len(prompts))],
    }
    sync(torch, sh.device)
    tra.reset_launches()
    out = {}
    for name, sos in bursts.items():
        reqs = [{"token_ids": p, "stop_conditions": {"max_tokens": sh.f32_tokens,
                                                     "ignore_eos": True},
                 "sampling_options": {**so, "logprobs": LP_TOP}} for p, so in zip(prompts, sos)]

        def run(**kw):
            return p8_burst(torch, p8_engine(pkg, mcfg, model, "float32", sh, **kw), reqs,
                            sh.device)

        chained = run()
        unchained = run(chained_decode=False)
        ngram = run(spec_mode="ngram")
        static = run(spec_mode=continuation_drafter(pkg, prompts, chained["tokens"]),
                     spec_draft_len=8)
        eng = p8_engine(pkg, mcfg, model, "float32", sh)
        solo = [p8_burst(torch, eng, [r], sh.device)["out"][0] for r in reqs]
        check_drained(eng, f"(c) {name}")
        del eng
        free(torch, sh.device)
        assert chained["dispatches"]["chained"] > 0, chained["dispatches"]
        assert static["metrics"]["spec_accepted_tokens"] > 0, static["metrics"]
        # Chained and unchained run the same batch shapes: equal tokens.
        # The others score positions in other shapes (verify spans, one
        # row): equal tokens up to a float32 tie, if one comes.
        ties = {}
        for what, r in (("unchained", unchained["out"]), ("ngram", ngram["out"]),
                        ("static", static["out"]), ("solo", solo)):
            faults, ties[what] = divergences(
                chained["out"], r, 0.0 if what == "unchained" else F32_TIE)
            assert not faults, f"(c) {name}: {what} tokens differ from chained: {faults}"
        tie_note = "; ".join(f"{k}: {v}" for k, v in ties.items() if v) or "none"
        lp_err = 0.0
        for a, b in zip(chained["out"], unchained["out"]):
            assert len(a["lps"]) == len(a["tokens"]) == sh.f32_tokens
            lp_err = max(lp_err, max(abs(x - y) for x, y in zip(a["lps"], b["lps"])))
            for ta, tb in zip(a["tops"], b["tops"]):
                assert list(ta) == list(tb), "(c) top-5 ids differ"
                lp_err = max(lp_err, max(abs(x - y) for x, y in zip(ta.values(), tb.values())))
        assert lp_err <= 1e-5, f"(c) {name}: chained and unchained logprobs differ by {lp_err}"
        log(f"[f32] (c) {smi} {name} burst, width {mcfg.hidden_size}, {mcfg.num_layers} layers, "
            f"float32: chained ({p8_line(chained)}), unchained, ngram (verify rows "
            f"{ngram['metrics']['spec_row_dispatches']}, accepted "
            f"{ngram['metrics']['spec_accepted_tokens']}), continuation drafts (verify rows "
            f"{static['metrics']['spec_row_dispatches']}, accepted "
            f"{static['metrics']['spec_accepted_tokens']}) and each request alone give equal "
            f"tokens (float32 ties within {F32_TIE} in logprob, rows compared up to them: "
            f"{tie_note}); chained vs unchained logprobs max abs diff {lp_err:.3e} (atol 1e-5)")
        out[name] = dict(chained=chained, lp_err=lp_err, ties=ties)
    sync(torch, sh.device)
    designs = dict(tra.KERNEL_LAUNCHES)
    if sh.device == "cuda":
        assert designs["mixed_f32"] > 0 and designs["decode_split"] > 0, designs
        assert designs["mixed_tc_bf16"] == 0, designs
    log(f"[f32] (c) launches by kernel {designs}")
    del model
    gc.collect()
    if sh.device == "cuda":
        torch.cuda.empty_cache()
    return dict(bursts=out, designs=designs)


def logprob_http(torch, np, pkg, tra, smi: str, logit_err: float, sh: Phase8,
                 mcfg=None) -> dict:
    """(d) logprobs over HTTP: ``run.main_async(in=http out=cuda)`` on
    phase 6's model directory; one streaming chat with ``logprobs:
    true, top_logprobs: 5`` and one streaming legacy completion with
    ``logprobs: 5``, both greedy."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        max_len = sh.lp_prompt_len + sh.http_tokens + 4 * PS
        argv = [
            "in=http", "out=cuda", "--device", sh.device, "--model-path", model_dir,
            "--model-name", "llama-8b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max_len), "--kv-dtype", "bfloat16",
        ]
        res = asyncio.run(asyncio.wait_for(
            _logprob_traffic(torch, np, pkg, tra, run, client, run.parse_args(argv), mcfg,
                             sh), timeout=900))
    # The tolerance: log_softmax moves by at most twice the largest
    # logit error (the token's own and the normaliser's); phase 4 reads
    # that error for a 64-token prefill; a decode row at a longer
    # context through other batch shapes gets twice that room.
    tol = 4 * logit_err
    assert res["plain_err"] <= tol, (
        f"(d) logprobs differ from log_softmax of the plain path by {res['plain_err']} > {tol}")
    log(f"[logprobs] (d) {smi}: streaming chat (top_logprobs 5) and streaming completion "
        f"(logprobs 5): one entry per token in every content frame ({res['frames']} frames, "
        f"{res['entries']} entries), chosen logprobs <= 0, the chosen token is the top-1 "
        f"(ties at bf16 logits allowed); the completion's logprobs equal the engine's own "
        f"packs and lie within {res['plain_err']:.4f} of log_softmax of the plain path's "
        f"full logits at the same {sh.http_tokens} positions (tolerance 4 x phase 4's logit "
        f"error {logit_err:.4f} = {tol:.4f}); launches by kernel {res['designs']}")
    gc.collect()
    if sh.device == "cuda":
        torch.cuda.empty_cache()
    return dict(res, tol=tol)


async def _logprob_traffic(torch, np, pkg, tra, run, client, opts, mcfg, sh: Phase8) -> dict:
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()
    served = ready.result()
    base = f"http://127.0.0.1:{served.port}"
    eng = served.torch_engine
    rs = np.random.RandomState(23)
    ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=sh.lp_prompt_len)]
    try:
        sync(torch, sh.device)
        tra.reset_launches()
        frames = {}
        for kind, path, body in (
            ("chat", "/v1/chat/completions",
             {"messages": CHATS[0], "logprobs": True, "top_logprobs": LP_TOP}),
            ("completion", "/v1/completions", {"prompt": ids, "logprobs": LP_TOP}),
        ):
            body = {"model": "llama-8b", "max_tokens": sh.http_tokens, "stream": True,
                    "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True},
                    **body}
            frames[kind] = [f.data async for f in client.sse_frames(base + path, body)]
        sync(torch, sh.device)
        designs = dict(tra.KERNEL_LAUNCHES)
        # The completion straight into the engine (its prefix cache
        # dropped, so the prompt prefills as it did over HTTP): its ids
        # and packs.
        with eng.hold_admission():
            eng.reset_prefix_cache()
            stream = eng.submit({"token_ids": ids, "stop_conditions": {
                "max_tokens": sh.http_tokens, "ignore_eos": True},
                "sampling_options": {"logprobs": LP_TOP}})
        direct = dict(tokens=[], lps=[], tops=[])
        async for item in stream:
            if item.get("token_ids"):
                direct["tokens"] += item["token_ids"]
                direct["lps"] += item["logprobs"]
                direct["tops"] += item["top_logprobs"]
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server
    n_frames = n_entries = 0
    lp_http = []
    for kind, fs in frames.items():
        assert fs[-1] == "[DONE]", kind
        prev, total, usage = 0, 0, None
        for data in fs[:-1]:
            usage = data.get("usage") or usage
            for c in data["choices"]:
                lp = c.get("logprobs")
                if not lp:
                    continue
                entries = lp["content"] if kind == "chat" else lp["token_logprobs"]
                if data.get("seq_index") is not None:
                    # One entry per token the frame carries.
                    assert len(entries) == data["seq_index"] - prev, (kind, data)
                    prev = data["seq_index"]
                total += len(entries)
                n_frames += 1
                if kind == "chat":
                    for e in entries:
                        top = e["top_logprobs"]
                        assert len(top) == LP_TOP and e["logprob"] <= 0, e
                        assert e["logprob"] == top[0]["logprob"], e  # greedy: the top-1
                        assert e["token"] in [t["token"] for t in top
                                              if t["logprob"] == top[0]["logprob"]], e
                else:
                    for tok_text, x, tops in zip(lp["tokens"], lp["token_logprobs"],
                                                 lp["top_logprobs"]):
                        assert x <= 0 and x == max(tops.values()), (tok_text, x, tops)
                    lp_http += lp["token_logprobs"]
        assert total == usage["completion_tokens"] == sh.http_tokens, (kind, total, usage)
        n_entries += total
    n = sh.http_tokens
    assert len(direct["tokens"]) == n and max(abs(a - b) for a, b in zip(lp_http, direct["lps"])) <= 1e-6
    for t, x, top in zip(direct["tokens"], direct["lps"], direct["tops"]):
        first = next(iter(top.values()))
        assert x == first and t in [i for i, v in top.items() if v == first], (t, x, top)
    # log_softmax of the plain path's full logits at the same positions.
    llama = pkg.models.llama
    seq = ids + direct["tokens"][:-1]
    P = len(ids)
    pages = -(-len(seq) // PS)
    dev = eng.device
    kc, vc = llama.init_kv_cache(mcfg, pages, PS, torch.bfloat16, dev)
    lg, _, _ = llama.forward_ragged(
        eng.model, mcfg, torch.tensor(seq, device=dev),
        torch.arange(len(seq), dtype=torch.int32, device=dev),
        torch.zeros(len(seq), dtype=torch.int32, device=dev),
        torch.arange(pages, dtype=torch.int32, device=dev)[None], kc, vc,
        torch.arange(P - 1, P - 1 + n, device=dev), attn_impl="reference")
    want = torch.log_softmax(lg, dim=-1)[torch.arange(n, device=dev),
                                         torch.tensor(direct["tokens"], device=dev)]
    plain_err = float((want.cpu() - torch.tensor(direct["lps"])).abs().max())
    del kc, vc, lg
    return dict(frames=n_frames, entries=n_entries, plain_err=plain_err, designs=designs,
                http_lps=lp_http)


def phase8(torch, np, pkg, tra, smi: str, logit_err: float, sh: Phase8 = Phase8(),
           mcfg=None, f32_mcfg=None) -> dict:
    """Phase 8: chaining, speculation and logprobs."""
    mcfg = mcfg or pkg.models.LLAMA_8B
    model = seeded_model(torch, pkg, mcfg, sh.device)
    a = chain_turns(torch, np, pkg, tra, smi, model, mcfg, sh)
    b = spec_path(torch, np, pkg, tra, smi, model, mcfg, sh, a["tokens"])
    del model
    gc.collect()
    if sh.device == "cuda":
        torch.cuda.empty_cache()
    c = f32_identity(torch, np, pkg, tra, smi, sh, f32_mcfg)
    d = logprob_http(torch, np, pkg, tra, smi, logit_err, sh, mcfg)
    return dict(a=a, b=b, c=c, d=d)


# ------------------------------------------------------------ phase 9
LOADER_LAYERS = 4  # (a): llama-8b's width at 4 layers, bf16 (about 3.9 GB)


@dataclass
class Phase9:
    """Phase 9's sizes: the card's by default; the CPU tests rehearse it
    smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = MAX_TOKENS  # (a), and (b)'s phase 5 burst
    chain_tokens: int = CHAIN_TOKENS  # (b)'s phase 8 (a) burst
    loader_layers: int = LOADER_LAYERS
    preset: str = "llama-8b"  # (b)'s warm boot
    repeat_block: int = 64  # (b)'s speculation burst: a block of random ids a row ...
    repeat_times: int = 4  # ... repeated
    second_preset: str = "llama-1b"  # (c)'s second boot, in a new process


def write_checkpoint(model, path: str, shards: int = 2) -> int:
    """``model``'s weights in HF layout as ``shards`` safetensors files
    (``models.loader.save_safetensors``, one tensor on the host at a
    time). Returns the bytes written."""
    from dynamo_exp_tpu_torch.models.loader import hf_tensor_names, save_safetensors

    names = hf_tensor_names(model.cfg)
    keys = list(names)
    per = -(-len(keys) // shards)
    total = 0
    for i in range(shards):
        part = {}
        for k in keys[i * per : (i + 1) * per]:
            li, attr = names[k]
            part[k] = getattr(model if li is None else model.layers[li], attr)
        f = os.path.join(path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors")
        save_safetensors(f, part)
        total += os.path.getsize(f)
    return total


def loader_path(torch, np, pkg, tra, smi: str, sh: Phase9 = Phase9(), mcfg=None) -> dict:
    """(a) Seeded random weights at llama-8b's width and ``loader_layers``
    layers, written as two safetensors shards beside phase 6's
    config.json and tokenizer in a temporary directory, served through
    ``run.main_async(in=http out=cuda --model-path <dir>)`` without
    ``--random-weights``: the weights on the card are bit-equal to the
    in-memory ones, and the 8 streams (phase 5's burst over HTTP) equal
    the same weights served from memory in the same batch shape (the
    loaded engine's and an in-memory engine's tokens, and the HTTP
    texts against the in-memory tokens decoded). The directory is
    deleted afterwards."""
    import tempfile
    from dataclasses import replace

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.models import loader

    mcfg = replace(mcfg or pkg.models.LLAMA_8B, num_layers=sh.loader_layers)
    model = seeded_model(torch, pkg, mcfg, sh.device)
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    timing: dict = {}
    load = loader.load_params

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        out = load(*a, **kw)
        sync(torch, sh.device)
        timing["load_s"] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "ckpt"), tokmod, mcfg, text)
        t0 = time.perf_counter()
        nbytes = write_checkpoint(model, model_dir)
        write_s = time.perf_counter() - t0
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        max_len = max(sh.prompt_lens) + sh.max_tokens + PS
        argv = [
            "in=http", "out=cuda", "--device", sh.device, "--model-path", model_dir,
            "--model-name", "ckpt", "--http-host", "127.0.0.1", "--http-port", "0",
            "--max-decode-slots", "8", "--page-size", str(PS), "--max-model-len", str(max_len),
            "--num-pages", str(8 * -(-max_len // PS)), "--kv-dtype", "bfloat16",
            "--max-tokens", str(sh.max_tokens),
        ]
        loader.load_params = timed_load
        try:
            stats = asyncio.run(asyncio.wait_for(
                _drive_loaded(torch, np, pkg, tra, tok, run.parse_args(argv), client, model,
                              mcfg, sh), timeout=900))
        finally:
            loader.load_params = load
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    assert not os.path.exists(model_dir)
    stats.update(bytes=nbytes, write_s=write_s, load_s=timing["load_s"], shards=len(shards))
    log(f"[loader] (a) {smi}: {mcfg.num_layers} layers of hidden {mcfg.hidden_size}, "
        f"{nbytes / 1e9:.3f} GB in {len(shards)} shards written in {write_s:.2f} s; "
        f"run.main_async(--model-path, no --random-weights) loaded them in "
        f"{timing['load_s']:.3f} s ({nbytes / timing['load_s'] / 1e9:.2f} GB/s read and "
        f"copied to the {sh.device}); weights bit-equal to the in-memory model; the "
        f"{len(stats['tokens'])} streams "
        f"equal the in-memory weights' (tokens, and HTTP text); launches by kernel "
        f"{stats['designs']}; directory deleted")
    del model
    gc.collect()
    if sh.device == "cuda":
        torch.cuda.empty_cache()
    return stats


async def _drive_loaded(torch, np, pkg, tra, tok, opts, client, model, mcfg, sh) -> dict:
    from dynamo_exp_tpu_torch import run

    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    served = ready.result()
    eng = served.torch_engine
    try:
        mine, got = dict(model.named_parameters()), dict(eng.model.named_parameters())
        assert got.keys() == mine.keys(), sorted(set(got) ^ set(mine))
        differ = [n for n, p in mine.items() if not torch.equal(got[n], p)]
        assert not differ, f"(a) loaded weights differ from the in-memory ones: {differ[:5]}"
        prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
        seeded = min(SEEDED, len(prompts) - 1)
        requests = [
            {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens,
                                                   "ignore_eos": True},
             "sampling_options": SEEDED_OPTIONS if i == seeded else {}}
            for i, ids in enumerate(prompts)
        ]
        bodies = [
            {"model": "ckpt", "prompt": ids, "max_tokens": sh.max_tokens, "stream": True,
             "stream_options": {"include_usage": True}, "nvext": {"ignore_eos": True},
             **(SEEDED_OPTIONS if i == seeded else {})}
            for i, ids in enumerate(prompts)
        ]
        sync(torch, sh.device)
        tra.reset_launches()
        http_out, wall, _, _ = await burst(
            client, eng, f"http://127.0.0.1:{served.port}/v1/completions", bodies,
            reset_cache=False)
        designs = dict(tra.KERNEL_LAUNCHES)
        for i, r in enumerate(http_out):
            assert r["done"] and r["finish"] == "length", f"(a) request {i}: {r['finish']}"
        loaded, *_ = await direct_burst(eng, requests)
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server
    mem = pkg.engine.TorchEngine(eng.cfg, model=model, device=sh.device)
    try:
        in_memory, *_ = await direct_burst(mem, requests)
    finally:
        mem.stop()
    want = [r["tokens"] for r in in_memory]
    assert all(len(t) == sh.max_tokens for t in want)
    assert [r["tokens"] for r in loaded] == want, "(a) loaded and in-memory tokens differ"
    texts = [r["text"] == streamed_text(tok, t) for r, t in zip(http_out, want)]
    assert all(texts), f"(a) HTTP texts against the in-memory tokens: {texts}"
    return dict(designs=designs, http_wall_s=wall, tokens=want)


@contextlib.contextmanager
def mixed_padding():
    """Record every mixed dispatch's flat stream before and after its
    padding to the token bucket, as ``(q_tile-aligned tokens, key)``,
    through a wrapper on the engine module's key resolution."""
    mod = sys.modules["dynamo_exp_tpu_torch.engine.engine"]
    resolve, seen = mod.resolve_mixed_key, []

    def spy(cfg, attn_impl, n_tokens, *a):
        key = resolve(cfg, attn_impl, n_tokens, *a)
        seen.append((n_tokens, key))
        return key

    mod.resolve_mixed_key = spy
    try:
        yield seen
    finally:
        mod.resolve_mixed_key = resolve


@contextlib.contextmanager
def speculation(eng, on: bool):
    """A burst on an engine built with speculation, with it on or set
    aside (its drafter manager ``_spec``), so the burst dispatches as an
    engine without speculation would."""
    saved = eng._spec
    if not on:
        eng._spec = None
    try:
        yield
    finally:
        eng._spec = saved


def spec_burst_requests(np, vocab: int, sh: "Phase9") -> list[dict]:
    """(b)'s speculation burst: one prompt a row, each a block of random
    ids repeated (the n-gram drafter's food), all greedy."""
    rs = np.random.RandomState(19)
    return [
        {"token_ids": [int(t) for t in rs.randint(3, vocab, size=sh.repeat_block)]
         * sh.repeat_times,
         "stop_conditions": {"max_tokens": sh.chain_tokens, "ignore_eos": True}}
        for _ in sh.prompt_lens
    ]


def padding_line(seen: list) -> str:
    real = sum(n for n, _ in seen)
    padded = sum(k.tokens for _, k in seen)
    pairs = ", ".join(f"{n}->{k.tokens}" for n, k in seen[:12])
    more = f", ... ({len(seen) - 12} more)" if len(seen) > 12 else ""
    return (f"{len(seen)} mixed dispatches, flat tokens real (q_tile-aligned) {real} / padded "
            f"{padded} ({100 * (padded - real) / max(padded, 1):.1f} % padding): {pairs}{more}")


def warm_boot(torch, np, pkg, tra, smi: str, cache_dir: str, sh: Phase9 = Phase9()) -> dict:
    """(b) ``run.build_cuda_engine(--preset llama-8b --spec ngram
    --prewarm --compile-cache-dir)``: llama-8b at full width and depth,
    every window and mixed variant (verify spans too) captured before
    traffic. Then phase 8 (a)'s greedy burst and phase 5's burst (a
    seeded row: two sampler partitions), both with speculation set
    aside, and a speculation burst (the n-gram drafter on repeated
    blocks), through the prewarmed engine (graphs) and an eager engine on
    the same weights (``cuda_graphs=False``), in turns (graphed, eager,
    eager, graphed): equal tokens bit for bit, equal launch counts, the
    speculation burst's verify spans replayed from verify-span graphs,
    and no graph captured after the prewarm. Each run's mixed dispatches
    are printed with their flat tokens before and after padding."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch.aot import MixedKey, build_manifest

    max_len = (max(*sh.prompt_lens, sh.repeat_block * sh.repeat_times)
               + max(sh.chain_tokens, sh.max_tokens) + PS)
    argv = [
        "out=cuda", "--device", sh.device, "--preset", sh.preset, "--max-decode-slots", "8",
        "--page-size", str(PS), "--max-model-len", str(max_len),
        "--num-pages", str(8 * -(-max_len // PS)), "--kv-dtype", "bfloat16",
        "--spec", "ngram", "--prewarm", "--compile-cache-dir", cache_dir,
    ]
    t0 = time.perf_counter()
    warm, _ = run.build_cuda_engine(run.parse_args(argv))
    boot_s = time.perf_counter() - t0
    report = warm.metrics()["prewarm"]
    graphs_on = warm.graphs is not None
    manifest = build_manifest(warm.cfg, warm.attn_impl)
    assert report["variants"] == len(manifest.windows) > 0, report
    assert report["mixed_variants"] == len(manifest.mixed) > 0, report
    assert any(k.with_spec for k in manifest.mixed)
    assert report["graphs"] == (report["variants"] if graphs_on else 0), report
    assert report["mixed_graphs"] == (report["mixed_variants"] if graphs_on else 0), report
    assert report["builds"] == (1 if sh.device == "cuda" else 0), report
    log(f"[warm] (b) {smi}: {sh.preset} booted with --spec ngram --prewarm in {boot_s:.2f} s: "
        f"{report['variants']} window variants ({report['graphs']} CUDA graphs) in "
        f"{report['window_seconds']:.2f} s, {report['mixed_variants']} mixed variants "
        f"({report['mixed_graphs']} CUDA graphs, buckets "
        f"{sorted({k.tokens for k in manifest.mixed})}) in {report['mixed_seconds']:.2f} s, "
        f"{report['builds']} kernel build(s) into the cache dir, prewarm "
        f"{report['seconds']:.2f} s, graph pool {report['pool_bytes']} bytes "
        f"({report['pool_bytes'] / 2**20:.1f} MiB)")
    eager = pkg.engine.TorchEngine(replace(warm.cfg, cuda_graphs=False), model=warm.model,
                                   device=sh.device)
    vocab = warm.cfg.model.vocab_size
    p8 = Phase8(device=sh.device, prompt_lens=sh.prompt_lens)
    seeded = min(SEEDED, len(sh.prompt_lens) - 1)
    bursts = {
        "8a": (False, greedy_requests(np, vocab, p8, sh.chain_tokens)),
        "5": (False, [
            {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens,
                                                   "ignore_eos": True},
             "sampling_options": SEEDED_OPTIONS if i == seeded else {}}
            for i, ids in enumerate(phase5_prompts(np, vocab, sh.prompt_lens))
        ]),
        "spec": (True, spec_burst_requests(np, vocab, sh)),
    }
    results = {}

    def spec_replays() -> int:
        return sum(g.replays for k, g in (warm.graphs.graphs.items() if graphs_on else ())
                   if isinstance(k, MixedKey) and k.with_spec)

    for name, (spec_on, requests) in bursts.items():
        n = requests[0]["stop_conditions"]["max_tokens"]
        runs = []
        for kind, eng in (("graphed", warm), ("eager", eager), ("eager", eager),
                          ("graphed", warm)):
            eng.reset_prefix_cache()  # each run prefills as a cold engine would
            m0 = eng.metrics()
            mixed_replays = m0["graphs"].get("mixed", {}).get("replays", 0)
            verify = spec_replays()
            sync(torch, sh.device)
            tra.reset_launches()
            with speculation(eng, spec_on), mixed_padding() as seen:
                r = p8_burst(torch, eng, requests, sh.device)
            r["designs"], r["kind"], r["padding"] = dict(tra.KERNEL_LAUNCHES), kind, seen
            m = r["metrics"]  # the engine's, since its boot: this run's is the difference
            r["mixed_replays"] = m["graphs"].get("mixed", {}).get("replays", 0) - mixed_replays
            r["dispatches"] = {k: v - m0["dispatches"][k] for k, v in m["dispatches"].items()}
            spec_m = {k: m[k] - m0[k] for k in ("spec_row_dispatches", "spec_dispatches",
                                                "spec_draft_tokens", "spec_accepted_tokens",
                                                "spec_emitted_tokens")}
            r["verify_replays"] = spec_replays() - verify
            for i, o in enumerate(r["out"]):
                assert o["finish"] == "length" and len(o["tokens"]) == n, (
                    f"(b) burst {name} {kind} request {i}: {o['finish']}, {len(o['tokens'])}")
            graphed = kind == "graphed" and graphs_on
            assert (r["mixed_replays"] > 0) == graphed, r["mixed_replays"]
            assert r["mixed_replays"] == (len(seen) if graphed else 0), (r["mixed_replays"], seen)
            with_spec = sum(k.with_spec for _, k in seen)
            assert (with_spec > 0) == spec_on, with_spec
            assert r["verify_replays"] == (with_spec if graphed else 0), r["verify_replays"]
            log(f"[warm] (b) burst {name} {kind}: wall {r['wall_s']:.3f} s, "
                f"{r['tokens_per_s']:.2f} tokens/s, loop CPU {r['loop_cpu_s']:.3f} s, mixed "
                f"graph replays {r['mixed_replays']} (verify spans {r['verify_replays']}), "
                f"dispatches {r['dispatches']}, launches by kernel {r['designs']}")
            log(f"[warm] (b) burst {name} {kind}: {padding_line(seen)}")
            if spec_on:
                sm = spec_m
                log(f"[warm] (b) burst {name} {kind}: verify rows {sm['spec_row_dispatches']} in "
                    f"{sm['spec_dispatches']} dispatches, proposed {sm['spec_draft_tokens']} / "
                    f"accepted {sm['spec_accepted_tokens']} / emitted "
                    f"{sm['spec_emitted_tokens']}")
            runs.append(r)
        for r in runs[1:]:
            assert r["tokens"] == runs[0]["tokens"], f"(b) burst {name}: graphed and eager differ"
            assert r["designs"] == runs[0]["designs"], (
                f"(b) burst {name}: launches differ {r['designs']} / {runs[0]['designs']}")
        if "--profile" in sys.argv and sh.device == "cuda":
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            for kind, eng in (("graphed", warm), ("eager", eager)):
                eng.reset_prefix_cache()
                with speculation(eng, spec_on), tprofile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    r = p8_burst(torch, eng, requests, sh.device)
                assert r["tokens"] == runs[0]["tokens"]
                report_profile(prof, r["wall_s"], f"[profile warm {name} {kind}]", top=6)
        results[name] = runs
        log(f"[warm] (b) burst {name}: tokens bit-equal and launch counts equal in all four "
            f"runs (graphed / eager / eager / graphed)")
    m = warm.metrics()
    captured = m["graphs_captured"]
    assert captured == report["graphs"] + report["mixed_graphs"], (
        f"(b) traffic captured {captured - report['graphs'] - report['mixed_graphs']}")
    check_drained(warm, "(b) graphed")
    check_drained(eager, "(b) eager")
    log(f"[warm] (b) no graph captured after the prewarm ({graph_line(m)}); audits clean")
    del warm, eager
    free(torch, sh.device)
    return dict(report=report, boot_s=boot_s, bursts=results,
                designs=results["8a"][0]["designs"], designs_spec=results["spec"][0]["designs"])


def second_boot(cache_dir: str, smi: str, sh: Phase9 = Phase9()) -> dict:
    """(c) A new process boots against (b)'s ``--compile-cache-dir``
    (``--preset second_preset --prewarm``, one slot and 64 tokens: a
    lattice of 4 windows, since only the boot is under test): it runs
    no nvcc (``builds: 0``). Its graphs are captured anew: graphs do
    not outlive a process."""
    argv = [
        "out=cuda", "--device", sh.device, "--preset", sh.second_preset,
        "--max-decode-slots", "1", "--page-size", str(PS), "--max-model-len", "64",
        "--kv-dtype", "bfloat16", "--prewarm", "--compile-cache-dir", cache_dir,
    ]
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "from dynamo_exp_tpu_torch import run\n"
        f"engine, _ = run.build_cuda_engine(run.parse_args({argv!r}))\n"
        "print(json.dumps(engine.metrics()['prewarm']))\n"
        "engine.stop()\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=HERE)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"(c) second boot failed:\n{proc.stderr[-4000:]}"
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["builds"] == 0, f"(c) second boot ran nvcc: {report}"
    with open(os.path.join(cache_dir, "manifest.json"), encoding="utf-8") as f:
        record = json.load(f)
    assert record["manifest_hash"] == report["manifest_hash"]
    log(f"[warm] (c) {smi}: a new process booted {sh.second_preset} against the same "
        f"--compile-cache-dir in {wall:.2f} s: builds {report['builds']} (no nvcc), "
        f"{report['variants']} variants, {report['graphs']} graphs captured anew, prewarm "
        f"{report['seconds']:.2f} s; manifest.json holds its hash and "
        f"{len(record['kernels'])} source hashes")
    return dict(report=report, wall_s=wall)


def phase9(torch, np, pkg, tra, smi: str, sh: Phase9 = Phase9(), mcfg=None) -> dict:
    """Phase 9: real checkpoints and warm boot."""
    import tempfile

    a = loader_path(torch, np, pkg, tra, smi, sh, mcfg)
    with tempfile.TemporaryDirectory() as cache_dir:
        b = warm_boot(torch, np, pkg, tra, smi, cache_dir, sh)
        c = second_boot(cache_dir, smi, sh)
    return dict(a=a, b=b, c=c)


# ------------------------------------------------------------ phase 10
@dataclass
class Phase10:
    """Phase 10's sizes and targets: the card's by default; the CPU test
    rehearses it smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    stream_tokens: int = 256  # (a), (b): the long streams that fill the pool
    probe_tokens: int = 8  # (a)'s admitted probes
    max_inflight: int = 10
    shed_watermark: int = 6
    # TTFT: a request queued behind 8 streams of 256 tokens waits at least
    # 256 decode steps (1.2 s at llama-8b's weight reads at 3.35 TB/s), so
    # it misses; a lone warm request meets it.
    slo_ttft_ms: float = 1000.0
    # ITL: a window's 8 tokens arrive together; even a window whose key
    # is captured at first use (0.54-0.67 s in an H100 prewarm) stays under it.
    slo_itl_ms: float = 100.0
    deadline_s: float = 0.5  # (b): behind a busy pool (>= 1.2 s), unmeetable
    decode_tokens: int = 1024  # (b): a lone stream, >= 4.9 s of decode steps ...
    decode_deadline_s: float = 3.0  # ... whose deadline falls inside its decode
    burst_tokens: int = MAX_TOKENS  # (d): phase 5's burst


def _family_values(text: str) -> dict:
    """Prometheus text as {(sample name, sorted labels): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, _, value = line.rpartition(" ")
        name, _, labels = name_labels.partition("{")
        pairs = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels)))
        out[(name, pairs)] = float(value)
    return out


def _delta(after: dict, before: dict, name: str) -> dict:
    """The samples of ``name`` that moved: {sorted labels: change}."""
    return {k[1]: v - before.get(k, 0.0) for k, v in after.items()
            if k[0] == name and v != before.get(k, 0.0)}


async def _stream(client, url: str, body: dict, first: asyncio.Event | None = None) -> dict:
    """One streaming request (with usage in its last frame): its data
    frames, text, finish reason and completion tokens; ``first`` is set
    at its first frame."""
    frames, text, finish, usage = [], [], None, None
    async for f in client.sse_frames(url, {**body, "stream": True,
                                           "stream_options": {"include_usage": True}}):
        assert f.event != "error", f"stream error: {f.comment}"
        if f.data == "[DONE]":
            break
        frames.append(f.data)
        if first is not None:
            first.set()
        usage = f.data.get("usage") or usage
        for c in f.data["choices"]:
            if c.get("text"):
                text.append(c["text"])
            finish = c.get("finish_reason") or finish
    return dict(status=200, frames=frames, text="".join(text), finish=finish, stream=True,
                tokens=usage["completion_tokens"] if usage else 0)


def phase10(torch, np, pkg, tra, smi: str, sh: Phase10 = Phase10(), mcfg=None) -> dict:
    """Phase 10: the port's observable, overload-protected HTTP edge."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    old_dump = os.environ.get("DYN_FLIGHT_DUMP")
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        trace_file = os.path.join(tmp, "spans.jsonl")
        dump_file = os.path.join(tmp, "flight.jsonl")
        os.environ["DYN_FLIGHT_DUMP"] = dump_file
        max_len = max(max(sh.prompt_lens) + sh.stream_tokens, 64 + sh.decode_tokens) + PS
        argv = [
            "in=http", "out=cuda", "--device", sh.device, "--model-path", model_dir,
            "--model-name", "llama-8b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max_len), "--num-pages", str(8 * -(-max_len // PS)),
            "--kv-dtype", "bfloat16", "--max-tokens", str(sh.stream_tokens),
            "--max-inflight", str(sh.max_inflight), "--shed-watermark", str(sh.shed_watermark),
            "--slo-ttft-ms", str(sh.slo_ttft_ms), "--slo-itl-ms", str(sh.slo_itl_ms),
            "--trace-file", trace_file,
        ]
        try:
            out = asyncio.run(asyncio.wait_for(
                _drive_edge(torch, np, pkg, tra, smi, run.parse_args(argv), client, mcfg, sh,
                            trace_file, dump_file), timeout=900))
        finally:
            if old_dump is None:
                os.environ.pop("DYN_FLIGHT_DUMP", None)
            else:
                os.environ["DYN_FLIGHT_DUMP"] = old_dump
            from dynamo_exp_tpu_torch.telemetry import get_telemetry

            get_telemetry().configure(None)
    model = out.pop("model")
    out["d"] = telemetry_turns(torch, np, pkg, tra, smi, model, mcfg, sh)
    del model
    free(torch, sh.device)
    return out


async def _drive_edge(torch, np, pkg, tra, smi, opts, client, mcfg, sh, trace_file,
                      dump_file) -> dict:
    from dynamo_exp_tpu_torch import run

    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    served = ready.result()
    try:
        out = await _edge_traffic(torch, np, pkg, tra, smi, client, served, mcfg, sh,
                                  trace_file, dump_file)
        out["model"] = served.torch_engine.model
        return out
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server


async def _edge_traffic(torch, np, pkg, tra, smi, client, served, mcfg, sh, trace_file,
                        dump_file) -> dict:
    from dynamo_exp_tpu_torch.telemetry import dump_all

    base = f"http://127.0.0.1:{served.port}"
    url = base + "/v1/completions"
    eng, svc = served.torch_engine, served.service
    adm = svc.admission
    assert eng.graphs is not None or sh.device != "cuda"
    assert eng.prewarm_report is None  # first-use captures happen under traffic
    prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
    sent: list[dict] = []  # every answer, as the client saw it

    def body(ids, n, **kw):
        return {"model": "llama-8b", "prompt": ids, "max_tokens": n,
                "nvext": {"ignore_eos": True}, **kw}

    async def scrape() -> tuple[str, dict]:
        r = await client.request(base + "/metrics")
        assert r.status == 200 and r.headers["content-type"].startswith("text/plain")
        text = r.body.decode()
        return text, _family_values(text)

    async def fill_pool(tag: str) -> list:
        """Phase 5's 8 prompts as long streams at normal priority; returns
        once every one has its first frame (all 8 slots bound)."""
        firsts = [asyncio.Event() for _ in prompts]
        tasks = [asyncio.ensure_future(_stream(client, url, body(ids, sh.stream_tokens), ev))
                 for ids, ev in zip(prompts, firsts)]
        await asyncio.wait_for(asyncio.gather(*(ev.wait() for ev in firsts)), 600)
        assert not any(t.done() for t in tasks), f"{tag}: a stream ended before the rest began"
        assert adm.inflight == len(prompts), adm.inflight
        return tasks

    def check_streams(results, tag):
        for i, r in enumerate(results):
            assert r["finish"] == "length" and r["tokens"] == sh.stream_tokens, (
                tag, i, r["finish"], r["tokens"])
        sent.extend(results)

    sync(torch, sh.device)
    tra.reset_launches()
    text0, m0 = await scrape()
    slo0 = (svc.slo.completed, svc.slo.goodput_total, dict(svc.slo.violations))
    eng.flight.clear()

    # (a) Overload: the edge holds 8 streams; probes in a fixed order.
    t0 = time.perf_counter()
    streams = await fill_pool("(a)")
    thresholds = {name: adm.threshold(p) for name, p in (("low", 0), ("normal", 1),
                                                          ("high", 2))}
    probes, admitted = [], []
    for prio in ("low", "normal", "high", "high", "high", "low"):
        n = adm.inflight
        task = asyncio.ensure_future(client.request(
            url, "POST", body(prompts[0][:64], sh.probe_tokens), {"X-Request-Priority": prio}))
        while not task.done() and adm.inflight == n:
            await asyncio.sleep(0.002)
        if task.done():
            r = task.result()
            assert r.status in (429, 503), (prio, r.status, r.body)
            assert r.headers.get("retry-after") == "1", r.headers
            err = r.json()["error"]
            assert err["type"] == ("service_overloaded" if r.status == 503 else "request_shed")
            probes.append((prio, r.status))
            sent.append(dict(status=r.status, stream=False, shed=True))
        else:
            probes.append((prio, "admitted"))
            admitted.append(task)
    assert probes == [("low", 429), ("normal", 429), ("high", "admitted"),
                      ("high", "admitted"), ("high", 503), ("low", 503)], probes
    check_streams(await asyncio.gather(*streams), "(a)")
    for t in admitted:
        r = t.result() if t.done() else await t
        assert r.status == 200 and r.json()["choices"][0]["finish_reason"] == "length", r.body
        sent.append(dict(status=200, stream=False))
    a_wall = time.perf_counter() - t0
    # The edge releases a request's slot once its last frame is written.
    for _ in range(1000):
        if adm.inflight == 0:
            break
        await asyncio.sleep(0.005)
    assert adm.inflight == 0, adm.inflight
    _, m_a = await scrape()
    shed = _delta(m_a, m0, "dynamo_requests_shed_total")
    client_shed = {}
    for prio, status in probes:
        if status != "admitted":
            key = (("code", str(status)), ("priority", prio))
            client_shed[key] = client_shed.get(key, 0) + 1
    assert shed == client_shed, (shed, client_shed)
    assert m_a[("dynamo_admission_inflight", ())] == 0
    shed_line = {"/".join(v for _, v in k): int(n) for k, n in shed.items()}
    log(f"[edge] (a) {smi}: 8 streams of {sh.stream_tokens} tokens held the edge at 8 in flight "
        f"(thresholds low/normal/high {thresholds['low']}/{thresholds['normal']}/"
        f"{thresholds['high']}, cap {adm.max_inflight}); probes {probes}; "
        f"dynamo_requests_shed_total code/priority {shed_line} equals the client's count; "
        f"every admitted stream finished at full length; wall {a_wall:.3f} s; in flight back "
        f"to 0")

    # (b) Deadlines. Behind a full pool: a request with no deadline
    # (high priority passes the edge; it waits the streams' decode, so it
    # misses the TTFT target) and one whose deadline passes first.
    streams = await fill_pool("(b)")
    queued = asyncio.ensure_future(_stream(
        client, url, body(prompts[1][:64], sh.probe_tokens, priority="high")))
    t0 = time.perf_counter()
    late = await client.request(url, "POST", body(prompts[0][:64], sh.probe_tokens,
                                                  timeout_s=sh.deadline_s,
                                                  priority="high"))
    late_s = time.perf_counter() - t0
    assert late.status == 200, late.body
    late_body = late.json()
    assert late_body["choices"][0]["finish_reason"] == "error", late_body
    assert late_body["choices"][0]["text"] == "", late_body
    assert not queued.done() and not any(t.done() for t in streams)
    sent.append(dict(status=200, stream=False))
    check_streams(await asyncio.gather(*streams), "(b)")
    q = await queued
    assert q["finish"] == "length" and q["tokens"] == sh.probe_tokens, q
    sent.append(q)
    _, m_b1 = await scrape()
    dl = _delta(m_b1, m_a, "dynamo_deadline_exceeded_total")
    assert dl == {(("stage", "engine_admission"),): 1.0}, dl
    with eng.hold_admission():
        audit = eng.kv_audit()
    assert audit["ok"] and audit["counts"]["active"] == 0, audit
    # A generous deadline gives the tokens of the same request without one.
    gen = body(prompts[2][:64], sh.probe_tokens)
    generous = await client.request(url, "POST", {**gen, "timeout_s": 600})
    plain = await client.request(url, "POST", gen)
    assert generous.status == plain.status == 200
    assert generous.json()["choices"] == plain.json()["choices"], (
        generous.json(), plain.json())
    sent += [dict(status=200, stream=False)] * 2
    # A lone stream whose deadline falls inside its decode: finishes
    # "error" with its tokens so far, the start of the same request's
    # tokens without a deadline.
    dstream = await _stream(client, url, body(prompts[3][:64], sh.decode_tokens,
                                              timeout_s=sh.decode_deadline_s))
    sent.append(dstream)
    got_tokens = dstream["tokens"]
    assert dstream["finish"] == "error", dstream["finish"]
    assert 0 < got_tokens < sh.decode_tokens, got_tokens
    ref = await client.request(url, "POST", body(prompts[3][:64], got_tokens))
    sent.append(dict(status=200, stream=False))
    assert ref.json()["choices"][0]["text"] == dstream["text"], "deadline prefix"
    _, m_b = await scrape()
    dl = _delta(m_b, m_a, "dynamo_deadline_exceeded_total")
    assert dl == {(("stage", "engine_admission"),): 1.0, (("stage", "decode"),): 1.0}, dl
    with eng.hold_admission():
        audit = eng.kv_audit()
    assert audit["ok"] and audit["counts"]["active"] == 0, audit
    log(f"[edge] (b) {smi}: timeout_s {sh.deadline_s} behind a full pool: 200, finish_reason "
        f"'error', no text, answered after {late_s:.3f} s, "
        f"dynamo_deadline_exceeded_total{{stage=engine_admission}} +1; a lone stream with "
        f"timeout_s {sh.decode_deadline_s} finished 'error' after {got_tokens} of "
        f"{sh.decode_tokens} tokens, its text the start of the same request's without a "
        f"deadline, {{stage=decode}} +1; timeout_s 600 gave the text of no deadline; page "
        f"audits clean")

    # (c) Accounting against independent counts.
    text1, m1 = await scrape()
    req = _delta(m1, m0, "llm_http_service_requests_total")
    client_req: dict = {}
    for r in sent:
        if r.get("shed"):
            rt, status = "shed", f"shed_{r['status']}"
        else:
            rt, status = ("stream" if r["stream"] else "unary"), "success"
        key = (("endpoint", "completions"), ("model", "llama-8b"), ("request_type", rt),
               ("status", status))
        client_req[key] = client_req.get(key, 0) + 1
    assert req == client_req, (req, client_req)
    ttft_count = _delta(m1, m0, "llm_http_service_time_to_first_token_seconds_count")
    framed = sum(1 for r in sent if r.get("stream") and r["frames"])
    assert sum(ttft_count.values()) == framed, (ttft_count, framed)
    slo = svc.slo
    completed = slo.completed - slo0[0]
    goodput = slo.goodput_total - slo0[1]
    violations = {k: v - slo0[2][k] for k, v in slo.violations.items()}
    good = _delta(m1, m0, "dynamo_goodput_requests_total")
    bad = _delta(m1, m0, "dynamo_slo_violations_total")
    assert sum(good.values()) == goodput and sum(bad.values()) == sum(violations.values())
    roots = []
    with open(trace_file, encoding="utf-8") as f:
        for line in f:
            ev = json.loads(line)["event"]
            if ev["stage"] == "http_request" and "ttft_s" in ev["attrs"]:
                roots.append(ev["attrs"])
    ttft_t, itl_t = slo.cfg.ttft_s, slo.cfg.itl_s
    over = {"ttft": sum(a["ttft_s"] > ttft_t for a in roots),
            "itl": sum(a.get("itl_s", 0.0) > itl_t for a in roots)}
    violating = sum(a["ttft_s"] > ttft_t or a.get("itl_s", 0.0) > itl_t for a in roots)
    assert len(roots) == completed, (len(roots), completed)
    assert goodput + violating == completed, (goodput, violating, completed)
    assert over == violations, (over, violations)
    assert goodput > 0 and violations["ttft"] > 0, (goodput, violations)
    m = eng.metrics()
    compile_counts = {k[0][1]: int(v) for k, v in
                      _delta(m1, m0, "dynamo_compile_seconds_count").items()}
    captures = {k: g["captured"] for k, g in m["graphs"].items() if g["captured"]}
    if eng.graphs is not None:
        assert compile_counts == captures, (compile_counts, captures)
    n_dumped = dump_all("smoke")
    assert n_dumped == 1, n_dumped
    from dynamo_exp_tpu_torch.telemetry import load_dumps

    blocks = load_dumps(dump_file)
    assert [b["header"]["reason"] for b in blocks] == ["smoke"], blocks[0]["header"]
    events = blocks[0]["events"]
    assert events and events[0]["seq"] == 0, "the flight ring wrapped"
    ragged = sum(1 for e in events if e["kind"] == "dispatch" and e["dispatch"] == "ragged")
    disp = m["dispatches"]
    assert ragged == disp["windowed"] + disp["mixed"], (ragged, disp)
    assert eng._watchdog is not None and eng._watchdog.dumps == 0
    designs = dict(tra.KERNEL_LAUNCHES)
    if sh.device == "cuda":
        assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
    families = text1.count("# TYPE")
    req_line = {f"{dict(k)['request_type']}/{dict(k)['status']}": int(v) for k, v in req.items()}
    log(f"[edge] (c) {smi}: requests by status {len(sent)} = the client's ({req_line}); "
        f"TTFT samples {int(sum(ttft_count.values()))} = streams with a frame; goodput "
        f"{goodput} + violating {violating} = completed {completed} (violations {violations}, "
        f"= the trace file's root spans over {ttft_t * 1e3:.0f} / {itl_t * 1e3:.0f} ms); "
        f"compile_seconds counts {compile_counts} = captures by kind; flight dump: "
        f"{len(events)} events, {ragged} ragged dispatch events = the engine's dispatches "
        f"{disp}; no watchdog dump; launches by kernel {designs}")
    log(f"[edge] (c) {smi}: /metrics scrape {len(text1.encode())} bytes, {families} families, "
        f"{sum(1 for ln in text1.splitlines() if ln and not ln.startswith('#'))} samples; "
        f"graphs {graph_line(m)}")
    return dict(probes=probes, shed=shed, designs=designs, scrape_bytes=len(text1.encode()),
                families=families, compile_counts=compile_counts,
                goodput=goodput, violations=violations, completed=completed,
                events=len(events), captures=captures, a_wall_s=a_wall)


def telemetry_turns(torch, np, pkg, tra, smi, model, mcfg, sh: Phase10) -> dict:
    """(d) Phase 5's burst straight to ``TorchEngine``, telemetry on
    (flight events, dispatch profiling) and off, in turns on, off, off,
    on, after one untimed burst on each engine (its graphs captured):
    tokens and launch counts bit-equal in all four runs, the two "on"
    runs' flight events equal (``t`` aside), and every dispatch of the
    "on" engine's timed runs (and its gauge publish) under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from dynamo_exp_tpu_torch.runtime.engine import AsyncEngineContext

    max_len = max(sh.prompt_lens) + sh.burst_tokens + PS
    seeded = min(SEEDED, len(sh.prompt_lens) - 1)
    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.burst_tokens,
                                               "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == seeded else {}}
        for i, ids in enumerate(phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens))
    ]

    def engine(on: bool):
        ecfg = pkg.engine.EngineConfig(
            model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
            num_pages=8 * -(-max_len // PS), kv_dtype="bfloat16", flight_events=on,
            profile_dispatches=on,
        )
        return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)

    guard = {"guarded": 0, "errors": []}

    def guarded(fn):
        def call(*a, **kw):
            if sh.device == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            except Exception as e:
                guard["errors"].append(repr(e))
                raise
            finally:
                if sh.device == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            guard["guarded"] += 1
            return out
        return call

    async def burst(eng):
        async def collect(stream):
            return [t async for item in stream for t in item.get("token_ids", [])]

        streams = [eng.submit(r, AsyncEngineContext(f"req{i}")) for i, r in enumerate(requests)]
        t0 = time.perf_counter()
        eng.start()
        out = await asyncio.wait_for(asyncio.gather(*(collect(s) for s in streams)), 600)
        sync(torch, sh.device)
        return out, time.perf_counter() - t0

    def run_once(eng):
        eng.reset_prefix_cache()
        if eng.flight is not None:
            eng.flight.clear()
        sync(torch, sh.device)
        tra.reset_launches()
        try:
            out, wall = asyncio.run(burst(eng))
        finally:
            eng.stop()
        events = ([{k: v for k, v in e.items() if k != "t"} for e in eng.flight.snapshot()]
                  if eng.flight is not None else None)
        return dict(tokens=out, wall_s=wall, designs=dict(tra.KERNEL_LAUNCHES), events=events)

    engines = {True: engine(True), False: engine(False)}
    for eng in engines.values():
        run_once(eng)  # first-use captures, untimed
    on = engines[True]
    on._build_mixed = guarded(on._build_mixed)
    on._launch_window = guarded(on._launch_window)
    on._maybe_publish_gauges = guarded(on._maybe_publish_gauges)
    runs = []
    for flag in (True, False, False, True):
        r = run_once(engines[flag])
        r["on"] = flag
        runs.append(r)
        log(f"[edge] (d) {smi}: telemetry {'on ' if flag else 'off'}: wall {r['wall_s']:.3f} s, "
            f"launches by kernel {r['designs']}")
    for r in runs[1:]:
        assert r["tokens"] == runs[0]["tokens"], "(d) tokens differ with telemetry on and off"
        assert r["designs"] == runs[0]["designs"], "(d) launch counts differ"
    assert runs[0]["events"] == runs[3]["events"] and runs[0]["events"], "(d) flight events"
    assert runs[1]["events"] is None and on.profiler is not None
    assert all(len(t) == sh.burst_tokens for t in runs[0]["tokens"])
    assert not guard["errors"] and guard["guarded"] > 0, guard
    walls = {"on": [runs[0]["wall_s"], runs[3]["wall_s"]],
             "off": [runs[1]["wall_s"], runs[2]["wall_s"]]}
    diff = sum(walls["on"]) / 2 - sum(walls["off"]) / 2
    log(f"[edge] (d) {smi}: tokens and launch counts bit-equal in all four runs; the two "
        f"telemetry-on runs recorded the same {len(runs[0]['events'])} flight events; "
        f"{guard['guarded']} dispatches ran under torch.cuda.set_sync_debug_mode('error') "
        f"without raising; mean wall on - off {diff * 1e3:+.1f} ms "
        f"(on {walls['on'][0]:.3f} / {walls['on'][1]:.3f} s, off {walls['off'][0]:.3f} / "
        f"{walls['off'][1]:.3f} s)")
    if "--profile" in sys.argv and sh.device == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        for flag in (True, False):
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                r = run_once(engines[flag])
            assert r["tokens"] == runs[0]["tokens"]
            report_profile(prof, r["wall_s"], f"[profile telemetry={'on' if flag else 'off'}]",
                           top=6)
    for eng in engines.values():
        check_drained(eng, "(d)")
    del engines, on
    free(torch, sh.device)
    return dict(walls=walls, diff_s=diff, events=len(runs[0]["events"]),
                guarded=guard["guarded"], designs=runs[0]["designs"])


# ------------------------------------------------------------ phase 11
CLUSTER_ENDPOINT = "dyn://smoke.llm.generate"


@dataclass(frozen=True)
class Phase11:
    """Phase 11's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``)."""

    device: str = "cuda"
    groups: int = 16  # (b): prefix groups per routing mode
    prefix_tokens: int = 1024
    suffix_tokens: tuple = (64, 256)  # each suffix's length, drawn in this range
    per_group: int = 4  # wave 1 sends the first, wave 2 the rest
    max_tokens: int = MAX_TOKENS
    num_pages: int = 2048  # 4 GiB at llama-8b's 2 MiB a page, in each worker
    slots: int = 8
    max_model_len: int = 2048
    discovery_s: float = 60.0  # (a): the model is listed this soon after the 2nd start
    failover_streams: int = 8  # (d)
    failover_prompt: int = 64
    failover_tokens: int = 256
    kill_after_tokens: int = 32  # (d): SIGKILL once every stream has this many
    lease_ttl_s: float = 10.0  # the runtime's default lease TTL (RuntimeConfig)
    state_period_s: float = 0.25  # how often a worker writes its counters


def _p11_worker(argv: list, state_path: str, period_s: float, t_spawn: float) -> None:
    """A phase 11 worker process: the port's entry point,
    ``run.main_async`` on ``argv`` (``in=dyn://… out=cuda``), stopped by
    SIGTERM as ``run.main`` stops it. This process's launch counters,
    prefix hits, computed prefill tokens and boot time (from ``t_spawn``,
    the wall clock when the smoke started the process, to registration)
    go to ``state_path`` every ``period_s`` seconds, and once more, with
    its telemetry, after the entry point returned."""
    sys.path.insert(0, HERE)
    import signal

    import torch

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    def write(state: dict) -> None:
        with open(state_path + ".tmp", "w") as f:
            json.dump(state, f)
        os.replace(state_path + ".tmp", state_path)

    async def serve() -> None:
        loop = asyncio.get_running_loop()
        ready = loop.create_future()
        task = asyncio.ensure_future(run.main_async(run.parse_args(argv), ready))
        loop.add_signal_handler(signal.SIGTERM, task.cancel)
        await asyncio.wait({task, ready}, return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            task.result()  # the worker failed to start: raise its error
        served, boot_s = ready.result(), time.time() - t_spawn
        eng = served.torch_engine

        def state(final: bool) -> dict:
            m = eng.metrics()
            return dict(t=time.time(), pid=os.getpid(), final=final, boot_s=boot_s,
                        instance=served.instance.instance_id,
                        launches=dict(tra.LAUNCHES), designs=dict(tra.KERNEL_LAUNCHES),
                        prefix_hits=m["kv_prefix_hits"], prefill=m["prefill_tokens_computed"],
                        active=m["request_active_slots"], dispatches=m["dispatches"],
                        graphs=m["graphs_captured"],
                        # The reclaim plane (phase 12 (d)): the triage's
                        # summary once it ran, and the blocks this worker
                        # seeded from migrations it received.
                        reclaim=served.reclaim.last_summary if served.reclaim else {},
                        seeded=served.migrate_sink.seeded_blocks if served.migrate_sink else 0,
                        peak_gib=(torch.cuda.max_memory_reserved() / 2**30
                                  if torch.cuda.is_available() else 0.0))

        async def pump() -> None:
            while True:
                write(state(False))
                await asyncio.sleep(period_s)

        pumping = asyncio.ensure_future(pump())
        with contextlib.suppress(asyncio.CancelledError):
            await task
        pumping.cancel()
        write({**state(True), "telemetry": get_telemetry().render().decode()})

    asyncio.run(serve())


def _p11_read(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


async def _p11_states(paths, procs, after: float, timeout: float = 60.0) -> list[dict]:
    """The workers' states written after ``after`` (wall clock); fails
    if a worker died or went quiet."""
    deadline = time.monotonic() + timeout
    while True:
        states = [_p11_read(p) for p in paths]
        if all(st is not None and st["t"] > after for st in states):
            return states
        for proc in procs:
            assert proc.is_alive(), f"worker {proc.name} exited with {proc.exitcode}"
        assert time.monotonic() < deadline, "a worker stopped writing its state"
        await asyncio.sleep(0.05)


def _p11_delta(after: list[dict], before: list[dict]) -> list[dict]:
    """Per worker: computed prefill tokens, prefix-hit pages (G1 shared)
    and launches by kernel design between two states."""
    return [dict(prefill=a["prefill"] - b["prefill"],
                 shared=a["prefix_hits"]["shared"] - b["prefix_hits"]["shared"],
                 designs={k: v - b["designs"][k] for k, v in a["designs"].items()})
            for a, b in zip(after, before)]


def _p11_groups(np, vocab: int, sh: Phase11, seed: int) -> list[list[list[int]]]:
    """``sh.groups`` prefix groups: a shared prefix, then ``per_group``
    suffixes of seeded random lengths and ids."""
    rs = np.random.RandomState(seed)
    lo, hi = sh.suffix_tokens
    out = []
    for _ in range(sh.groups):
        prefix = [int(t) for t in rs.randint(3, vocab, size=sh.prefix_tokens)]
        out.append([prefix + [int(t) for t in rs.randint(3, vocab, size=rs.randint(lo, hi + 1))]
                    for _ in range(sh.per_group)])
    return out


def _p11_body(ids: list[int], max_tokens: int, **extra) -> dict:
    return {"model": "llama-8b", "prompt": ids, "max_tokens": max_tokens, "stream": True,
            "temperature": 0, "nvext": {"ignore_eos": True},
            "stream_options": {"include_usage": True}, **extra}


def _p11_pct(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


async def _p11_ingress(run, addr: str, mode: str, endpoint: str = CLUSTER_ENDPOINT,
                       trace_file: str = ""):
    """The ingress in this process through the entry point a user calls:
    ``run.main_async(in=http out=<endpoint> --router-mode <mode>)``, no
    ``--model-path`` (with ``trace_file``: ``--trace-file``). Returns
    (task, base URL)."""
    opts = run.parse_args(["in=http", f"out={endpoint}", "--coordinator", addr,
                           "--http-host", "127.0.0.1", "--http-port", "0",
                           "--router-mode", mode]
                          + (["--trace-file", trace_file] if trace_file else []))
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({task, ready}, return_when=asyncio.FIRST_COMPLETED)
    if task.done():
        task.result()
    return task, f"http://127.0.0.1:{ready.result().port}"


async def _p11_stop(task) -> None:
    task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await task


async def _p11_models(client, base: str) -> list[str]:
    return [m["id"] for m in (await client.request(base + "/v1/models")).json()["data"]]


async def _p11_traffic(client, base: str, groups, sh: Phase11) -> dict:
    """Wave 1 (each group's first request, together), then wave 2 (the
    rest, together); every stream must finish ``length`` at full
    length. Returns wave 2's TTFTs and the wall."""
    url = base + "/v1/completions"

    async def wave(prompts):
        res = await asyncio.gather(*(sse_request(client, url, _p11_body(p, sh.max_tokens))
                                     for p in prompts))
        for r in res:
            assert r["done"] and r["finish"] == "length", r
            assert r["usage"]["completion_tokens"] == sh.max_tokens, r["usage"]
        return res

    t0 = time.perf_counter()
    await wave([g[0] for g in groups])
    await asyncio.sleep(1.0)  # wave 1's KV events indexed, the workers idle
    res = await wave([p for g in groups for p in g[1:]])
    return dict(ttft=[r["frames"][0] - r["sent"] for r in res], wall_s=time.perf_counter() - t0,
                requests=len(groups) * sh.per_group)


async def _p11_failover(client, base, np, vocab, sh: Phase11, procs, paths, tel) -> dict:
    """(d): streams under round-robin, one worker SIGKILLed while they
    stream; every stream still finishes at full length with its
    ``seq_index`` rising by its frame's tokens (logprob entries)."""
    rs = np.random.RandomState(13)
    url = base + "/v1/completions"
    counts = [0] * sh.failover_streams

    async def one(i, ids):
        frames, idx, n_lp, finish, usage, done = [], [], 0, None, None, False
        async for f in client.sse_frames(url, _p11_body(ids, sh.failover_tokens, logprobs=1)):
            assert f.event != "error", f"stream error: {f.comment}"
            if f.data == "[DONE]":
                done = True
                break
            usage = f.data.get("usage") or usage
            for c in f.data["choices"]:
                finish = c.get("finish_reason") or finish
                lp = (c.get("logprobs") or {}).get("tokens") or []
                n_lp += len(lp)
            if f.data.get("seq_index") is not None:
                idx.append(f.data["seq_index"])
                counts[i] = idx[-1]
        return dict(idx=idx, logprob_tokens=n_lp, finish=finish, usage=usage, done=done)

    prompts = [[int(t) for t in rs.randint(3, vocab, size=sh.failover_prompt)]
               for _ in range(sh.failover_streams)]
    def counts_now() -> tuple[float, float]:
        v = _family_values(tel.render().decode())
        return (v.get(("dynamo_request_recoveries_total", (("reason", "stream_drop"),)), 0.0),
                v.get(("dynamo_tokens_deduplicated_total", ()), 0.0))

    rec0, dedup0 = counts_now()
    tasks = [asyncio.ensure_future(one(i, p)) for i, p in enumerate(prompts)]
    while min(counts) < sh.kill_after_tokens:
        assert not any(t.done() for t in tasks), "a stream ended before the kill"
        await asyncio.sleep(0.005)
    mark = time.time()
    states = await _p11_states(paths, procs, mark)
    victim = 0
    on_victim = states[victim]["active"]
    procs[victim].kill()
    t_kill = time.perf_counter()
    res = await asyncio.gather(*tasks)
    recovery_wall = time.perf_counter() - t_kill
    for r in res:
        assert r["done"] and r["finish"] == "length", r
        assert r["usage"]["completion_tokens"] == sh.failover_tokens, r["usage"]
        assert all(a < b for a, b in zip(r["idx"], r["idx"][1:])), r["idx"]
        assert r["idx"][-1] == sh.failover_tokens == r["logprob_tokens"], r
    rec1, dedup1 = counts_now()
    recoveries, dedup = int(rec1 - rec0), int(dedup1 - dedup0)
    client_dups = sum(len(r["idx"]) - len(set(r["idx"])) for r in res)
    assert recoveries == on_victim and on_victim > 0, (recoveries, on_victim)
    assert dedup == client_dups == 0, (dedup, client_dups)
    return dict(victim_pid=states[victim]["pid"], on_victim=on_victim, recoveries=recoveries,
                dedup=dedup, streams=len(res), wall_after_kill_s=recovery_wall,
                states_before_kill=states)


def phase11(torch, np, pkg, tra, smi: str, lone: tuple, sh: Phase11 = Phase11(),
            mcfg=None) -> dict:
    """Phase 11: two worker processes behind the KV-aware router, the
    port's coordinator and the HTTP ingress in this process. ``lone``:
    (prompt ids, tokens) of a lone greedy request served by a direct
    ``TorchEngine`` on the same seeded weights (phase 6's)."""
    import multiprocessing
    import socket
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    t_phase = time.perf_counter()
    free(torch, sh.device)
    if sh.device == "cuda":
        free_b, total_b = torch.cuda.mem_get_info()
        log(f"[cluster] {smi}: card memory before the workers: {free_b / 2**30:.2f} GiB free "
            f"of {total_b / 2**30:.2f} GiB (this process: "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved)")
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        coord = subprocess.Popen(
            [sys.executable, "-m", "dynamo_exp_tpu_torch.runtime.transports.coordinator",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=HERE, stdout=subprocess.PIPE, text=True)
        procs = []
        try:
            line = coord.stdout.readline().strip()
            assert line == f"coordinator ready on 127.0.0.1:{port}", line
            addr = f"127.0.0.1:{port}"
            argv = [f"in={CLUSTER_ENDPOINT}", "out=cuda", "--device", sh.device,
                    "--model-path", model_dir, "--model-name", "llama-8b", "--random-weights",
                    "--coordinator", addr, "--num-pages", str(sh.num_pages),
                    "--max-decode-slots", str(sh.slots), "--page-size", str(PS),
                    "--max-model-len", str(sh.max_model_len), "--kv-dtype", "bfloat16"]
            paths = [os.path.join(tmp, f"worker{i}.json") for i in range(2)]
            ctx = multiprocessing.get_context("spawn")
            for i in range(2):
                proc = ctx.Process(target=_p11_worker, name=f"worker{i}",
                                   args=(argv, paths[i], sh.state_period_s, time.time()))
                proc.start()
                procs.append(proc)
            t_second = time.perf_counter()
            out = asyncio.run(asyncio.wait_for(
                _drive_cluster(np, pkg, run, client, smi, sh, mcfg, addr, procs, paths,
                               t_second, lone), timeout=900))
            # The survivor drains on SIGTERM and writes its telemetry.
            survivor = procs[1]
            survivor.terminate()
            survivor.join(120)
            assert survivor.exitcode == 0, f"the surviving worker exited {survivor.exitcode}"
            final = _p11_read(paths[1])
            assert final["final"] and "dynamo_engine_" in final["telemetry"]
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(30)
            coord.kill()
            coord.wait(30)
    # Launches of the whole phase by kernel design: the survivor's final
    # counts and the victim's last before the kill.
    last = [out["d"]["states_before_kill"][0], final]
    out["designs"] = {k: sum(st["designs"][k] for st in last) for k in last[0]["designs"]}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[cluster] {smi}: phase 11 wall {out['wall_s']:.1f} s; launches of both workers by "
        f"kernel {out['designs']}; peak memory reserved by worker "
        f"{[round(st['peak_gib'], 2) for st in last]} GiB, graphs captured "
        f"{[st['graphs'] for st in last]}")
    return out


async def _drive_cluster(np, pkg, run, client, smi, sh, mcfg, addr, procs, paths, t_second,
                         lone) -> dict:
    from dynamo_exp_tpu_torch import tokens as ttokens
    from dynamo_exp_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime, PushRouter, RouterMode
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    hits_sub = await drt.event_plane.subscribe(KV_HIT_RATE_SUBJECT)
    hits: list[dict] = []

    async def collect_hits():
        async for h in hits_sub:
            hits.append(h)

    collecting = asyncio.ensure_future(collect_hits())
    ingress, base = await _p11_ingress(run, addr, "kv")
    out: dict = {}
    try:
        # (a) Discovery: the model at the ingress, both instances listed.
        while "llama-8b" not in await _p11_models(client, base):
            for proc in procs:
                assert proc.is_alive(), f"worker {proc.name} exited with {proc.exitcode}"
            await asyncio.sleep(0.1)
        listed_s = time.perf_counter() - t_second
        comp = drt.namespace("smoke").component("llm")
        while len(await drt.discovery.list_instances(comp.path)) < 2:
            await asyncio.sleep(0.1)
        both_s = time.perf_counter() - t_second
        assert both_s <= sh.discovery_s, f"2 instances after {both_s:.1f} s"
        st0 = await _p11_states(paths, procs, 0.0)
        boot = [st["boot_s"] for st in st0]
        log(f"[cluster] {smi}: (a) model listed at the ingress {listed_s:.1f} s and both "
            f"instances in discovery {both_s:.1f} s after the second worker started; boot to "
            f"registration (from the process's start: interpreter, imports, weights, pool, "
            f"registration) {boot[0]:.1f} / {boot[1]:.1f} s")

        # Warm-up, not measured: the traffic's shape on groups of its own,
        # so that the first-use graph captures (no prewarm) land here and
        # not on whichever mode runs first.
        t0 = time.perf_counter()
        await _p11_traffic(client, base, _p11_groups(np, mcfg.vocab_size, sh, 303), sh)
        log(f"[cluster] {smi}: warm-up wave pair (graph captures at first use) in "
            f"{time.perf_counter() - t0:.2f} s")

        # (b) Routing: the same traffic shape, kv then round-robin.
        modes = {}
        for mode, seed in (("kv", 101), ("round-robin", 202)):
            if mode != "kv":
                await _p11_stop(ingress)
                ingress, base = await _p11_ingress(run, addr, mode)
                while "llama-8b" not in await _p11_models(client, base):
                    await asyncio.sleep(0.1)
            groups = _p11_groups(np, mcfg.vocab_size, sh, seed)
            before = await _p11_states(paths, procs, time.time())
            n_hits = len(hits)
            traffic = await _p11_traffic(client, base, groups, sh)
            await asyncio.sleep(2 * sh.state_period_s)
            after = await _p11_states(paths, procs, time.time())
            d = _p11_delta(after, before)
            decisions = hits[n_hits:]
            modes[mode] = dict(traffic, workers=d, decisions=decisions,
                               prefill=sum(w["prefill"] for w in d),
                               shared=sum(w["shared"] for w in d))
        kv, rr = modes["kv"], modes["round-robin"]
        assert len(kv["decisions"]) == kv["requests"], len(kv["decisions"])
        assert not rr["decisions"], "round-robin published kv decisions"
        overlap = sum(h["overlap_blocks"] for h in kv["decisions"])
        # Wave 2 is routed after wave 1's pages are all registered and
        # indexed: no block is still being filled at routing time, so the
        # router's overlap must equal the pages the engines attached.
        assert overlap == kv["shared"], (overlap, kv["shared"])
        assert kv["prefill"] < rr["prefill"], (kv["prefill"], rr["prefill"])
        for w, (dk, dr) in enumerate(zip(kv["workers"], rr["workers"])):
            moved = {k: dk["designs"][k] + dr["designs"][k] for k in dk["designs"]}
            if sh.device == "cuda":
                assert moved["mixed_tc_bf16"] > 0 and moved["decode_split"] > 0, (w, moved)
                assert moved["mixed_f32"] == 0, (w, moved)
        for mode, m in modes.items():
            log(f"[cluster] {smi}: (b) {mode}: {m['requests']} streams of {sh.max_tokens} "
                f"tokens ({sh.groups} groups: a {sh.prefix_tokens}-token prefix, suffixes "
                f"{sh.suffix_tokens[0]}-{sh.suffix_tokens[1]}) all finished 'length'; prefill "
                f"tokens computed {m['prefill']} (by worker "
                f"{[w['prefill'] for w in m['workers']]}), prefix-hit pages {m['shared']}; "
                f"wave 2 TTFT p50 {_p11_pct(m['ttft'], 0.5):.3f} s p95 "
                f"{_p11_pct(m['ttft'], 0.95):.3f} s; wall {m['wall_s']:.2f} s; launches by "
                f"worker {[w['designs'] for w in m['workers']]}")
        log(f"[cluster] {smi}: (b) kv decisions {len(kv['decisions'])}: overlap blocks "
            f"{overlap} = prefix-hit pages the chosen workers attached {kv['shared']}; "
            f"prefill tokens computed kv {kv['prefill']} < round-robin {rr['prefill']} "
            f"({kv['prefill'] / rr['prefill']:.3f}x)")

        # The operator's view of the cluster through the port's llmctl,
        # in subprocesses: the registered model and both workers.
        listed = await llmctl("--coordinator", addr, "http", "list")
        assert listed.returncode == 0 and "llama-8b" in listed.stdout, listed
        top = await llmctl("--coordinator", addr, "top", "--json")
        assert top.returncode == 0, top
        ids = sorted(f"llm/{st['instance']}" for st in st0)
        assert sorted(json.loads(top.stdout)["instances"]) == ids, (top.stdout, ids)
        log(f"[cluster] {smi}: llmctl http list: {listed.stdout.strip()!r}; llmctl top --json "
            f"lists {ids}")

        # The ingress's block hashing, per prompt (kv mode hashes each).
        hash_ms = {}
        rs = np.random.RandomState(5)
        for n in (1024, 2048):
            ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=n)]
            t0 = time.perf_counter()
            for _ in range(10):
                ttokens.compute_block_hashes_for_seq(ids, PS)
            hash_ms[n] = (time.perf_counter() - t0) / 10 * 1e3
        log(f"[cluster] {smi}: the ingress's block hashing (tokens.py, Python) "
            f"{hash_ms[1024]:.3f} ms per 1024-token prompt, {hash_ms[2048]:.3f} ms per 2048")

        # (c) Worker identity: the lone greedy request twice under
        # round-robin, each worker serving it once.
        lone_ids, lone_tokens = lone
        endpoint = comp.endpoint("generate")
        cl = await endpoint.client()
        router = PushRouter(cl, RouterMode.ROUND_ROBIN)
        before = await _p11_states(paths, procs, time.time())
        got = []
        for _ in range(2):
            stream = await router.generate({"token_ids": lone_ids, "stop_conditions": {
                "max_tokens": len(lone_tokens), "ignore_eos": True}})
            got.append([t async for f in stream for t in (f.get("token_ids") or [])])
        await asyncio.sleep(2 * sh.state_period_s)
        after = await _p11_states(paths, procs, time.time())
        served = [w["prefill"] for w in _p11_delta(after, before)]
        cl.close()
        assert served == [len(lone_ids)] * 2, served
        assert got[0] == got[1] == list(lone_tokens), (got, lone_tokens)
        log(f"[cluster] {smi}: (c) the lone {len(lone_ids)}-token greedy request, once on each "
            f"worker (prefill tokens by worker {served}): {len(lone_tokens)} tokens bit-equal "
            f"across the workers and to phase 6's direct engine on the same weights")

        # (d) Failover under round-robin.
        d = await _p11_failover(client, base, np, mcfg.vocab_size, sh, procs, paths, tel)
        t_wait = time.perf_counter()
        await asyncio.sleep(sh.lease_ttl_s + 2.0)
        listed = await _p11_models(client, base)
        alive = await drt.discovery.list_instances(comp.path)
        assert "llama-8b" in listed and len(alive) == 1, (listed, alive)
        log(f"[cluster] {smi}: (d) {d['streams']} streams of {sh.failover_tokens} tokens, "
            f"worker pid {d['victim_pid']} SIGKILLed with {d['on_victim']} of them on it: all "
            f"finished 'length' at full length, seq_index strictly rising to "
            f"{sh.failover_tokens} = logprob entries; recoveries {d['recoveries']} = streams on "
            f"the killed worker, tokens deduplicated {d['dedup']} = the client's duplicate "
            f"indices; {d['wall_after_kill_s']:.2f} s from the kill to the last [DONE]; "
            f"{time.perf_counter() - t_wait:.1f} s later the model is still listed, 1 instance")
        out.update(listed_s=listed_s, both_s=both_s, boot_s=boot, modes=modes, overlap=overlap,
                   hash_ms=hash_ms, d=d)
        return out
    finally:
        await _p11_stop(ingress)
        collecting.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await collecting
        await drt.close()


@dataclass
class Phase12:
    """Phase 12's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``)."""

    device: str = "cuda"
    num_pages: int = 2048  # each worker's pool, as in phase 11
    slots: int = 8
    max_model_len: int = 2048 + MAX_TOKENS + PS  # a 2048-token prompt and its tokens
    max_local: int = 1024  # DisaggConfig.max_local_prefill_length
    max_queue: int = 8  # DisaggConfig.max_prefill_queue_size
    remote_lens: tuple = (1280, 2048)  # (a): prompts that go to the prefill worker
    remote_n: int = 16
    local_lens: tuple = (64, 256)  # (a): prompts the decode worker prefills
    local_n: int = 8
    max_tokens: int = MAX_TOKENS
    lone_n: int = 4  # (a): requests sent alone against a direct engine
    prefix_tokens: int = 1024  # (b)
    suffix_tokens: int = 512
    wave: int = 8
    lease_ttl_s: float = 3.0  # the prefill worker's kv_lease_ttl_s; (c) waits it out
    reap_by_s: float = 10.0  # (c): the reap lands within [lease_ttl_s, reap_by_s]
    reclaim_streams: int = 8  # (d)
    reclaim_prompt: int = 1024
    # (d): each stream must still run on the victim when the triage
    # reports, after llmctl's start and a triage of 2-4 s at ~30 ms a
    # token: 256 tokens left too little (one triage of 3.6 s outlasted
    # every stream on the victim).
    reclaim_tokens: int = 512
    reclaim_after_tokens: int = 32  # (d): SIGTERM once every stream has this many
    reclaim_grace_s: float = 30.0  # (d): llmctl reclaim's notice (DYN_RECLAIM_GRACE_S's default)
    state_period_s: float = 0.25


P12_NS = "smoke12"
P12_DISAGG = f"dyn://{P12_NS}.disagg.generate"
P12_AGG = f"dyn://{P12_NS}.agg.generate"


def _p12_worker(role: str, argv: list, state_path: str, period_s: float, t_spawn: float,
                knobs: dict) -> None:
    """A phase 12 disaggregated worker process, wired as the SDK's
    worker and prefill-worker components wire theirs: the CLI's engine
    builder (``run.build_cuda_engine`` on ``argv``) and, by ``role``,
    a ``PrefillWorker`` pulling the model's prefill queue, or a
    ``DisaggDecodeEngine`` (``KvPageReceiver``, ``DisaggConfigWatcher``)
    served on ``dyn://smoke12.disagg.generate`` with its model card
    registered. Its counters go to ``state_path`` every ``period_s``
    seconds; on SIGTERM it stops serving and writes a last state with
    the stopped engine's page audit and copy-stream totals."""
    sys.path.insert(0, HERE)
    import signal

    import torch

    from dynamo_exp_tpu_torch import disagg, run
    from dynamo_exp_tpu_torch.local_model import register_llm
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra
    from dynamo_exp_tpu_torch.planner import prefill_queue_name
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.component import annotated_stream
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.runtime.runtime import CancellationToken
    from dynamo_exp_tpu_torch.telemetry import get_telemetry
    from dynamo_exp_tpu_torch.telemetry.fleet import get_transfer_ledger

    opts = run.parse_args(argv)

    def write(state: dict) -> None:
        with open(state_path + ".tmp", "w") as f:
            json.dump(state, f)
        os.replace(state_path + ".tmp", state_path)

    async def serve() -> None:
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        loop.add_signal_handler(signal.SIGTERM, stop.set)
        drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=opts.coordinator))
        eng, _mdc = run.build_cuda_engine(opts)
        eng.cfg.kv_lease_ttl_s = knobs["lease_ttl_s"]
        eng.start()
        queue = drt.work_queue(prefill_queue_name(opts.model_name))
        worker = dis = recv = watcher = served = task = None
        if role == "prefill":
            worker = disagg.PrefillWorker(eng, queue, CancellationToken(),
                                          component=drt.namespace(P12_NS).component("prefill"))
            task = asyncio.ensure_future(worker.run())
        else:
            recv = disagg.KvPageReceiver()
            await recv.start()
            watcher = disagg.DisaggConfigWatcher(drt.discovery, opts.model_name, default=(
                disagg.DisaggConfig(max_local_prefill_length=knobs["max_local"],
                                    max_prefill_queue_size=knobs["max_queue"])))
            await watcher.start()
            dis = disagg.DisaggDecodeEngine(eng, queue, recv, watcher)
            ep = drt.namespace(P12_NS).component("disagg").endpoint("generate")

            async def handler(request: dict, context):
                async for frame in annotated_stream(dis, request, context):
                    yield frame

            served = await ep.serve_endpoint(handler)
            await register_llm(drt, ep, opts.model_path, opts.model_name,
                               kv_cache_block_size=opts.page_size)
        boot_s = time.time() - t_spawn

        def state(final: bool, audit=None) -> dict:
            m = eng.metrics()
            tel = _family_values(get_telemetry().render().decode())

            def total(name: str, **labels) -> float:
                want = set(labels.items())
                return sum(v for (n, lab), v in tel.items() if n == name and want <= set(lab))

            st = dict(
                t=time.time(), pid=os.getpid(), role=role, final=final, boot_s=boot_s,
                launches=dict(tra.LAUNCHES), designs=dict(tra.KERNEL_LAUNCHES),
                prefill=m["prefill_tokens_computed"], prefix_hits=m["kv_prefix_hits"],
                free_pages=eng.kv.free_pages, dispatches=m["dispatches"],
                graphs=m["graphs_captured"],
                **{k: m[k] for k in (
                    "kv_extract_pages", "kv_extract_seconds", "kv_inject_pages",
                    "kv_leases_active", "kv_leases_granted", "kv_leases_confirmed",
                    "kv_lease_reclaimed_pages", "kv_wire_checksum_failures")},
                lease_reclaims=total("dynamo_kv_lease_reclaims_total"),
                sent_bytes=total("dynamo_kv_transfer_bytes_sum", direction="send"),
                sent_s=total("dynamo_kv_transfer_duration_seconds_sum", direction="send"),
                recv_bytes=total("dynamo_kv_transfer_bytes_sum", direction="recv"),
                recv_s=total("dynamo_kv_transfer_duration_seconds_sum", direction="recv"),
                transfers_ok=total("dynamo_kv_transfers_total", outcome="ok"),
                transfers_error=total("dynamo_kv_transfers_total", outcome="error"),
                links=get_transfer_ledger().snapshot(), instance=get_telemetry().instance,
                peak_gib=(torch.cuda.max_memory_reserved() / 2**30
                          if torch.cuda.is_available() else 0.0),
                audit=audit, copy=eng.copy_stats() if final else None,
            )
            if worker is not None:
                st.update(served=worker.served, failed=worker.failed, expired=worker.expired)
            if dis is not None:
                st.update(remote=dis.remote_prefills, fallbacks=dis.local_fallbacks,
                          skipped=dis.blocks_skipped, probe_failures=dis.queue_probe_failures)
            return st

        while not stop.is_set():
            write(state(False))
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop.wait(), period_s)
        if worker is not None:
            worker.cancel.cancel()
            await asyncio.wait_for(task, 60)
        if served is not None:
            await asyncio.wait_for(served.close(), 30)
            await watcher.close()
            await recv.close()
        eng.stop()
        write(state(True, eng.kv_audit()))
        await asyncio.wait_for(drt.close(), 15)

    asyncio.run(serve())


def _p12_prompts(np, vocab: int, sh: Phase12) -> dict:
    """(a)'s burst (remote and local lengths), (a)'s lone prompts and
    (b)'s shared-prefix prompts, seeded."""
    rs = np.random.RandomState(1212)

    def ids(n):
        return [int(t) for t in rs.randint(3, vocab, size=n)]

    lo, hi = sh.remote_lens
    prefix = ids(sh.prefix_tokens)
    return dict(
        remote=[ids(int(n)) for n in rs.randint(lo, hi + 1, size=sh.remote_n)],
        local=[ids(int(n)) for n in rs.randint(sh.local_lens[0], sh.local_lens[1] + 1,
                                               size=sh.local_n)],
        lone=[ids(int(n)) for n in np.linspace(lo, hi, sh.lone_n).astype(int)],
        shared=[prefix + ids(sh.suffix_tokens) for _ in range(sh.wave + 1)],
        unconfirmed=ids(lo),
        reclaim=[ids(sh.reclaim_prompt) for _ in range(sh.reclaim_streams)],
    )


def _p12_reference(torch, pkg, mcfg, sh: Phase12, prompts: list[list[int]]) -> list[list[int]]:
    """Each prompt served alone, greedy, by a direct ``TorchEngine`` on
    the workers' seeded weights (``--random-weights``: seed 0) and
    their engine shape; freed after."""
    eng = pkg.engine.TorchEngine(pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=sh.slots, page_size=PS, num_pages=sh.num_pages,
        max_model_len=sh.max_model_len, kv_dtype="bfloat16"), device=sh.device)

    async def run():
        out = []
        for ids in prompts:
            stream = await eng.generate({"token_ids": ids, "stop_conditions": {
                "max_tokens": sh.max_tokens, "ignore_eos": True}})
            out.append([t async for f in stream for t in (f.get("token_ids") or [])])
        return out

    try:
        return asyncio.run(asyncio.wait_for(run(), 600))
    finally:
        eng.stop()
        del eng
        free(torch, sh.device)


def _p12_anatomy(smi, sh, traces: dict, worker_pids: list, ingress: str) -> dict:
    """(a)'s traces read back from the three processes' span files: each
    remote request's tree spans the ingress, the prefill and the decode
    process, has KV transfer hops and a ``kv_transfer`` component; the
    median component shares of remote against local requests."""
    from dynamo_exp_tpu_torch.telemetry import anatomy_from_spans, load_spans, transfer_hops

    groups = _traces(load_spans([traces["ingress"], traces["workers"]]))
    kinds: dict = {"remote": [], "local": []}
    for group in groups.values():
        if not any(s.stage == "http_request" for s in group):
            continue
        prompt = max((int(s.attrs.get("prompt_tokens", 0) or 0) for s in group
                      if s.stage == "prefill"), default=0)
        kind = "remote" if prompt > sh.max_local else "local"
        a = anatomy_from_spans(group)
        if kind == "remote":
            pids = {str(s.attrs.get("instance", "")).rsplit(":", 1)[-1] for s in group}
            assert {str(p) for p in worker_pids} <= pids, (pids, worker_pids)
            assert any(s.attrs.get("instance") == ingress for s in group), ingress
            assert any(s.stage == "remote_prefill" for s in group), a.request_id
            assert transfer_hops(group), f"no transfer hop in {a.request_id}"
            assert a.components["kv_transfer"] > 0, a.components
        kinds[kind].append(a)
    assert len(kinds["remote"]) == sh.remote_n and len(kinds["local"]) == sh.local_n, (
        {k: len(v) for k, v in kinds.items()})
    shares = {k: _shares(v) for k, v in kinds.items()}
    for k in ("remote", "local"):
        edge = sorted(a.edge_latency_s for a in kinds[k])
        log(f"[disagg] {smi}: (a) anatomy of the {k} requests (median share of the edge "
            f"latency, p50 edge {edge[len(edge) // 2]:.3f} s): {_share_line(shares[k])}")
    log(f"[disagg] {smi}: (a) every remote request's trace spans the ingress, prefill and "
        f"decode processes, with transfer hops and kv_transfer > 0")
    return shares


def _p12_pages(n_tokens: int) -> int:
    return -(-n_tokens // PS)


def phase12(torch, np, pkg, tra, smi: str, sh: Phase12 = Phase12(), mcfg=None) -> dict:
    """Phase 12: disaggregated prefill/decode (a prefill worker and a
    decode worker process behind the HTTP ingress in this process),
    suffix-only transfers, a handoff lease never confirmed, then spot
    reclaim with live KV migration between two aggregated workers."""
    import multiprocessing
    import socket
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    t_phase = time.perf_counter()
    free(torch, sh.device)
    prompts = _p12_prompts(np, mcfg.vocab_size, sh)
    t0 = time.perf_counter()
    refs = _p12_reference(torch, pkg, mcfg, sh, prompts["lone"] + prompts["shared"])
    log(f"[disagg] {smi}: reference tokens of {len(refs)} prompts, each alone on a direct "
        f"engine, in {time.perf_counter() - t0:.1f} s")
    page_nbytes = 2 * mcfg.num_layers * PS * mcfg.num_kv_heads * mcfg.head_dim_ * 2
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        coord = subprocess.Popen(
            [sys.executable, "-m", "dynamo_exp_tpu_torch.runtime.transports.coordinator",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=HERE, stdout=subprocess.PIPE, text=True)
        procs = []
        try:
            line = coord.stdout.readline().strip()
            assert line == f"coordinator ready on 127.0.0.1:{port}", line
            addr = f"127.0.0.1:{port}"
            common = ["out=cuda", "--device", sh.device, "--model-path", model_dir,
                      "--model-name", "llama-8b", "--random-weights", "--coordinator", addr,
                      "--num-pages", str(sh.num_pages), "--max-decode-slots", str(sh.slots),
                      "--page-size", str(PS), "--max-model-len", str(sh.max_model_len),
                      "--kv-dtype", "bfloat16"]
            knobs = dict(lease_ttl_s=sh.lease_ttl_s, max_local=sh.max_local,
                         max_queue=sh.max_queue)
            ctx = multiprocessing.get_context("spawn")
            paths = [os.path.join(tmp, f"{role}.json") for role in ("prefill", "decode")]
            # (a)'s spans: each worker process records under
            # DYN_TRACE_FILE (to <path>.pid<pid>), the ingress beside it.
            traces = {"workers": os.path.join(tmp, "workers.jsonl"),
                      "ingress": os.path.join(tmp, "ingress.jsonl")}
            old_trace = os.environ.get("DYN_TRACE_FILE")
            os.environ["DYN_TRACE_FILE"] = traces["workers"]
            try:
                for role, path in zip(("prefill", "decode"), paths):
                    proc = ctx.Process(target=_p12_worker, name=role, args=(
                        role, [f"in={P12_DISAGG}", *common], path, sh.state_period_s,
                        time.time(), knobs))
                    proc.start()
                    procs.append(proc)
            finally:
                if old_trace is None:
                    os.environ.pop("DYN_TRACE_FILE", None)
                else:
                    os.environ["DYN_TRACE_FILE"] = old_trace
            out.update(asyncio.run(asyncio.wait_for(
                _p12_drive_disagg(np, pkg, run, client, smi, sh, mcfg, addr, procs, paths,
                                  prompts, refs, page_nbytes, traces), timeout=900)))
            for proc in procs:
                proc.terminate()
            for proc in procs:
                proc.join(120)
                assert proc.exitcode == 0, f"the {proc.name} worker exited {proc.exitcode}"
            finals = [_p11_read(p) for p in paths]
            for st in finals:
                assert st["final"], st["role"]
                assert st["audit"]["ok"], (st["role"], st["audit"]["violations"][:5])
                assert st["audit"]["leases"] == 0 and st["kv_leases_active"] == 0, st["role"]
            pre, dec = finals
            # Every extract lease was confirmed but (c)'s, which was
            # reaped; every decode-side pin was released at its inject.
            assert pre["kv_leases_granted"] == pre["kv_leases_confirmed"] + 1, pre
            assert pre["kv_lease_reclaimed_pages"] == out["c"]["pages"], pre
            assert dec["kv_leases_granted"] == dec["kv_leases_confirmed"] == sh.wave, dec
            out["finals"] = finals
            copy = dec["copy"]
            inject_ms = copy["h2d_s"] / max(copy["h2d_pages"], 1) * 1e3
            extract_ms = pre["kv_extract_seconds"] / max(pre["kv_extract_pages"], 1) * 1e3
            out.update(inject_ms_per_page=inject_ms, extract_ms_per_page=extract_ms)
            log(f"[disagg] {smi}: extract {extract_ms:.4f} ms per page (gather, device->host "
                f"on the copy stream, one sync per sequence; host wall, {pre['kv_extract_pages']} "
                f"pages)")
            log(f"[disagg] {smi}: inject {inject_ms:.4f} ms per page (host->device copy, CUDA "
                f"events, {copy['h2d_pages']} pages)")
            log(f"[disagg] {smi}: page audits clean on both workers, leases "
                f"granted {pre['kv_leases_granted']} = confirmed {pre['kv_leases_confirmed']} + "
                f"1 reaped; peak memory reserved {[round(st['peak_gib'], 2) for st in finals]} "
                f"GiB; launches by worker {[st['designs'] for st in finals]}")

            # (d) Spot reclaim between two aggregated workers.
            agg_paths = [os.path.join(tmp, f"agg{i}.json") for i in range(2)]
            agg = []
            argv = [f"in={P12_AGG}", *common]
            for i in range(2):
                proc = ctx.Process(target=_p11_worker, name=f"agg{i}",
                                   args=(argv, agg_paths[i], sh.state_period_s, time.time()))
                proc.start()
                agg.append(proc)
            procs.extend(agg)
            out["d"] = asyncio.run(asyncio.wait_for(
                _p12_drive_reclaim(np, run, client, smi, sh, mcfg, addr, agg, agg_paths,
                                   prompts["reclaim"]), timeout=900))
            survivor = agg[1]
            survivor.terminate()
            survivor.join(120)
            assert survivor.exitcode == 0, f"the surviving worker exited {survivor.exitcode}"
            final = _p11_read(agg_paths[1])
            assert final["final"] and final["reclaim"]["migrated"] == 0, final["reclaim"]
            last = [out["d"]["victim_last"], final]
            out["designs_reclaim"] = {k: sum(st["designs"][k] for st in last)
                                      for k in last[0]["designs"]}
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(30)
            coord.kill()
            coord.wait(30)
    out["designs_prefill"] = out["finals"][0]["designs"]
    out["designs_decode"] = out["finals"][1]["designs"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[disagg] {smi}: phase 12 wall {out['wall_s']:.1f} s; launches by kernel: prefill "
        f"worker {out['designs_prefill']}, decode worker {out['designs_decode']}, reclaim "
        f"workers {out['designs_reclaim']}")
    return out


async def _p12_drive_disagg(np, pkg, run, client, smi, sh, mcfg, addr, procs, paths, prompts,
                            refs, page_nbytes, traces) -> dict:
    from dynamo_exp_tpu_torch.disagg import RemotePrefillRequest
    from dynamo_exp_tpu_torch.disagg.protocol import kv_signature
    from dynamo_exp_tpu_torch.planner import prefill_queue_name
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime, PushRouter, RouterMode
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    ingress, base = await _p11_ingress(run, addr, "round-robin", P12_DISAGG, traces["ingress"])
    out: dict = {}
    try:
        t0 = time.perf_counter()
        while "llama-8b" not in await _p11_models(client, base):
            for proc in procs:
                assert proc.is_alive(), f"worker {proc.name} exited with {proc.exitcode}"
            await asyncio.sleep(0.1)
        comp = drt.namespace(P12_NS).component("prefill")
        while not await drt.discovery.list_instances(comp.path):
            await asyncio.sleep(0.1)
        st0 = await _p11_states(paths, procs, 0.0)
        log(f"[disagg] {smi}: both workers up, model listed {time.perf_counter() - t0:.1f} s "
            f"after the spawn's end; boot to serving {st0[0]['boot_s']:.1f} / "
            f"{st0[1]['boot_s']:.1f} s (prefill / decode)")

        # (a) The burst over HTTP: remote and local prompts together.
        url = base + "/v1/completions"
        before = await _p11_states(paths, procs, time.time())
        bodies = [("remote", p) for p in prompts["remote"]] + [("local", p)
                                                              for p in prompts["local"]]
        t0 = time.perf_counter()
        res = await asyncio.gather(*(sse_request(client, url, _p11_body(p, sh.max_tokens))
                                     for _, p in bodies))
        wall = time.perf_counter() - t0
        for (kind, p), r in zip(bodies, res):
            assert r["done"] and r["finish"] == "length", (kind, r)
            assert r["usage"]["completion_tokens"] == sh.max_tokens, r["usage"]
            assert r["usage"]["prompt_tokens"] == len(p), (r["usage"], len(p))
        await asyncio.sleep(2 * sh.state_period_s)
        after = await _p11_states(paths, procs, time.time())
        pre = {k: after[0][k] - before[0][k] for k in (
            "served", "failed", "kv_extract_pages", "sent_bytes", "sent_s", "transfers_ok",
            "kv_leases_granted", "kv_leases_confirmed")}
        dec = {k: after[1][k] - before[1][k] for k in (
            "remote", "fallbacks", "prefill", "kv_inject_pages", "recv_bytes", "recv_s")}
        designs = [{k: a["designs"][k] - b["designs"][k] for k in a["designs"]}
                   for a, b in zip(after, before)]
        remote_pages = sum(_p12_pages(len(p)) for p in prompts["remote"])
        assert dec["remote"] == sh.remote_n and dec["fallbacks"] == 0, dec
        assert pre["served"] == sh.remote_n and pre["failed"] == 0, pre
        assert pre["kv_extract_pages"] == dec["kv_inject_pages"] == remote_pages, (pre, dec)
        # The decode worker prefilled the local prompts only.
        assert dec["prefill"] == sum(len(p) for p in prompts["local"]), dec
        assert pre["sent_bytes"] == dec["recv_bytes"] == remote_pages * page_nbytes, (pre, dec)
        assert after[1]["kv_wire_checksum_failures"] == 0
        assert after[0]["transfers_error"] == after[1]["transfers_error"] == 0
        assert pre["kv_leases_granted"] == pre["kv_leases_confirmed"] == sh.remote_n, pre
        assert after[0]["kv_leases_active"] == after[1]["kv_leases_active"] == 0
        if sh.device == "cuda":
            assert designs[0]["mixed_tc_bf16"] > 0, designs  # the prefill worker's prefill
            assert designs[1]["mixed_tc_bf16"] > 0 and designs[1]["decode_split"] > 0, designs
            assert designs[0]["mixed_f32"] == designs[1]["mixed_f32"] == 0, designs
        ttft = {kind: [r["frames"][0] - r["sent"] for (k, _), r in zip(bodies, res) if k == kind]
                for kind in ("remote", "local")}
        bw = pre["sent_bytes"] / max(pre["sent_s"], 1e-9)
        link = next(lk for lk in after[0]["links"] if lk["dst"] == after[1]["instance"])
        log(f"[disagg] {smi}: (a) {sh.remote_n} remote ({sh.remote_lens[0]}-"
            f"{sh.remote_lens[1]} tokens) + {sh.local_n} local ({sh.local_lens[0]}-"
            f"{sh.local_lens[1]}) streams of {sh.max_tokens} tokens at once: all 'length' with "
            f"exact usage; remote prefills {dec['remote']}, local fallbacks {dec['fallbacks']}; "
            f"the decode worker computed {dec['prefill']} prefill tokens (the local prompts') "
            f"and injected {dec['kv_inject_pages']} pages; {remote_pages} pages x "
            f"{page_nbytes} B = {pre['sent_bytes']:.0f} B sent = received, 0 checksum "
            f"failures, leases granted {pre['kv_leases_granted']} = confirmed, 0 active; wall "
            f"{wall:.2f} s; launches by worker (prefill, decode) {designs}")
        log(f"[disagg] {smi}: (a) transfer bandwidth {bw / 1e9:.3f} GB/s (bytes / send seconds "
            f"over {pre['transfers_ok']:.0f} transfers)")
        log(f"[disagg] {smi}: (a) the transfer ledger's learned link bandwidth "
            f"{link['bandwidth_bps'] / 1e9:.3f} GB/s")
        log(f"[disagg] {smi}: (a) TTFT of the remote prompts p50 "
            f"{_p11_pct(ttft['remote'], 0.5):.3f} s p95 {_p11_pct(ttft['remote'], 0.95):.3f} s")
        log(f"[disagg] {smi}: (a) TTFT of the local prompts p50 "
            f"{_p11_pct(ttft['local'], 0.5):.3f} s p95 {_p11_pct(ttft['local'], 0.95):.3f} s")
        # The KV plane alone: a 2048-token prompt's pages between two
        # tasks of this (idle) process, with no engine beside either end.
        import torch

        from dynamo_exp_tpu_torch.disagg import KvPageReceiver, send_kv_pages

        shape = (mcfg.num_layers, PS, mcfg.num_kv_heads * mcfg.head_dim_)
        page = (torch.ones(shape, dtype=torch.bfloat16), torch.ones(shape, dtype=torch.bfloat16))
        n_plane = _p12_pages(sh.remote_lens[1])
        recv = KvPageReceiver()
        await recv.start()
        try:
            fut = recv.expect("plane")
            t0 = time.perf_counter()
            await send_kv_pages(recv.address, "plane", 0, [page] * n_plane)
            assert len((await fut)[1]) == n_plane
            plane_s = time.perf_counter() - t0
        finally:
            await recv.close()
        plane_bps = n_plane * page_nbytes / plane_s
        log(f"[disagg] {smi}: (a) the KV plane alone, {n_plane} pages ({n_plane * page_nbytes} B) "
            f"between two tasks of the idle smoke process: {plane_s:.3f} s, "
            f"{plane_bps / 1e9:.3f} GB/s")
        out["a"] = dict(pre=pre, dec=dec, designs=designs, ttft=ttft, wall_s=wall,
                        bandwidth_bps=bw, link_bps=link["bandwidth_bps"], plane_bps=plane_bps,
                        anatomy=_p12_anatomy(smi, sh, traces, [p.pid for p in procs],
                                             get_telemetry().instance))
        get_telemetry().configure(None)  # the ingress's trace holds (a) alone

        # (a) identity, then (b): token-level requests, each alone.
        cl = await drt.namespace(P12_NS).component("disagg").endpoint("generate").client()
        router = PushRouter(cl, RouterMode.ROUND_ROBIN)

        async def alone(ids):
            stream = await router.generate({"token_ids": ids, "stop_conditions": {
                "max_tokens": sh.max_tokens, "ignore_eos": True}})
            return [t async for f in stream for t in (f.get("token_ids") or [])]

        n_lone = len(prompts["lone"])
        before = await _p11_states(paths, procs, time.time())
        got = [await alone(p) for p in prompts["lone"]]
        assert got == refs[:n_lone], "a lone request through the pair differs from the direct engine"
        after = await _p11_states(paths, procs, time.time())
        assert after[1]["remote"] - before[1]["remote"] == n_lone
        log(f"[disagg] {smi}: (a) {n_lone} lone greedy requests ({[len(p) for p in prompts['lone']]}"
            f" tokens) through the pair, each alone: {sh.max_tokens} tokens bit-equal to a "
            f"direct TorchEngine on the same weights")

        shared = prompts["shared"]
        before = await _p11_states(paths, procs, time.time())
        first = await alone(shared[0])
        mid = await _p11_states(paths, procs, time.time())
        wave = [await alone(p) for p in shared[1:]]
        await asyncio.sleep(2 * sh.state_period_s)
        after = await _p11_states(paths, procs, time.time())
        skip = sh.prefix_tokens // PS
        n_pages = _p12_pages(len(shared[0]))
        assert [first] + wave == refs[n_lone:], "a suffix-only transfer changed the tokens"
        assert mid[0]["kv_extract_pages"] - before[0]["kv_extract_pages"] == n_pages
        assert after[1]["skipped"] - mid[1]["skipped"] == skip * sh.wave, (after[1], mid[1])
        assert after[1]["remote"] - mid[1]["remote"] == sh.wave
        shipped = after[0]["kv_extract_pages"] - mid[0]["kv_extract_pages"]
        assert shipped == (n_pages - skip) * sh.wave, shipped
        assert after[1]["kv_leases_active"] == 0 and after[0]["kv_leases_active"] == 0
        log(f"[disagg] {smi}: (b) a {sh.prefix_tokens}-token prefix + {sh.suffix_tokens}-token "
            f"suffix alone ({n_pages} pages shipped), then {sh.wave} requests with the prefix "
            f"and new suffixes, one after another: skip_blocks {skip} each, {shipped} pages "
            f"shipped (the suffixes' only), tokens equal to the full-transfer run sent one at a "
            f"time (the direct engine's, which (a)'s lone requests equal)")
        out["b"] = dict(skip=skip, shipped=shipped)
        cl.close()

        # (c) A handoff lease nobody confirms: a receiver that reads and
        # never acks; the prefill worker's reaper takes the pages back.
        conns = []

        async def swallow(reader, writer):
            conns.append(writer)
            with contextlib.suppress(ConnectionError, asyncio.IncompleteReadError):
                while await reader.read(1 << 20):
                    pass
            writer.close()

        sink = await asyncio.start_server(swallow, "127.0.0.1", 0)
        ids = prompts["unconfirmed"]
        n_pages = _p12_pages(len(ids))
        sig = kv_signature(pkg.engine.EngineConfig(model=mcfg, page_size=PS, kv_dtype="bfloat16"))
        before = (await _p11_states(paths, procs, time.time()))[0]
        req = RemotePrefillRequest(
            request_id="never-acked", token_ids=ids,
            return_addr=f"127.0.0.1:{sink.sockets[0].getsockname()[1]}",
            sampling_options={}, page_size=PS, model=sig)
        await drt.work_queue(prefill_queue_name("llama-8b")).push(req.to_bytes())
        t_push = time.perf_counter()
        while True:
            st = (await _p11_states(paths, procs, time.time()))[0]
            if st["lease_reclaims"] - before["lease_reclaims"] >= n_pages:
                break
            assert time.perf_counter() - t_push < sh.reap_by_s, "the lease was never reaped"
            await asyncio.sleep(0.05)
        reaped_after = time.perf_counter() - t_push
        assert st["lease_reclaims"] - before["lease_reclaims"] == n_pages, st
        assert sh.lease_ttl_s <= reaped_after <= sh.reap_by_s, reaped_after
        assert st["free_pages"] == before["free_pages"], (st["free_pages"], before["free_pages"])
        sink.close()
        for w in conns:
            w.close()  # the stuck send fails; the worker goes on pulling
        while (await _p11_states(paths, procs, time.time()))[0]["failed"] == before["failed"]:
            await asyncio.sleep(0.05)
        log(f"[disagg] {smi}: (c) a {len(ids)}-token prefill whose receiver never acks: "
            f"dynamo_kv_lease_reclaims_total +{n_pages} (its pages) {reaped_after:.2f} s after "
            f"the push (TTL {sh.lease_ttl_s} s); free pages back to {st['free_pages']}")
        out["c"] = dict(pages=n_pages, reaped_after_s=reaped_after)
        return out
    finally:
        await _p11_stop(ingress)
        await drt.close()


async def _p12_drive_reclaim(np, run, client, smi, sh, mcfg, addr, procs, paths,
                             prompts) -> dict:
    """(d): streams under round-robin; SIGTERM to one worker once every
    stream has ``reclaim_after_tokens``: its reclaim triage migrates
    the in-flight KV to the survivor; once the triage has run (the
    earliest a platform's grace could end without cutting a migration)
    the worker is SIGKILLed, as the platform ends a grace window. Every
    stream finishes on the survivor from its journal."""
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    ingress, base = await _p11_ingress(run, addr, "round-robin", P12_AGG)
    try:
        comp = drt.namespace(P12_NS).component("agg")
        while ("llama-8b" not in await _p11_models(client, base)
               or len(await drt.discovery.list_instances(comp.path)) < 2):
            for proc in procs:
                assert proc.is_alive(), f"worker {proc.name} exited with {proc.exitcode}"
            await asyncio.sleep(0.1)
        url = base + "/v1/completions"
        counts = [0] * len(prompts)

        async def one(i, ids):
            idx, n_lp, finish, usage, done, toks = [], 0, None, None, False, []
            async for f in client.sse_frames(url, _p11_body(ids, sh.reclaim_tokens, logprobs=1)):
                assert f.event != "error", f"stream error: {f.comment}"
                if f.data == "[DONE]":
                    done = True
                    break
                usage = f.data.get("usage") or usage
                for c in f.data["choices"]:
                    finish = c.get("finish_reason") or finish
                    lp = c.get("logprobs") or {}
                    n_lp += len(lp.get("tokens") or [])
                    toks.extend(lp.get("tokens") or [])
                if f.data.get("seq_index") is not None:
                    idx.append(f.data["seq_index"])
                    counts[i] = idx[-1]
            return dict(idx=idx, logprob_tokens=n_lp, finish=finish, usage=usage, done=done,
                        tokens=toks)

        def recoveries() -> float:
            v = _family_values(tel.render().decode())
            return sum(val for (n, _), val in v.items() if n == "dynamo_request_recoveries_total")

        rec0 = recoveries()
        t0 = time.perf_counter()
        tasks = [asyncio.ensure_future(one(i, p)) for i, p in enumerate(prompts)]
        while min(counts) < sh.reclaim_after_tokens:
            assert not any(t.done() for t in tasks), "a stream ended before the reclaim"
            await asyncio.sleep(0.005)
        states = await _p11_states(paths, procs, time.time())
        victim, survivor = 0, 1
        on_victim = states[victim]["active"]
        at_term = list(counts)
        # The operator's notice first (llmctl reclaim, in a subprocess):
        # the victim republishes itself as reclaiming and starts its
        # triage; the platform's SIGTERM then lands on a worker already
        # reclaiming, as a second notice of the same reclaim.
        iid = states[victim]["instance"]
        notice = await llmctl("--coordinator", addr, "reclaim", str(iid),
                              "--grace-s", str(sh.reclaim_grace_s))
        assert notice.returncode == 0 and f"instance {iid}" in notice.stdout, notice
        t_notice = time.perf_counter()
        while not any(i.instance_id == iid and i.metadata.get("reclaiming")
                      for i in await drt.discovery.list_instances(comp.path)):
            assert time.perf_counter() - t_notice < 30, "llmctl reclaim: no reclaiming flip"
            await asyncio.sleep(0.05)
        flip_s = time.perf_counter() - t_notice
        procs[victim].terminate()  # the spot platform's reclaim notice
        t_term = time.perf_counter()
        while True:
            st = await _p11_states(paths, procs, time.time())
            if st[victim]["reclaim"]:
                break
            assert time.perf_counter() - t_term < 120, "the reclaim triage never finished"
        triage_wall = time.perf_counter() - t_term
        victim_last = st[victim]
        still = victim_last["active"]
        at_kill = list(counts)
        assert still > 0, f"every stream on the victim finished inside the triage: {at_kill}"
        procs[victim].kill()  # the grace window ends
        res = await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        for r in res:
            assert r["done"] and r["finish"] == "length", r
            assert r["usage"]["completion_tokens"] == sh.reclaim_tokens, r["usage"]
            assert all(a < b for a, b in zip(r["idx"], r["idx"][1:])), r["idx"]
            assert r["idx"][-1] == sh.reclaim_tokens == r["logprob_tokens"], r
            assert len(r["idx"]) == len(set(r["idx"]))
        await asyncio.sleep(2 * sh.state_period_s)
        st_after = await _p11_states(paths[survivor:], procs[survivor:], time.time())
        surv0, surv1 = states[survivor], st_after[0]
        summary = victim_last["reclaim"]
        migrated = summary["migrated_pages"]
        n_rec = int(recoveries() - rec0)
        hits = surv1["prefix_hits"]["shared"] - surv0["prefix_hits"]["shared"]
        prefill = surv1["prefill"] - surv0["prefill"]
        assert migrated > 0 and summary["migrated"] > 0, summary
        assert surv1["seeded"] - surv0["seeded"] == migrated, (surv1["seeded"], migrated)
        assert n_rec == still > 0, (n_rec, still)
        assert hits >= migrated, (hits, migrated)
        # A SIGKILL failover re-prefills each continuation's whole
        # context on the survivor (the prompt and at least the tokens
        # streamed at the notice), none of which it held.
        sigkill = still * (sh.reclaim_prompt + sh.reclaim_after_tokens)
        assert prefill < sigkill, (prefill, sigkill)
        moved = {k: surv1["designs"][k] - surv0["designs"][k] for k in surv1["designs"]}
        if sh.device == "cuda":
            assert moved["mixed_tc_bf16"] > 0 and moved["decode_split"] > 0, moved
        # An uninterrupted run of the same prompts on the survivor, for
        # the token comparison printed (not asserted at bf16: batch
        # shapes differ).
        ref = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
        same = [sum(a == b for a, b in zip(r["tokens"], q["tokens"])) for r, q in zip(res, ref)]
        log(f"[reclaim] {smi}: (d) {len(prompts)} streams of {sh.reclaim_tokens} tokens "
            f"({sh.reclaim_prompt}-token prompts) under round-robin, {on_victim} on the worker "
            f"SIGTERMed once each had {sh.reclaim_after_tokens} (streamed at the notice "
            f"{at_term}); triage {summary['triage_s']:.3f} s ({triage_wall:.2f} s from the "
            f"signal to its report): {summary['migrated']} migrated, {migrated} pages, "
            f"{summary['failover']} journal failovers; SIGKILLed then with {still} in flight "
            f"(streamed {at_kill}); recoveries {n_rec}; all finished 'length', seq_index "
            f"rising, no duplicate; the survivor seeded {migrated} blocks, its prefix hits on "
            f"the continuations {hits} >= {migrated}, prefill tokens computed {prefill} < "
            f"{sigkill} (a SIGKILL failover's floor); wall {wall:.2f} s")
        log(f"[reclaim] {smi}: (d) llmctl reclaim {iid} --grace-s {sh.reclaim_grace_s:g} flipped "
            f"the victim to reclaiming {flip_s:.3f} s after the command returned, before the "
            f"SIGTERM")
        log(f"[reclaim] {smi}: (d) the reclaim's triage {summary['triage_s']:.3f} s")
        log(f"[reclaim] {smi}: (d) migrated pages {migrated}")
        log(f"[reclaim] {smi}: (d) tokens equal to an uninterrupted run on the survivor, by "
            f"stream: {same} of {sh.reclaim_tokens}")
        return dict(on_victim=on_victim, still=still, recoveries=n_rec, migrated_pages=migrated,
                    summary=summary, hits=hits, prefill=prefill, sigkill_floor=sigkill,
                    same=same, wall_s=wall, victim_last=victim_last)
    finally:
        await _p11_stop(ingress)
        await drt.close()



# ------------------------------------------------------------------ phase 13
@dataclass
class Phase13:
    """Phase 13's sizes: the card's by default (phase 7 (a)'s pressure);
    the CPU test rehearses it smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = PRESSURE_TOKENS
    num_pages: int = PRESSURE_PAGES
    host_pages: int = HOST_PAGES
    drift_n: int = 16  # (c): a burst unlike the pinned reference ...
    drift_lens: tuple = (16, 32)
    drift_tokens: int = 8
    profile_lens: tuple = (64, 160)  # (d): a small burst, its keys captured first
    profile_tokens: int = 32
    profile_lead_s: float = 3.0  # (d): a capture starts this long before its burst ...
    profile_ms: int = 20000  # ... and records this long, the burst inside it


# Each anatomy component and the edge latency are rounded to 6 decimals,
# so a sum of k nonzero components can miss the root span's duration by
# the k + 1 roundings: half a microsecond each.
ROUND_S = 5e-7
# Live against offline anatomy, the engine's share (every component but
# ``other``): both split the same host stamps (submission, admission,
# first token, finish, and the swap and stall windows), so they differ
# only by float64 sums of unix seconds (2.4e-7 s apart at 1.7e9 s) and
# the roundings -- once one interval is set aside. The backend ends a
# stream when it has counted ``max_tokens`` tokens, so the ``http_request``
# root span can close before the engine's loop thread stamps the finish
# (the last token is emitted before ``Scheduler.finish``). The offline
# anatomy clips the decode span at the root's end; the live one runs to
# the finish stamp. The JAX engine splits a request the same way
# (``tests/test_torch_anatomy.py`` forces the race in both), so the
# comparison takes that overrun (``decode_past_root``) off the live side.
LIVE_OFFLINE_S = 1e-5


def decode_past_root(spans, root) -> float:
    """Seconds of a trace's engine ``decode`` span past its root span's
    end: decode (and its host gap) the live anatomy counts and the
    offline one, clipped to the root, does not."""
    end = max((s.end for s in spans if s.stage == "decode"), default=root.end)
    return max(end - root.end, 0.0)


def engine_share_gap(offline, live: dict, spans, root) -> float:
    """|offline - live| engine share (every component but ``other``) of
    one request, with the live decode past the root span set aside."""
    eng_off = sum(v for c, v in offline.components.items() if c != "other")
    eng_live = sum(v for c, v in live["components"].items() if c != "other")
    return abs(eng_off - (eng_live - decode_past_root(spans, root)))


def llmctl(*argv, timeout: float = 120.0):
    """``python -m dynamo_exp_tpu_torch.llmctl`` in a subprocess, off the
    event loop (a coordinator this process serves must keep answering):
    await the result."""
    return asyncio.to_thread(
        subprocess.run, [sys.executable, "-m", "dynamo_exp_tpu_torch.llmctl", *argv], cwd=HERE,
        capture_output=True, text=True, timeout=timeout)


def guard_taps(torch, eng, device: str) -> dict:
    """Wrap the anatomy and fingerprint taps the loop thread calls (the
    scheduler's finish tap, the fingerprint's admission feed, the
    profiler's capture-seconds read) so that on the card each runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in one
    raises. The mode is the process's, not the thread's: each tap puts
    back the mode it found, and ``tally["undo"]()`` takes the wrappers
    off again, before anything that synchronizes on purpose (the
    profiler) runs beside the loop. The host tier's copy thread waits on
    CUDA events, which the mode does not check. Tallies the taps' calls
    and host seconds."""
    tally = {"calls": 0, "seconds": 0.0}
    wrapped = []

    def wrap(obj, name: str) -> None:
        fn = getattr(obj, name)

        def guarded(*args, **kw):
            t0 = time.perf_counter()
            if device == "cuda":
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                if device == "cuda":
                    torch.cuda.set_sync_debug_mode(mode)
                tally["calls"] += 1
                tally["seconds"] += time.perf_counter() - t0

        setattr(obj, name, guarded)
        wrapped.append((obj, name, fn))

    def undo() -> None:
        for obj, name, fn in wrapped:
            setattr(obj, name, fn)

    wrap(eng.sched, "on_finish")
    wrap(eng.fingerprint, "observe_admit")
    if eng.profiler is not None:
        wrap(eng.profiler, "compile_total_s")
    tally["undo"] = undo
    return tally


def _p13_prompts(np, vocab: int, lens, seed: int) -> list[list[int]]:
    rs = np.random.RandomState(seed)
    return [[int(t) for t in rs.randint(3, vocab, size=n)] for n in lens]


def _traces(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.trace_id, []).append(s)
    return out


def _roots(groups: dict, since: float = 0.0) -> dict:
    """{request id: (trace id, root span)} of the traces whose
    ``http_request`` root started at or after ``since``."""
    out = {}
    for tid, group in groups.items():
        root = next((s for s in group if s.stage == "http_request"), None)
        if root is not None and root.start >= since:
            out[str(root.attrs.get("request_id", ""))] = (tid, root)
    return out


def _shares(anatomies) -> dict:
    """The median share of the edge latency, by component."""
    from dynamo_exp_tpu_torch.telemetry import COMPONENTS

    out = {}
    for c in COMPONENTS:
        xs = sorted(a.components.get(c, 0.0) / max(a.edge_latency_s, 1e-9) for a in anatomies)
        out[c] = xs[len(xs) // 2] if xs else 0.0
    return out


def _share_line(shares: dict) -> str:
    return ", ".join(f"{c} {v:.3f}" for c, v in shares.items() if v > 0)


def phase13(torch, np, pkg, tra, smi: str, sh: Phase13 = Phase13(), mcfg=None) -> dict:
    """Phase 13: request anatomy, the workload fingerprint and drift,
    the profiler and llmctl, on llama-8b served over HTTP under KV
    pressure."""
    import socket
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.telemetry import FingerprintBuilder, get_telemetry

    mcfg = mcfg or pkg.models.LLAMA_8B
    t_phase = time.perf_counter()
    free(torch, sh.device)
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    saved = {k: os.environ.get(k) for k in ("DYN_FLIGHT_DUMP", "DYN_WORKLOAD_REF")}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama-8b"), tokmod, mcfg, text)
        files = {name: os.path.join(tmp, f"{name}") for name in (
            "spans.jsonl", "flight.jsonl", "ref.json", "capture", "profiles")}
        # The reference the drift gauge scores against: the planned
        # burst's lengths, built before any traffic.
        ref = FingerprintBuilder()
        for n in sh.prompt_lens:
            ref.observe_admit(n)
            ref.observe_finish(sh.max_tokens)
        with open(files["ref.json"], "w") as f:
            json.dump(ref.snapshot().to_dict(), f)
        os.environ["DYN_WORKLOAD_REF"] = files["ref.json"]
        os.environ["DYN_FLIGHT_DUMP"] = files["flight.jsonl"]
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            prof_port = probe.getsockname()[1]
        argv = [
            "in=http", "out=cuda", "--device", sh.device, "--model-path", model_dir,
            "--model-name", "llama-8b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max(sh.prompt_lens) + sh.max_tokens + PS),
            "--num-pages", str(sh.num_pages), "--host-cache-pages", str(sh.host_pages),
            "--kv-dtype", "bfloat16", "--trace-file", files["spans.jsonl"],
            "--profiler-port", str(prof_port),
        ]
        try:
            tra.reset_launches()
            out = asyncio.run(asyncio.wait_for(
                _p13_drive(torch, np, run, client, smi, run.parse_args(argv), mcfg, sh, files,
                           prof_port), timeout=900))
            out["designs"] = dict(tra.KERNEL_LAUNCHES)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            get_telemetry().configure(None)
    d = out["designs"]
    if sh.device == "cuda":
        assert d["mixed_tc_bf16"] > 0 and d["decode_split"] > 0, d
        assert d["mixed_f32"] == 0, d
    free(torch, sh.device)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[observe] {smi}: phase 13 wall {out['wall_s']:.1f} s; launches by kernel {d}")
    return out


async def _p13_drive(torch, np, run, client, smi, opts, mcfg, sh, files, prof_port) -> dict:
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    try:
        return await _p13_traffic(torch, np, client, smi, ready.result(), mcfg, sh, files,
                                  prof_port)
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server


async def _p13_traffic(torch, np, client, smi, served, mcfg, sh, files, prof_port) -> dict:
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra
    from dynamo_exp_tpu_torch.runtime import profiler
    from dynamo_exp_tpu_torch.telemetry import (
        anatomy_from_spans,
        fingerprint_from_spans,
        load_spans,
    )
    from dynamo_exp_tpu_torch.telemetry.fingerprint import DRIFT_ALERT_THRESHOLD

    base = f"http://127.0.0.1:{served.port}"
    url = base + "/v1/completions"
    eng = served.torch_engine
    trace_file = files["spans.jsonl"]
    taps = guard_taps(torch, eng, sh.device)
    assert eng.drift_watch.reference is not None, "DYN_WORKLOAD_REF was not read"

    async def run_burst(prompts, n, one_by_one=False):
        """``one_by_one``: each request after the last one's end, so the
        same lengths give the same schedule and keys whatever the
        arrival times."""
        t0 = time.perf_counter()
        bodies = [_p11_body(p, n) for p in prompts]
        if one_by_one:
            res = [await sse_request(client, url, b) for b in bodies]
        else:
            res = await asyncio.gather(*(sse_request(client, url, b) for b in bodies))
        wall = time.perf_counter() - t0
        for p, r in zip(prompts, res):
            assert r["done"] and r["finish"] == "length", r
            assert r["usage"]["completion_tokens"] == n, r["usage"]
            assert r["usage"]["prompt_tokens"] == len(p), (r["usage"], len(p))
        await asyncio.sleep(0.5)  # the root spans close after the last frame
        return wall

    async def scrape() -> dict:
        r = await client.request(base + "/metrics")
        assert r.status == 200
        return _family_values(r.body.decode())

    def family(values: dict, name: str) -> dict:
        return {dict(k[1]).get("component", ""): v for k, v in values.items() if k[0] == name}

    # (a) The pressured burst, its anatomy offline and live.
    before = family(await scrape(), "dynamo_request_seconds_total")
    prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
    t_a = time.time()
    taps0 = dict(taps)
    wall_a = await run_burst(prompts, sh.max_tokens)
    tap_s = taps["seconds"] - taps0["seconds"]
    tap_calls = taps["calls"] - taps0["calls"]
    taps["undo"]()
    m = eng.metrics()
    assert m["swapped_out"] > 0 or m["preempted"] > 0, f"(a) no pressure: {m}"
    groups = _traces(load_spans([trace_file]))
    roots = _roots(groups, t_a)
    assert len(roots) == len(prompts), (len(roots), len(prompts))
    offline, sum_err = {}, 0.0
    for rid, (tid, root) in roots.items():
        a = anatomy_from_spans(groups[tid])
        k = sum(1 for v in a.components.values() if v > 0)
        err = abs(a.total_s - root.duration_s)
        assert err <= ROUND_S * (k + 1), (rid, a.components, root.duration_s)
        sum_err = max(sum_err, err)
        offline[rid] = a
    assert any(a.components["swap_stall"] > 0 for a in offline.values()), "no swap stall"
    live = {d["request_id"]: d for d in m["anatomy_slow"]}
    assert set(live) == set(offline), (sorted(live), sorted(offline))
    live_err = 0.0
    for rid, a in offline.items():
        d = live[rid]
        assert d["dominant"] == a.dominant, (rid, d["components"], a.components)
        tid, root = roots[rid]
        gap = engine_share_gap(a, d, groups[tid], root)
        live_err = max(live_err, gap)
        assert gap <= LIVE_OFFLINE_S, (rid, d["components"], a.components,
                                       decode_past_root(groups[tid], root))
    after = family(await scrape(), "dynamo_request_seconds_total")
    totals = m["anatomy_totals"]
    for comp, total in totals.items():
        got = after.get(comp, 0.0) - before.get(comp, 0.0)
        assert abs(got - total) <= 1e-6 * max(1.0, total), (comp, got, total)
    shares = _shares(offline.values())
    worst = max(offline.values(), key=lambda a: a.edge_latency_s)
    log(f"[observe] {smi}: (a) {len(prompts)} streams of {sh.max_tokens} tokens over HTTP on "
        f"{sh.num_pages} pages + {sh.host_pages} host pages: wall {wall_a:.3f} s; swapped out "
        f"{m['swapped_out']}, in {m['swapped_in']}, preempted {m['preempted']}; every trace's "
        f"components sum to its root span (max error {sum_err:.2e} s); the live ring and the "
        f"offline anatomy name the same dominant component for all {len(offline)} and differ "
        f"by at most {live_err:.2e} s in the engine's share; dynamo_request_seconds = "
        f"anatomy_totals {dict((c, round(v, 3)) for c, v in totals.items() if v)}")
    log(f"[observe] {smi}: (a) median share of the edge latency by component: "
        f"{_share_line(shares)}; slowest request {worst.request_id} "
        f"{worst.edge_latency_s:.3f} s, dominant {worst.dominant}")
    log(f"[observe] {smi}: (a) the anatomy and fingerprint taps: {tap_calls} calls under "
        f"set_sync_debug_mode('error'), {tap_s * 1e3:.3f} ms of host time on the burst's "
        f"{wall_a:.3f} s wall ({tap_s / wall_a * 100:.4f} %)")

    # (b) The live digest against the trace file's; (c) drift, low.
    live_digest = m["workload_fingerprint"]
    off_fp = fingerprint_from_spans([s for tid, _ in roots.values() for s in groups[tid]])
    assert off_fp.digest() == live_digest and off_fp.n == len(prompts), (
        off_fp.to_dict(), live_digest)
    low = m["workload_drift_score"]
    gauge = _family_values_one(await scrape(), "dynamo_workload_drift_score")
    m_low = eng.metrics()["workload_drift_score"]
    assert gauge == m_low == low < DRIFT_ALERT_THRESHOLD, (gauge, m_low, low)

    # (c) A burst unlike the reference: drift above the threshold.
    rs = np.random.RandomState(17)
    short = [[int(t) for t in rs.randint(3, mcfg.vocab_size, size=int(n))]
             for n in rs.randint(sh.drift_lens[0], sh.drift_lens[1] + 1, size=sh.drift_n)]
    wall_c = await run_burst(short, sh.drift_tokens)
    high = eng.metrics()["workload_drift_score"]
    gauge_high = _family_values_one(await scrape(), "dynamo_workload_drift_score")
    assert high > DRIFT_ALERT_THRESHOLD and gauge_high == high, (high, gauge_high)
    log(f"[observe] {smi}: (c) drift against the pinned reference: {low:.4f} after the "
        f"matching burst, {high:.4f} after {sh.drift_n} prompts of {sh.drift_lens[0]}-"
        f"{sh.drift_lens[1]} tokens x {sh.drift_tokens} ({wall_c:.3f} s); threshold "
        f"{DRIFT_ALERT_THRESHOLD}; the gauge on /metrics equals metrics() both times")

    # (b) The same burst again (new prompts, the same lengths): the same
    # digest from its spans alone.
    t_b = time.time()
    wall_b = await run_burst(_p13_prompts(np, mcfg.vocab_size, sh.prompt_lens, 23), sh.max_tokens)
    groups = _traces(load_spans([trace_file]))
    roots_b = _roots(groups, t_b)
    assert len(roots_b) == len(prompts), len(roots_b)
    fp_b = fingerprint_from_spans([s for tid, _ in roots_b.values() for s in groups[tid]])
    assert fp_b.digest() == live_digest, (fp_b.to_dict(), live_digest)
    log(f"[observe] {smi}: (b) the live fingerprint's digest {live_digest[:16]} = the trace "
        f"file's (fingerprint_from_spans) = the second run's ({wall_b:.3f} s, "
        f"{eng.metrics()['preempted']} preempted in all)")

    # (d) The profiler, around a small burst whose keys are captured:
    # each run has new prompts of the same lengths (no prefix to reuse,
    # in the pool or the host tier), one request after another, so it
    # replays the first run's graphs and captures none. (Admission is
    # not held here: a pause stops and restarts the loop and copy
    # threads, and a trace across one recorded no CUDA kernel at all on
    # an H100, cause not found.)
    await run_burst(_p13_prompts(np, mcfg.vocab_size, sh.profile_lens, 29), sh.profile_tokens,
                    one_by_one=True)
    graphs0 = eng.metrics()["graphs_captured"]
    # The process's first trace starts CUPTI, which takes seconds: a
    # burst sent meanwhile ends before the recording begins. A short
    # trace first, timed.
    t0 = time.perf_counter()
    first = await asyncio.to_thread(profiler.capture_trace, files["capture"] + "_first", 100,
                                    sh.device)
    first_s = time.perf_counter() - t0
    log(f"[observe] {smi}: (d) the process's first trace, a 100 ms window: {first_s:.3f} s "
        f"from the call to its return ({first.seconds:.3f} s between start and stop)")
    traced = {}

    async def profiled(tag, start, seed):
        task = asyncio.ensure_future(start())
        await asyncio.sleep(sh.profile_lead_s)
        before = dict(tra.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        await run_burst(_p13_prompts(np, mcfg.vocab_size, sh.profile_lens, seed),
                        sh.profile_tokens, one_by_one=True)
        dt = time.perf_counter() - t0
        kernels = await task
        delta = {k: tra.KERNEL_LAUNCHES[k] - before[k] for k in before}
        count = {name: sum(n for k, n in kernels.items() if name in k)
                 for name in ("mixed_tc_kernel", "decode_split_kernel")}
        if sh.device == "cuda":
            assert count["mixed_tc_kernel"] > 0 and count["decode_split_kernel"] > 0, (
                tag, sorted(kernels)[:20])
        traced[tag] = dict(kernels=count, launches=delta, burst_s=dt)
        log(f"[observe] {smi}: (d) {tag}: traced kernels {count} against the launch counters' "
            f"delta {delta} over the {dt:.3f} s burst")

    async def by_call():
        cap = await asyncio.to_thread(profiler.capture_trace, files["capture"], sh.profile_ms,
                                      sh.device)
        assert os.path.exists(cap.path), cap.path
        return dict(cap.kernels)

    async def by_listener():
        import urllib.request

        def get():
            with urllib.request.urlopen(f"http://127.0.0.1:{prof_port}/capture?duration_ms="
                                        f"{sh.profile_ms}", timeout=sh.profile_ms / 1e3 + 300) as r:
                return json.loads(r.read())

        doc = await asyncio.to_thread(get)
        assert os.path.exists(doc["trace_file"]), doc
        return doc["kernels"]

    await profiled("capture_trace", by_call, 31)
    await profiled("--profiler-port listener", by_listener, 37)
    graphs1 = eng.metrics()["graphs_captured"]
    assert graphs1 == graphs0, f"(d) {graphs1 - graphs0} graphs captured while profiling"
    log(f"[observe] {smi}: (d) graphs captured while profiling: {graphs1 - graphs0}")

    # (e) llmctl on this phase's own trace file and flight dump.
    with eng.hold_admission():
        eng._dump_flight("smoke")
    tid = worst.trace_id
    why = await llmctl("trace", tid, "--trace-file", trace_file, "--why")
    assert why.returncode == 0 and f"request {worst.request_id}" in why.stdout, why
    slow = await llmctl("slow", "--trace-file", trace_file, "-n", "40")
    assert slow.returncode == 0 and worst.request_id[:28] in slow.stdout, slow
    fpr = await llmctl("fingerprint", trace_file, "--json", "--ref", files["ref.json"])
    assert fpr.returncode == 0 and "drift vs" in fpr.stdout, fpr
    doc = json.loads(fpr.stdout[: fpr.stdout.index("drift vs")])
    assert doc["digest"] == eng.metrics()["workload_fingerprint"], doc["digest"]
    flight = await llmctl("flight", files["flight.jsonl"], "--why")
    all_rids = set(_roots(_traces(load_spans([trace_file]))))
    named = [rid for rid in all_rids if f"request {rid}" in flight.stdout]
    assert flight.returncode == 0 and named, flight
    audit = await llmctl("audit", files["flight.jsonl"])
    assert audit.returncode == 0 and "CONSERVED" in audit.stdout, audit
    log(f"[observe] {smi}: (e) llmctl trace {tid[:8]}.. --why names request "
        f"{worst.request_id} (dominant {worst.dominant}); slow lists it; fingerprint --json "
        f"--ref: digest {doc['digest'][:16]} = the live one, {fpr.stdout.strip().splitlines()[-1]}"
        f"; flight --why explains {len(named)} requests of the dump; audit: conserved")
    print(why.stdout, end="", flush=True)
    return dict(a=dict(wall_s=wall_a, shares=shares, sum_err=sum_err, live_err=live_err,
                       tap_s=tap_s, tap_calls=tap_calls, swapped_out=m["swapped_out"],
                       preempted=m["preempted"]),
                digest=live_digest, drift_low=low, drift_high=high, profile=traced,
                first_trace_s=first_s)


def _family_values_one(values: dict, name: str) -> float:
    """The one sample of an unlabelled family."""
    (v,) = [v for k, v in values.items() if k[0] == name]
    return v


# ------------------------------------------------------------ phase 14
GEMMA_SPECIALS = ["<pad>", "<eos>", "<bos>", "<unk>", "<mask>", "<start_of_turn>",
                  "<end_of_turn>"]
GEMMA_CHAT_TEMPLATE = (
    "{{ bos_token }}"
    "{%- for message in messages %}"
    "{%- set role = 'model' if message['role'] == 'assistant' else message['role'] %}"
    "{{ '<start_of_turn>' + role + '\n' + message['content'] | trim + '<end_of_turn>\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{ '<start_of_turn>model\n' }}{%- endif %}"
)


@dataclass(frozen=True)
class Phase14:
    """Phase 14's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, a tiny gemma2 config)."""

    device: str = "cuda"
    long_lens: tuple = (4500, 6000)  # (a): past gemma2's 4,096 window ...
    short_lens: tuple = (64, 160, 320, 512, 768, 1024)  # ... beside chat turns
    max_tokens: int = 32
    seeded: int = 3  # (a): the request sampled at temperature 0.8
    check_layers: int = 4  # (b): depth of the plain-against-kernel models
    check_len: int = 4500  # (b): their prompt, past the window
    long_chat_chars: int = 24000  # (c): one chat of README text past the window


def sp_tokenizer_spec(vocab_size: int, text: str, n_merges: int = 3000) -> dict:
    """A Gemma-layout SentencePiece-BPE ``tokenizer.json`` of exactly
    ``vocab_size`` entries: Gemma's special tokens first, the 256
    ``<0xNN>`` byte tokens, ``▁`` and the characters ``text`` uses at
    least 3 times (rarer ones, CJK and emoji fall back to bytes), the
    merges learned from ``text``'s words (``▁`` for each space), then
    deterministic filler pieces. ``Replace(" ", "▁")`` normalizer, no
    pre-tokenizer, ``Replace`` / ``ByteFallback`` / ``Fuse`` decoder, a
    ``<bos>`` template."""
    import random
    from collections import Counter

    vocab: dict[str, int] = {}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < vocab_size:
            vocab[tok] = len(vocab)

    for t in GEMMA_SPECIALS + [f"<0x{b:02X}>" for b in range(256)] + ["▁"]:
        add(t)
    for c, n in sorted(Counter(text).items()):
        if n >= 3 and c not in " \n":
            add(c)
    words = Counter("▁" + w for w in text.split())
    kept = []  # merges of pieces the vocabulary holds, while it has room
    for a, b in learn_merges(dict(words), n_merges):
        if a in vocab and b in vocab:
            add(a + b)
            if a + b in vocab:
                kept.append([a, b])
    pieces = [a + b for a, b in kept] or ["▁"]
    rng = random.Random(0)
    while len(vocab) < vocab_size:
        add(("▁" if rng.random() < 0.6 else "") + "".join(
            rng.choice(pieces).lstrip("▁") for _ in range(rng.randint(1, 3))))
    added = [
        {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True}
        for i, t in enumerate(GEMMA_SPECIALS)
    ]
    bos = vocab["<bos>"]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<bos>": {"id": "<bos>", "ids": [bos], "tokens": ["<bos>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": kept},
    }


def gemma2_hf_config(mcfg) -> dict:
    """A gemma2 ``config.json`` that reads back equal to ``mcfg``."""
    cfg = {
        "architectures": ["Gemma2ForCausalLM"], "model_type": mcfg.model_type,
        "vocab_size": mcfg.vocab_size, "hidden_size": mcfg.hidden_size,
        "intermediate_size": mcfg.intermediate_size, "num_hidden_layers": mcfg.num_layers,
        "num_attention_heads": mcfg.num_heads, "num_key_value_heads": mcfg.num_kv_heads,
        "head_dim": mcfg.head_dim_, "rope_theta": mcfg.rope_theta,
        "rms_norm_eps": mcfg.rms_norm_eps,
        "max_position_embeddings": mcfg.max_position_embeddings,
        "tie_word_embeddings": mcfg.tie_word_embeddings, "torch_dtype": mcfg.dtype,
        "hidden_activation": "gelu_pytorch_tanh",
        "attn_logit_softcapping": mcfg.attn_logit_softcap,
        "final_logit_softcapping": mcfg.final_logit_softcap,
        "query_pre_attn_scalar": mcfg.query_pre_attn_scalar,
        "sliding_window": mcfg.sliding_window, "attention_bias": mcfg.attention_bias,
        "norm_topk_prob": mcfg.norm_topk_prob,
        "bos_token_id": GEMMA_SPECIALS.index("<bos>"),
        "eos_token_id": [GEMMA_SPECIALS.index("<eos>"),
                         GEMMA_SPECIALS.index("<end_of_turn>")],
    }
    return cfg


def write_gemma_model_dir(path: str, mcfg, text: str) -> str:
    """config.json of ``mcfg``, the tokenizer of ``sp_tokenizer_spec``,
    Gemma's chat template; EOS ``<eos>`` and ``<end_of_turn>``. No
    weights: the server runs with --random-weights."""
    os.makedirs(path, exist_ok=True)
    files = {
        "config.json": gemma2_hf_config(mcfg),
        "tokenizer_config.json": {"bos_token": "<bos>", "eos_token": "<eos>",
                                  "chat_template": GEMMA_CHAT_TEMPLATE},
        "tokenizer.json": sp_tokenizer_spec(mcfg.vocab_size, text),
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return path


def p14_requests(np, vocab: int, sh: Phase14) -> list[dict]:
    rs = np.random.RandomState(14)
    return [
        {"token_ids": [int(t) for t in rs.randint(3, vocab, size=n)],
         "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == sh.seeded else {}}
        for i, n in enumerate(sh.long_lens + sh.short_lens)
    ]


def p14_engine_path(torch, pkg, tra, smi, sh: Phase14, mcfg, requests) -> dict:
    """(a): ``TorchEngine`` serving ``mcfg`` at full width and depth
    (random weights from seed 0): the 8 requests admitted together,
    then again on a new engine over the same weights."""
    lens = [len(r["token_ids"]) for r in requests]
    max_len = max(lens) + sh.max_tokens + PS
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
        num_pages=pages_needed(lens, sh.max_tokens) + 64, kv_dtype="bfloat16",
    )
    dev = torch.device(sh.device, 0) if sh.device == "cuda" else torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = pkg.models.init_params(mcfg, gen, dev)
    sync(torch, sh.device)
    n_params = sum(p.numel() for p in model.parameters())
    kv_token = 2 * mcfg.num_layers * mcfg.num_kv_heads * mcfg.head_dim_ * 2
    log(f"[gemma2] {mcfg.model_type}: {mcfg.num_layers} layers, hidden {mcfg.hidden_size}, "
        f"H {mcfg.num_heads}/Hkv {mcfg.num_kv_heads} x {mcfg.head_dim_}, ffn "
        f"{mcfg.intermediate_size}, vocab {mcfg.vocab_size}, {n_params / 1e9:.3f} B params "
        f"bf16 from seed 0 in {time.perf_counter() - t0:.1f} s; {kv_token} B of KV a token; "
        f"window {mcfg.sliding_window} (even layers: {mcfg.alt_sliding_window}), softcaps "
        f"{mcfg.attn_logit_softcap} / {mcfg.final_logit_softcap}")
    runs = []
    for _ in range(2):
        eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
        sync(torch, sh.device)
        tra.reset_launches()
        out, wall = run_engine(eng, requests)
        sync(torch, sh.device)
        runs.append((out, wall, dict(tra.KERNEL_LAUNCHES), eng.metrics()))
        del eng
        free(torch, sh.device)
    (out, wall, designs, metrics), (rerun, wall2, designs2, _) = runs
    for i, (toks, finish, _) in enumerate(out):
        assert finish == "length" and len(toks) == sh.max_tokens, (i, finish, len(toks))
        assert all(0 <= t < mcfg.vocab_size for t in toks)
    assert [t for t, _, _ in rerun] == [t for t, _, _ in out], "rerun gave other tokens"
    if sh.device == "cuda":
        for d in (designs, designs2):
            assert d["mixed_tc_bf16"] > 0 and d["decode_split"] > 0, d
            assert d["mixed_f32"] == 0, d
    ttfts = sorted(t for _, _, t in out)
    total = sum(len(t) for t, _, _ in out)
    log(f"[gemma2] {smi}: (a) 8 requests (prompts {lens}, {sh.max_tokens} tokens each, "
        f"request {sh.seeded} seeded at T=0.8) admitted together: wall {wall:.3f} s (rerun "
        f"{wall2:.3f} s), {total} tokens, {total / wall:.2f} tokens/s, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.3f} s max {ttfts[-1]:.3f} s; all 'length', the rerun "
        f"token-identical; launches by kernel {designs}; dispatches {metrics['dispatches']}")
    del model
    free(torch, sh.device)
    return dict(wall_s=wall, rerun_wall_s=wall2, completion_tokens=total,
                tokens_per_s=total / wall, ttft_p50_s=ttfts[len(ttfts) // 2],
                ttft_max_s=ttfts[-1], designs=designs, tokens=[t for t, _, _ in out])


def p14_window_logits(torch, np, pkg, tra, smi, sh: Phase14, mcfg) -> dict:
    """(b): ``mcfg`` cut to ``sh.check_layers`` layers (random weights,
    seed 0), one ``sh.check_len``-token prompt through ``forward_ragged``
    with the kernels and with the plain versions: the logits at every
    64th position before the window and at every position past it.
    Held as phase 4 holds llama-8b's: max abs error within 5 % of the
    logits' scale (bf16 activations through the layers; the two
    attention numerics differ by bf16 ulps a layer)."""
    from dataclasses import replace

    llama = pkg.models.llama
    cfg = replace(mcfg, num_layers=sh.check_layers,
                  layer_types=mcfg.layer_types[: sh.check_layers] if mcfg.layer_types else None)
    dev = torch.device(sh.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = pkg.models.init_params(cfg, gen, dev)
    n = sh.check_len
    pad = (-n) % 8
    rs = np.random.RandomState(15)
    toks = torch.tensor(list(rs.randint(3, cfg.vocab_size, size=n)) + [0] * pad, device=dev)
    pos = torch.tensor(list(range(n)) + [-1] * pad, dtype=torch.int32, device=dev)
    rows = torch.zeros(n + pad, dtype=torch.int32, device=dev)
    pages = -(-(n + pad) // PS)
    table = torch.arange(pages, dtype=torch.int32, device=dev)[None]
    win = cfg.sliding_window or n
    idx = list(range(63, min(win, n), 64)) + list(range(min(win, n), n))
    out_idx = torch.tensor(idx, device=dev)
    logits, secs = {}, {}
    for impl in ("kernel", "reference"):
        kc, vc = llama.init_kv_cache(cfg, pages, PS, torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        tra.reset_launches()
        lg, _, _ = llama.forward_ragged(model, cfg, toks, pos, rows, table, kc, vc, out_idx,
                                        attn_impl=impl, q_tile=8)
        sync(torch, sh.device)
        secs[impl] = time.perf_counter() - t0
        if impl == "kernel":
            designs = dict(tra.KERNEL_LAUNCHES)
        logits[impl] = lg
        del kc, vc
    a, b = logits["kernel"], logits["reference"]
    assert a.shape == (len(idx), cfg.vocab_size) and torch.isfinite(a).all()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[gemma2] {smi}: (b) {cfg.model_type} width at {cfg.num_layers} layers (D "
        f"{cfg.head_dim_}, window {cfg.sliding_window}, softcaps {cfg.attn_logit_softcap} / "
        f"{cfg.final_logit_softcap}), a {n}-token prompt, logits at {len(idx)} positions "
        f"({n - min(win, n)} past the window): kernel vs plain max abs err {err:.4e} (logit "
        f"scale {scale:.3f}, limit 5 %), argmax agreement {agree:.4f}; forward "
        f"{secs['kernel']:.2f} s kernel ({designs}), {secs['reference']:.2f} s plain")
    assert err <= 0.05 * scale, f"{cfg.model_type} logits differ: {err} > 5% of {scale}"
    if sh.device == "cuda":
        assert designs["mixed_tc_bf16"] == cfg.num_layers, designs
    del model, logits, a, b
    free(torch, sh.device)
    return dict(max_abs_err=err, scale=scale, argmax_agreement=agree, designs=designs)


def p14_chats(text: str, sh: Phase14) -> list[list[dict]]:
    """(c)'s 8 chats: short turns (one with CJK and emoji, which the
    tokenizer sends through byte fallback), a follow-up with the model's
    role, and one long user message of README text past the window."""
    return [
        [{"role": "user", "content": "Name three uses of paged attention."}],
        [{"role": "user", "content": "Ünïcödé, 日本語 and emoji ☃🎉 in one prompt."}],
        [{"role": "user", "content": "What is a sliding window?"},
         {"role": "assistant", "content": "A mask on keys older than a bound."},
         {"role": "user", "content": "And a softcap?"}],
        [{"role": "user", "content": "Summarise: " + text[: sh.long_chat_chars]}],
        [{"role": "user", "content": "  Leading  and doubled  spaces.  "}],
        [{"role": "user", "content": "Count to ten."}],
        [{"role": "user", "content": text[1000:1600]}],
        [{"role": "user", "content": "Write a haiku about GPUs."}],
    ]


def p14_http(torch, np, pkg, tra, smi, sh: Phase14, mcfg) -> dict:
    """(c): ``run.main_async(in=http out=cuda --model-path <dir>
    --random-weights)`` on a gemma2 model directory written here (the
    preset's config.json, read back equal; a SentencePiece-BPE
    tokenizer.json; Gemma's chat template), the same seeded weights as
    (a)'s: 8 streaming chats at once, then a lone greedy completion of
    token ids, also served straight by a ``TorchEngine`` on the served
    weights."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_exp_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_exp_tpu_torch.protocols.openai import ChatCompletionRequest

    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model_dir = write_gemma_model_dir(os.path.join(tmp, "gemma2-9b"), mcfg, text)
        t_write = time.perf_counter() - t0
        assert pkg.models.ModelConfig.from_pretrained(model_dir) == mcfg
        t0 = time.perf_counter()
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        t_load = time.perf_counter() - t0
        assert tok.vocab_size == mcfg.vocab_size
        chats = p14_chats(text, sh)
        pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(model_dir, "gemma2-9b"),
                                 tok)
        t0 = time.perf_counter()
        chat_ids = [
            pre.preprocess_chat(ChatCompletionRequest.from_dict(
                {"model": "gemma2-9b", "messages": m})).token_ids
            for m in chats
        ]
        t_encode = time.perf_counter() - t0
        lens = [len(i) for i in chat_ids]
        assert max(lens) > (mcfg.sliding_window or 0), lens
        max_len = max(lens + [LONE_PROMPT_LEN]) + sh.max_tokens + PS
        argv = [
            "in=http", "out=cuda", "--device", sh.device, "--model-path", model_dir,
            "--model-name", "gemma2-9b", "--random-weights", "--http-host", "127.0.0.1",
            "--http-port", "0", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max_len), "--num-pages",
            str(pages_needed(lens + [LONE_PROMPT_LEN], sh.max_tokens) + 64),
            "--kv-dtype", "bfloat16", "--max-tokens", str(sh.max_tokens),
        ]
        log(f"[gemma2] (c) model dir: config.json of the preset, a SentencePiece-BPE "
            f"tokenizer.json of {tok.vocab_size} entries (written in {t_write:.2f} s, loaded "
            f"in {t_load:.2f} s), EOS {tok.eos_token_ids}; the 8 chats templated and "
            f"encoded in {t_encode:.3f} s")
        out = asyncio.run(asyncio.wait_for(
            _p14_drive(torch, np, pkg, tra, run, client, tok, run.parse_args(argv), chats,
                       chat_ids, mcfg, sh, smi), timeout=900))
    free(torch, sh.device)
    return out


async def _p14_drive(torch, np, pkg, tra, run, client, tok, opts, chats, chat_ids, mcfg, sh,
                     smi):
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.ensure_future(run.main_async(opts, ready))
    await asyncio.wait({server, ready}, return_when=asyncio.FIRST_COMPLETED)
    if server.done():
        server.result()  # startup failed: raise its error
    served = ready.result()
    base = f"http://127.0.0.1:{served.port}"
    eng = served.torch_engine
    try:
        bodies = [{"model": "gemma2-9b", "messages": m, "max_tokens": sh.max_tokens,
                   "stream": True, "stream_options": {"include_usage": True}}
                  for m in chats]
        sync(torch, sh.device)
        tra.reset_launches()
        res, wall, _, _ = await burst(client, eng, base + "/v1/chat/completions", bodies,
                                      reset_cache=False)
        for i, (r, ids) in enumerate(zip(res, chat_ids)):
            assert r["done"], f"chat {i} did not end with [DONE]"
            assert r["finish"] in ("length", "stop"), (i, r["finish"])
            n = r["usage"]["completion_tokens"]
            assert r["usage"]["prompt_tokens"] == len(ids) and 0 < n <= sh.max_tokens, r
            assert n == sh.max_tokens or r["finish"] == "stop", r
        # A lone greedy request of token ids, over HTTP ...
        rs = np.random.RandomState(16)
        lone_ids = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=LONE_PROMPT_LEN)]
        lone = await sse_request(client, base + "/v1/completions", {
            "model": "gemma2-9b", "prompt": lone_ids, "max_tokens": sh.max_tokens,
            "stream": True, "nvext": {"ignore_eos": True}})
        sync(torch, sh.device)
        designs = dict(tra.KERNEL_LAUNCHES)
        if sh.device == "cuda":
            assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
            assert designs["mixed_f32"] == 0, designs
        # ... and straight to a TorchEngine on the served weights.
        eng2 = pkg.engine.TorchEngine(eng.cfg, model=eng.model, device=sh.device)
        try:
            stream = eng2.submit({"token_ids": lone_ids, "stop_conditions": {
                "max_tokens": sh.max_tokens, "ignore_eos": True}})
            eng2.start()
            direct = [t async for item in stream for t in item.get("token_ids", [])]
        finally:
            eng2.stop()
        del eng2
        assert len(direct) == sh.max_tokens
        assert lone["text"] == streamed_text(tok, direct), (lone["text"], tok.decode(direct))
        # A chat may stop at a first sampled EOS and stream no text.
        texts = [r for r in res if r["frames"]]
        st = dict(edge_stats(texts, wall, 0.0, 0.0), completion_tokens=sum(
            r["usage"]["completion_tokens"] for r in res))
        st["tokens_per_s"] = st["completion_tokens"] / wall
        log(f"[gemma2] {smi}: (c) 8 streaming chats over HTTP (prompts "
            f"{[len(i) for i in chat_ids]} tokens) at once: wall {wall:.3f} s, "
            f"{st['completion_tokens']} tokens, {st['tokens_per_s']:.2f} tokens/s, edge TTFT "
            f"p50 {st['ttft_p50_s']:.3f} s max {st['ttft_max_s']:.3f} s; every stream ended "
            f"[DONE], finishes {[r['finish'] for r in res]}, usage exact; the lone greedy "
            f"request's HTTP text equals a direct engine's tokens decoded; launches by "
            f"kernel {designs}")
        return dict(st, designs=designs, finishes=[r["finish"] for r in res],
                    prompt_tokens=[len(i) for i in chat_ids])
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server


def phase14(torch, np, pkg, tra, smi: str, sh: Phase14 = Phase14(), mcfg=None,
            check_cfgs=None) -> dict:
    """Phase 14: gemma2-9b (head dim 256, a 4,096 window on even layers,
    softcaps) at full width and depth through both bf16 kernels: (a) the
    engine, (b) plain against kernel at 4 layers, also at mistral-7b's
    width (D = 128, a window on every layer), (c) over HTTP with a
    SentencePiece-BPE tokenizer."""
    mcfg = mcfg or pkg.models.GEMMA2_9B
    check_cfgs = check_cfgs or (mcfg, pkg.models.MISTRAL_7B)
    t0 = time.perf_counter()
    free(torch, sh.device)
    a = p14_engine_path(torch, pkg, tra, smi, sh, mcfg,
                        p14_requests(np, mcfg.vocab_size, sh))
    b = {c.model_type: p14_window_logits(torch, np, pkg, tra, smi, sh, c) for c in check_cfgs}
    c = p14_http(torch, np, pkg, tra, smi, sh, mcfg)
    wall = time.perf_counter() - t0
    log(f"[gemma2] {smi}: phase 14 wall {wall:.1f} s")
    return dict(a=a, b=b, c=c, designs=a["designs"], designs_http=c["designs"],
                wall_s=wall)


# ------------------------------------------------------------ phase 15
@dataclass
class Phase15:
    """Phase 15's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS  # (a): the last (2,048) is the conversation
    num_pages: int = 160  # (a): G1 holds one 2,048-token prompt and its decode ...
    host_pages: int = 256  # ... G2 overflows into G3 ...
    store_pages: int = 1024  # ... of at most 2 GiB (2 MiB a llama-8b bf16 page)
    hit_tokens: int = MAX_TOKENS
    max_evictors: int = 12
    f32_layers: int = F32_LAYERS  # (b): llama-8b's width at 4 layers, float32
    f32_len: int = 512  # (b): the conversation ...
    f32_churn: int = 3  # ... and the prompts that push it into G3
    f32_pages: int = 48
    f32_host_pages: int = 16
    flip_at: int = 5  # (b): the stored page whose read is flipped
    chat_chars: tuple = (1200, 6000)  # (c): README text of chat 1, and of chats 2 and 3
    chat_tokens: int = 16
    chaos_tokens: int = MAX_TOKENS  # (d)
    cut_at: int = 16  # (d): the mid-stream crash
    chaos_pages: int = 512
    process_timeout_s: float = 300.0


def p15_engine(pkg, mcfg, model, kv_dtype: str, sh: Phase15, store_dir: str, num_pages: int,
               host_pages: int, max_len: int, chaos=None, **kw):
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, num_pages=num_pages,
        max_model_len=max_len, kv_dtype=kv_dtype, host_cache_pages=host_pages,
        kv_store_dir=store_dir, kv_store_pages=sh.store_pages, kv_store_chaos=chaos, **kw,
    )
    return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)


def run_live(engine, requests):
    """``serve`` without stopping the engine (a stop drains G2 into G3)."""
    return asyncio.run(serve(engine, requests))


def hard_kill(engine) -> None:
    """A crash: the loop thread ends with no teardown (no offload flush,
    no G2 -> G3 drain, no manifest seal), as ``tests/test_kv_persist.py``
    kills one. Whatever the demotion write-through committed is all the
    next boot gets."""
    engine._running = False
    engine._wake.set()
    if engine._watchdog is not None:
        engine._watchdog.stop()
        engine._watchdog = None
    if engine._thread is not None:
        engine._thread.join(timeout=60)
        assert not engine._thread.is_alive(), "the loop thread did not end"
        engine._thread = None
    if engine.copy_stream is not None:
        engine.copy_stream.stop()
        engine.copy_stream = None


def timed_calls(obj, name: str, writes: bool) -> dict:
    """Wrap ``obj.name``, a G3 write ``(hash, k, v) -> bool`` or read
    ``(hash) -> (k, v) | None``: the calls that moved a page, their
    bytes (K and V) and their seconds."""
    t = {"pages": 0, "bytes": 0, "s": 0.0}
    fn = getattr(obj, name)

    def wrapped(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        t["s"] += time.perf_counter() - t0
        if out:
            k = args[1] if writes else out[0]
            t["pages"] += 1
            t["bytes"] += 2 * k.numel() * k.element_size()
        return out

    setattr(obj, name, wrapped)
    return t


def gbps(t: dict) -> float:
    return t["bytes"] / t["s"] / 1e9 if t["s"] else 0.0


def g3_restart(torch, np, pkg, tra, smi: str, sh: Phase15, mcfg=None) -> dict:
    """Phase 15 (a): llama-8b at full width and depth, bf16. The
    2,048-token prompt cold, then as a G1 hit (its pages' bytes saved on
    the card); other prompts until its pages have gone G1 -> G2 -> G3;
    a hard kill; a new engine over the same directory (the same weight
    tensors) adopts the pages at boot and the rerun restores all of them
    from G3 (``persist``), with the saved bytes and the G1 hit's tokens;
    then a G2 hit after one more evicting prompt."""
    import shutil
    import tempfile

    mcfg = mcfg or pkg.models.LLAMA_8B
    cuda = sh.device == "cuda"
    model = seeded_model(torch, pkg, mcfg, sh.device)
    prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
    prompt = prompts[-1]
    max_len = len(prompt) + sh.hit_tokens + PS
    req = {"token_ids": prompt, "stop_conditions": {"max_tokens": sh.hit_tokens,
                                                    "ignore_eos": True}}
    hashes = pkg.tokens.compute_block_hashes_for_seq(prompt, PS)
    rs = np.random.RandomState(13)

    def evict(eng) -> None:
        other = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=len(prompt))]
        run_live(eng, [{"token_ids": other,
                        "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}])

    store_dir = tempfile.mkdtemp(prefix="g3-")
    try:
        eng = p15_engine(pkg, mcfg, model, "bfloat16", sh, store_dir, sh.num_pages,
                         sh.host_pages, max_len)
        # The demotion write-through: the host pool calls the store.
        writes = timed_calls(eng.host_pool, "on_demote", writes=True)
        (cold,), _ = run_live(eng, [req])
        (g1,), _ = run_live(eng, [req])
        # The cold run and the G1 hit score the last prompt token in other
        # batch shapes, so at bf16 they may part at a tie (not asserted);
        # every later hit restores the same pages and is held to the G1 hit.
        assert g1[1] == "length" and len(g1[0]) == sh.hit_tokens, g1[1]
        pids = eng.kv.match_resident_hashes(hashes)
        assert len(pids) == len(hashes), "(a) the G1 run did not hit every prompt page"
        saved = {h: (eng.k_cache[:, p].clone(), eng.v_cache[:, p].clone())
                 for h, p in zip(hashes, pids)}
        evictors = 0
        while eng.g3_store.match_chain(hashes) != hashes:
            assert evictors < sh.max_evictors, "(a) the prompt's pages never reached G3"
            evict(eng)
            evictors += 1
            time.sleep(0.05)  # the loop's idle pass hands evictions to the copy stream
            eng.copy_stream.drain()
        assert eng.kv.match_resident_hashes(hashes) == [], "(a) pages still in G1"
        m1 = eng.metrics()
        assert m1["kv_store_degraded"] == 0, m1
        demoted = m1["kv_store_demotes"]
        hard_kill(eng)
        del eng
        free(torch, sh.device)

        hash_calls = dict(pkg.native.CALLS)
        eng = p15_engine(pkg, mcfg, model, "bfloat16", sh, store_dir, sh.num_pages,
                         sh.host_pages, max_len)
        adopted, boot_s = eng.g3_store.adopted, eng.g3_boot_seconds
        assert adopted >= len(hashes) and eng.g3_store.match_chain(hashes) == hashes, (
            adopted, eng.g3_store.torn_pages)
        reads = timed_calls(eng.g3_store, "fetch", writes=False)
        injected, inject_s = {}, [0.0]
        apply_uploads = eng._apply_uploads

        def spy(seq):
            """The injected pages' bytes, read on the device right after
            the inject, before any forward; the inject's seconds."""
            ups = [(pid, h) for pid, h, _, _ in seq.pending_uploads]
            t0 = time.perf_counter()
            apply_uploads(seq)
            sync(torch, sh.device)
            inject_s[0] += time.perf_counter() - t0
            for pid, h in ups:
                injected[h] = (eng.k_cache[:, pid].clone(), eng.v_cache[:, pid].clone())

        eng._apply_uploads = spy
        guard = guard_chained_syncs(torch, eng, sh.device)
        guarded = {"dispatches": 0, "ledger": 0}

        def under_error_mode(fn, key):
            """``fn`` run under sync debug 'error' on the card."""
            def wrapped(*args):
                if cuda:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out = fn(*args)
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
                guarded[key] += 1
                return out
            return wrapped

        eng._dispatch_ragged = under_error_mode(eng._dispatch_ragged, "dispatches")
        eng._check_ledger = under_error_mode(eng._check_ledger, "ledger")
        (g3,), _ = run_live(eng, [req])
        m = eng.metrics()
        assert m["kv_prefix_hits_persist"] == len(hashes), m["kv_prefix_hits"]
        assert sorted(injected) == sorted(hashes), (len(injected), len(hashes))
        for h in hashes:
            assert torch.equal(injected[h][0], saved[h][0]) and torch.equal(
                injected[h][1], saved[h][1]), "(a) injected bytes differ from the evicted ones"
        assert g3[0] == g1[0], "(a) the G3 hit gave other tokens than the G1 hit"
        assert guarded["dispatches"] + guard["guarded"] > 0 and not guard["errors"], guard
        assert guarded["ledger"] > 0
        assert pkg.native.native_available()
        assert pkg.native.CALLS["seq_hashes"] > hash_calls["seq_hashes"], pkg.native.CALLS
        restore = dict(reads, s=reads["s"] + inject_s[0])
        for name in ("_apply_uploads", "_dispatch_ragged", "_check_ledger",
                     "_dispatch_chained"):
            vars(eng).pop(name)  # the engine's own methods again
        restored0 = m["kv_prefix_hits_restore"]
        for _ in range(3):  # until no page of the prompt is left in G1
            evict(eng)
            if not any(eng.kv.resident_page(h) is not None for h in hashes):
                break
        assert not any(eng.kv.resident_page(h) is not None for h in hashes)
        (g2,), _ = run_live(eng, [req])
        m = eng.metrics()
        assert m["kv_prefix_hits_restore"] - restored0 == len(hashes), m["kv_prefix_hits"]
        assert g2[0] == g1[0], "(a) the G2 hit gave other tokens than the G1 hit"
        eng.stop()
        audit = check_drained(eng, "(a)")
        report = eng.kv_audit()
        assert report["g3"]["violations"] == [] and m["kv_ledger_violations"] == 0, report
        assert m["kv_store_degraded"] == 0 and m["kv_store_checksum_failures"] == 0, m
        ttft = {"cold": cold[2], "G1 hit": g1[2], "G2 hit": g2[2], "G3 hit": g3[2]}
        log(f"[g3] (a) {smi}: width {mcfg.hidden_size}, {mcfg.num_layers} layers, bf16, "
            f"{len(prompt)}-token prompt ({len(hashes)} pages), "
            f"G1 {sh.num_pages} pages, G2 {sh.host_pages}: {evictors} evicting prompts demoted "
            f"{demoted} pages into G3 ({writes['bytes'] / 1e9:.3f} GB written at "
            f"{gbps(writes):.2f} GB/s, checksummed, tmp + rename); hard kill; boot_scan adopted "
            f"{adopted} pages in {boot_s:.3f} s; the rerun restored {len(hashes)} pages from G3 "
            f"({reads['bytes'] / 1e9:.3f} GB read and verified at {gbps(reads):.2f} GB/s, "
            f"G3 -> G1 with the inject at {gbps(restore):.2f} GB/s), injected bytes equal the "
            f"evicted ones, tokens equal the G1 hit's (the cold run's: "
            f"{'equal' if cold[0] == g1[0] else 'other tokens, bf16, not asserted'}); TTFT "
            + ", ".join(
                f"{k} {v:.3f} s" for k, v in ttft.items())
            + f"; {guarded['dispatches']} dispatches, {guard['guarded']} chained windows and "
            f"{guarded['ledger']} in-loop ledger checks of the rerun under sync debug 'error'; "
            f"audit clean {audit}, G3 ledger clean")
        del eng, saved, injected
        return dict(demoted=demoted, evictors=evictors, adopted=adopted, boot_s=boot_s,
                    write_gbps=gbps(writes), read_gbps=gbps(reads), restore_gbps=gbps(restore),
                    ttft=ttft, tokens=g1[0])
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
        del model
        free(torch, sh.device)


def g3_containment_f32(torch, np, pkg, tra, smi: str, sh: Phase15, mcfg=None) -> dict:
    """Phase 15 (b): llama-8b's width at 4 layers, float32. A bit flipped
    in the read of one stored page (``StorageChaos``): that page is
    quarantined, the conversation restores the pages before it and
    re-prefills from it, with the fault-free tokens; torn writes are
    quarantined at the next boot_scan; an ENOSPC degrades the store and
    the engine serves G2-only with the same tokens."""
    import shutil
    import tempfile
    from dataclasses import replace

    from dynamo_exp_tpu_torch.runtime.transports.chaos import StorageChaos

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=sh.f32_layers, dtype="float32")
    model = seeded_model(torch, pkg, mcfg, sh.device)
    rs = np.random.RandomState(15)
    convo = [int(t) for t in rs.randint(3, mcfg.vocab_size, size=sh.f32_len)]
    churn = [[int(t) for t in rs.randint(3, mcfg.vocab_size, size=sh.f32_len)]
             for _ in range(sh.f32_churn)]
    hashes = pkg.tokens.compute_block_hashes_for_seq(convo, PS)
    max_len = sh.f32_len + sh.hit_tokens + PS

    def body(ids, n=sh.hit_tokens):
        return {"token_ids": ids, "stop_conditions": {"max_tokens": n, "ignore_eos": True},
                "sampling_options": {"logprobs": LP_TOP}}

    def engine(store_dir, chaos=None):
        return p15_engine(pkg, mcfg, model, "float32", sh, store_dir, sh.f32_pages,
                          sh.f32_host_pages, max_len, chaos=chaos)

    def convo_run(eng) -> dict:
        return p8_burst(torch, eng, [body(convo)], sh.device)["out"][0]

    def seed(eng) -> dict:
        want = p8_live(eng, body(convo))
        for c in churn:
            p8_live(eng, body(c, 2))
        return want

    dirs = [tempfile.mkdtemp(prefix="g3-f32-") for _ in range(3)]
    try:
        eng = engine(dirs[0])
        want = seed(eng)
        eng.stop()  # graceful: the warm G2 set drains into G3, the manifest seals
        assert eng.g3_store.match_chain(hashes) == hashes, "(b) the conversation is not in G3"
        assert eng.metrics()["kv_store_degraded"] == 0
        del eng

        chaos = StorageChaos(7).delay_read(0.0, times=sh.flip_at).bitflip_read(times=1)
        eng = engine(dirs[0], chaos)
        flipped = convo_run(eng)
        m = eng.metrics()
        assert chaos.injected == ["store_read:delay"] * sh.flip_at + ["store_read:bitflip"], (
            chaos.injected)
        assert m["kv_store_checksum_failures"] == 1 and m["kv_store_quarantined"] == 1, m
        assert m["kv_store_degraded"] == 0, m
        assert m["kv_prefix_hits_persist"] == sh.flip_at, m["kv_prefix_hits"]
        quarantined = os.listdir(os.path.join(dirs[0], "quarantine"))
        assert len(quarantined) == 1, quarantined
        check_drained(eng, "(b) bitflip")
        assert eng.kv_audit()["g3"]["violations"] == []
        del eng

        chaos = StorageChaos(7).torn_write(times=2)
        eng = engine(dirs[1], chaos)
        want_torn = seed(eng)
        assert chaos.injected == ["store_write:torn"] * 2, chaos.injected
        hard_kill(eng)
        del eng
        eng = engine(dirs[1])
        torn = eng.g3_store.torn_pages
        assert torn == 2, torn
        torn_run = convo_run(eng)
        assert eng.metrics()["kv_store_degraded"] == 0
        check_drained(eng, "(b) torn")
        del eng

        chaos = StorageChaos(7).enospc(times=1)
        eng = engine(dirs[2], chaos)
        want_full = seed(eng)
        m = eng.metrics()
        assert m["kv_store_degraded"] == 1 and m["kv_store_errors"] >= 1, m
        g2_only = convo_run(eng)
        check_drained(eng, "(b) enospc")
        del eng

        faults, ties = divergences([want] * 5, [flipped, want_torn, torn_run, want_full,
                                                g2_only], F32_TIE)
        assert not faults, f"(b) tokens differ from the fault-free run: {faults}"
        log(f"[g3] (b) {smi}: width {mcfg.hidden_size}, {mcfg.num_layers} layers, float32, a "
            f"{sh.f32_len}-token conversation ({len(hashes)} pages) stored in G3: a bit flipped "
            f"in the read of page {sh.flip_at} -> checksum failure 1, quarantined 1, "
            f"{sh.flip_at} pages restored and the rest re-prefilled; 2 torn writes -> "
            f"quarantined by the next boot_scan ({torn}); an ENOSPC -> degraded, served G2-only; "
            f"every run's tokens equal the fault-free run's (float32 ties within {F32_TIE}: "
            f"{'; '.join(ties) or 'none'})")
        return dict(flip_at=sh.flip_at, torn=torn, ties=ties)
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
        del model
        free(torch, sh.device)


def p8_live(eng, request: dict) -> dict:
    """One request through a running engine (not stopped after): its
    tokens and logprob packs, as ``p8_burst`` collects them."""

    async def go():
        r = dict(tokens=[], lps=[], tops=[], finish=None)
        stream = eng.submit(request)
        eng.start()
        async for item in stream:
            ids = item.get("token_ids", [])
            r["tokens"] += ids
            if item.get("logprobs"):
                r["lps"] += item["logprobs"]
                r["tops"] += item.get("top_logprobs") or [None] * len(ids)
            r["finish"] = item.get("finish_reason", r["finish"])
        return r

    return asyncio.run(asyncio.wait_for(go(), 600))


class _Server:
    """A ``python -m dynamo_exp_tpu_torch.run`` process: its output read
    on a thread; ``url`` once it prints ``listening on``."""

    def __init__(self, argv: list, env: dict, timeout: float):
        import threading

        self.proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        deadline = time.monotonic() + timeout
        self.url = None
        while self.url is None:
            for line in list(self.lines):
                if line.startswith("listening on "):
                    self.url = line.split()[-1]
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise AssertionError("(c) the server did not start:\n" + "".join(self.lines[-40:]))
            time.sleep(0.1)

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)

    def stop(self, timeout: float = 120.0) -> int:
        """SIGTERM (the normal shutdown: the engine stops, draining G2
        into G3 and sealing) and wait; SIGKILL if it hangs."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._reader.join(timeout=10)
        return self.proc.returncode


def g3_processes(torch, np, pkg, smi: str, sh: Phase15, mcfg=None) -> dict:
    """Phase 15 (c): ``DYN_KV_STORE`` across processes. A server process
    (``run in=http out=cuda``, llama-8b at full width and depth, random
    weights from seed 0, a G1 that holds one chat) answers chats 1, 2
    and 3 (which push chat 1's pages into G2) and chat 1 again (a G2
    hit), and stops through its normal shutdown (drain and seal); a
    second process over the same directory answers chat 1 with
    the same text from the same pages restored from G3
    (``dynamo_kv_prefix_hits_total{kind="persist"}`` equal to the first
    process's ``restore`` hits of chat 1, ``dynamo_kv_store_pages`` > 0);
    a misspelled ``DYN_KV_PACKNG`` makes a third process exit non-zero
    naming the accepted spellings."""
    import shutil
    import tempfile

    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or pkg.models.LLAMA_8B
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    tmp = tempfile.mkdtemp(prefix="p15c-")
    store = os.path.join(tmp, "g3")
    try:
        model_dir = write_model_dir(os.path.join(tmp, "model"), tokmod, mcfg, text)
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        n1, n2 = sh.chat_chars
        contents = [text[:n1], text[n1:n1 + n2], text[n1 + n2:n1 + 2 * n2]]
        # Pages each chat holds at its end (its text, the template's
        # tokens within one page, its answer). G1 holds the longest
        # chat: chats 2 and 3 push every page of chat 1 out into G2,
        # which holds all three, so chat 1 again restores all its full
        # pages, and the drain at shutdown takes them to G3.
        pages = [-(-(len(tok.encode(c).ids) + PS + sh.chat_tokens) // PS) + 1 for c in contents]
        num_pages = max(pages)
        host_pages = sum(pages) + 8
        max_len = (num_pages + 2) * PS
        argv = [sys.executable, "-m", "dynamo_exp_tpu_torch.run", "in=http", "out=cuda",
                "--device", sh.device, "--model-path", model_dir, "--model-name", "m",
                "--random-weights", "--http-host", "127.0.0.1", "--http-port", "0",
                "--max-decode-slots", "8", "--page-size", str(PS),
                "--max-model-len", str(max_len), "--num-pages", str(num_pages),
                "--host-cache-pages", str(host_pages),
                "--kv-dtype", "bfloat16" if sh.device == "cuda" else "float32"]
        env = {k: v for k, v in os.environ.items() if not k.startswith("DYN_KV_")}
        env["DYN_KV_STORE"] = store
        chats = [[{"role": "user", "content": c}] for c in contents]

        async def chat(url, messages):
            r = await client.request(f"{url}/v1/chat/completions", "POST", {
                "model": "m", "messages": messages, "max_tokens": sh.chat_tokens,
                "temperature": 0.0})
            assert r.status == 200, r.body[:500]
            body = r.json()
            assert body["choices"][0]["finish_reason"] == "length", body
            return body["choices"][0]["message"]["content"]

        async def hits(url):
            await asyncio.sleep(1.0)  # the engine publishes its gauges twice a second
            r = await client.request(f"{url}/metrics")
            values = _family_values(r.body.decode())
            return {k[1][0][1]: v for k, v in values.items()
                    if k[0] == "dynamo_kv_prefix_hits_total"}, values

        t0 = time.perf_counter()
        first = _Server(argv, env, sh.process_timeout_s)
        try:
            answers = [asyncio.run(chat(first.url, c)) for c in chats]
            before, _ = asyncio.run(hits(first.url))
            assert before.get("restore", 0.0) == 0, before
            answers.append(asyncio.run(chat(first.url, chats[0])))
            after, _ = asyncio.run(hits(first.url))
        finally:
            rc1 = first.stop()
        assert rc1 == 0, "".join(first.lines[-40:])
        restored = after.get("restore", 0.0) - before.get("restore", 0.0)
        assert restored > 0, (before, after)
        names = os.listdir(store)
        stored = sum(1 for n in names if n.endswith(".kv"))
        assert stored >= restored and "manifest.jsonl" in names, (stored, restored)
        second = _Server(argv, env, sh.process_timeout_s)
        try:
            again = asyncio.run(chat(second.url, chats[0]))
            got, values = asyncio.run(hits(second.url))
        finally:
            rc2 = second.stop()
        assert rc2 == 0, "".join(second.lines[-40:])
        assert again == answers[3], (again, answers[3])
        persist = got.get("persist", 0.0)
        store_pages = values.get(("dynamo_kv_store_pages", ()), 0.0)
        assert persist == restored and store_pages > 0, (got, store_pages)
        bad_env = dict(env, DYN_KV_PACKNG="1")
        bad = subprocess.run(argv, cwd=HERE, env=bad_env, capture_output=True, text=True,
                             timeout=sh.process_timeout_s)
        assert bad.returncode != 0, bad.stdout
        for name in ("DYN_KV_STORE", "DYN_KV_DEFAULT_BW_BPS"):
            assert name in bad.stderr, bad.stderr[-2000:]
        wall = time.perf_counter() - t0
        log(f"[g3] (c) {smi}: DYN_KV_STORE across processes (G1 {num_pages} pages, G2 "
            f"{host_pages}): the first server answered chats 1, 2, 3 and chat 1 "
            f"again ({restored:.0f} pages restored from G2; chats of {pages} pages) and shut down (drain + "
            f"seal: {stored} page files); the second adopted them and answered chat 1 with "
            f"the same text from {persist:.0f} pages restored from G3 (first answer, cold, "
            f"{'equal' if answers[0] == again else 'other text (bf16, not asserted)'}), "
            f"dynamo_kv_store_pages {store_pages:.0f}; DYN_KV_PACKNG=1 exited "
            f"{bad.returncode} naming the accepted spellings; {wall:.1f} s")
        return dict(persist=persist, restored=restored, store_pages=store_pages,
                    stored=stored, wall_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def _p15_chaos(pkg, engines, prompts, sh: Phase15, seed: int, opts: list,
                     cut_only: bool = False) -> dict:
    """One scripted run of the serving plane: ``engines`` as two
    instances on the in-process transport wrapped in the chaos planes,
    behind ``PushRouter`` with the journal; requests one at a time.
    Returns the streams, the breaker's states and the normalized
    ``injected`` list."""
    import random

    from dynamo_exp_tpu_torch import runtime as rt
    from dynamo_exp_tpu_torch.runtime.transports import chaos, inproc

    sched = chaos.ChaosSchedule(seed)
    drt = rt.DistributedRuntime(
        discovery=chaos.ChaosDiscovery(inproc.InProcDiscovery(), sched),
        request_plane=chaos.ChaosRequestPlane(inproc.InProcRequestPlane(), sched))
    ep = drt.namespace("smoke15").component("engine").endpoint("generate")

    def handler(eng):
        async def serve(request, context=None):
            # The worker's own index past each frame's last token, set
            # before the journal sees the frame: a continuation starts
            # at the resume_offset its request carries.
            end = request.get("resume_offset") or 0
            async for frame in rt.annotated_stream(eng, request, context):
                data = frame.get("data")
                if isinstance(data, dict) and data.get("token_ids"):
                    end += len(data["token_ids"])
                    frame = {**frame, "data": {**data, "end_index": end}}
                yield frame
        return serve

    clock = [0.0]
    a = await ep.serve_endpoint(handler(engines[0]), lease=await drt.discovery.create_lease())
    client = await ep.client(health=rt.HealthTracker(failure_threshold=2, cooldown_s=5.0,
                                                     clock=lambda: clock[0]))
    await client.wait_for_instances(1, timeout=10)
    if not cut_only:
        sched.fail_watch(times=2)  # the next watch pushes die: the client re-lists
    b = await ep.serve_endpoint(handler(engines[1]), lease=await drt.discovery.create_lease())
    await client.wait_for_instances(2, timeout=10)
    names = {a.instance_id: "a", b.instance_id: "b"}
    router = rt.PushRouter(client, rt.RouterMode.ROUND_ROBIN, rng=random.Random(seed),
                           backoff_base_s=0.001, max_recoveries=2)
    breaker = client.health.breaker(b.instance_id)

    async def one(i):
        req = {"token_ids": prompts[i], "stop_conditions": {"max_tokens": sh.chaos_tokens,
                                                            "ignore_eos": True},
               "sampling_options": dict(opts[i])}
        r = dict(tokens=[], gaps=[], lps=[], tops=[], finish=None, completion=None)
        async for item in await router.generate(req):
            ids = item.get("token_ids", [])
            if ids and item["end_index"] - len(ids) != len(r["tokens"]):
                # The worker placed these tokens elsewhere than after
                # what the client holds: a gap or a duplicate.
                r["gaps"].append((len(r["tokens"]), item["end_index"], len(ids)))
            r["tokens"] += ids
            if item.get("logprobs"):
                r["lps"] += item["logprobs"]
                r["tops"] += item.get("top_logprobs") or [None] * len(ids)
            r["finish"] = item.get("finish_reason", r["finish"])
            r["completion"] = item.get("completion_tokens", r["completion"])
        return r

    out, states = [], []
    if cut_only:
        sched.crash_at_token(sh.cut_at)
        out.append(await one(0))
    else:
        sched.fail_requests(times=1)  # a crash at stream start: failover
        out.append(await one(0))
        sched.crash_at_token(sh.cut_at)  # a crash mid-stream: the journal resumes it
        out.append(await one(1))
        sched.partition(b.instance_id)  # one wave with b unreachable
        while breaker.state.name != "OPEN" and len(out) < 6:
            out.append(await one(len(out)))
        states.append(breaker.state.name)
        sched.heal(b.instance_id)
        clock[0] += 6.0  # past the cooldown: the next pick of b is a probe
        while len(out) < len(prompts):
            out.append(await one(len(out)))
        states.append(breaker.state.name)
    injected = []
    for e in sched.injected:
        parts = e.split(":")
        if len(parts) == 3 and parts[1].isdigit():
            parts[1] = names.get(int(parts[1]), "?")
        injected.append(":".join(parts))
    await drt.close()
    return dict(out=out, states=states, injected=injected)


def chaos_plane(torch, np, pkg, tra, smi: str, sh: Phase15, mcfg=None, f32_cfg=None) -> dict:
    """Phase 15 (d): two ``TorchEngine``s sharing llama-8b's weights
    (bf16, full depth) behind the chaos planes and ``PushRouter`` with
    the journal: a crash at stream start, a crash at token 16, a
    partition healed after one wave and a discovery watch flap, over 8
    greedy requests and a seeded one, twice with the same seed; then at
    float32 (4 layers) a stream cut at token 16 against the
    uninterrupted one."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    mcfg = mcfg or pkg.models.LLAMA_8B
    model = seeded_model(torch, pkg, mcfg, sh.device)
    prompts = phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens)
    prompts = prompts + [prompts[min(SEEDED, len(prompts) - 1)]]
    opts = [{} for _ in prompts[:-1]] + [dict(SEEDED_OPTIONS)]
    max_len = max(len(p) for p in prompts) + sh.chaos_tokens + PS
    engines = [p15_engine(pkg, mcfg, model, "bfloat16", sh, "", sh.chaos_pages, 0, max_len)
               for _ in range(2)]
    tel = get_telemetry()

    def recoveries() -> float:
        return sum(v for k, v in _family_values(tel.render().decode()).items()
                   if k[0] == "dynamo_request_recoveries_total")

    try:
        rec0 = recoveries()
        runs = [asyncio.run(asyncio.wait_for(_p15_chaos(pkg, engines, prompts, sh, 15, opts),
                                             900)) for _ in range(2)]
        recovered = recoveries() - rec0
        for eng in engines:
            with eng.hold_admission():
                audit = eng.kv_audit()
            assert audit["ok"] and eng.kv_ledger_violations == 0, audit["violations"][:5]
    finally:
        for eng in engines:
            eng.stop()
    first, second = runs
    assert first["injected"] == second["injected"], (first["injected"], second["injected"])
    assert first["states"] == second["states"] == ["OPEN", "CLOSED"], first["states"]
    for run in runs:
        assert len(run["out"]) == len(prompts)
        for i, r in enumerate(run["out"]):
            assert r["finish"] == "length" and len(r["tokens"]) == sh.chaos_tokens, (i, r["finish"])
            assert not r["gaps"], (i, r["gaps"])
    assert recovered >= 2, recovered  # one journal resume a run
    assert any(e.endswith(":error") for e in first["injected"])
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(first["out"], second["out"]))
    del engines
    free(torch, sh.device)

    f32_cfg = f32_cfg or replace(pkg.models.LLAMA_8B, num_layers=sh.f32_layers, dtype="float32")
    model = seeded_model(torch, pkg, f32_cfg, sh.device)
    prompt = phase5_prompts(np, f32_cfg.vocab_size, (sh.f32_len,))
    engines = [p15_engine(pkg, f32_cfg, model, "float32", sh, "", sh.chaos_pages // 4, 0,
                          sh.f32_len + sh.chaos_tokens + PS) for _ in range(2)]
    try:
        want = p8_live(engines[0], {"token_ids": prompt[0], "stop_conditions": {
            "max_tokens": sh.chaos_tokens, "ignore_eos": True},
            "sampling_options": {"logprobs": LP_TOP}})
        cut = asyncio.run(asyncio.wait_for(_p15_chaos(
            pkg, engines, prompt, sh, 15, [{"logprobs": LP_TOP}], cut_only=True), 600))
        for eng in engines:
            with eng.hold_admission():
                assert eng.kv_audit()["ok"]
    finally:
        for eng in engines:
            eng.stop()
    (got,) = cut["out"]
    assert len(cut["injected"]) == 1 and cut["injected"][0].endswith(":error"), cut["injected"]
    assert len(got["tokens"]) == sh.chaos_tokens and got["finish"] == "length"
    faults, ties = divergences([want], [got], F32_TIE)
    assert not faults, f"(d) the stream cut at token {sh.cut_at} differs: {faults}"
    log(f"[chaos] (d) {smi}: two bf16 engines of {mcfg.num_layers} layers, width "
        f"{mcfg.hidden_size} (shared weights) behind the chaos planes "
        f"and PushRouter: {len(prompts)} requests x 2 runs, injected {first['injected']} in "
        f"both runs (seed 15), b's breaker {' -> '.join(first['states'])}, recoveries "
        f"{recovered:.0f}, every stream whole and gapless; {same}/{len(prompts)} streams equal "
        f"across the runs (bf16, not asserted); float32 ({f32_cfg.num_layers} layers): the "
        f"stream cut at token {sh.cut_at} equals the uninterrupted one (ties within {F32_TIE}: "
        f"{'; '.join(ties) or 'none'})")
    del engines, model
    free(torch, sh.device)
    return dict(injected=first["injected"], states=first["states"], recovered=recovered,
                same=same, ties=ties)


def phase15(torch, np, pkg, tra, smi: str, sh: Phase15 = Phase15(), mcfg=None,
            f32_cfg=None) -> dict:
    """Phase 15: the G3 persistent tier and the chaos planes on the card:
    (a) restart-identical prefix at full width, (b) containment at
    float32, (c) across processes, (d) chaos on the serving plane. The
    launches of (a)-(b) and of (d) go to the kernels line."""
    t0 = time.perf_counter()
    free(torch, sh.device)
    sync(torch, sh.device)
    tra.reset_launches()
    a = g3_restart(torch, np, pkg, tra, smi, sh, mcfg)
    b = g3_containment_f32(torch, np, pkg, tra, smi, sh, f32_cfg)
    sync(torch, sh.device)
    designs_g3 = dict(tra.KERNEL_LAUNCHES)
    c = g3_processes(torch, np, pkg, smi, sh, mcfg)
    sync(torch, sh.device)
    tra.reset_launches()
    d = chaos_plane(torch, np, pkg, tra, smi, sh, mcfg, f32_cfg)
    sync(torch, sh.device)
    designs_chaos = dict(tra.KERNEL_LAUNCHES)
    if sh.device == "cuda":
        for what, designs in (("g3", designs_g3), ("chaos", designs_chaos)):
            assert all(designs[k] > 0 for k in ("mixed_tc_bf16", "decode_split", "mixed_f32")), (
                what, designs)
    wall = time.perf_counter() - t0
    log(f"[g3] {smi}: phase 15 launches by kernel: G3 {designs_g3}, chaos {designs_chaos}; "
        f"wall {wall:.1f} s")
    return dict(a=a, b=b, c=c, d=d, designs_g3=designs_g3, designs_chaos=designs_chaos,
                wall_s=wall)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import dynamo_exp_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported the port from {pkg.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    import numpy as np

    import dynamo_exp_tpu_torch.engine  # noqa: F401
    import dynamo_exp_tpu_torch.models  # noqa: F401
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = device_info(torch)
    build(tra)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    kern = check_kernels(torch, np, tra, flush)
    windowed = check_windowed(torch, np, tra, flush)
    del flush
    stats = main_path(torch, np, pkg, tra)
    log(f"[engine] {name} ({smi}): wall {stats['wall_s']:.3f} s (rerun "
        f"{stats['rerun_wall_s']:.3f} s), {stats['completion_tokens']} tokens, "
        f"{stats['tokens_per_s']:.2f} tokens/s, TTFT p50 {stats['ttft_p50_s']:.3f} s "
        f"max {stats['ttft_max_s']:.3f} s")
    h = http_path(torch, np, pkg, tra, stats["tokens"])
    a, r = h["a"], h["a_rerun"]
    log(f"[http] {name} ({smi}): (a) 8 streaming completions over HTTP: wall "
        f"{a['wall_s']:.3f} s (rerun {r['wall_s']:.3f} s), {a['completion_tokens']} "
        f"tokens, {a['tokens_per_s']:.2f} tokens/s, edge TTFT p50 {a['ttft_p50_s']:.3f} s "
        f"max {a['ttft_max_s']:.3f} s, mean gap between content frames "
        f"{a['frame_gap_mean_s'] * 1e3:.2f} ms over {a['frames']} frames (rerun: "
        f"{r['tokens_per_s']:.2f} tokens/s, TTFT p50 {r['ttft_p50_s']:.3f} s max "
        f"{r['ttft_max_s']:.3f} s, gap {r['frame_gap_mean_s'] * 1e3:.2f} ms); host CPU "
        f"seconds, server and client thread / engine loop thread: {a['edge_cpu_s']:.3f} / "
        f"{a['loop_cpu_s']:.3f} (rerun {r['edge_cpu_s']:.3f} / {r['loop_cpu_s']:.3f}); phase 5 in "
        f"this call, first run (cold) and rerun: wall {stats['wall_s']:.3f} / "
        f"{stats['rerun_wall_s']:.3f} s, {stats['tokens_per_s']:.2f} / "
        f"{stats['rerun_tokens_per_s']:.2f} tokens/s, TTFT p50 {stats['ttft_p50_s']:.3f} / "
        f"{stats['rerun_ttft_p50_s']:.3f} s, max {stats['ttft_max_s']:.3f} / "
        f"{stats['rerun_ttft_max_s']:.3f} s")
    log("[http] the edge against the engine alone, same engine, same burst, in turns: " +
        "; ".join(
            f"{kind} wall {t['wall_s']:.3f} s, {t['tokens_per_s']:.2f} tokens/s, TTFT p50 "
            f"{t['ttft_p50_s']:.3f} s max {t['ttft_max_s']:.3f} s, gap "
            f"{t['frame_gap_mean_s'] * 1e3:.2f} ms, CPU s asyncio / loop thread "
            f"{t['edge_cpu_s']:.3f} / {t['loop_cpu_s']:.3f}"
            for kind, t in h["turns"]))
    log(f"[http] every stream ended with [DONE]; (a) finished 'length' with "
        f"{MAX_TOKENS} tokens and exact usage, a rerun gave identical text, and "
        f"{sum(h['same_as_phase5'])}/8 texts equal phase 5's tokens decoded; (b) chat "
        f"finishes {h['b_finish']}; (d) stopped at {h['stop']!r} with (c)'s text before it; "
        f"the lone greedy request's HTTP text equals its direct-engine tokens decoded")
    log(f"[http] launches of the HTTP requests alone {h['launches']}, by kernel "
        f"{h['designs']}: {h['per_burst']} in each (a) burst, {h['rest']} in (b), (c), "
        f"(d) and the lone request")
    log(f"[http] host text work: 2 chat requests templated and encoded in "
        f"{h['chat_preprocess_s'] * 1e3:.2f} ms ({h['chat_prompt_tokens']} tokens); "
        f"(a)'s prompts as text, {h['encode_chars']} chars -> {h['encode_tokens']} tokens, "
        f"encoded in {h['encode_s']:.3f} s")
    t7 = time.perf_counter()
    p7 = pressure_burst(torch, np, pkg, tra, smi)
    p7c = pressure_identity_f32(torch, np, pkg, tra, smi)
    log(f"[pressure] phase 7 in {time.perf_counter() - t7:.1f} s")
    t8 = time.perf_counter()
    p8 = phase8(torch, np, pkg, tra, smi, stats["logit_err"])
    log(f"[phase8] in {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    p9 = phase9(torch, np, pkg, tra, smi)
    log(f"[phase9] in {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    p10 = phase10(torch, np, pkg, tra, smi)
    log(f"[phase10] in {time.perf_counter() - t10:.1f} s")
    p11 = phase11(torch, np, pkg, tra, smi, (h["lone_ids"], h["lone_tokens"]))
    log(f"[phase11] in {p11['wall_s']:.1f} s")
    p12 = phase12(torch, np, pkg, tra, smi)
    log(f"[phase12] in {p12['wall_s']:.1f} s")
    p13 = phase13(torch, np, pkg, tra, smi)
    log(f"[phase13] in {p13['wall_s']:.1f} s")
    p14 = phase14(torch, np, pkg, tra, smi)
    log(f"[phase14] in {p14['wall_s']:.1f} s")
    p15 = phase15(torch, np, pkg, tra, smi)
    log(f"[phase15] in {p15['wall_s']:.1f} s")
    log(f"[smoke] {smi}: total {time.perf_counter() - t_start:.1f} s")

    replaces = "dynamo_exp_tpu/ops/ragged_attention.py:123"
    # (kernels-line name, kernel result, source, where its launches are
    # counted: the main path of its dtype, then the other paths).
    rows = [
        ("ragged_paged_attention", "ragged_paged_attention",
         "dynamo_exp_tpu_torch/csrc/ragged_mixed_tc.cu", "mixed_tc_bf16", stats["launches"]),
        ("ragged_decode_attention", "ragged_decode_attention",
         "dynamo_exp_tpu_torch/csrc/ragged_decode_split.cu", "decode_split", stats["launches"]),
        ("ragged_paged_attention_f32", "ragged_paged_attention_f32",
         "dynamo_exp_tpu_torch/csrc/ragged_attention.cu", "mixed_f32", None),
    ]
    kernels = []
    for name, key, source, design, main_launches in rows:
        k = kern[key]
        entry = key.removesuffix("_f32")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (main_launches[entry] if main_launches is not None
                         else p7c["designs"][design]),
            "launches_http": h["designs"][design],
            "launches_kv_pressure": p7["a"]["designs"][design],
            "launches_kv_pressure_f32": p7c["designs"][design],
            "launches_chained": p8["a"]["designs"][design],
            "launches_spec": p8["b"]["designs"][design],
            "launches_identity_f32": p8["c"]["designs"][design],
            "launches_http_logprobs": p8["d"]["designs"][design],
            "launches_loader": p9["a"]["designs"][design],
            "launches_warm_boot": p9["b"]["designs"][design],
            "launches_warm_boot_spec": p9["b"]["designs_spec"][design],
            "launches_edge": p10["designs"][design],
            "launches_telemetry_turns": p10["d"]["designs"][design],
            "launches_cluster": p11["designs"][design],
            "launches_disagg_prefill": p12["designs_prefill"][design],
            "launches_disagg_decode": p12["designs_decode"][design],
            "launches_reclaim": p12["designs_reclaim"][design],
            "launches_observability": p13["designs"][design],
            "launches_gemma2": p14["designs"][design],
            "launches_gemma2_http": p14["designs_http"][design],
            "launches_window_logits": sum(r["designs"][design] for r in p14["b"].values()),
            "launches_g3": p15["designs_g3"][design],
            "launches_chaos": p15["designs_chaos"][design],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
        if entry == "ragged_paged_attention":
            # Phase 8's verify spans (9 queries, two q tiles a row).
            v = kern[key.replace("attention", "attention_verify")]
            kernels[-1].update({f"verify_{t}": v[t] for t in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            if "bound_ms_ffma" in k:  # float32: the bound outside the tensor cores
                kernels[-1].update(bound_ms_ffma=k["bound_ms_ffma"],
                                   verify_bound_ms_ffma=v["bound_ms_ffma"])
        # Phase 3's windowed and softcapped cases (gemma2 at D = 256,
        # mistral's window at D = 128): this design's own shape and dtype;
        # the decode design also at float32 pools.
        for case, res in windowed.items():
            if entry == "ragged_decode_attention":
                kernels[-1][case] = res["decode_bfloat16"]
                kernels[-1][case + "_f32"] = res["decode_float32"]
            else:
                kernels[-1][case] = res["mixed_float32" if name.endswith("_f32")
                                        else "mixed_bfloat16"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
