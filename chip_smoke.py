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
   padding token; the mixed kernels also at the tuning grid's other q
   tiles, 1, 4 and 16 (``check_q_tiles``: llama-8b's heads and gemma2's
   D=256 with softcap and window, both pool dtypes; q_tile 16 timed at
   llama-8b's); time both mixed kernels and the bf16 decode kernel, the plain
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
   served straight by a ``TorchEngine`` on the same weights; (e) a chat
   whose body names no model and no ``max_tokens`` gets the
   ``--request-template``'s model and its ``max_completion_tokens``. Every
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
   deleted. (b) ``run.build_cuda_engine(--model-path <dir> --random-weights
   --prewarm --compile-cache-dir <tmp> --spec ngram)``, the directory's
   config.json llama-8b's at 2 of its 32 layers (``Phase9.warm_layers``;
   a cut that keeps the smoke inside its time limit):
   every window and mixed variant (112 and 80 keys, verify spans too)
   captured as a CUDA graph before traffic (printed: variants, graphs and
   seconds of each kind, the graph pool's bytes; no kernel build: phase
   2's library is copied into the cache directory with its stamp, and a
   library whose stamp equals the sources' hashes is reused); then phase
   8 (a)'s greedy burst and phase 5's
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
   bfloat16)``, llama-8b at full width and 4 of its 32 layers
   (``Phase11.layers``; what is checked is counted in pages, tokens and
   requests, or held against a direct engine of that depth) from seed 0,
   no prewarm, and writes its launch counters, prefix hits and computed
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
   twice under round-robin (each worker serves it once), gives a direct
   engine's tokens at the workers' depth bit for bit; (d) 8 streams of
   256 tokens
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
   width, (a)-(c) at 4 of its 32 layers (``Phase12.disagg_layers``:
   what they check is counted in pages, requests and tokens, or held
   against a direct engine of the same depth), (d) at full depth (seed
   0, 2048 pages of 16 in each worker, no prewarm). A direct ``TorchEngine`` first serves (a)'s lone prompts
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
   and ``llmctl``, llama-8b at full width and 4 of its 32 layers
   (``Phase13.layers``; no check depends on depth) over HTTP
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
   with ``DYN_KV_STORE=<dir>`` (llama-8b's width at 4 layers,
   ``Phase15.process_layers``, the model directory of phase 6's layout): chats 1, 2, 3 and chat 1 again (a G2 hit), then SIGTERM
   (drain and seal); a second process over the directory answers chat 1
   with the same text, ``dynamo_kv_prefix_hits_total{kind="persist"}``
   equal to the first process's G2 hits and ``dynamo_kv_store_pages`` >
   0 on ``/metrics``; ``DYN_KV_PACKNG=1`` exits non-zero naming the
   accepted spellings. (d) two ``TorchEngine``s sharing llama-8b's
   weights (bf16, full width, 4 of its 32 layers: ``Phase15.chaos_layers``)
   served as two instances on the in-process
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

16. the sparse-MoE families and copy-on-write of partial tails. (a)
   ``run.build_cuda_engine(--model-path <dir> --random-weights)`` on a
   directory of the ``mixtral-8x7b`` preset's config.json cut to 24 of
   its 32 layers (hidden 4096, 32/8 heads of 128, 8 experts of 14,336,
   top-2, vocab 32,000; 70.2 GB of bf16 weights, where 32 layers would
   be 93.4 GB), page size 16, 8 slots: phase 5's 8 prompts (32 tokens
   each, the 2,048-token one 128), then its first 1,000 and 1,500 ids (32
   tokens each), all queued before the loop starts; the last two wait
   for slots and are admitted while the 2,048-token row still decodes,
   attach its pages and, as a shared tail, the page their prompt ends
   in, which each copies before its first write. Every stream whole,
   ``cow_copies`` >= 2, the grouped products and both bf16 kernels
   launched, window and mixed graphs replayed; a rerun on a new engine
   over the same weights token-identical, with every dispatch and every
   copy-on-write under ``torch.cuda.set_sync_debug_mode("error")``.
   Printed: wall, TTFT p50 and max, tokens/s, ``cow_copies``, grouped
   launches, graphs by kind, ``torch.cuda.mem_get_info``. (b) 4 layers
   of Qwen3-30B-A3B's, Qwen1.5-MoE-A2.7B's and mixtral-8x7b's published
   widths (config.json written here and read back): a 512-token prompt's
   logits with the grouped products against their plain per-expert loop
   within 5 % of the logit scale; layer 0's FFN at a decode batch of 8
   and a 512-token chunk, grouped against plain within two bf16 ulps of
   the output's scale, both timed by CUDA events beside the bound of
   that routing (each touched expert's weights read once). (c)
   llama-8b's width at 4 layers, float32: (a)'s traffic with
   ``prefix_sharing`` on and off: the same tokens (float32 ties within
   ``F32_TIE``), copies on and none off, fewer prefill tokens computed
   on. (d) (b)'s mixtral at 4 layers, bf16: phase 5's prompts with
   drafts of each row's own continuation, so verify spans run the MoE
   layers: drafts accepted, verify-span graphs replayed, every dispatch
   under sync debug "error"; tokens equal to a run without speculation
   printed, not asserted (bf16 ties).

17. a self-contained GGUF. (a) Mistral-7B-Instruct-v0.2's published
   width (hidden 4,096, 32/8 heads of 128, ffn 14,336, vocab 32,000,
   rope base 1e6, no window) at 4 of its 32 layers, seeded weights
   written here as one llama-architecture GGUF: the 2-D weights in Q8_0
   (encoded here on the card: an f16 scale a block of 32 and int8
   values; q and k in llama.cpp's rope order), the norms in F32,
   ``token_embd`` in F16 and ``output`` in BF16, with an embedded
   Unigram tokenizer of 32,000 pieces (``<unk>``, ``<s>``, ``</s>``,
   the 256 ``<0xNN>`` byte pieces, README.md's characters and frequent
   substrings scored by log frequency, seeded filler) and Mistral's
   ``[INST]`` chat template; its config reads back equal to the preset
   at 4 layers. Served by ``run.main_async(in=http out=cuda
   --model-path x.gguf)`` (bf16): load seconds and GB/s (file bytes
   over load seconds) printed; every weight on the card equals, bit for
   bit, the bf16 of this script's own decoding of what it wrote; 8
   streamed chats at once end [DONE], ``length``, with
   ``usage.prompt_tokens`` the port's Unigram encoding of the rendered
   template; a rerun after the prefix cache is dropped gives the same
   text; the same prompt ids straight into the served engine give
   tokens whose streamed text is the HTTP text; both bf16 kernels ran.
   (b) The same model as a directory of config.json,
   ``tokenizer.model`` (a SentencePiece protobuf of the same pieces),
   ``tokenizer_config.json`` and bf16 safetensors of the same decoded
   weights, served the same way: the same prompt ids and the same
   tokens as (a) (bit-equal weights, so identity is asserted at bf16).

18. tensor parallelism through ``python -m dynamo_exp_tpu_torch.run
   in=batch:<token_ids lines> --tp 2``, each rank a process of its own:
   with one card both ranks share it over gloo, with two or more each
   has a card, over NCCL (printed with ``torch.cuda.device_count()``
   and each rank's device and peak memory); the three kernels run at
   per-rank head counts. (a) llama-8b at full width and 4 of its 32
   layers (a model directory of its config.json; the checks do not
   depend on depth, and the cut keeps the smoke inside its time limit),
   bf16, random weights from seed 0: phase 5's 8 prompts (the
   seeded one too), 32 tokens each, admitted together, then a rerun in
   new processes (beside (b)'s; (c)'s two runs side by side too: only
   their tokens are compared): the same tokens, both ranks' output
   digests equal,
   both bf16 kernels launched on each rank as often on both; printed:
   wall, tokens/s, rank 0's collectives (count, seconds, share of the
   wall). (b) llama-8b's width at 4 layers, float32: tp=2 against the
   tp=1 engine in this process on the same seed-0 weights: the same
   greedy tokens up to a float32 tie (``F32_TIE``) through the float32
   mixed and split-KV kernels. (c) Qwen1.5-MoE-A2.7B's published width
   at 4 layers, bf16 (16/16 heads of 128, 60 experts of 1,408, top-4, a
   shared expert of 5,632): 8 prompts of 32 tokens and a rerun,
   identical, with the grouped products and both bf16 kernels launched
   on each rank.

19. the serve graphs and the planner through the entry points a user
   calls: ``python -m dynamo_exp_tpu_torch.sdk.serve <graph>:Frontend -f
   <json> --start-coordinator`` (the supervisor and its coordinator,
   spawning the Frontend, Processor and CudaWorker processes; worker
   slots ``0,0``: two workers may share the card) and ``python -m
   dynamo_exp_tpu_torch.planner.planner`` beside it. The graph module is
   the port's, its CudaWorker instrumented by a module this script
   writes (``P19_GRAPH``: launch counts to a state file, a held-burst
   control endpoint). (a) The agg_router graph (KV routing) with llama-8b
   at full width and depth, bf16, seed-0 random weights, 1,024 pages and
   8 slots a worker: phase 5's lengths as 8 streamed chats (one seeded
   at temperature 0.8), 32 tokens each, admitted together, twice:
   [DONE] with usage, identical reruns (the seeded one too), the model
   listed, both bf16 kernels launched in the worker. (b) The planner
   (metric 0.5 s, adjustment 2 s, KV thresholds 0.7 / 0.3,
   ``max_gpu_budget`` 2, ``min_endpoint`` 1) adds a second CudaWorker
   under 16 chats of 1,500-2,000 tokens at 128 tokens; 16 more are
   served by both workers (each worker's launches rise); once idle it
   removes the newest, which drains on SIGTERM: exactly one add and one
   remove, every stream whole, no restart; printed: load -> add, add ->
   second instance visible, idle -> remove seconds, each wave's TTFT
   p50 / max and tokens/s, each worker's launches. (c) The agg graph at
   llama-8b's width, 4 layers, float32: 8 greedy completions of phase 5's
   prompt ids (32 tokens, top-2 logprobs) give a ``TorchEngine`` in this
   process on the same seed-0 weights its tokens (as the service shows
   them: each decoded alone), up to a float32 tie (``F32_TIE``), through
   the float32 mixed and split-KV kernels. A ``{"phase19": ...}`` line
   holds the numbers.

20. the deploy tier and the standalone components, through the entry
   points a user calls. (a) ``python -m dynamo_exp_tpu_torch.deploy.cli
   build`` packs the port's agg_router graph and a JSON config (llama-8b
   at full width and 4 of its 32 layers (``Phase20.layers``: the
   identity, overlap, counter and exit checks do not depend on depth),
   bf16, seed-0 random weights, 1,024 pages and
   8 slots a worker, ``CudaWorker`` ``ServiceArgs.workers`` 2) into a
   content-addressed artifact with the kernels' sources; ``render``,
   ``push`` to a ``python -m dynamo_exp_tpu_torch.deploy.api_store``
   process and ``deploy``; a ``DeploymentOperator`` on a
   ``MemoryBackend`` applies exactly the rendered documents, and its
   second pass nothing. This script then plays the kubelet: the artifact
   unpacked into a fresh directory with phase 2's kernel library and its
   stamp copied in (no second nvcc), the rendered coordinator started,
   the ConfigMap's ``config.json`` written where its mount would be, and
   each Deployment's container command run once a replica with the
   rendered env and the unpacked tree alone on ``PYTHONPATH`` (a
   Service name resolves to 127.0.0.1; the ``nvidia.com/gpu`` pod gets
   card 0 and one slot of it a worker, so both CudaWorkers share it).
   Phase 5's lengths as 8 streamed chats (one seeded) of 32 tokens
   through the rendered HTTP Service's port: a burst, then twice one at
   a time (an artifact's graph has no hook that holds a worker's
   admission, and bf16 tokens are identical only at equal batch shapes
   and cache states): [DONE] and usage on every stream, the two runs
   identical and routed alike, both bf16 kernels launched in the
   workers (their stats scrape's ``kernel_launches``). (b) Started with
   the fleet: ``python -m dynamo_exp_tpu_torch.components.router
   --workers CudaWorker --block-size 16`` names, for each of (a)'s
   prompts, the worker the Processor routed it to, with
   ``overlap_blocks`` its full 16-token pages, and 0 for a prompt never
   served; ``python -m dynamo_exp_tpu_torch.components.metrics
   --component dynamo.CudaWorker`` shows the 7 ``llm_kv_*`` gauges for
   both workers (``llm_kv_kv_total_blocks`` 1,024 each), and a third
   burst raises ``llm_kv_hit_events_total`` by its routing decisions.
   Every process exits 0 on SIGTERM; with the record deleted the
   operator's next pass collects every document. A ``{"phase20": ...}``
   line holds the numbers.
21. the cluster simulator and the autotuner against the card. (a)
   llama-8b at full width and depth, bf16, seed-0 random weights: the
   simulator's calibration bridge (the JAX package's pressure harness:
   4 slots, 8 pages of 8 tokens, a 0.05 s stall grace, eager dispatches,
   the real ``AdmissionController`` at 6 in flight with the watermark at
   3): ``overload_burst`` seeds 0-2 (8 requests of 6-12 tokens) through
   the engine and through ``ClusterSim`` with the same config, completed
   and shed counts equal, preemptions within 2, no errors; then phase
   5's prompts at 32 tokens through a graphed engine (a capturing
   burst, then the burst again traced to a span file) and ``llmctl sim
   --trace-in <the burst> --fit-spans <the spans>``: the fitted prefill
   seconds per token and ITL, the sim's TTFT and ITL p50 beside the
   live burst's (printed, not gated). (b) ``llmctl tune --workload burst
   --seed 0 --requests 32 --budget 32 --eval-seeds 1 --top-k 3
   --validate-passes 3 --preset llama-8b --kv-dtype bfloat16
   --max-model-len 2096 --check --json`` in a subprocess (the search's
   three best differ in decode slots and admission, which the card
   shows; at the default 64 requests they differ by two admitted
   requests, which it does not, so the live ranking is noise): rc 0,
   one journal line a trial, each of the three
   candidates served live on a 32-layer llama-8b ``TorchEngine``
   through both bf16 kernels, the artifact loads; Kendall tau, top-1 and
   each candidate's live goodput printed; then, in this process, the
   contrasting pair ``[{}, {"max_inflight": 1}]`` at 2 layers ranks the
   default first in the sim and on the card (tau 1.0). (c) a boot from
   (b)'s artifact (``engine_config_from_artifact``, llama-8b at 2
   layers (``Phase21.small_layers``); its knobs hash to the artifact's ``config_hash``):
   ``prewarm_engine`` with the artifact's graph manifest against a cache
   directory holding phase 2's build builds nothing; phase 5's prompts at
   32 tokens, twice: no capture under traffic (no new
   ``dynamo_compile_seconds`` sample), the same tokens; ``llmctl aot
   list --preset llama-8b`` exits 0 with the lattice's hash; the engine
   at 2 layers boots at each ``ragged_q_tile`` of the tuning grid (1, 4,
   8, 16) and serves phase 5's prompts greedily at 8 tokens through the
   bf16 mixed kernel at that q tile. A ``{"phase21": ...}`` line holds
   the numbers.

22. the last modules. (a) phase 5's burst on a fresh llama-8b engine
   (full depth, bf16) under ``torch.cuda.set_sync_debug_mode("warn")``:
   every sync warning of every thread (``warnings.showwarning``; the
   engine loop has a thread of its own) recorded by the innermost frame
   of the port on its stack, each site in a hot-path zone of dynlint
   (``analysis/zones.py``) held to be a waived host-sync line of the
   lint; a control ``.item()`` on another thread must be recorded;
   printed: the sites and their counts. (b) LLaVA-1.5's vision tower
   (CLIP ViT-L/14-336: ``models.vision.CLIP_VIT_L_336``, 576 patches,
   feature layer -2, random bf16 from seed 0, a projector into 4096)
   through ``EncodeWorker``'s ``VisionEncoder``, then its 576 soft tokens
   and an 8-token prompt as one mixed dispatch of llama-8b's width at 4
   layers (``multimodal_demo.soft_token_prefill``: one ragged-kernel
   launch a layer, counted); layer 0's attention against the plain
   version (``close`` and ``close_to_f32``), the logits against the plain
   path's within 5 % of their scale (as phase 4), ``token_embeds =
   embed[ids]`` bit-equal to the id path through the kernel, then 8
   greedy tokens through the decode kernel, equal on a rerun; printed:
   the tower's ms an image and the prefill's ms (CUDA events). (c)
   ``forward_ring_prefill`` over sp = 2 spawned rank processes sharing
   the card over gloo (``parallel.rank_layout(sp=2)``,
   ``parallel.sp_tp_comms``), llama-8b's width at 2 layers, float32,
   T = 4,096, against one ``forward_ragged`` dispatch of the whole
   prompt on each rank through the float32 mixed kernel: logits within
   atol 2e-3 + rtol 1e-3, layer 0's K/V within atol 1e-5, deeper
   layers' within 1e-5 beyond the gap between the kernel's and the
   plain path's own single-rank prefills (float32 rounding of the
   attention before them, magnified by the RMS norm); printed: the
   ring's wall and its rotation's share. A ``{"phase22": ...}`` line
   holds the numbers.

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
(``launches_chaos``: (d)), and phase 16's mixtral engine
(``launches_moe``: (a)) and float32 sharing engines
(``launches_sharing_f32``: (c)), and phase 17's GGUF and directory
servers (``launches_gguf``, ``launches_gguf_dir``: their HTTP chats),
and phase 18's rank 0 (``launches_tp2``: (a), ``launches_tp2_f32``: (b),
``launches_tp2_moe``: (c); every rank's are equal), and phase 19's
graph workers (``launches_graph``: (a) and (b), both workers summed;
``launches_graph_f32``: (c)), and phase 20's rendered fleet
(``launches_deploy``: (a); ``launches_components``: (b)'s third burst;
both workers summed), and phase 21's engines (``launches_sim_calibration``:
(a); ``launches_tune_validation``: (b)'s three validation engines in the
tune process and the contrasting pair; ``launches_artifact_boot``: (c)),
and phase 22's (``launches_sync_warn``: (a); ``launches_multimodal``: (b),
the soft-token prefills and decode steps; ``launches_ring_reference``:
(c), both ranks' single-rank float32 dispatches);
both mixed entries also carry phase 3's other q tiles
(``q_tile{1,4,16}_*_max_abs_err`` and ``q_tile16``'s timing);
both mixed entries also carry the
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
import shutil
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
# Phase 6 (e): the request template's defaults, filled into a body
# that names no model and no max_tokens.
TEMPLATE = {"model": "llama-8b", "max_completion_tokens": 4}
PRESSURE_TOKENS = 128
PRESSURE_PAGES = 416
HOST_PAGES = 1024
F32_LAYERS = 4  # phase 7 (c): llama-8b's width, 4 layers, float32


def reset_launches() -> None:
    """Zero every launch counter of the port (ops/launches.py)."""
    from dynamo_exp_tpu_torch.ops import launches

    launches.reset()


def log(msg: str) -> None:
    print(msg, flush=True)


def copy_kernel_build(dst_dir: str, prefix: str = "") -> list[str]:
    """Copy phase 2's libraries (names starting with ``prefix``) with
    their stamps from this checkout's ``_build/`` into ``dst_dir``: a
    library whose stamp equals the sources' hashes is reused where it
    lies (``ops/ragged_attention.build_kernel``), so nothing is built
    again there. Returns the names copied (none on a host without a
    build)."""
    src = os.path.join(HERE, "dynamo_exp_tpu_torch", "_build")
    names = sorted(n for n in os.listdir(src) if n.startswith(prefix)
                   and n.endswith((".so", ".sources.json"))) if os.path.isdir(src) else []
    os.makedirs(dst_dir, exist_ok=True)
    for name in names:
        shutil.copy2(os.path.join(src, name), os.path.join(dst_dir, name))
    return names


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
_POOLS: dict = {}  # flat_batch's last pools


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
    # The pools and the page order do not depend on q_tile: the last
    # ones drawn are kept, with the generator's state after them, so a
    # case at another q tile draws the same q without drawing them again.
    key = (seed, tuple(spans), tuple(shape))
    if key in _POOLS:
        k, v, perm, state = _POOLS[key]
        rs.set_state(state)
    else:
        k = torch.from_numpy(rs.standard_normal((pages, PS, n_kv * hd)).astype(np.float32))
        v = torch.from_numpy(rs.standard_normal((pages, PS, n_kv * hd)).astype(np.float32))
        perm = rs.permutation(pages)
        _POOLS.clear()
        _POOLS[key] = (k, v, perm, rs.get_state())
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
               shape=(H, HKV, D), attn=None, q_tile=8) -> tuple:
    """The mixed shape at ``q_tile`` (the main path's 8 unless asked),
    one empty tile at the end (and scratch-row tiles up to ``pad_to``),
    against the plain version with ``dt`` pools, at attention shape
    ``shape`` with ``attn`` (window, softcap, sm_scale) passed to both.
    Returns (max abs err, the float32 reading, the inputs, the call, the
    plain call, the (row_of, positions) the plain call reads)."""
    dev = torch.device("cuda", 0)
    q, k, v, table, row_of, pos = flat_batch(torch, np, 0, spans, q_tile, dt, dev, pad_to,
                                             shape)
    kw = dict(attn or {}, num_kv_heads=shape[1])

    def call():
        return tra.ragged_paged_attention(q, k, v, table, row_of, pos, q_tile=q_tile, **kw)

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


# Phase 3's other q tiles: the tuning grid's ragged_q_tile values beside
# the main path's 8 (tune/space.py), each through both mixed designs.
Q_TILES = (1, 4, 16)


def check_q_tiles(torch, np, tra, flush) -> dict:
    """The mixed kernels at every other q tile of the tuning grid (1, 4,
    16), with float32 and bf16 pools: at llama-8b's heads on
    ``MIXED_SPANS`` (q_tile 16: 64 query rows a tile, a block's run of
    two tiles) and at gemma2-9b's D=256 sliding layers with their
    softcap and window on ``WINDOW_MIXED_SPANS``, held to the plain
    version as ``check_kernels`` holds them (float32 at atol 1e-4; bf16
    at atol 2e-2 + rtol 2^-7 and within bf16 rounding of float32
    copies), empty and padding tiles exact zeros. q_tile 16 at llama-8b's
    heads is also timed (CUDA events after an L2 flush) beside the plain
    version, its bound and one SDPA call. Returns {case: numbers}."""
    F = torch.nn.functional
    gemma = "gemma2_d256_softcap_window"
    cases = {"llama8b": ((H, HKV, D), {}, MIXED_SPANS),
             gemma: (WINDOW_CASES[gemma][0], WINDOW_CASES[gemma][1], WINDOW_MIXED_SPANS)}
    out = {}
    for case, (shape, attn, spans) in cases.items():
        for qt in Q_TILES:
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt).removeprefix("torch.")
                err, tight, inputs, call, plain, (rows, pos) = mixed_case(
                    torch, np, tra, dt, spans, f"{case} q_tile={qt}", shape=shape,
                    attn=attn, q_tile=qt)
                res = out[f"q_tile{qt}_{case}_{dname}"] = dict(max_abs_err=err)
                line = (f"[kernel] q_tile={qt} {case} {dname} H/Hkv/D {shape} {attn}: "
                        f"N={inputs[0].shape[0]}, max abs err {err:.3e}"
                        + (f" (against float32 plain {tight[0]:.3e}, {tight[1]:.3f} of its "
                           f"limit)" if tight else ""))
                if qt == 16 and case == "llama8b":
                    q, k, v, table = inputs
                    peak = BF16_FLOP_PER_S if dt == torch.bfloat16 else F32_3XTF32_FLOP_PER_S
                    qd, kd, vd, mask = sdpa_inputs(torch, q, k, v, table, rows, pos)
                    res.update(
                        ms=timed(torch, call, 20, flush), plain_ms=timed(torch, plain, 3, flush),
                        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                            qd, kd, vd, attn_mask=mask, enable_gqa=True), 20, flush))
                    res["bound_ms"], res["bound_by"] = bound(torch, q, k, table, rows, pos,
                                                             peak)[:2]
                    del qd, kd, vd, mask
                    line += (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                             f"sdpa {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
                             f"by {res['bound_by']}")
                log(line)
                del inputs, call, plain
        torch.cuda.empty_cache()
    return out


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
    reset_launches()
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


def hf_config(mcfg) -> dict:
    """A llama-layout ``config.json`` (llama, mistral, qwen2/3 and the
    MoE families) that reads back equal to ``mcfg``."""
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
        # The preset's MoE routing default (unused by a dense model), so
        # that the file reads back equal to the preset.
        "norm_topk_prob": mcfg.norm_topk_prob,
    }
    if mcfg.head_dim:
        cfg["head_dim"] = mcfg.head_dim
    if mcfg.sliding_window:
        cfg["sliding_window"] = mcfg.sliding_window
    if mcfg.is_moe:
        experts = "num_local_experts" if mcfg.model_type == "mixtral" else "num_experts"
        cfg.update({experts: mcfg.num_experts, "num_experts_per_tok": mcfg.num_experts_per_tok,
                    "moe_intermediate_size": mcfg.moe_intermediate_size,
                    "shared_expert_intermediate_size": mcfg.shared_expert_intermediate_size})
    return cfg


def write_model_dir(path: str, tokmod, mcfg, text: str) -> str:
    """config.json of ``mcfg`` (read back equal to it), the tokenizer
    of ``tokenizer_spec``, a Llama-3-style chat template and EOS
    ``<|eot_id|>`` in generation_config.json. No weights: the server
    runs with --random-weights."""
    os.makedirs(path, exist_ok=True)
    bos = mcfg.vocab_size - N_SPECIAL
    files = {
        "config.json": {**hf_config(mcfg), "bos_token_id": bos},
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
            "--request-template", os.path.join(tmp, "template.json"),
        ]
        with open(argv[-1], "w", encoding="utf-8") as f:
            json.dump(TEMPLATE, f)
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
    reset_launches()
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
    # Four characters from past its first third, else three, else two
    # (random weights' text may split a character every few).
    stop = next(
        (c_text[i : i + n] for n in (4, 3, 2) for i in range(len(c_text) // 3, len(c_text) - n)
         if c_text[i : i + n].strip() and "�" not in c_text[i : i + n]),
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
    # (e) a body with no model and no max_tokens: the request template
    # (--request-template) fills both.
    e_models, e_usage, e_finish = set(), None, None
    async for f in client.sse_frames(chat, {"messages": CHATS[0], "stream": True,
                                            "stream_options": {"include_usage": True},
                                            "nvext": {"ignore_eos": True}}):
        if f.data == "[DONE]":
            break
        e_models.add(f.data["model"])
        e_usage = f.data.get("usage") or e_usage
        e_finish = next((c["finish_reason"] for c in f.data["choices"]
                         if c.get("finish_reason")), e_finish)
    assert e_models == {TEMPLATE["model"]}, e_models
    assert e_finish == "length", e_finish
    assert e_usage["completion_tokens"] == TEMPLATE["max_completion_tokens"], e_usage
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
        stop=stop, b_finish=[r["finish"] for r in b_out], template=e_usage,
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
    reset_launches()
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
    reset_launches()
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
        reset_launches()
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
    reset_launches()
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
    reset_launches()
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
        reset_launches()
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
    preset: str = "llama-8b"  # (b)'s warm boot: the preset's width ...
    warm_layers: int = 2  # ... at this depth (a model directory of its config.json)
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
        reset_launches()
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
    """(b) ``run.build_cuda_engine(--model-path <dir> --random-weights
    --spec ngram --prewarm --compile-cache-dir)``, the directory's
    config.json the preset's width at ``sh.warm_layers`` layers,
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
    import tempfile

    model_dir = tempfile.mkdtemp(prefix="warm-model-")
    wcfg = replace(pkg.models.PRESETS[sh.preset], num_layers=sh.warm_layers)
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf_config(wcfg), f)
    argv = [
        "out=cuda", "--device", sh.device, "--model-path", model_dir, "--random-weights",
        "--max-decode-slots", "8",
        "--page-size", str(PS), "--max-model-len", str(max_len),
        "--num-pages", str(8 * -(-max_len // PS)), "--kv-dtype", "bfloat16",
        "--spec", "ngram", "--prewarm", "--compile-cache-dir", cache_dir,
    ]
    t0 = time.perf_counter()
    try:
        warm, _ = run.build_cuda_engine(run.parse_args(argv))
    finally:
        shutil.rmtree(model_dir)
    boot_s = time.perf_counter() - t0
    report = warm.metrics()["prewarm"]
    graphs_on = warm.graphs is not None
    manifest = build_manifest(warm.cfg, warm.attn_impl)
    assert report["variants"] == len(manifest.windows) > 0, report
    assert report["mixed_variants"] == len(manifest.mixed) > 0, report
    assert any(k.with_spec for k in manifest.mixed)
    assert report["graphs"] == (report["variants"] if graphs_on else 0), report
    assert report["mixed_graphs"] == (report["mixed_variants"] if graphs_on else 0), report
    assert report["builds"] == 0, report  # the library copied in with its stamp
    assert warm.cfg.model == wcfg, warm.cfg.model
    log(f"[warm] (b) {smi}: {sh.preset} at {sh.warm_layers} layers booted with --spec ngram "
        f"--prewarm in {boot_s:.2f} s: "
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
            reset_launches()
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

    from dynamo_exp_tpu_torch.aot.compile import LIB_NAME

    a = loader_path(torch, np, pkg, tra, smi, sh, mcfg)
    with tempfile.TemporaryDirectory() as cache_dir:
        # Phase 2's library and its stamp: (b) reuses it, no second nvcc.
        copy_kernel_build(cache_dir, LIB_NAME)
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
    reset_launches()
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
        reset_launches()
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
    # llama-8b at full width and 4 of its 32 layers: routing, failover and
    # worker identity are counted in pages, tokens and requests, and (c)'s
    # reference is a direct engine of the same depth.
    layers: int = 4
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


def _p11_lone(torch, pkg, mcfg, sh: Phase11, ids: list[int], max_tokens: int) -> list[int]:
    """A greedy request's tokens from a direct ``TorchEngine`` (the
    workers' engine shape) on the seed-0 weights of ``mcfg``."""
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine

    eng = TorchEngine(EngineConfig(model=mcfg, max_decode_slots=sh.slots, page_size=PS,
                                   num_pages=sh.num_pages, max_model_len=sh.max_model_len),
                      model=seeded_model(torch, pkg, mcfg, sh.device), device=sh.device)

    async def go():
        stream = eng.submit({"token_ids": ids, "stop_conditions": {
            "max_tokens": max_tokens, "ignore_eos": True}})
        eng.start()
        return [t async for item in stream for t in item.get("token_ids") or []]

    try:
        return asyncio.run(asyncio.wait_for(go(), 300))
    finally:
        eng.stop()
        del eng
        free(torch, sh.device)


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
    ``TorchEngine`` on the same seeded weights (phase 6's, at full
    depth; without ``mcfg`` the workers run llama-8b at ``sh.layers``
    layers, and the lone request's tokens are taken again from a direct
    engine of that depth)."""
    import multiprocessing
    import socket
    import tempfile
    from dataclasses import replace

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    t_phase = time.perf_counter()
    if mcfg is None:
        mcfg = replace(pkg.models.LLAMA_8B, num_layers=sh.layers)
        lone = (lone[0], _p11_lone(torch, pkg, mcfg, sh, lone[0], len(lone[1])))
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
            f"across the workers and to a direct engine on the same weights ({mcfg.num_layers} "
            f"layers)")

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
    # (a)-(c): llama-8b at full width and 4 of its 32 layers (what they
    # check is counted in pages, requests and tokens, and compared with
    # a direct engine at the same depth); (d) at full depth, whose
    # streams must outlast the reclaim's triage at full depth's pace.
    disagg_layers: int = 4
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
    # every stream on the victim), and 512 too (a triage of 8.5 s, its
    # transfers at a third of their usual rate, outlasted the streams at
    # ~18 ms a token).
    reclaim_tokens: int = 768
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
    decode worker process behind the HTTP ingress in this process, at
    ``sh.disagg_layers`` layers), suffix-only transfers, a handoff lease
    never confirmed, then spot reclaim with live KV migration between
    two aggregated workers at full depth."""
    import multiprocessing
    import socket
    import tempfile

    from dataclasses import replace

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    full = mcfg or pkg.models.LLAMA_8B  # (d)'s
    mcfg = mcfg or replace(full, num_layers=sh.disagg_layers)  # (a)-(c)'s
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
        full_dir = model_dir
        if full is not mcfg:
            full_dir = os.path.join(tmp, "llama-8b-full")
            shutil.copytree(model_dir, full_dir)
            with open(os.path.join(full_dir, "config.json"), "w", encoding="utf-8") as f:
                json.dump({**hf_config(full), "bos_token_id": full.vocab_size - N_SPECIAL}, f)
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

            def worker_argv(path: str) -> list[str]:
                return ["out=cuda", "--device", sh.device, "--model-path", path,
                        "--model-name", "llama-8b", "--random-weights", "--coordinator", addr,
                        "--num-pages", str(sh.num_pages), "--max-decode-slots", str(sh.slots),
                        "--page-size", str(PS), "--max-model-len", str(sh.max_model_len),
                        "--kv-dtype", "bfloat16"]

            common = worker_argv(model_dir)
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
            argv = [f"in={P12_AGG}", *worker_argv(full_dir)]
            for i in range(2):
                proc = ctx.Process(target=_p11_worker, name=f"agg{i}",
                                   args=(argv, agg_paths[i], sh.state_period_s, time.time()))
                proc.start()
                agg.append(proc)
            procs.extend(agg)
            out["d"] = asyncio.run(asyncio.wait_for(
                _p12_drive_reclaim(np, run, client, smi, sh, full, addr, agg, agg_paths,
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
    # llama-8b at full width and 4 of its 32 layers: the anatomy, the
    # fingerprint, the traces and llmctl do not depend on depth, and the
    # pressure is counted in pages.
    layers: int = 4
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
    # ... and records this long, the burst (0.74 s at 8 layers) inside it.
    profile_ms: int = 8000


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
    the profiler and llmctl, on llama-8b (full width, ``sh.layers``
    layers) served over HTTP under KV pressure."""
    import socket
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client
    from dataclasses import replace

    from dynamo_exp_tpu_torch.telemetry import FingerprintBuilder, get_telemetry

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=sh.layers)
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
            reset_launches()
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
        reset_launches()
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
        reset_launches()
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
        reset_launches()
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
    # (c): llama-8b at full width and 4 of its 32 layers in the server
    # processes: the store's checks count pages and compare texts, none
    # depends on depth.
    process_layers: int = 4
    chat_tokens: int = 16
    # (d): llama-8b at full width and 4 of its 32 layers: its checks
    # count faults, recoveries and tokens, none depends on depth.
    chaos_layers: int = 4
    chaos_tokens: int = MAX_TOKENS
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
    from dynamo_exp_tpu_torch.telemetry import unregister_dumper

    engine._running = False
    engine._wake.set()
    if engine._watchdog is not None:
        engine._watchdog.stop()
        engine._watchdog = None
    if engine._flight_handle is not None:
        # The process's dump registry goes with it: a later dump_all in
        # this process must not find the dead engine.
        unregister_dumper(engine._flight_handle)
        engine._flight_handle = None
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
    (``run in=http out=cuda``, llama-8b at full width and
    ``sh.process_layers`` layers, random
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

    from dataclasses import replace

    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.http import client

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=sh.process_layers)
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
    (bf16, ``sh.chaos_layers`` layers) behind the chaos planes and ``PushRouter`` with
    the journal: a crash at stream start, a crash at token 16, a
    partition healed after one wave and a discovery watch flap, over 8
    greedy requests and a seeded one, twice with the same seed; then at
    float32 (4 layers) a stream cut at token 16 against the
    uninterrupted one."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.telemetry import get_telemetry

    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=sh.chaos_layers)
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
    reset_launches()
    a = g3_restart(torch, np, pkg, tra, smi, sh, mcfg)
    b = g3_containment_f32(torch, np, pkg, tra, smi, sh, f32_cfg)
    sync(torch, sh.device)
    designs_g3 = dict(tra.KERNEL_LAUNCHES)
    c = g3_processes(torch, np, pkg, smi, sh, mcfg)
    sync(torch, sh.device)
    reset_launches()
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


# ------------------------------------------------------------ phase 16
MOE_LAYERS = 24  # (a): mixtral-8x7b's 32 layers are 93.4 GB in bf16; 24 are 70.2 GB
# (b): published shapes at 4 layers: Qwen3-30B-A3B and Qwen1.5-MoE-A2.7B's
# config.json (the HF hub's), and mixtral-8x7b's.
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 6144, "num_hidden_layers": 48, "num_attention_heads": 32,
    "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
    "moe_intermediate_size": 768, "norm_topk_prob": True, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 40960, "tie_word_embeddings": False,
    "attention_bias": False, "torch_dtype": "bfloat16",
}
QWEN15_MOE_A27B = {
    "model_type": "qwen2_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 24, "num_attention_heads": 16,
    "num_key_value_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "norm_topk_prob": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 8192, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}


@dataclass
class Phase16:
    """Phase 16's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, tiny MoE configs)."""

    device: str = "cuda"
    layers: int = MOE_LAYERS  # (a)'s depth
    prompt_lens: tuple = PROMPT_LENS  # (a), (c): phase 5's prompts ...
    max_tokens: int = MAX_TOKENS  # ... at 32 tokens ...
    long_tokens: int = 128  # ... but the longest, still decoding when ...
    share_lens: tuple = (1000, 1500)  # ... its first 1,000 and 1,500 ids arrive
    check_layers: int = 4  # (b)'s depth
    check_len: int = 512  # (b)'s prompt
    decode_rows: int = 8  # (b): the FFN timed at a decode batch ...
    chunk: int = 512  # ... and at a prefill chunk
    reps: int = 20
    f32_layers: int = 4  # (c)'s depth


def p16_requests(np, vocab: int, sh: Phase16, **so) -> list[dict]:
    """Phase 5's prompts (the longest decoding ``long_tokens``), then
    prompts ending inside pages of the longest one's: with 8 slots the
    last two wait until the short rows finish, and are admitted while
    the longest still decodes. Admitted in that order every run."""
    prompts = phase5_prompts(np, vocab, sh.prompt_lens)
    long = prompts[-1]
    toks = [sh.max_tokens] * (len(prompts) - 1) + [sh.long_tokens]
    toks += [sh.max_tokens] * len(sh.share_lens)
    prompts += [long[:n] for n in sh.share_lens]
    return [{"token_ids": p, "stop_conditions": {"max_tokens": n, "ignore_eos": True},
             "sampling_options": dict(so)} for p, n in zip(prompts, toks)]


def p16_run(torch, eng, requests, device: str) -> dict:
    """``requests`` queued before the loop starts; each stream's tokens,
    time to first token and time to finish."""
    async def collect(stream, t0):
        r = dict(tokens=[], finish=None, ttft=None, done=None)
        async for item in stream:
            if item.get("token_ids") and r["ttft"] is None:
                r["ttft"] = time.perf_counter() - t0
            r["tokens"] += item.get("token_ids", [])
            r["finish"] = item.get("finish_reason", r["finish"])
        r["done"] = time.perf_counter() - t0
        return r

    async def go():
        streams = [eng.submit(r) for r in requests]
        t0 = time.perf_counter()
        eng.start()
        out = await asyncio.wait_for(asyncio.gather(*(collect(s, t0) for s in streams)), 600)
        sync(torch, device)
        return out, time.perf_counter() - t0

    try:
        out, wall = asyncio.run(go())
    finally:
        eng.stop()
    return dict(out=out, wall_s=wall, metrics=eng.metrics())


def guard_dispatch(torch, eng, device: str, names) -> dict:
    """Wrap the engine instance's ``names`` so that on the card each call
    runs under ``torch.cuda.set_sync_debug_mode("error")``: a host sync
    in one raises. Returns the tally of guarded calls."""
    guard = {"guarded": 0, "errors": []}

    def wrap(fn):
        def call(*a, **kw):
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            except Exception as e:
                guard["errors"].append(repr(e))
                raise
            finally:
                if device == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            guard["guarded"] += 1
            return out
        return call

    for name in names:
        setattr(eng, name, wrap(getattr(eng, name)))
    return guard


def p16_mixtral(torch, np, pkg, tra, smi: str, sh: Phase16, mcfg) -> dict:
    """(a) ``run.build_cuda_engine(--model-path <dir> --random-weights)``
    on a model directory of ``mcfg``'s config.json (bf16, page size 16):
    :func:`p16_requests` twice, on two engines over the same weights,
    the second with every dispatch and copy-on-write under sync debug
    "error"."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch.ops import moe as tmoe

    requests = p16_requests(np, mcfg.vocab_size, sh)
    lens = [len(r["token_ids"]) for r in requests]
    max_len = max(lens) + sh.long_tokens + PS
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w", encoding="utf-8") as f:
            json.dump(hf_config(mcfg), f)
        argv = ["out=cuda", "--device", sh.device, "--model-path", tmp, "--random-weights",
                "--max-decode-slots", "8", "--page-size", str(PS), "--max-model-len",
                str(max_len), "--num-pages", str(pages_needed(lens, sh.long_tokens) + 64),
                "--kv-dtype", "bfloat16"]
        t0 = time.perf_counter()
        eng, _ = run.build_cuda_engine(run.parse_args(argv))
        sync(torch, sh.device)
        init_s = time.perf_counter() - t0
    assert eng.cfg.model == mcfg, eng.cfg.model
    model = eng.model
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mem = ""
    if sh.device == "cuda":
        free_b, total_b = torch.cuda.mem_get_info()
        mem = (f"; torch.cuda.mem_get_info after the engine: {free_b / 1e9:.2f} GB free of "
               f"{total_b / 1e9:.2f} GB")
    log(f"[moe] (a) {smi}: {mcfg.model_type} at {mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, H {mcfg.num_heads}/Hkv {mcfg.num_kv_heads} x {mcfg.head_dim_}, "
        f"{mcfg.num_experts} experts of {mcfg.expert_intermediate_size}, top-"
        f"{mcfg.num_experts_per_tok}, vocab {mcfg.vocab_size}: {n_params / 1e9:.3f} B params, "
        f"{weight_bytes / 1e9:.2f} GB bf16 from seed 0, engine built in {init_s:.1f} s{mem}")
    ecfg, runs = eng.cfg, []
    for i in range(2):
        if i:
            eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
        guard = (guard_dispatch(torch, eng, sh.device,
                                ("_build_mixed", "_launch_window", "_resolve_shared_tail"))
                 if i else None)
        sync(torch, sh.device)
        reset_launches()
        r = p16_run(torch, eng, requests, sh.device)
        r.update(designs=dict(tra.KERNEL_LAUNCHES), grouped=tmoe.LAUNCHES["grouped_mm"],
                 guard=guard, pool=eng.graphs.pool_bytes() if eng.graphs is not None else 0)
        runs.append(r)
        del eng
        free(torch, sh.device)
    first, rerun = runs
    out, m = first["out"], first["metrics"]
    for i, (r, req) in enumerate(zip(out, requests)):
        want = req["stop_conditions"]["max_tokens"]
        assert r["finish"] == "length" and len(r["tokens"]) == want, (i, r["finish"],
                                                                       len(r["tokens"]))
        assert all(0 <= t < mcfg.vocab_size for t in r["tokens"])
    assert [r["tokens"] for r in rerun["out"]] == [r["tokens"] for r in out], "rerun tokens"
    n_share = len(sh.share_lens)
    long_row, sharers = out[-n_share - 1], out[-n_share:]
    assert all(s["ttft"] < long_row["done"] for s in sharers), "the sharers came too late"
    for r in runs:
        mr = r["metrics"]
        assert mr["kv_cow_copies"] >= n_share, mr["kv_cow_copies"]
        assert mr["kv_prefix_hits"]["shared"] >= sum(n // PS + 1 for n in sh.share_lens), (
            mr["kv_prefix_hits"])
        if sh.device == "cuda":
            assert r["grouped"] > 0 and r["designs"]["mixed_tc_bf16"] > 0, r
            assert r["designs"]["decode_split"] > 0, r["designs"]
            g = mr["graphs"]
            assert g["window"]["replays"] > 0 and g["mixed"]["replays"] > 0, g
    guard = rerun["guard"]
    assert not guard["errors"] and guard["guarded"] > 0, guard
    ttfts = sorted(r["ttft"] for r in out)
    total = sum(len(r["tokens"]) for r in out)
    log(f"[moe] (a) {smi}: phase 5's 8 prompts ({sh.max_tokens} tokens; the "
        f"{max(sh.prompt_lens)}-token one {sh.long_tokens}) then its first "
        f"{list(sh.share_lens)} ids, admitted while it "
        f"decoded: wall {first['wall_s']:.3f} s (rerun {rerun['wall_s']:.3f} s), {total} "
        f"tokens, {total / first['wall_s']:.2f} tokens/s, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.3f} s max {ttfts[-1]:.3f} s; sharers' TTFT "
        f"{[round(s['ttft'], 3) for s in sharers]} s before the long row's end at "
        f"{long_row['done']:.3f} s; cow_copies {m['kv_cow_copies']}, prefix hits "
        f"{m['kv_prefix_hits']}, prefill tokens computed {m['prefill_tokens_computed']}; "
        f"grouped products launched {first['grouped']} (rerun {rerun['grouped']}); graphs "
        f"{graph_line(m)}, pool {first['pool'] / 2**20:.1f} MiB; launches by kernel "
        f"{first['designs']}; dispatches {m['dispatches']}; all 'length', the rerun "
        f"token-identical with {guard['guarded']} dispatches and copies under "
        f"torch.cuda.set_sync_debug_mode('error')")
    del model
    free(torch, sh.device)
    return dict(wall_s=first["wall_s"], rerun_wall_s=rerun["wall_s"], completion_tokens=total,
                tokens_per_s=total / first["wall_s"], ttft_p50_s=ttfts[len(ttfts) // 2],
                ttft_max_s=ttfts[-1], cow_copies=m["kv_cow_copies"],
                grouped=first["grouped"], designs=first["designs"],
                tokens=[r["tokens"] for r in out], guarded=guard["guarded"])


@contextlib.contextmanager
def plain_grouped(tmoe):
    """Within the block, the MoE FFN's grouped products run through
    their plain version (the per-expert loop) on any device."""
    grouped = tmoe.grouped_linear
    tmoe.grouped_linear = lambda xs, w, counts, ends: tmoe.grouped_linear_ref(xs, w, counts)
    try:
        yield
    finally:
        tmoe.grouped_linear = grouped


def moe_bound_ms(mcfg, ids, n_tokens: int, itemsize: int = 2) -> tuple[float, str]:
    """The least time of one MoE FFN on this routing: each touched
    expert's three matrices read once, the tokens read and the output
    written once, against 2 x 3 x (tokens x k) x D x I products at the
    bf16 peak."""
    D, Ie, K = mcfg.hidden_size, mcfg.expert_intermediate_size, mcfg.num_experts_per_tok
    touched = len(set(ids.reshape(-1).tolist()))
    nbytes = (touched * 3 * D * Ie + 2 * n_tokens * D) * itemsize
    flops = 2 * 3 * n_tokens * K * D * Ie
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def p16_check(torch, np, pkg, smi: str, sh: Phase16, mcfg) -> dict:
    """(b) ``mcfg`` (a config.json written here, read back): one
    ``sh.check_len``-token prompt through ``forward_ragged`` with the
    grouped products on the card and with their plain version, logits
    within 5 % of their scale (phase 14 (b)'s bound: bf16 activations
    through the layers); then layer 0's FFN on ``sh.decode_rows`` and
    ``sh.chunk`` tokens, grouped against plain (outputs, and device ms
    by CUDA events) beside the bound of that routing."""
    import tempfile

    from dynamo_exp_tpu_torch.ops import moe as tmoe

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w", encoding="utf-8") as f:
            json.dump(mcfg, f)
        cfg = pkg.models.ModelConfig.from_pretrained(tmp)
    from dataclasses import replace

    cfg = replace(cfg, num_layers=sh.check_layers)
    llama = pkg.models.llama
    dev = torch.device(sh.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = pkg.models.init_params(cfg, gen, dev)
    n = sh.check_len
    rs = np.random.RandomState(16)
    toks = torch.tensor(rs.randint(3, cfg.vocab_size, size=n), device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    table = torch.arange(-(-n // PS), dtype=torch.int32, device=dev)[None]
    out_idx = torch.arange(63, n, 64, device=dev)
    logits = {}
    for impl in ("grouped", "plain"):
        kc, vc = llama.init_kv_cache(cfg, table.shape[1], PS, torch.bfloat16, device=dev)
        reset_launches()
        with plain_grouped(tmoe) if impl == "plain" else contextlib.nullcontext():
            lg, _, _ = llama.forward_ragged(model, cfg, toks, pos, rows, table, kc, vc, out_idx,
                                            q_tile=8)
        sync(torch, sh.device)
        launches = tmoe.LAUNCHES["grouped_mm"] if impl == "grouped" else launches
        logits[impl] = lg
        del kc, vc
    a, b = logits["grouped"], logits["plain"]
    assert torch.isfinite(a).all()
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    assert err <= 0.05 * scale, f"{cfg.model_type} logits differ: {err} > 5% of {scale}"
    if sh.device == "cuda":
        assert launches == 3 * cfg.num_layers, launches
    # Layer 0's FFN alone, at a decode batch and a prefill chunk.
    layer = model.layers[0]
    args = (layer.router, layer.w_gate, layer.w_up, layer.w_down, cfg.num_experts_per_tok,
            cfg.norm_topk_prob)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev) if sh.device == "cuda" else None
    ffn = {}
    for rows_n in (sh.decode_rows, sh.chunk):
        x = (torch.randn(rows_n, cfg.hidden_size, generator=gen, device=dev)).to(torch.bfloat16)
        got = tmoe.moe_ffn(x, *args)
        with plain_grouped(tmoe):
            want = tmoe.moe_ffn(x, *args)
        ffn_err = float((got.float() - want.float()).abs().max())
        ffn_scale = float(want.float().abs().max())
        assert ffn_err <= 2 * 2**-8 * ffn_scale, (rows_n, ffn_err, ffn_scale)
        ids = tmoe.moe_router(x, layer.router, cfg.num_experts_per_tok, cfg.norm_topk_prob)[1]
        bound_ms, bound_by = moe_bound_ms(cfg, ids, rows_n)
        ms = plain_ms = None
        if sh.device == "cuda":
            ms = timed(torch, lambda: tmoe.moe_ffn(x, *args), sh.reps, flush)
            with plain_grouped(tmoe):
                plain_ms = timed(torch, lambda: tmoe.moe_ffn(x, *args), sh.reps, flush)
        ffn[rows_n] = dict(max_abs_err=ffn_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, touched=len(set(ids.reshape(-1).tolist())))
    # float32 on the card: torch._grouped_mm would copy the ends to the
    # host (a sync, refused inside a capture), so the FFN must refuse it.
    refused = None
    if sh.device == "cuda":
        w32 = [layer.w_gate[:, :8].float(), layer.w_up[:, :8].float(),
               layer.w_down[..., :8].float()]
        try:
            tmoe.moe_ffn(x[:2].float(), layer.router, *w32, cfg.num_experts_per_tok,
                         cfg.norm_topk_prob)
        except NotImplementedError as e:
            refused = str(e).split(":")[0]
        assert refused, "a float32 MoE FFN ran on the card"
    log(f"[moe] (b) {smi}: {cfg.model_type} at {cfg.num_layers} layers (hidden "
        f"{cfg.hidden_size}, {cfg.num_experts} experts of {cfg.expert_intermediate_size}, top-"
        f"{cfg.num_experts_per_tok}, shared expert {cfg.shared_expert_intermediate_size}), a "
        f"{n}-token prompt: grouped vs plain logits max abs err {err:.4e} (scale {scale:.3f}, "
        f"limit 5 %), argmax agreement {agree:.4f}, grouped products {launches}; layer 0's "
        f"FFN: " + "; ".join(
            f"{k} tokens ({v['touched']} experts touched): grouped {v['ms']} ms, plain loop "
            f"{v['plain_ms']} ms, bound {v['bound_ms']:.4f} ms by {v['bound_by']}, max abs err "
            f"{v['max_abs_err']:.3e}" for k, v in ffn.items()) + f"; float32 refused: {refused}")
    del model, logits, a, b, flush
    free(torch, sh.device)
    return dict(max_abs_err=err, scale=scale, argmax_agreement=agree, ffn=ffn,
                f32_refused=refused)


def p16_sharing_f32(torch, np, pkg, tra, smi: str, sh: Phase16, mcfg) -> dict:
    """(c) ``mcfg`` (float32 weights and pools): :func:`p16_requests`
    with ``prefix_sharing`` on and off (the private-copy baseline): the
    same tokens (float32 ties within ``F32_TIE`` in logprob: the shared
    prefix's KV comes from another row's prefill chunks), copies on, none
    off, fewer prefill tokens computed on."""
    requests = p16_requests(np, mcfg.vocab_size, sh, logprobs=LP_TOP)
    lens = [len(r["token_ids"]) for r in requests]
    max_len = max(lens) + sh.long_tokens + PS
    model = seeded_model(torch, pkg, mcfg, sh.device)
    runs = {}
    for sharing in (True, False):
        ecfg = pkg.engine.EngineConfig(
            model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
            num_pages=pages_needed(lens, sh.long_tokens) + 64, kv_dtype="float32",
            prefix_sharing=sharing,
        )
        eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
        sync(torch, sh.device)
        reset_launches()
        r = p8_burst(torch, eng, requests, sh.device)
        r["designs"] = dict(tra.KERNEL_LAUNCHES)
        runs[sharing] = r
        del eng
        free(torch, sh.device)
    on, off = runs[True], runs[False]
    faults, ties = divergences(off["out"], on["out"], F32_TIE)
    assert not faults, faults
    m_on, m_off = on["metrics"], off["metrics"]
    assert m_on["kv_cow_copies"] >= 1 and m_off["kv_cow_copies"] == 0, (
        m_on["kv_cow_copies"], m_off["kv_cow_copies"])
    assert m_on["prefill_tokens_computed"] < m_off["prefill_tokens_computed"]
    if sh.device == "cuda":
        for r in runs.values():
            assert r["designs"]["mixed_f32"] > 0 and r["designs"]["decode_split"] > 0, r
    log(f"[moe] (c) {smi}: {mcfg.model_type} width at {mcfg.num_layers} layers, float32: "
        f"prefix sharing on / off: wall {on['wall_s']:.3f} / {off['wall_s']:.3f} s, prefill "
        f"tokens computed {m_on['prefill_tokens_computed']} / "
        f"{m_off['prefill_tokens_computed']}, prefix hits {m_on['kv_prefix_hits']} / "
        f"{m_off['kv_prefix_hits']}, cow_copies {m_on['kv_cow_copies']} / "
        f"{m_off['kv_cow_copies']}; tokens equal ({len(ties)} float32 ties: {ties}); launches "
        f"by kernel {on['designs']} / {off['designs']}")
    del model
    free(torch, sh.device)
    return dict(ties=ties, cow_copies=m_on["kv_cow_copies"], designs=on["designs"],
                tokens=on["tokens"])


def p16_spec(torch, np, pkg, tra, smi: str, sh: Phase16, mcfg) -> dict:
    """(d) ``mcfg`` at ``sh.check_layers`` layers (bf16, graphs on the
    card): phase 5's prompts greedy without speculation, then with a
    drafter proposing each row's continuation from that run, so verify
    spans (a row's last token and its drafts in one mixed dispatch) run
    the MoE layers; every dispatch of the speculating engine under sync
    debug "error", its verify-span graphs replayed. Tokens equal to the
    plain run are counted, not asserted (bf16: a verify pass scores a
    position in another batch shape than a window step)."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.ops import moe as tmoe

    cfg = replace(mcfg, num_layers=sh.check_layers)
    requests = [{"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens,
                                                        "ignore_eos": True}}
                for ids in phase5_prompts(np, cfg.vocab_size, sh.prompt_lens)]
    lens = [len(r["token_ids"]) for r in requests]
    model = seeded_model(torch, pkg, cfg, sh.device)

    def engine(**kw):
        ecfg = pkg.engine.EngineConfig(
            model=cfg, max_decode_slots=8, page_size=PS, max_model_len=max(lens) + 2 * PS
            + sh.max_tokens, num_pages=pages_needed(lens, sh.max_tokens) + 64,
            kv_dtype="bfloat16", **kw)
        return pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)

    base = p8_burst(torch, engine(), requests, sh.device)
    free(torch, sh.device)
    mode = continuation_drafter(pkg, [r["token_ids"] for r in requests], base["tokens"])
    eng = engine(spec_mode=mode, spec_draft_len=8, spec_max_draft=8)
    guard = guard_dispatch(torch, eng, sh.device, ("_build_mixed", "_launch_window"))
    sync(torch, sh.device)
    reset_launches()
    st = p8_burst(torch, eng, requests, sh.device)
    grouped = tmoe.LAUNCHES["grouped_mm"]
    spec_graphs = (sum(g.replays for k, g in eng.graphs.graphs.items()
                       if getattr(k, "with_spec", False)) if eng.graphs is not None else None)
    del eng
    free(torch, sh.device)
    for o in st["out"]:
        assert o["finish"] == "length" and len(o["tokens"]) == sh.max_tokens, o["finish"]
    m = st["metrics"]
    assert m["spec_row_dispatches"] > 0 and m["spec_accepted_tokens"] > 0, m
    assert not guard["errors"] and guard["guarded"] > 0, guard
    if sh.device == "cuda":
        assert grouped > 0 and spec_graphs, (grouped, spec_graphs)
    equal = sum(a == b for t, w in zip(st["tokens"], base["tokens"]) for a, b in zip(t, w))
    log(f"[moe] (d) {smi}: {cfg.model_type} at {cfg.num_layers} layers, phase 5's prompts with "
        f"drafts of each row's continuation: verify rows {m['spec_row_dispatches']}, proposed "
        f"{m['spec_draft_tokens']} / accepted {m['spec_accepted_tokens']} / emitted "
        f"{m['spec_emitted_tokens']}; verify-span graph replays {spec_graphs}; grouped products "
        f"{grouped}; {guard['guarded']} dispatches under sync debug 'error'; tokens equal to the "
        f"plain run {equal}/{sum(len(t) for t in base['tokens'])} (not asserted at bf16); wall "
        f"{st['wall_s']:.3f} s against {base['wall_s']:.3f} s")
    del model
    free(torch, sh.device)
    return dict(verify_rows=m["spec_row_dispatches"], accepted=m["spec_accepted_tokens"],
                equal=equal, spec_graph_replays=spec_graphs, grouped=grouped)


def phase16(torch, np, pkg, tra, smi: str, sh: Phase16 = Phase16(), mcfg=None,
            check_cfgs=None, f32_cfg=None) -> dict:
    """Phase 16: the sparse-MoE families and copy-on-write of partial
    tails on the card: (a) mixtral-8x7b at ``sh.layers`` layers through
    the engine, (b) the grouped products against their plain version at
    three families' published widths, (c) float32 sharing on against
    off."""
    from dataclasses import replace

    mcfg = mcfg or replace(pkg.models.MIXTRAL_8X7B, num_layers=sh.layers)
    check_cfgs = check_cfgs or {"qwen3_moe": QWEN3_30B_A3B, "qwen2_moe": QWEN15_MOE_A27B,
                                "mixtral": hf_config(pkg.models.MIXTRAL_8X7B)}
    f32_cfg = f32_cfg or replace(pkg.models.LLAMA_8B, num_layers=sh.f32_layers, dtype="float32")
    t0 = time.perf_counter()
    free(torch, sh.device)
    if sh.device == "cuda":
        free_b, total_b = torch.cuda.mem_get_info()
        log(f"[moe] {smi}: before phase 16, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated, {free_b / 1e9:.2f} GB free of {total_b / 1e9:.2f} GB")
    a = p16_mixtral(torch, np, pkg, tra, smi, sh, mcfg)
    b = {name: p16_check(torch, np, pkg, smi, sh, c) for name, c in check_cfgs.items()}
    c = p16_sharing_f32(torch, np, pkg, tra, smi, sh, f32_cfg)
    d = p16_spec(torch, np, pkg, tra, smi, sh, mcfg)
    wall = time.perf_counter() - t0
    log(f"[moe] {smi}: phase 16 wall {wall:.1f} s")
    return dict(a=a, b=b, c=c, d=d, designs=a["designs"], designs_f32=c["designs"],
                wall_s=wall)



# ------------------------------------------------------------ phase 17
GGUF_LAYERS = 4  # (a): Mistral-7B-Instruct-v0.2's width at 4 of its 32 layers
MISTRAL_CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ message['content'] + eos_token }}"
    "{% else %}{{ raise_exception('Only user and assistant roles are supported!') }}"
    "{% endif %}{% endfor %}"
)


@dataclass(frozen=True)
class Phase17:
    """Phase 17's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, a tiny llama config)."""

    device: str = "cuda"
    layers: int = GGUF_LAYERS
    max_tokens: int = MAX_TOKENS
    chat_chars: int = 3000  # the long chat's README text
    seed: int = 17  # the vocabulary's filler pieces


def mistral_v02(np, pkg, layers: int):
    """Mistral-7B-Instruct-v0.2's published widths (hidden 4,096, 32/8
    heads of 128, ffn 14,336, vocab 32,000, rope base 1e6, no sliding
    window, context 32,768) at ``layers`` layers, as its llama-
    architecture GGUF reads back (eps 1e-5 stored as float32)."""
    from dataclasses import replace

    return replace(pkg.models.MISTRAL_7B, num_layers=layers, head_dim=128, rope_theta=1e6,
                   sliding_window=None, rms_norm_eps=float(np.float32(1e-5)),
                   model_type="llama")


def unigram_pieces(text: str, n: int, seed: int) -> list[tuple[str, float, int]]:
    """A SentencePiece vocabulary of exactly ``n`` pieces: ``<unk>``,
    ``<s>``, ``</s>`` (UNKNOWN, CONTROL, CONTROL), the 256 ``<0xNN>``
    pieces (BYTE), the characters ``text`` uses at least 3 times, its
    most frequent substrings of ``▁``-led words, each scored by its log
    frequency rounded to halves (so paths tie), then pieces from a
    seeded generator at lower scores. Rarer characters, CJK and emoji
    fall back to bytes."""
    import math
    import random
    from collections import Counter

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    seen = {p for p, _, _ in pieces}

    def add(p: str, score: float) -> None:
        if p not in seen and len(pieces) < n:
            seen.add(p)
            pieces.append((p, score, 1))

    chars = Counter(text.replace(" ", "▁"))
    subs: Counter = Counter()
    for w in text.split():
        w = "▁" + w
        for i in range(len(w)):
            for j in range(i + 2, min(len(w), i + 10) + 1):
                subs[w[i:j]] += 1
    total = sum(subs.values()) + sum(chars.values())
    for table in (chars, subs):
        for p, k in sorted(table.items(), key=lambda kv: (-kv[1], kv[0])):
            if k >= 3 and p != "\n":
                add(p, round(2 * math.log(k / total)) / 2)
    rng = random.Random(seed)
    alphabet = sorted(c for c, k in chars.items() if k >= 3 and c != "\n")
    while len(pieces) < n:
        add(("▁" if rng.random() < 0.5 else "") +
            "".join(rng.choice(alphabet) for _ in range(rng.randint(2, 6))),
            -24.0 - rng.randint(0, 8) / 2)
    return pieces


def sp_model_bytes(pieces: list[tuple[str, float, int]]) -> bytes:
    """``pieces`` as a SentencePiece ``tokenizer.model`` (a protobuf
    ``ModelProto``; TrainerSpec unk 0, bos 1, eos 2, pad off)."""
    import struct

    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num: int, payload: bytes) -> bytes:
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    out = bytearray()
    for p, score, kind in pieces:
        body = field(1, p.encode()) + varint(2 << 3 | 5) + struct.pack("<f", score)
        out += field(1, body + varint(3 << 3) + varint(kind))
    trainer = b"".join(varint(f << 3) + varint(v % (1 << 64))
                       for f, v in ((40, 0), (41, 1), (42, 2), (43, -1)))
    return bytes(out + field(2, trainer))


def gguf_encode(torch, w, kind: str):
    """``w`` as a GGUF tensor of ``kind`` (``models.gguf.Encoded``): F32,
    F16, BF16, or Q8_0 (blocks of 32: an f16 scale of the block's
    largest magnitude / 127 and the values / scale rounded to int8), and
    the float32 the file decodes to, on ``w``'s device."""
    from dynamo_exp_tpu_torch.models import gguf

    shape, x = tuple(w.shape), w.contiguous().float()
    if kind == "F32":
        return gguf.Encoded(gguf.GGML_F32, shape, x.cpu().numpy()), x
    if kind == "F16":
        h = x.half()
        return gguf.Encoded(gguf.GGML_F16, shape, h.cpu().numpy()), h.float()
    if kind == "BF16":
        b = x.bfloat16()
        return gguf.Encoded(gguf.GGML_BF16, shape, b.view(torch.int16).cpu().numpy()), b.float()
    blocks = x.reshape(-1, gguf.Q8_0_BLOCK)
    d = blocks.abs().amax(1) / 127
    scale = d.half()
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    q = torch.round(blocks * inv[:, None]).clamp(-127, 127).to(torch.int8)
    raw = torch.cat([scale.view(torch.uint8).reshape(-1, 2), q.view(torch.uint8)], 1)
    return (gguf.Encoded(gguf.GGML_Q8_0, shape, raw.cpu().numpy()),
            (q.float() * scale.float()[:, None]).reshape(shape))


def write_mistral_gguf(torch, path: str, model, pieces) -> int:
    """``model``'s weights as a llama-architecture GGUF with its
    tokenizer embedded: the 2-D weights in Q8_0 (q and k in llama.cpp's
    rope order), the norms in F32, ``token_embd`` in F16 and ``output``
    in BF16. Each of ``model``'s weights becomes what the file decodes
    to, so the model is the file's. Returns the file's bytes."""
    from dynamo_exp_tpu_torch.models import gguf

    cfg = model.cfg
    heads = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}
    tensors = {}
    with torch.no_grad():
        for name, (li, attr) in gguf.gguf_tensor_names(cfg).items():
            w = getattr(model if li is None else model.layers[li], attr)
            src = w
            if attr in heads:  # llama.cpp's permutation, which the loader inverts
                out, inner = w.shape
                hd = out // heads[attr]
                src = w.reshape(heads[attr], 2, hd // 2, inner).transpose(1, 2).reshape(out, inner)
            kind = ("F16" if attr == "embed" else "BF16" if attr == "lm_head"
                    else "F32" if w.dim() == 1 else "Q8_0")
            tensors[name], decoded = gguf_encode(torch, src, kind)
            if attr in heads:
                decoded = gguf._unpermute_rope(decoded, heads[attr])
            w.copy_(decoded)
    a = "llama"
    md = {
        "general.architecture": a, "general.name": "Mistral-7B-Instruct-v0.2 (random weights)",
        "general.file_type": 7,  # llama.cpp's MOSTLY_Q8_0
        f"{a}.context_length": cfg.max_position_embeddings,
        f"{a}.embedding_length": cfg.hidden_size, f"{a}.block_count": cfg.num_layers,
        f"{a}.feed_forward_length": cfg.intermediate_size,
        f"{a}.rope.dimension_count": cfg.head_dim_, f"{a}.attention.head_count": cfg.num_heads,
        f"{a}.attention.head_count_kv": cfg.num_kv_heads,
        f"{a}.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        f"{a}.rope.freq_base": float(cfg.rope_theta), f"{a}.vocab_size": cfg.vocab_size,
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": [p for p, _, _ in pieces],
        "tokenizer.ggml.scores": [float(s) for _, s, _ in pieces],
        "tokenizer.ggml.token_type": [k for _, _, k in pieces],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0, "tokenizer.ggml.add_bos_token": True,
        "tokenizer.ggml.add_eos_token": False, "tokenizer.chat_template": MISTRAL_CHAT_TEMPLATE,
    }
    gguf.write_gguf(path, md, tensors)
    return os.path.getsize(path)


def write_sp_model_dir(path: str, model, pieces) -> int:
    """The same model another way: config.json (read back equal to the
    model's config), ``tokenizer.model`` of the same pieces,
    ``tokenizer_config.json`` with the chat template, and the model's
    weights as bf16 safetensors. Returns the weights' bytes."""
    os.makedirs(path, exist_ok=True)
    files = {
        "config.json": dict(hf_config(model.cfg), bos_token_id=1, eos_token_id=2),
        "tokenizer_config.json": {"add_bos_token": True, "add_eos_token": False,
                                  "bos_token": "<s>", "eos_token": "</s>",
                                  "unk_token": "<unk>", "chat_template": MISTRAL_CHAT_TEMPLATE},
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(sp_model_bytes(pieces))
    return write_checkpoint(model, path)


def p17_chats(text: str, sh: Phase17) -> list[list[dict]]:
    """8 chats in Mistral's alternating roles: short turns (one with CJK
    and emoji, which fall back to bytes), a follow-up after an answer,
    README text, and doubled spaces."""
    return [
        [{"role": "user", "content": "What is paged attention?"}],
        [{"role": "user", "content": "Ünïcödé, 日本語 and emoji ☃🎉 in one prompt."}],
        [{"role": "user", "content": "What is a GGUF file?"},
         {"role": "assistant", "content": "One file that holds the weights and a tokenizer."},
         {"role": "user", "content": "And Q8_0?"}],
        [{"role": "user", "content": "Summarise: " + text[: sh.chat_chars]}],
        [{"role": "user", "content": "  Leading  and doubled  spaces.  "}],
        [{"role": "user", "content": "Count to ten."}],
        [{"role": "user", "content": text[1000:1600]}],
        [{"role": "user", "content": "Write a haiku about GPUs."}],
    ]


def p17_prompt_ids(path: str, chats, name: str) -> tuple:
    """The chats' prompt ids as the port's front end makes them from the
    model at ``path`` (its card's template rendered, then its tokenizer's
    encoding), and the tokenizer."""
    from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_exp_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_exp_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_exp_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_pretrained(path)
    pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(path, name), tok)
    ids = [pre.preprocess_chat(ChatCompletionRequest.from_dict(
        {"model": name, "messages": m})).token_ids for m in chats]
    return ids, tok


def p17_argv(sh: Phase17, path: str, name: str, chat_ids) -> list[str]:
    lens = [len(i) for i in chat_ids]
    return [
        "in=http", "out=cuda", "--device", sh.device, "--model-path", path,
        "--model-name", name, "--http-host", "127.0.0.1", "--http-port", "0",
        "--max-decode-slots", "8", "--page-size", str(PS),
        "--max-model-len", str(max(lens) + sh.max_tokens + PS),
        "--num-pages", str(pages_needed(lens, sh.max_tokens) + 64),
        "--kv-dtype", "bfloat16", "--max-tokens", str(sh.max_tokens),
    ]


async def _p17_serve(torch, pkg, tra, opts, tok, chats, chat_ids, model, sh: Phase17,
                     rerun: bool) -> dict:
    """Serve ``opts``: the served weights equal ``model``'s bit for bit;
    the 8 chats streamed at once (and again with ``rerun``, after the
    prefix cache is dropped: the same text); every stream ends [DONE],
    'length' with ``max_tokens`` tokens, its ``usage.prompt_tokens`` the
    length of its prompt ids; both bf16 kernels launched; then the same
    prompt ids straight into the served engine: their tokens, streamed,
    are the HTTP text."""
    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch.http import client

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
        assert not differ, f"served weights differ from the written ones: {differ[:5]}"
        url = f"http://127.0.0.1:{served.port}/v1/chat/completions"
        bodies = [{"model": opts.model_name, "messages": m, "max_tokens": sh.max_tokens,
                   "stream": True, "stream_options": {"include_usage": True},
                   "nvext": {"ignore_eos": True}} for m in chats]
        sync(torch, sh.device)
        reset_launches()
        runs = []
        for i in range(2 if rerun else 1):
            res, wall, _, _ = await burst(client, eng, url, bodies, reset_cache=i > 0)
            for k, (r, ids) in enumerate(zip(res, chat_ids)):
                assert r["done"] and r["finish"] == "length", (k, r["finish"])
                assert r["usage"]["prompt_tokens"] == len(ids), (k, r["usage"], len(ids))
                assert r["usage"]["completion_tokens"] == sh.max_tokens, (k, r["usage"])
            runs.append((res, wall))
        sync(torch, sh.device)
        designs = dict(tra.KERNEL_LAUNCHES)
        if sh.device == "cuda":
            assert designs["mixed_tc_bf16"] > 0 and designs["decode_split"] > 0, designs
            assert designs["mixed_f32"] == 0, designs
        texts = [r["text"] for r in runs[0][0]]
        assert all([r["text"] for r in res] == texts for res, _ in runs), "rerun text differs"
        direct, *_ = await direct_burst(eng, [
            {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens,
                                                   "ignore_eos": True}} for ids in chat_ids])
        tokens = [r["tokens"] for r in direct]
        assert [streamed_text(tok, t) for t in tokens] == texts, "HTTP text != direct tokens"
    finally:
        server.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await server
    st = edge_stats(runs[0][0], runs[0][1], 0.0, 0.0)
    return dict(st, texts=texts, tokens=tokens, designs=designs,
                rerun_wall_s=runs[-1][1] if rerun else None)


def phase17(torch, np, pkg, tra, smi: str, sh: Phase17 = Phase17(), mcfg=None) -> dict:
    """Phase 17: a self-contained Q8_0 GGUF at Mistral-7B-Instruct-v0.2's
    width. (a) One llama-architecture file of seeded weights (Q8_0 2-D
    weights, F32 norms, F16 ``token_embd``, BF16 ``output``) with an
    embedded Unigram tokenizer and Mistral's chat template, served by
    ``run.main_async(--model-path x.gguf)``: load seconds and GB/s,
    weights bit-equal to the file's decoding, 8 streamed chats and a
    token-identical rerun through both bf16 kernels. (b) The same model
    as ``config.json`` + ``tokenizer.model`` + bf16 safetensors: the
    same prompt ids and the same tokens."""
    import tempfile

    from dynamo_exp_tpu_torch import run
    from dynamo_exp_tpu_torch.models import gguf

    mcfg = mcfg or mistral_v02(np, pkg, sh.layers)
    t0 = time.perf_counter()
    free(torch, sh.device)
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    chats = p17_chats(text, sh)
    pieces = unigram_pieces(text, mcfg.vocab_size, sh.seed)
    model = seeded_model(torch, pkg, mcfg, sh.device)
    timing: dict = {}
    load = gguf.load_params_from_gguf

    def timed_load(*a, **kw):
        t = time.perf_counter()
        out = load(*a, **kw)
        sync(torch, sh.device)
        timing["load_s"] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mistral-7b-instruct-v0.2.Q8_0.gguf")
        tw = time.perf_counter()
        nbytes = write_mistral_gguf(torch, path, model, pieces)
        write_s = time.perf_counter() - tw
        g = gguf.GGUFFile.parse(path)
        assert gguf.config_from_gguf(g) == mcfg, gguf.config_from_gguf(g)
        counts: dict = {}
        for info in g.tensors.values():
            kind = gguf._TYPE_NAMES[info.ggml_type]
            counts[kind] = counts.get(kind, 0) + 1
        del g
        assert set(counts) == {"Q8_0", "F32", "F16", "BF16"}, counts
        chat_ids, tok = p17_prompt_ids(path, chats, "mistral-gguf")
        assert tok.vocab_size == mcfg.vocab_size and tok.eos_token_ids == [2]
        assert all(ids[0] == 1 and ids.count(1) == 1 for ids in chat_ids)
        gguf.load_params_from_gguf = timed_load
        try:
            a = asyncio.run(asyncio.wait_for(_p17_serve(
                torch, pkg, tra, run.parse_args(p17_argv(sh, path, "mistral-gguf", chat_ids)),
                tok, chats, chat_ids, model, sh, rerun=True), timeout=600))
        finally:
            gguf.load_params_from_gguf = load
        log(f"[gguf] (a) {smi}: {mcfg.num_layers} layers of Mistral-7B-Instruct-v0.2's width "
            f"as one GGUF of {nbytes / 1e9:.3f} GB (tensors by encoding {counts}, a Unigram "
            f"tokenizer of {len(pieces)} pieces) written in {write_s:.2f} s; "
            f"run.main_async(--model-path x.gguf) loaded it in {timing['load_s']:.3f} s "
            f"({nbytes / timing['load_s'] / 1e9:.2f} GB/s, file bytes over load seconds), "
            f"weights bit-equal to the file's decoding; 8 streamed chats (prompts "
            f"{[len(i) for i in chat_ids]} tokens): wall {a['wall_s']:.3f} s (rerun "
            f"{a['rerun_wall_s']:.3f} s, the same text), {a['tokens_per_s']:.2f} tokens/s, "
            f"edge TTFT p50 {a['ttft_p50_s']:.3f} s max {a['ttft_max_s']:.3f} s; usage equal "
            f"to the port's Unigram encoding of the template; launches by kernel {a['designs']}")
        model_dir = os.path.join(tmp, "mistral-dir")
        tw = time.perf_counter()
        st_bytes = write_sp_model_dir(model_dir, model, pieces)
        dir_write_s = time.perf_counter() - tw
        assert pkg.models.ModelConfig.from_pretrained(model_dir) == mcfg
        ids_b, tok_b = p17_prompt_ids(model_dir, chats, "mistral-dir")
        assert ids_b == chat_ids, "tokenizer.model and the GGUF encode the chats differently"
        b = asyncio.run(asyncio.wait_for(_p17_serve(
            torch, pkg, tra, run.parse_args(p17_argv(sh, model_dir, "mistral-dir", ids_b)),
            tok_b, chats, ids_b, model, sh, rerun=False), timeout=600))
        assert b["tokens"] == a["tokens"], "the directory's tokens differ from the GGUF's"
        assert b["texts"] == a["texts"]
    del model
    free(torch, sh.device)
    wall = time.perf_counter() - t0
    log(f"[gguf] (b) {smi}: config.json + tokenizer.model ({len(pieces)} pieces) + "
        f"{st_bytes / 1e9:.3f} GB of bf16 safetensors written in {dir_write_s:.2f} s: the same "
        f"prompt ids and the same {sum(len(t) for t in b['tokens'])} tokens as (a); launches "
        f"by kernel {b['designs']}; phase 17 wall {wall:.1f} s")
    return dict(a=a, b=b, bytes=nbytes, load_s=timing["load_s"],
                load_gbps=nbytes / timing["load_s"] / 1e9, write_s=write_s,
                designs=a["designs"], designs_dir=b["designs"], wall_s=wall)


# --------------------------------------------------------------- phase 18
TP_DEGREE = 2


@dataclass
class Phase18:
    """Phase 18's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, tiny configs in place of the presets)."""

    device: str = "cuda"
    dense_preset: str = "llama-8b"  # (a): the preset at full width ...
    dense_layers: int = 4  # ... and 4 of its 32 layers, bf16
    prompt_lens: tuple = PROMPT_LENS  # (a), (b): phase 5's prompts ...
    max_tokens: int = MAX_TOKENS  # ... at 32 tokens
    f32_layers: int = 4  # (b): llama-8b's width at 4 layers, float32
    moe_layers: int = 4  # (c): Qwen1.5-MoE-A2.7B's width at 4 layers, bf16
    moe_prompts: int = 8  # (c): 8 prompts ...
    moe_prompt_len: int = 32  # ... of 32 tokens
    timeout_s: float = 300.0  # each run.py process pair


def p18_placement(torch, device: str) -> tuple[int, str]:
    """(cards, backend) of the tp ranks: one card shared over gloo, or a
    card each over NCCL; the CPU over gloo."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    return cards, "nccl" if cards >= TP_DEGREE else "gloo"


def p18_batch(path: str, prompts, max_tokens: int, options=None, logprobs=None) -> str:
    """``in=batch`` lines of token ids (each admitted with the others)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, ids in enumerate(prompts):
            line = {"token_ids": list(ids), "max_tokens": max_tokens, "ignore_eos": True,
                    **((options or {}).get(i, {}))}
            if logprobs is not None:
                line["logprobs"] = logprobs
            f.write(json.dumps(line) + "\n")
    return path


P18_PROCS: list = []  # every run.py this phase started (killed if left running)


def p18_start(argv: list, tp: int = TP_DEGREE):
    """Start ``python -m dynamo_exp_tpu_torch.run <argv> --tp <tp>`` from
    this checkout; :func:`p18_result` waits for it."""
    env = dict(os.environ, PYTHONPATH=HERE)
    cmd = [sys.executable, "-m", "dynamo_exp_tpu_torch.run", *argv, "--tp", str(tp)]
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    P18_PROCS.append(proc)
    return proc, tp, time.time(), time.perf_counter()


def p18_result(started, sh: Phase18) -> dict:
    """A started run, stopped at ``sh.timeout_s``: its outputs by index,
    the stats line, the ``{"tp": ...}`` line and the process wall."""
    proc, tp, t_popen, t0 = started
    try:
        out, err = proc.communicate(timeout=max(sh.timeout_s - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate(timeout=60)
        raise AssertionError(f"run.py --tp {tp} passed {sh.timeout_s} s:\n{err[-4000:]}")
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"run.py --tp {tp} exited {proc.returncode}:\n{err[-6000:]}"
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    rows = sorted((x for x in lines if "index" in x), key=lambda x: x["index"])
    (stats,) = [x for x in lines if "requests" in x]
    tp_line = [x for x in lines if "ranks" in x]
    if tp_line:
        # Rank 0's interpreter and imports before main_async, from the
        # spawn of the process.
        tp_line[0]["timeline"]["main_s"] = round(tp_line[0]["started_at"] - t_popen, 3)
    boots = [x.split("boot, seconds since spawn: ", 1)[1] for x in err.splitlines()
             if "boot, seconds since spawn" in x]
    return dict(rows=rows, stats=stats, tp=tp_line[0] if tp_line else None, wall_s=wall,
                tokens=[r["token_ids"] for r in rows], follower_boot=boots)


def p18_run(argv: list, sh: Phase18, tp: int = TP_DEGREE) -> dict:
    """``python -m dynamo_exp_tpu_torch.run <argv> --tp <tp>``, to its end."""
    return p18_result(p18_start(argv, tp), sh)


def p18_argv(sh: Phase18, batch: str, model: list, kv_dtype: str, lens, max_tokens: int,
             backend: str) -> list:
    return [f"in=batch:{batch}", "out=cuda", "--device", sh.device, *model,
            "--random-weights", "--max-decode-slots", "8", "--page-size", str(PS),
            "--max-model-len", str(max(lens) + max_tokens + PS),
            "--num-pages", str(pages_needed(lens, max_tokens) + 64), "--kv-dtype", kv_dtype,
            "--max-tokens", str(max_tokens), "--dist-backend", backend]


def p18_ranks(r: dict, what: str, kernels, moe: bool = False) -> dict:
    """Check the tp line of run ``r``: every rank's outputs' digest is
    rank 0's, each rank launched ``kernels`` (and the grouped products
    with ``moe``) on the card, the same number of times on every rank.
    Returns rank 0's launches by kernel."""
    tp = r["tp"]
    assert tp is not None and len(tp["ranks"]) == TP_DEGREE, (what, tp)
    ranks = tp["ranks"]
    assert len({(x["digest"], x["dispatches"]) for x in ranks}) == 1, (what, ranks)
    designs = [x["launches"]["attention_kernels"] for x in ranks]
    grouped = [x["launches"]["moe"]["grouped_mm"] for x in ranks]
    assert all(d == designs[0] for d in designs), f"{what}: launches differ by rank {designs}"
    assert all(g == grouped[0] for g in grouped), f"{what}: grouped products differ {grouped}"
    if ranks[0]["device"].startswith("cuda"):
        for k in kernels:
            assert designs[0][k] > 0, f"{what}: {k} never launched: {designs[0]}"
        if moe:
            assert grouped[0] > 0, f"{what}: no grouped product launched"
    return dict(designs[0], grouped_mm=grouped[0])


def p18_rank_line(r: dict) -> str:
    """Each rank's device, peak memory, dispatches and collectives, and
    where rank 0's process spent its wall (seconds into ``main_async``
    when the group formed, the engine was built and it stopped)."""
    t = r["tp"]["timeline"]
    return f"process {r['wall_s']:.1f} s (main_async at {t['main_s']} s; group at " \
        f"{t['joined_s']} s, engine at {t['built_s']} s, stopped at {t['stopped_s']} s, " \
        f"other ranks joined at {t['closed_s']} s into main_async; rank 1's boot " \
        f"{r['follower_boot']}); " + "; ".join(
        f"rank {x['rank']} on {x['device']}: peak {x['peak_memory_bytes'] / 1e9:.2f} GB, "
        f"{x['dispatches']} dispatches, collectives {x['comm']['calls']} in "
        f"{ {k: round(v, 4) for k, v in x['comm']['seconds'].items()} } s"
        for x in r["tp"]["ranks"])


def p18_reference(torch, pkg, mcfg, sh: Phase18, prompts, max_tokens: int, logprobs: int):
    """The tp=1 engine on the same seed-0 weights as ``--random-weights``
    (eager, as the tp ranks run), the prompts admitted together: each
    row's tokens, logprobs and top logprobs."""
    from dynamo_exp_tpu_torch.engine import EngineConfig, TorchEngine

    lens = [len(p) for p in prompts]
    cfg = EngineConfig(model=mcfg, max_decode_slots=8, page_size=PS,
                       num_pages=pages_needed(lens, max_tokens) + 64,
                       max_model_len=max(lens) + max_tokens + PS, kv_dtype=mcfg.dtype,
                       default_max_tokens=max_tokens, cuda_graphs=False)
    eng = TorchEngine(cfg, model=seeded_model(torch, pkg, mcfg, sh.device), device=sh.device)

    async def collect(stream):
        r = dict(tokens=[], lps=[], tops=[])
        async for item in stream:
            r["tokens"] += item.get("token_ids") or []
            r["lps"] += item.get("logprobs") or []
            r["tops"] += item.get("top_logprobs") or []
        return r

    async def go():
        streams = [eng.submit({"token_ids": p, "stop_conditions": {
            "max_tokens": max_tokens, "ignore_eos": True},
            "sampling_options": {"logprobs": logprobs}}) for p in prompts]
        eng.start()
        return await asyncio.wait_for(asyncio.gather(*map(collect, streams)), 600)

    try:
        out = asyncio.run(go())
    finally:
        eng.stop()
    del eng
    free(torch, sh.device)
    return out


def phase18(torch, np, pkg, tra, smi: str, sh: Phase18 = Phase18(), dense=None, f32=None,
            moe=None) -> dict:
    """Phase 18: tensor parallelism through the entry point a user calls,
    ``python -m dynamo_exp_tpu_torch.run ... --tp 2`` in subprocesses,
    each rank a process of its own (one card: both on it over gloo; two
    or more: a card each over NCCL), the kernels at per-rank head
    counts. (a) llama-8b at full width and 4 of its 32 layers
    (``Phase18.dense_layers``), bf16, random weights from seed 0: phase
    5's 8 prompts (one seeded), 32 tokens each, admitted together, then
    a rerun in a new pair of processes (beside (b)'s pair and tp=1
    reference): the same tokens; both ranks' outputs equal; both bf16
    kernels launched on each rank, as often on both. (b) llama-8b's
    width at 4 layers, float32: tp=2 against tp=1 (in this process, the
    same weights): the same greedy tokens up to a float32 tie
    (``F32_TIE``), through the float32 mixed and split-KV kernels. (c)
    Qwen1.5-MoE-A2.7B's published width at 4 layers, bf16 (16/16 heads
    of 128, 60 experts of 1,408, top-4, a shared expert of 5,632): 8
    prompts of 32 tokens and a rerun (the two pairs side by side),
    identical, the grouped products and both bf16 kernels launched on
    each rank. ``dense`` / ``f32`` /
    ``moe`` replace the three configs (the CPU rehearsal's)."""
    import tempfile
    from dataclasses import replace

    t0 = time.perf_counter()
    free(torch, sh.device)
    cards, backend = p18_placement(torch, sh.device)
    log(f"[tp] {smi}: tp={TP_DEGREE} over {cards} card(s) (torch.cuda.device_count()), "
        f"backend {backend}")
    dense = dense or replace(pkg.models.PRESETS[sh.dense_preset], num_layers=sh.dense_layers)
    f32 = f32 or replace(pkg.models.LLAMA_8B, num_layers=sh.f32_layers, dtype="float32")
    moe = moe or pkg.models.ModelConfig.from_hf_config(
        dict(QWEN15_MOE_A27B, num_hidden_layers=sh.moe_layers))
    bf16_kernels = ("mixed_tc_bf16", "decode_split")
    out: dict = {"backend": backend, "cards": cards}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _phase18_runs(torch, np, pkg, smi, sh, dense, f32, moe, backend, bf16_kernels,
                          tmp, out)
    finally:
        for proc in P18_PROCS:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
        P18_PROCS.clear()
    wall = time.perf_counter() - t0
    log(f"[tp] phase 18 wall {wall:.1f} s")
    return dict(out, designs=out["a"]["designs"], designs_f32=out["b"]["designs"],
                designs_moe=out["c"]["designs"], wall_s=wall)


def _phase18_runs(torch, np, pkg, smi, sh, dense, f32, moe, backend, bf16_kernels, tmp,
                  out) -> None:
    """Phase 18's three runs into ``out`` (see :func:`phase18`)."""
    def model_dir(name, mcfg):
        path = os.path.join(tmp, name)
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
            json.dump(hf_config(mcfg), f)
        assert pkg.models.ModelConfig.from_pretrained(path) == mcfg
        return ["--model-path", path]

    # (a) llama-8b at full width, sh.dense_layers layers.
    prompts = phase5_prompts(np, dense.vocab_size, sh.prompt_lens)
    lens = [len(p) for p in prompts]
    batch = p18_batch(os.path.join(tmp, "a.jsonl"), prompts, sh.max_tokens,
                      {SEEDED: dict(SEEDED_OPTIONS)})
    model = (["--preset", sh.dense_preset] if dense is pkg.models.PRESETS.get(sh.dense_preset)
             else model_dir("dense", dense))
    argv = p18_argv(sh, batch, model, "bfloat16", lens, sh.max_tokens, backend)
    # The first run alone (its wall and collectives are printed); the
    # rerun, whose tokens alone are checked, beside (b)'s run and
    # reference below.
    runs = [p18_run(argv, sh)]
    rerun = p18_start(argv)
    prompts_b = phase5_prompts(np, f32.vocab_size, sh.prompt_lens)
    batch_b = p18_batch(os.path.join(tmp, "b.jsonl"), prompts_b, sh.max_tokens, logprobs=2)
    started_b = p18_start(p18_argv(sh, batch_b, model_dir("f32", f32), "float32", lens,
                                   sh.max_tokens, backend))
    want = p18_reference(torch, pkg, f32, sh, prompts_b, sh.max_tokens, 2)
    runs.append(p18_result(rerun, sh))
    rb = p18_result(started_b, sh)
    for r in runs:
        assert [len(t) for t in r["tokens"]] == [sh.max_tokens] * len(prompts), r["tokens"]
        assert all(x["finish_reason"] == "length" for x in r["rows"])
    assert runs[1]["tokens"] == runs[0]["tokens"], "(a) the rerun's tokens differ"
    a = [p18_ranks(r, "(a)", bf16_kernels) for r in runs]
    ra, comm = runs[0], runs[0]["tp"]["ranks"][0]["comm"]
    coll_s = comm["seconds"]["all_reduce"] + comm["seconds"]["all_gather"]
    share = coll_s / ra["stats"]["wall_s"]
    log(f"[tp] (a) {smi}: {dense.num_layers} layers at width {dense.hidden_size}, bf16, "
        f"tp={TP_DEGREE} ({backend}): 8 prompts {lens} x {sh.max_tokens} tokens admitted "
        f"together: wall {ra['stats']['wall_s']:.3f} s, {ra['stats']['output_tok_s']:.2f} "
        f"tokens/s, TTFT p50 {ra['stats']['ttft_p50_ms']} ms (rerun wall "
        f"{runs[1]['stats']['wall_s']:.3f} s, {runs[1]['stats']['output_tok_s']:.2f} "
        f"tokens/s; processes {ra['wall_s']:.1f} / {runs[1]['wall_s']:.1f} s); rank 0's "
        f"collectives {comm['calls']}, all_reduce + all_gather {coll_s:.3f} s = "
        f"{share * 100:.1f} % of the wall; the rerun's tokens identical, both ranks' "
        f"digests equal; launches by kernel on each rank {a[0]} (rerun {a[1]}); "
        f"{p18_rank_line(ra)}")
    out["a"] = dict(wall_s=ra["stats"]["wall_s"], tokens_per_s=ra["stats"]["output_tok_s"],
                    rerun_wall_s=runs[1]["stats"]["wall_s"], designs=a[0], comm=comm,
                    collective_share=share, ranks=ra["tp"]["ranks"],
                    process_wall_s=[r["wall_s"] for r in runs])

    # (b) float32 at 4 layers: tp=2 against tp=1 on the same weights
    # (run above, beside (a)'s rerun).
    got = [dict(tokens=x["token_ids"], lps=x["logprobs"],
                tops=[{int(k): v for k, v in t.items()} for t in x["top_logprobs"]])
           for x in rb["rows"]]
    faults, ties = divergences(want, got, F32_TIE)
    assert not faults, f"(b) tp=2 tokens differ from tp=1: {faults}"
    lp_err = max((abs(x - y) for w, g in zip(want, got) if w["tokens"] == g["tokens"]
                  for x, y in zip(w["lps"], g["lps"])), default=0.0)
    b = p18_ranks(rb, "(b)", ("mixed_f32", "decode_split"))
    log(f"[tp] (b) {smi}: width {f32.hidden_size}, {f32.num_layers} layers, float32: tp=2 "
        f"({backend}) gives tp=1's greedy tokens (ties within {F32_TIE}: "
        f"{'; '.join(ties) or 'none'}), logprobs of equal rows within {lp_err:.2e}; wall "
        f"{rb['stats']['wall_s']:.3f} s; launches by kernel on each rank {b}; "
        f"{p18_rank_line(rb)}")
    out["b"] = dict(designs=b, ties=ties, lp_err=lp_err, wall_s=rb["stats"]["wall_s"])

    # (c) Qwen1.5-MoE-A2.7B's width at 4 layers, bf16.
    rs = np.random.RandomState(18)
    prompts = [[int(t) for t in rs.randint(3, moe.vocab_size, size=sh.moe_prompt_len)]
               for _ in range(sh.moe_prompts)]
    lens = [len(p) for p in prompts]
    batch = p18_batch(os.path.join(tmp, "c.jsonl"), prompts, sh.max_tokens)
    argv = p18_argv(sh, batch, model_dir("moe", moe), "bfloat16", lens, sh.max_tokens,
                    backend)
    # The run and its rerun side by side (only their tokens are
    # compared; the wall printed is the first's, under the other).
    started = [p18_start(argv) for _ in range(2)]
    runs = [p18_result(x, sh) for x in started]
    assert runs[1]["tokens"] == runs[0]["tokens"], "(c) the rerun's tokens differ"
    assert [len(t) for t in runs[0]["tokens"]] == [sh.max_tokens] * len(prompts)
    c = [p18_ranks(r, "(c)", bf16_kernels, moe=True) for r in runs]
    rc = runs[0]
    log(f"[tp] (c) {smi}: Qwen1.5-MoE-A2.7B's width ({moe.num_heads}/{moe.num_kv_heads} "
        f"heads of {moe.head_dim_}, {moe.num_experts} experts of "
        f"{moe.expert_intermediate_size}, top-{moe.num_experts_per_tok}, shared "
        f"{moe.shared_expert_intermediate_size}) at {moe.num_layers} layers, bf16, tp=2 "
        f"({backend}): {len(prompts)} prompts of {sh.moe_prompt_len} x {sh.max_tokens} "
        f"tokens: wall {rc['stats']['wall_s']:.3f} s, {rc['stats']['output_tok_s']:.2f} "
        f"tokens/s (rerun {runs[1]['stats']['wall_s']:.3f} s, identical tokens); "
        f"launches on each rank {c[0]}; {p18_rank_line(rc)}")
    out["c"] = dict(designs=c[0], wall_s=rc["stats"]["wall_s"])


# ------------------------------------------------------------ phase 19
# The smoke's view of the LLM graphs: the port's graph modules, their
# CudaWorker instrumented for phase 19 only. It is written beside the
# phase's temporary files and put on the PYTHONPATH of the graph's
# processes; the package gains no counter for it. Each worker process
# writes its launch counters (ops/launches.py's kernel record) to
# ``$DYN_P19_STATE_DIR/worker-<pid>.json`` every 0.25 s, and serves a
# control endpoint of its own component (``smoke19.control.burst``, so
# that the KV router and the planner, which list the CudaWorker
# component, never see it): ``{"n": N}`` holds the engine's admission,
# drops its prefix cache, answers, and admits the next N requests
# together, as ``burst`` does in this process for phase 6: a burst's
# schedule then does not depend on the requests' arrival times.
# ``DYN_P19_WINDOW_DELAY_S`` slows every decode window (the CPU
# rehearsal's tiny model would otherwise outrun the planner).
P19_GRAPH = '''"""Phase 19's graphs: the port's agg_router and agg graphs, their
CudaWorker instrumented for the smoke (launch counts to a state file, a
held-burst control endpoint)."""

import asyncio
import json
import os
import time

from dynamo_exp_tpu_torch.examples.llm.graphs import agg
from dynamo_exp_tpu_torch.examples.llm.graphs.agg_router import CudaWorker, Frontend
from dynamo_exp_tpu_torch.sdk import dynamo_context, get_spec

AggFrontend = agg.Frontend
__all__ = ["Frontend", "AggFrontend", "CudaWorker"]
T_IMPORT = time.time()
DELAY_S = float(os.environ.get("DYN_P19_WINDOW_DELAY_S", "0"))
if DELAY_S > 0:
    from dynamo_exp_tpu_torch.engine import TorchEngine

    _consume = TorchEngine._consume_windowed

    def _slow(self, pending):
        time.sleep(DELAY_S)
        return _consume(self, pending)

    TorchEngine._consume_windowed = _slow


async def _p19_start(self):
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    drt = dynamo_context["runtime"]
    path = os.path.join(os.environ["DYN_P19_STATE_DIR"], f"worker-{os.getpid()}.json")
    eng = self.engine

    async def burst(request, context=None):
        with eng.hold_admission():
            eng.reset_prefix_cache()
            yield {"data": {"holding": True}}
            deadline = time.monotonic() + 300
            while eng.queued() < request["n"]:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{eng.queued()} of {request['n']} requests queued")
                await asyncio.sleep(0.001)
        yield {"data": {"admitted": request["n"]}}

    ctl = await drt.namespace("smoke19").component("control").endpoint("burst").serve_endpoint(
        burst)

    def write():
        m = eng.metrics()
        state = dict(t=time.time(), pid=os.getpid(), t_import=T_IMPORT,
                     generate=dynamo_context["instance_ids"].get("generate"),
                     control=ctl.instance_id, designs=dict(tra.KERNEL_LAUNCHES),
                     prefix_hits=m["kv_prefix_hits"], prefill=m["prefill_tokens_computed"],
                     active=m["request_active_slots"])
        with open(path + ".tmp", "w") as f:
            json.dump(state, f)
        os.replace(path + ".tmp", path)

    async def pump():
        while True:
            write()
            await asyncio.sleep(0.25)

    self._p19_pump = asyncio.ensure_future(pump())


CudaWorker._p19_start = _p19_start
get_spec(CudaWorker).on_start.append("_p19_start")
'''

P19_NS = "dynamo"  # the graphs' namespace (the components' @service)


@dataclass(frozen=True)
class Phase19:
    """Phase 19's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, a tiny config in place of llama-8b)."""

    device: str = "cuda"
    cuda_devices: str = "0,0"  # the worker slots: two workers on card 0
    prompt_lens: tuple = PROMPT_LENS  # (a): phase 5's lengths ...
    max_tokens: int = MAX_TOKENS  # ... at 32 tokens, twice
    num_pages: int = 1024  # (a), (b): 2 GiB at llama-8b's 2 MiB a page ...
    slots: int = 8  # ... and 8 slots a worker
    max_model_len: int = 2048 + 128 + PS
    wave: int = 16  # (b): requests a wave ...
    wave_lens: tuple = (1500, 2000)  # ... of prompts of these lengths ...
    wave_tokens: int = 128  # ... at 128 tokens
    metric_s: float = 0.5  # the planner's metric pulling interval
    adjust_s: float = 2.0  # and its adjustment interval
    kv_up: float = 0.7
    kv_down: float = 0.3
    gpu_budget: int = 2
    f32_layers: int = 4  # (c): llama-8b's width at 4 layers, float32
    f32_tokens: int = MAX_TOKENS
    window_delay_s: float = 0.0  # DYN_P19_WINDOW_DELAY_S (the CPU rehearsal's)
    boot_s: float = 300.0  # a graph (or a spawned worker) serves within this
    scale_s: float = 120.0  # the planner acts within this


class _Proc:
    """A child process; a thread reads its merged output, each line with
    its arrival time (``time.perf_counter``)."""

    def __init__(self, argv: list, env: dict, name: str, cwd: str = HERE):
        import threading

        self.name = name
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: list[tuple[float, str]] = []
        self._termed = False
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip()))

    def find(self, needle: str, after: float = 0.0) -> list[tuple[float, str]]:
        return [(t, x) for t, x in list(self.lines) if needle in x and t >= after]

    def tail(self, n: int = 60) -> str:
        return "\n".join(x for _, x in self.lines[-n:])

    async def wait_line(self, needle: str, timeout_s: float, after: float = 0.0):
        deadline = time.monotonic() + timeout_s
        while True:
            hits = self.find(needle, after)
            if hits:
                return hits[0]
            assert self.proc.poll() is None, (
                f"{self.name} exited {self.proc.returncode} waiting for {needle!r}:\n"
                f"{self.tail()}")
            assert time.monotonic() < deadline, (
                f"{self.name}: no {needle!r} within {timeout_s} s:\n{self.tail()}")
            await asyncio.sleep(0.02)

    def stop(self, timeout_s: float = 60.0) -> int:
        """SIGTERM, then SIGKILL past ``timeout_s``; returns the exit code."""
        self.terminate()
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
        self._reader.join(10)
        return self.proc.returncode

    def terminate(self) -> None:
        """SIGTERM, once: a second one may land after the process's loop
        closed, while it exits, and kill it (-15)."""
        if self.proc.poll() is None and not self._termed:
            self._termed = True
            self.proc.terminate()


def _p19_states(state_dir: str) -> dict[int, dict]:
    """Every worker's last state, by pid."""
    out = {}
    for name in os.listdir(state_dir):
        if name.startswith("worker-") and name.endswith(".json"):
            st = _p11_read(os.path.join(state_dir, name))
            if st is not None:
                out[st["pid"]] = st
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


async def _p19_fresh_states(state_dir: str, pids, after: float, timeout_s: float = 30.0):
    """The workers ``pids``' states written after ``after`` (wall clock);
    a worker that has exited gives its last one."""
    deadline = time.monotonic() + timeout_s
    while True:
        states = _p19_states(state_dir)
        if all(p in states and (states[p]["t"] > after or not _alive(p)) for p in pids):
            return {p: states[p] for p in pids}
        assert time.monotonic() < deadline, f"a worker stopped writing its state: {pids}"
        await asyncio.sleep(0.05)


async def _p19_first_worker(state_dir: str, sup: "_Proc", timeout_s: float) -> dict:
    """The graph's one worker's state, once its generate endpoint serves."""
    deadline = time.monotonic() + timeout_s
    while True:
        states = [st for st in _p19_states(state_dir).values() if st["generate"] is not None]
        if states:
            assert len(states) == 1, states
            return states[0]
        assert sup.proc.poll() is None, f"the graph exited {sup.proc.returncode}:\n{sup.tail()}"
        assert time.monotonic() < deadline, f"no worker served:\n{sup.tail()}"
        await asyncio.sleep(0.05)


def _p19_delta(after: dict, before: dict) -> dict:
    return {k: v - before["designs"][k] for k, v in after["designs"].items()}


async def _p19_held(drt, control_iid: int, n: int, send):
    """Hold the worker's admission (its prefix cache dropped), run
    ``send()`` (which starts ``n`` requests and returns their gather),
    release once the worker holds all ``n``; returns ``send``'s result."""
    ep = drt.namespace("smoke19").component("control").endpoint("burst")
    ctl = await ep.client()
    await ctl.wait_for_instances(1, timeout=30)
    while control_iid not in ctl.instance_ids():
        await asyncio.sleep(0.05)
    frames = (await ctl.generate_to(ctl.instance(control_iid), {"n": n})).__aiter__()
    first = await frames.__anext__()
    assert first.data == {"holding": True}, first.data
    pending = send()
    admitted = await frames.__anext__()
    assert admitted.data == {"admitted": n}, admitted.data
    ctl.close()
    return await pending


def _p19_chat(text: str, max_tokens: int, **extra) -> dict:
    return {"model": "llama-8b", "messages": [{"role": "user", "content": text}],
            "max_tokens": max_tokens, "stream": True, "nvext": {"ignore_eos": True},
            "stream_options": {"include_usage": True}, **extra}


def _p19_texts(ids: list[int], tok, lens, offset: int) -> list[str]:
    """Texts of about ``lens`` tokens each: windows of ``ids`` (README's
    tokens) from ``offset`` on, one after another (wrapping)."""
    out, at = [], offset
    for n in lens:
        if at + n > len(ids):
            at = 0
        out.append(tok.decode(ids[at:at + n]))
        at += n
    return out


def _p19_check(res: list[dict], max_tokens: int, what: str) -> None:
    for i, r in enumerate(res):
        assert r["done"], f"{what}: request {i} did not end with [DONE]"
        assert r["finish"] == "length", f"{what}: request {i} finished {r['finish']!r}"
        assert r["usage"] and r["usage"]["completion_tokens"] == max_tokens, (what, r["usage"])


def _p19_wave_line(res: list[dict], wall: float) -> tuple[str, dict]:
    """A wave's TTFT (over the streams that carried text: a random
    model's greedy tokens may all be special tokens, which stream none),
    wall and tokens/s."""
    ttft = sorted(r["frames"][0] - r["sent"] for r in res if r["frames"])
    assert ttft, "no stream of the wave carried any text"
    tokens = sum(r["usage"]["completion_tokens"] for r in res)
    stats = dict(ttft_p50_s=_p11_pct(ttft, 0.5), ttft_max_s=ttft[-1], wall_s=wall,
                 tokens_per_s=tokens / wall)
    return (f"TTFT p50 {stats['ttft_p50_s']:.3f} s max {stats['ttft_max_s']:.3f} s, wall "
            f"{wall:.3f} s, {stats['tokens_per_s']:.2f} tokens/s"), stats


def _p19_actions(planner: "_Proc") -> list[tuple[float, dict]]:
    """The planner's logged actions, with their arrival times."""
    import ast

    return [(t, ast.literal_eval(x.split("planner action: ", 1)[1]))
            for t, x in planner.find("planner action: ")]


def _p19_supervisor(graph: str, cfg: dict, tmp: str, state_dir: str, sh: Phase19,
                    name: str) -> "_Proc":
    """``python -m dynamo_exp_tpu_torch.sdk.serve _p19_graph:<graph> -f
    <cfg> --start-coordinator`` with the worker slots ``sh.cuda_devices``."""
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, tmp]),
               DYN_CUDA_DEVICES=sh.cuda_devices, DYN_P19_STATE_DIR=state_dir,
               DYN_P19_WINDOW_DELAY_S=str(sh.window_delay_s))
    env.pop("DYN_SERVICE_CONFIG", None)
    return _Proc([sys.executable, "-m", "dynamo_exp_tpu_torch.sdk.serve", f"_p19_graph:{graph}",
                  "-f", path, "--start-coordinator"], env, name)


def _p19_graph_cfg(sh: Phase19, port: int, model_dir: str, router: str, kv_dtype: str,
                   num_pages: int, max_model_len: int) -> dict:
    return {
        "Frontend": {"served_model_name": "llama-8b", "port": port, "host": "127.0.0.1"},
        "Processor": {"model_path": model_dir, "served_model_name": "llama-8b",
                      "router": router, "page_size": PS},
        "CudaWorker": {"model_path": model_dir, "served_model_name": "llama-8b",
                       "random_weights": True, "max_decode_slots": sh.slots,
                       "num_pages": num_pages, "max_model_len": max_model_len,
                       "page_size": PS, "kv_dtype": kv_dtype, "device": sh.device},
    }


async def _p19_wait_served(client, sup: "_Proc", base: str, timeout_s: float) -> list[str]:
    deadline = time.monotonic() + timeout_s
    while True:
        assert sup.proc.poll() is None, f"the graph exited {sup.proc.returncode}:\n{sup.tail()}"
        try:
            r = await client.request(base + "/v1/models")
            if r.status == 200 and r.json()["data"]:
                return [m["id"] for m in r.json()["data"]]
        except OSError:
            pass
        assert time.monotonic() < deadline, f"the graph never served:\n{sup.tail()}"
        await asyncio.sleep(0.1)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _p19_addr(sup: "_Proc") -> str:
    deadline = time.monotonic() + 120
    while True:
        hits = sup.find("coordinator on ")
        if hits:
            return hits[0][1].split("coordinator on ", 1)[1].strip()
        assert sup.proc.poll() is None and time.monotonic() < deadline, sup.tail()
        time.sleep(0.02)


async def _p19_ab(np, pkg, smi, sh: Phase19, tok, text_ids, sup, planner, addr, base,
                  state_dir) -> dict:
    """(a) and (b), against the agg_router graph ``sup`` with the
    planner CLI ``planner`` beside it."""
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig

    t_boot = time.perf_counter()
    models = await _p19_wait_served(client, sup, base, sh.boot_s)
    assert models == ["llama-8b"], f"(a) /v1/models lists {models}"
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    try:
        workers = await drt.namespace(P19_NS).component("CudaWorker").endpoint(
            "generate").client()
        await workers.wait_for_instances(1, timeout=sh.boot_s)
        w0 = await _p19_first_worker(state_dir, sup, sh.boot_s)
        served_s = time.perf_counter() - t_boot
        chat = base + "/v1/chat/completions"

        # (a): phase 5's lengths as chats, one seeded, twice.
        bodies = [_p19_chat(t, sh.max_tokens, **(SEEDED_OPTIONS if i == SEEDED else {}))
                  for i, t in enumerate(_p19_texts(text_ids, tok, sh.prompt_lens, 0))]
        runs = []
        before = (await _p19_fresh_states(state_dir, [w0["pid"]], time.time()))[w0["pid"]]
        for _ in range(2):
            t0 = time.perf_counter()
            res = await _p19_held(drt, w0["control"], len(bodies), lambda: asyncio.gather(
                *(sse_request(client, chat, b) for b in bodies)))
            _p19_check(res, sh.max_tokens, "(a)")
            runs.append((res, time.perf_counter() - t0))
        after = (await _p19_fresh_states(state_dir, [w0["pid"]], time.time()))[w0["pid"]]
        a_designs = _p19_delta(after, before)
        (r1, wall1), (r2, wall2) = runs
        assert [r["text"] for r in r2] == [r["text"] for r in r1], "(a) the rerun's text differs"
        if sh.device == "cuda":
            for k in ("mixed_tc_bf16", "decode_split"):
                assert a_designs[k] > 0, f"(a) {k} never launched: {a_designs}"
        line1, a1 = _p19_wave_line(r1, wall1)
        line2, a2 = _p19_wave_line(r2, wall2)
        prompt_tokens = [r["usage"]["prompt_tokens"] for r in r1]
        log(f"[graph] (a) {smi}: agg_router graph served (model listed {models}) {served_s:.1f} s "
            f"after the supervisor's start; 8 chats of {prompt_tokens} prompt tokens x "
            f"{sh.max_tokens}, one seeded, admitted together: {line1}; rerun {line2}; every "
            f"stream [DONE] with usage, the rerun's text identical (the seeded one too); "
            f"launches by kernel {a_designs}")

        # (b): the planner scales the CudaWorker fleet 1 -> 2 -> 1. The
        # Processor's routing decisions (``kv-hit-rate`` events) are
        # recorded with their arrival times.
        from dynamo_exp_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT

        picks: list[tuple[float, int]] = []
        hits_sub = await drt.event_plane.subscribe(KV_HIT_RATE_SUBJECT)

        async def record_picks():
            async for ev in hits_sub:
                picks.append((time.perf_counter(), ev["worker_id"]))

        picker = asyncio.ensure_future(record_picks())
        rs = np.random.RandomState(19)
        lens = [int(x) for x in rs.randint(sh.wave_lens[0], sh.wave_lens[1] + 1, size=2 * sh.wave)]
        texts = _p19_texts(text_ids, tok, lens, sum(sh.prompt_lens))
        wave1 = [_p19_chat(t, sh.wave_tokens) for t in texts[:sh.wave]]
        wave2 = [_p19_chat(t, sh.wave_tokens) for t in texts[sh.wave:]]
        t_load = time.perf_counter()
        w1_task = asyncio.ensure_future(asyncio.gather(*(sse_request(client, chat, b)
                                                         for b in wave1)))
        done_at: list[float] = []
        w1_task.add_done_callback(lambda _: done_at.append(time.perf_counter()))
        t_add, add = await planner.wait_line("'op': 'add'", sh.scale_s, t_load)
        # Wave 2 waits for both wave 1's end and the second worker (the
        # second worker boots for longer than wave 1 lasts; while the
        # fleet is one worker the planner removes none).
        t_visible = None
        while t_visible is None or not w1_task.done():
            if t_visible is None and len(workers.instance_ids()) >= 2:
                t_visible = time.perf_counter()
            assert time.perf_counter() - t_add < sh.boot_s, f"no second worker:\n{sup.tail()}"
            assert sup.proc.poll() is None, sup.tail()
            await asyncio.sleep(0.02)
        t_spawn = sup.find("started CudaWorker[1]")
        w1, t_w1 = w1_task.result(), done_at[0]
        _p19_check(w1, sh.wave_tokens, "(b) wave 1")
        # Wave 2 as soon as the router's load view holds both workers idle
        # (it scrapes every 0.1 s; 0.5 s covers a few): the planner
        # averages its samples over a round, and a round of idle samples
        # would read as a fleet to shrink. Its first half at once (the
        # router breaks the tie at random), the second 0.3 s later (to
        # the less loaded worker). The new worker has launched nothing
        # yet, the first has been idle since wave 1.
        await asyncio.sleep(max(0.0, max(t_visible, t_w1) + 0.5 - time.perf_counter()))
        s_before = _p19_states(state_dir)
        pids = sorted(s_before)
        assert len(pids) == 2, pids
        half = len(wave2) // 2

        async def later(b):
            await asyncio.sleep(0.3)
            return await sse_request(client, chat, b)

        t_w2 = time.perf_counter()
        w2 = await asyncio.gather(*(sse_request(client, chat, b) for b in wave2[:half]),
                                  *(later(b) for b in wave2[half:]))
        t_idle = time.perf_counter()
        _p19_check(w2, sh.wave_tokens, "(b) wave 2")
        s_after = await _p19_fresh_states(state_dir, pids, time.time())
        w2_designs = {p: _p19_delta(s_after[p], s_before[p]) for p in pids}
        w2_prefill = {p: s_after[p]["prefill"] - s_before[p]["prefill"] for p in pids}
        for p in pids:
            assert w2_prefill[p] > 0, (
                f"(b) worker {p} served none of wave 2: {w2_prefill}; routed (s after the "
                f"load's start, instance) {[(round(t - t_load, 3), w) for t, w in picks]}; "
                f"wave 1 ended {t_w1 - t_load:.3f} s, second instance visible "
                f"{t_visible - t_load:.3f} s, wave 2 {t_w2 - t_load:.3f} to "
                f"{t_idle - t_load:.3f} s; the planner:\n"
                + "\n".join(f"{t - t_load:.3f} {x}" for t, x in planner.lines[-30:]))
            if sh.device == "cuda":
                assert sum(w2_designs[p].values()) > 0, (
                    f"(b) worker {p} launched nothing in wave 2: {w2_designs}")
        # The removal follows wave 2's end on the card; a short wave (the
        # CPU rehearsal's) may still drain when it lands.
        picker.cancel()
        routed = {}
        for t, w in picks:
            if t >= t_w2:
                routed[w] = routed.get(w, 0) + 1
        t_remove, _ = await planner.wait_line("'op': 'remove'", sh.scale_s, t_w2)
        while len(workers.instance_ids()) > 1:
            assert time.perf_counter() - t_remove < 60, "the removed worker stayed listed"
            await asyncio.sleep(0.02)
        t_gone = time.perf_counter()
        await asyncio.sleep(2 * sh.adjust_s)  # a round more: no other action follows
        acts = [(a["op"], a["component"]) for _, a in _p19_actions(planner)]
        assert acts == [("add", "CudaWorker"), ("remove", "CudaWorker")], (
            f"{acts}; wave 1 {t_w1 - t_load:.3f} s, wave 2 from {t_w2 - t_load:.3f} to "
            f"{t_idle - t_load:.3f} s after the load's start:\n"
            + "\n".join(f"{t - t_load:.3f} {x}" for t, x in planner.lines[-40:]))
        assert not sup.find("restarting"), f"a watcher restarted:\n{sup.tail()}"
        removed = max(pids, key=lambda p: s_after[p]["t_import"])
        last = _p19_states(state_dir)
        # (b)'s own launches: the first worker's from the end of (a), the
        # spawned worker's from 0.
        b_designs = {p: _p19_delta(last[p], after if p == w0["pid"] else
                                   {"designs": dict.fromkeys(last[p]["designs"], 0)})
                     for p in pids}
        l1, b1 = _p19_wave_line(w1, t_w1 - t_load)
        l2, b2 = _p19_wave_line(w2, t_idle - t_w2)
        b = dict(load_to_add_s=t_add - t_load, add_to_visible_s=t_visible - t_add,
                 spawn_to_visible_s=(t_visible - t_spawn[0][0]) if t_spawn else None,
                 idle_to_remove_s=t_remove - t_idle, remove_to_gone_s=t_gone - t_remove,
                 wave1=b1, wave2=b2, designs=b_designs, wave2_designs=w2_designs,
                 add_signal=add.split("'signal': ", 1)[1].rstrip("}"))
        log(f"[graph] (b) {smi}: planner (metric {sh.metric_s} s, adjust {sh.adjust_s} s, KV "
            f"{sh.kv_up} / {sh.kv_down}, max_gpu_budget {sh.gpu_budget}, min_endpoint 1): "
            f"load start -> add {b['load_to_add_s']:.3f} s (signal {b['add_signal']}); add -> "
            f"second instance visible {b['add_to_visible_s']:.3f} s (spawn -> visible "
            f"{b['spawn_to_visible_s'] or 0:.3f} s: interpreter, imports, weights, pool, "
            f"registration); idle -> remove {b['idle_to_remove_s']:.3f} s, remove -> the router's "
            f"view back to 1 instance {b['remove_to_gone_s']:.3f} s; wave 1 ({sh.wave} chats of "
            f"{sh.wave_lens} tokens x {sh.wave_tokens}): {l1}; wave 2 (both workers): {l2}; "
            f"adjustments {acts}; no restarts; launches by worker (pid {w0['pid']} first, "
            f"{removed} removed) {b_designs}; in wave 2 {w2_designs} (prefill tokens computed "
            f"{w2_prefill}; routed by instance {routed})")
        return dict(a=dict(runs=[a1, a2], designs=a_designs, served_s=served_s), b=b,
                    designs={k: a_designs[k] + sum(d[k] for d in b_designs.values())
                             for k in a_designs})
    finally:
        await drt.close()


async def _p19_c(np, pkg, smi, sh: Phase19, sup, addr, base, state_dir, prompts, want,
                 decode) -> dict:
    """(c): the agg graph's greedy float32 tokens against ``want``."""
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig

    await _p19_wait_served(client, sup, base, sh.boot_s)
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    try:
        w = await _p19_first_worker(state_dir, sup, sh.boot_s)
        url = base + "/v1/completions"

        async def one(ids):
            out = dict(tokens=[], lps=[], tops=[], done=False)
            async for f in client.sse_frames(url, {
                    "model": "llama-8b", "prompt": ids, "max_tokens": sh.f32_tokens,
                    "temperature": 0, "logprobs": 2, "stream": True,
                    "nvext": {"ignore_eos": True}}):
                if f.data == "[DONE]":
                    out["done"] = True
                    break
                for c in f.data["choices"]:
                    lp = c.get("logprobs") or {}
                    out["tokens"] += lp.get("tokens") or []
                    out["lps"] += lp.get("token_logprobs") or []
                    out["tops"] += lp.get("top_logprobs") or []
            return out

        t0 = time.perf_counter()
        got = await _p19_held(drt, w["control"], len(prompts),
                              lambda: asyncio.gather(*(one(p) for p in prompts)))
        wall = time.perf_counter() - t0
        last = (await _p19_fresh_states(state_dir, [w["pid"]], time.time()))[w["pid"]]
    finally:
        await drt.close()
    for g in got:
        assert g["done"] and len(g["tokens"]) == sh.f32_tokens == len(g["lps"]), g
    # The engine's rows as the service shows them: each token decoded
    # alone, the top candidates keyed by their decoded text (the best
    # logprob of a text).
    ref = []
    for w_ in want:
        tops = []
        for t in w_["tops"]:
            m: dict = {}
            for tid, lp in t.items():
                s = decode(tid)
                m[s] = max(lp, m.get(s, float("-inf")))
            tops.append(m)
        ref.append(dict(tokens=[decode(t) for t in w_["tokens"]], lps=w_["lps"], tops=tops))
    faults, ties = divergences(ref, got, F32_TIE)
    assert not faults, f"(c) the graph's tokens differ from TorchEngine's: {faults}"
    lp_err = max((abs(x - y) for r, g in zip(ref, got) if r["tokens"] == g["tokens"]
                  for x, y in zip(r["lps"], g["lps"])), default=0.0)
    assert lp_err <= 1e-3, f"(c) logprobs of equal rows differ by {lp_err}"
    designs = last["designs"]
    if sh.device == "cuda":
        for k in ("mixed_f32", "decode_split"):
            assert designs[k] > 0, f"(c) {k} never launched: {designs}"
    return dict(ties=ties, lp_err=lp_err, wall_s=wall, designs=designs)


def phase19(torch, np, pkg, tra, smi: str, sh: Phase19 = Phase19(), mcfg=None) -> dict:
    """Phase 19: the serve graphs and the planner, through the entry
    points a user calls: ``python -m dynamo_exp_tpu_torch.sdk.serve
    <graph>:Frontend -f <json> --start-coordinator`` (the supervisor,
    with its coordinator, spawning Frontend, Processor and CudaWorker
    processes on worker slots ``0,0`` of one card) and ``python -m
    dynamo_exp_tpu_torch.planner.planner`` beside it. (a) The agg_router
    graph (KV routing) with llama-8b at full width and depth, bf16,
    seed-0 random weights: phase 5's lengths as 8 streamed chats (one
    seeded), 32 tokens each, admitted together, twice: [DONE], usage,
    identical reruns, both bf16 kernels launched in the worker. (b) The
    planner adds a second CudaWorker under a wave of 16 long chats,
    both workers serve a second wave, and once idle it removes the
    newest: exactly one add and one remove, every stream whole, no
    restart. (c) The agg graph at llama-8b's width, 4 layers, float32:
    8 greedy completions equal to a ``TorchEngine`` in this process on
    the same weights and prompt ids, token for token (as the service
    shows tokens: decoded one by one), up to a float32 tie."""
    import tempfile
    from dataclasses import replace

    from dynamo_exp_tpu_torch import tokenizer as tokmod

    t_phase = time.perf_counter()
    free(torch, sh.device)
    mcfg = mcfg or pkg.models.LLAMA_8B
    f32 = replace(mcfg, num_layers=sh.f32_layers, dtype="float32")
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "_p19_graph.py"), "w", encoding="utf-8") as f:
            f.write(P19_GRAPH)
        model_dir = write_model_dir(os.path.join(tmp, "model"), tokmod, mcfg, text)
        f32_dir = os.path.join(tmp, "model-f32")
        shutil.copytree(model_dir, f32_dir)
        with open(os.path.join(f32_dir, "config.json"), "w", encoding="utf-8") as f:
            json.dump({**hf_config(f32), "bos_token_id": mcfg.vocab_size - N_SPECIAL}, f)
        assert pkg.models.ModelConfig.from_pretrained(f32_dir) == f32
        tok = tokmod.Tokenizer.from_pretrained(model_dir)
        text_ids = tok.encode(text).ids

        # (a), (b): the agg_router graph and the planner beside it.
        state_ab = os.path.join(tmp, "state-ab")
        os.makedirs(state_ab)
        port = _free_port()
        sup = _p19_supervisor("Frontend", _p19_graph_cfg(
            sh, port, model_dir, "kv", "bfloat16", sh.num_pages, sh.max_model_len),
            tmp, state_ab, sh, "agg_router")
        planner = None
        try:
            addr = _p19_addr(sup)
            planner = _Proc([sys.executable, "-m", "dynamo_exp_tpu_torch.planner.planner",
                             "--coordinator", addr, "--namespace", P19_NS,
                             "--decode-component", "CudaWorker",
                             "--metric-pulling-interval", str(sh.metric_s),
                             "--adjustment-interval", str(sh.adjust_s),
                             "--decode-kv-scale-up-threshold", str(sh.kv_up),
                             "--decode-kv-scale-down-threshold", str(sh.kv_down),
                             "--max-gpu-budget", str(sh.gpu_budget), "--min-endpoint", "1"],
                            dict(os.environ, PYTHONPATH=HERE), "planner")
            out.update(asyncio.run(asyncio.wait_for(_p19_ab(
                np, pkg, smi, sh, tok, text_ids, sup, planner, addr,
                f"http://127.0.0.1:{port}", state_ab), timeout=900)))
        finally:
            rc_planner = planner.stop() if planner is not None else None
            rc_sup = sup.stop()
        assert rc_sup == 0, f"the supervisor exited {rc_sup}:\n{sup.tail()}"
        assert rc_planner == 0, f"the planner exited {rc_planner}:\n{planner.tail()}"
        t_ab = time.perf_counter() - t_phase

        # (c): the agg graph at float32; the reference computes while the
        # graph boots.
        t_c = time.perf_counter()
        state_c = os.path.join(tmp, "state-c")
        os.makedirs(state_c)
        prompts = phase5_prompts(np, f32.vocab_size, sh.prompt_lens)
        lens = [len(p) for p in prompts]
        port = _free_port()
        sup = _p19_supervisor("AggFrontend", _p19_graph_cfg(
            sh, port, f32_dir, "round-robin", "float32",
            pages_needed(lens, sh.f32_tokens) + 64, max(lens) + sh.f32_tokens + PS),
            tmp, state_c, sh, "agg")
        try:
            addr = _p19_addr(sup)
            want = p18_reference(torch, pkg, f32, Phase18(device=sh.device), prompts,
                                 sh.f32_tokens, 2)
            c = asyncio.run(asyncio.wait_for(_p19_c(
                np, pkg, smi, sh, sup, addr, f"http://127.0.0.1:{port}", state_c, prompts,
                want, lambda t: tok.decode([t])), timeout=600))
        finally:
            rc_sup = sup.stop()
        assert rc_sup == 0, f"the supervisor exited {rc_sup}:\n{sup.tail()}"
        log(f"[graph] (c) {smi}: agg graph, width {f32.hidden_size}, {f32.num_layers} layers, "
            f"float32: 8 greedy completions of {lens} ids x {sh.f32_tokens}, admitted together, "
            f"give TorchEngine's tokens (ties within {F32_TIE}: {'; '.join(c['ties']) or 'none'}), "
            f"logprobs of equal rows within {c['lp_err']:.2e}; wall {c['wall_s']:.3f} s; "
            f"launches by kernel {c['designs']}; (c) {time.perf_counter() - t_c:.1f} s")
        out["c"] = c
    out["wall_s"] = time.perf_counter() - t_phase
    out["designs_f32"] = c["designs"]
    log(f"[graph] {smi}: phase 19 wall {out['wall_s']:.1f} s ((a) + (b) {t_ab:.1f} s); "
        f"launches by kernel, (a) + (b) {out['designs']}, (c) {c['designs']}")
    log(json.dumps({"phase19": {
        "a": out["a"], "b": {k: v for k, v in out["b"].items() if k != "wave2_designs"},
        "c": {k: c[k] for k in ("ties", "lp_err", "wall_s", "designs")},
        "wall_s": out["wall_s"]}}))
    return out


# ------------------------------------------------------------ phase 20
P20_GRAPH = "dynamo_exp_tpu_torch.examples.llm.graphs.agg_router:Frontend"
P20_NAME = "smoke20"  # the artifact's and the deployment's name
P20_SCRAPE_S = 0.2  # the exporter's scrape interval


@dataclass(frozen=True)
class Phase20:
    """Phase 20's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, a tiny config in place of llama-8b)."""

    device: str = "cuda"
    prompt_lens: tuple = PROMPT_LENS  # phase 5's lengths, as chats ...
    max_tokens: int = MAX_TOKENS  # ... at 32 tokens
    workers: int = 2  # CudaWorker's ServiceArgs.workers: two on card 0
    num_pages: int = 1024  # a worker's pool ...
    slots: int = 8  # ... and slots
    max_model_len: int = 2048 + 128 + PS
    boot_s: float = 300.0  # the rendered fleet serves within this
    layers: int = 4  # llama-8b's width at 4 of its 32 layers


def _p20_cli(*argv) -> str:
    """``python -m dynamo_exp_tpu_torch.deploy.cli <argv>`` run in this
    process (its ``main``): its standard output; a non-zero code raises."""
    import io

    from dynamo_exp_tpu_torch.deploy import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    assert rc == 0, f"deploy cli {argv[0]} exited {rc}: {out.getvalue()}"
    return out.getvalue()


def _p20_graph_cfg(sh: Phase20, model_dir: str, http_port: int) -> dict:
    return {
        "Frontend": {"served_model_name": "llama-8b", "port": http_port, "host": "127.0.0.1"},
        "Processor": {"model_path": model_dir, "served_model_name": "llama-8b",
                      "router": "kv", "page_size": PS},
        "CudaWorker": {"model_path": model_dir, "served_model_name": "llama-8b",
                       "random_weights": True, "max_decode_slots": sh.slots,
                       "num_pages": sh.num_pages, "max_model_len": sh.max_model_len,
                       "page_size": PS, "kv_dtype": "bfloat16", "device": sh.device,
                       "ServiceArgs": {"workers": sh.workers}},
    }


class _Kubelet:
    """Runs rendered documents on this host as a kubelet would: each
    Deployment's container ``command`` once a replica, as a process of
    its own, with the rendered ``env`` and nothing of this checkout: the
    unpacked artifact alone on ``PYTHONPATH`` (and its working
    directory). The pods share this host's network, so the kubelet
    stands in for their namespaces: every port of a rendered Service
    gets a free host port (bind(0)), the selected pod listens there (its
    ``--port`` argument, or its service's ``port`` key in the mounted
    config, rewritten; the documents stay as rendered), and cluster DNS
    resolves ``<service>:<port>`` to 127.0.0.1 and that host port. A
    ConfigMap volume: its files written into a directory that stands for
    the mount path. The GPU device plugin: a container with an
    ``nvidia.com/gpu`` limit gets the first card this process was given
    (the first entry of its ``CUDA_VISIBLE_DEVICES``, card 0 when that is
    unset), and its supervisor one card slot a worker of the service
    (``DYN_CUDA_DEVICES``), so that the service's workers share the
    card."""

    def __init__(self, docs: list[dict], root: str, mounts: dict, config: dict):
        from dynamo_exp_tpu_torch.sdk.allocator import inherited_cards

        self.root = root
        self.config = config  # the service config: a gpu pod's workers
        # Empty leaves this process no card: only a CPU rehearsal gets
        # that far, and its pods run on the CPU.
        self.card = (inherited_cards() or ["0"])[0]
        self.ports: dict = {}  # (Service name, port) -> host port
        self.listen: dict = {}  # pod label -> {container port: host port}
        for d in docs:
            if d["kind"] == "Service":
                pod = d["spec"]["selector"]["app.kubernetes.io/name"]
                for p in d["spec"]["ports"]:
                    host = self.ports[(d["metadata"]["name"], p["port"])] = _free_port()
                    self.listen.setdefault(pod, {})[p.get("targetPort", p["port"])] = host
        for d in docs:
            if d["kind"] == "ConfigMap":
                host = mounts[d["metadata"]["name"]]
                os.makedirs(host, exist_ok=True)
                for name, text in d["data"].items():
                    if name.endswith(".json"):
                        text = json.dumps(self._config_ports(json.loads(text), docs))
                    with open(os.path.join(host, name), "w", encoding="utf-8") as f:
                        f.write(text)
        self.volumes = mounts  # ConfigMap name -> the directory standing for its mount

    def _config_ports(self, cfg: dict, docs: list[dict]) -> dict:
        """The service config with each pod's listening ``port`` key
        moved to its host port."""
        for d in docs:
            if d["kind"] != "Deployment":
                continue
            listen = self.listen.get(d["spec"]["template"]["metadata"]["labels"][
                "app.kubernetes.io/name"], {})
            cmd = d["spec"]["template"]["spec"]["containers"][0]["command"]
            svc = cfg.get(cmd[cmd.index("--service-name") + 1]) if "--service-name" in cmd \
                else None
            if svc is not None and svc.get("port") in listen:
                svc["port"] = listen[svc["port"]]
        return cfg

    def resolve(self, value: str) -> str:
        """Cluster DNS: ``<service>:<port>`` -> ``127.0.0.1:<host port>``;
        any other value as it is."""
        host, sep, port = value.rpartition(":")
        if sep and port.isdigit() and (host, int(port)) in self.ports:
            return f"127.0.0.1:{self.ports[(host, int(port))]}"
        return value

    def _path(self, arg: str, pod: dict, container: dict) -> str:
        for vm in container.get("volumeMounts", []):
            if arg.startswith(vm["mountPath"] + "/"):
                vol = next(v for v in pod["volumes"] if v["name"] == vm["name"])
                return self.volumes[vol["configMap"]["name"]] + arg[len(vm["mountPath"]):]
        return arg

    def spec(self, doc: dict) -> tuple[list[str], dict]:
        """A Deployment's container as this host runs it: (argv, env)."""
        pod = doc["spec"]["template"]["spec"]
        listen = self.listen.get(doc["spec"]["template"]["metadata"]["labels"][
            "app.kubernetes.io/name"], {})
        (container,) = pod["containers"]
        cmd = [sys.executable if a == "python" else self._path(a, pod, container)
               for a in container["command"]]
        for i in range(1, len(cmd)):
            if cmd[i - 1] == "--port" and cmd[i].isdigit() and int(cmd[i]) in listen:
                cmd[i] = str(listen[int(cmd[i])])
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DYN_") and k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
        env.update({e["name"]: self.resolve(e["value"]) for e in container.get("env", [])})
        env["PYTHONPATH"] = self.root
        limits = container.get("resources", {}).get("limits", {})
        if "nvidia.com/gpu" in limits:
            svc = cmd[cmd.index("--service-name") + 1]
            workers = (self.config.get(svc, {}).get("ServiceArgs") or {}).get("workers", 1)
            env["CUDA_VISIBLE_DEVICES"] = self.card
            env["DYN_CUDA_DEVICES"] = ",".join(["0"] * int(workers))
        return cmd, env

    def run(self, doc: dict) -> list["_Proc"]:
        cmd, env = self.spec(doc)
        return [_Proc(cmd, env, f"{doc['metadata']['name']}-{r}", cwd=self.root)
                for r in range(doc["spec"]["replicas"])]


def _p20_scrape(text: str) -> dict:
    """The exporter's ``llm_kv_*`` samples: {name: {worker_id or None: value}}."""
    out: dict = {}
    for (name, labels), value in _family_values(text).items():
        if name.startswith("llm_kv_"):
            out.setdefault(name, {})[dict(labels).get("worker_id")] = value
    return out


async def _p20_quiet(decisions: list, at_least: int, quiet_s: float = 0.5) -> None:
    """Until ``decisions`` holds ``at_least`` entries and no more came for
    ``quiet_s`` (30 s at most)."""
    deadline = time.monotonic() + 30
    while True:
        n = len(decisions)
        await asyncio.sleep(quiet_s or 0.01)
        if len(decisions) >= at_least and (not quiet_s or len(decisions) == n):
            return
        assert time.monotonic() < deadline, f"{len(decisions)} routing decisions of {at_least}"


async def _p20_launches(comp) -> dict:
    """Every CudaWorker's kernel launches by design (its stats scrape)."""
    stats = await comp.scrape_stats()
    return {iid: dict(st["kernel_launches"]["attention_kernels"]) for iid, st in stats.items()}


async def _p20_captures(comp) -> dict:
    """Every CudaWorker's CUDA graphs captured and capture seconds so
    far (its stats scrape)."""
    stats = await comp.scrape_stats()
    return {iid: (st["graphs_captured"], st["graph_capture_seconds"])
            for iid, st in stats.items()}


def _p20_new(after: dict, before: dict) -> str:
    """Graphs captured and their seconds between two scrapes, by worker."""
    return ", ".join(f"{iid}: {n - before.get(iid, (0, 0.0))[0]} in "
                     f"{s - before.get(iid, (0, 0.0))[1]:.1f} s"
                     for iid, (n, s) in sorted(after.items()))


def _p20_sum(after: dict, before: dict) -> dict:
    out: dict = {}
    for iid, counts in after.items():
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v - before.get(iid, {}).get(k, 0)
    return out


async def _p20_drive(np, smi, sh: Phase20, tok, text_ids, model_dir, addr, base,
                     procs) -> dict:
    """(a)'s traffic and (b)'s components, against the rendered fleet."""
    from dynamo_exp_tpu_torch.http import client
    from dynamo_exp_tpu_torch.kv_router import KV_HIT_RATE_SUBJECT
    from dynamo_exp_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_exp_tpu_torch.preprocessor import OpenAIPreprocessor
    from dynamo_exp_tpu_torch.protocols.openai import ChatCompletionRequest
    from dynamo_exp_tpu_torch.runtime import DistributedRuntime
    from dynamo_exp_tpu_torch.runtime.config import RuntimeConfig

    t0 = time.perf_counter()
    drt = DistributedRuntime(config=RuntimeConfig(coordinator_endpoint=addr))
    decisions: list[tuple[float, dict]] = []
    picker = None
    try:
        sub = await drt.event_plane.subscribe(KV_HIT_RATE_SUBJECT)

        async def record():
            async for ev in sub:
                decisions.append((time.perf_counter(), ev))

        picker = asyncio.ensure_future(record())
        comp = drt.namespace(P19_NS).component("CudaWorker")
        router, exporter = procs[-2], procs[-1]
        await router.wait_line("kv router instance", sh.boot_s)
        _, line = await exporter.wait_line("metrics on http://", sh.boot_s)
        metrics_url = "http://127.0.0.1:" + line.rsplit(":", 1)[1]
        # Every worker answers the stats scrape (so the Processor's router,
        # scraping every 0.1 s, sees both) and the Frontend lists the model.
        before, models = {}, []
        while len(before) < sh.workers or models != ["llama-8b"]:
            for p in procs:
                assert p.proc.poll() is None, f"{p.name} exited {p.proc.returncode}:\n{p.tail()}"
            assert time.perf_counter() - t0 < sh.boot_s, "the rendered fleet never served"
            await asyncio.sleep(0.1)
            before = await _p20_launches(comp)
            with contextlib.suppress(OSError):
                r = await client.request(base + "/v1/models")
                models = [m["id"] for m in r.json()["data"]] if r.status == 200 else []
        await asyncio.sleep(0.3)  # a few of the Processor's load scrapes
        ids = sorted(before)
        caps = [await _p20_captures(comp)]
        boot_s = time.perf_counter() - t0
        chat = base + "/v1/chat/completions"

        # (a) phase 5's lengths as chats (one seeded): a burst, then two
        # runs in which each worker serves its prompts one at a time
        # (both workers at once), which must be identical.
        texts = _p19_texts(text_ids, tok, sh.prompt_lens, 0)
        bodies = [_p19_chat(t, sh.max_tokens, **(SEEDED_OPTIONS if i == SEEDED else {}))
                  for i, t in enumerate(texts)]
        pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(model_dir, "llama-8b"),
                                 tok)
        prompt_ids = [pre.preprocess_chat(ChatCompletionRequest.from_dict(b)).token_ids
                      for b in bodies]
        # A routing decision names its prompt by its input blocks.
        isl = [len(p) // PS for p in prompt_ids]
        assert len(set(isl)) == len(isl), f"(a) prompts of equal blocks: {isl}"

        async def routed(send) -> tuple:
            """``send()``'s result and each prompt's routing decision in it."""
            n = len(decisions)
            res = await send()
            await _p20_quiet(decisions, n + len(bodies), quiet_s=0.0)
            picks = {ev["isl_blocks"]: ev for _, ev in decisions[n:]}
            assert len(decisions) - n == len(bodies) and sorted(picks) == sorted(isl), (
                f"(a) one routing decision a request: {decisions[n:]}")
            return res, [picks[b] for b in isl]

        t_burst = time.perf_counter()
        burst_res, by = await routed(lambda: asyncio.gather(
            *(sse_request(client, chat, b) for b in bodies)))
        burst_wall = time.perf_counter() - t_burst
        caps.append(await _p20_captures(comp))
        _p19_check(burst_res, sh.max_tokens, "(a) burst")
        for r, p in zip(burst_res, prompt_ids):
            assert r["usage"]["prompt_tokens"] == len(p), (r["usage"], len(p))
        holder = [ev["worker_id"] for ev in by]

        async def one_at_a_time(wid: int) -> dict:
            return {i: await sse_request(client, chat, bodies[i])
                    for i in range(len(bodies)) if holder[i] == wid}

        async def run_once() -> list:
            parts = await asyncio.gather(*(one_at_a_time(w) for w in set(holder)))
            return [next(p[i] for p in parts if i in p) for i in range(len(bodies))]

        runs, one_s = [], []
        for _ in range(2):
            t_run = time.perf_counter()
            res, by = await routed(run_once)
            one_s.append(time.perf_counter() - t_run)
            caps.append(await _p20_captures(comp))
            _p19_check(res, sh.max_tokens, "(a)")
            assert [ev["worker_id"] for ev in by] == holder, (
                f"(a) a prompt left the worker that holds it: {by}, {holder}")
            assert [ev["overlap_blocks"] for ev in by] == isl, by
            runs.append(res)
        assert [r["text"] for r in runs[1]] == [r["text"] for r in runs[0]], (
            "(a) the rerun's text differs")
        after_a = await _p20_launches(comp)
        a_designs = _p20_sum(after_a, before)
        if sh.device == "cuda":
            for k in ("mixed_tc_bf16", "decode_split"):
                assert a_designs[k] > 0, f"(a) {k} never launched: {after_a}"
        a_line, a_stats = _p19_wave_line(burst_res, burst_wall)
        log(f"[deploy] (a) {smi}: the rendered fleet served (2 CudaWorkers, instances "
            f"{ids}) {boot_s:.1f} s after the kubelet's start; 8 chats of "
            f"{[len(p) for p in prompt_ids]} prompt tokens x {sh.max_tokens} (one seeded) "
            f"through the HTTP Service: a burst ({a_line}; its holders {holder}), then "
            f"twice one at a time on each worker ({one_s[0]:.3f} s and {one_s[1]:.3f} s "
            f"for the 8, TTFT p50 "
            f"{_p11_pct(sorted(r['frames'][0] - r['sent'] for r in runs[1] if r['frames']), 0.5):.3f} s): "
            f"identical text, each prompt routed to its holder with its full pages; launches "
            f"by kernel {a_designs}, by worker "
            f"{ {i: _p20_sum({i: after_a[i]}, before) for i in ids} }; graphs captured by "
            f"worker: the burst {_p20_new(caps[1], caps[0])}, run 1 {_p20_new(caps[2], caps[1])}, "
            f"run 2 {_p20_new(caps[3], caps[2])}")

        # (b) the router service names the worker of each prompt, with
        # the prompt's full pages as its overlap.
        ep = drt.namespace(P19_NS).component("kv_aware_router").endpoint("generate")
        rcl = await ep.client()
        await rcl.wait_for_instances(1, timeout=60)

        async def ask(token_ids):
            stream = await rcl.generate_to(rcl.instances[0], {"token_ids": token_ids})
            return [a.data async for a in stream if a.data is not None][0]

        answers = [await ask(p) for p in prompt_ids]
        fresh = [int(t) for t in np.random.RandomState(20).randint(3, 1000, size=300)]
        never = await ask(fresh)
        rcl.close()
        for i, (ans, wid, p) in enumerate(zip(answers, holder, prompt_ids)):
            assert ans == {"worker_id": wid, "overlap_blocks": len(p) // PS}, (
                f"(b) prompt {i} ({len(p)} tokens): the router service says {ans}, the "
                f"Processor routed it to {wid}")
        assert never["overlap_blocks"] == 0 and never["worker_id"] in ids, never

        # The exporter: every llm_kv_* gauge for both workers, the pool's
        # blocks each; then a third burst's decisions, counted.
        stats = await comp.scrape_stats()
        deadline = time.monotonic() + 30
        while True:
            scrape = _p20_scrape((await client.request(metrics_url)).body.decode())
            gauges = {k: v for k, v in scrape.items() if not k.startswith("llm_kv_hit_")}
            if all(set(v) == {str(i) for i in ids} for v in gauges.values()) and gauges:
                break
            assert time.monotonic() < deadline, f"(b) the exporter shows {scrape}"
            await asyncio.sleep(0.1)
        assert len(gauges) == 7, sorted(gauges)
        for i in ids:
            assert gauges["llm_kv_kv_total_blocks"][str(i)] == stats[i]["kv_total_blocks"] \
                == sh.num_pages, (gauges["llm_kv_kv_total_blocks"], sh.num_pages)
            assert gauges["llm_kv_request_total_slots"][str(i)] == sh.slots
        await _p20_quiet(decisions, len(decisions))  # the router service's answers too
        scrape = _p20_scrape((await client.request(metrics_url)).body.decode())
        hits0 = scrape["llm_kv_hit_events_total"][None]
        n = len(decisions)
        t_third = time.perf_counter()
        third = await asyncio.gather(*(sse_request(client, chat, b) for b in bodies))
        third_wall = time.perf_counter() - t_third
        caps.append(await _p20_captures(comp))
        _p19_check(third, sh.max_tokens, "(b) third burst")
        await _p20_quiet(decisions, n + len(bodies))
        made = len(decisions) - n
        assert made == len(bodies), f"(b) {made} routing decisions for {len(bodies)} chats"
        deadline = time.monotonic() + 10
        while True:
            scrape = _p20_scrape((await client.request(metrics_url)).body.decode())
            hits = scrape["llm_kv_hit_events_total"][None]
            if hits - hits0 >= made:
                break
            assert time.monotonic() < deadline, f"(b) the exporter counted {hits - hits0}"
            await asyncio.sleep(0.05)
        assert hits - hits0 == made, (hits, hits0, made)
        after_b = await _p20_launches(comp)
        b_designs = _p20_sum(after_b, after_a)
        b_line, b_stats = _p19_wave_line(third, third_wall)
        log(f"[deploy] (b) {smi}: the router service (python -m "
            f"dynamo_exp_tpu_torch.components.router) named the worker the Processor "
            f"routed each of (a)'s 8 prompts to, with overlap_blocks = its full pages "
            f"{[a['overlap_blocks'] for a in answers]}, and 0 for a prompt never served; the "
            f"exporter (components.metrics) showed the 7 llm_kv_* gauges for both workers, "
            f"llm_kv_kv_total_blocks {sh.num_pages} each; a third burst ({b_line}) made "
            f"{made} routing decisions and llm_kv_hit_events_total rose by "
            f"{hits - hits0:.0f}; launches by kernel {b_designs}; graphs captured by worker "
            f"{_p20_new(caps[4], caps[3])}")
        return dict(boot_s=boot_s, a=a_stats, one_at_a_time_s=one_s, b=b_stats,
                    designs_a=a_designs,
                    designs_b=b_designs, overlaps=[a["overlap_blocks"] for a in answers])
    finally:
        if picker is not None:
            picker.cancel()
        await drt.close()


def phase20(torch, np, pkg, tra, smi: str, sh: Phase20 = Phase20(), mcfg=None) -> dict:
    """Phase 20: the deploy tier and the standalone components, through
    the entry points a user calls. (a) ``python -m
    dynamo_exp_tpu_torch.deploy.cli build`` packs the port's agg_router
    graph with a JSON config (llama-8b at full width and
    ``Phase20.layers`` of its 32 layers, bf16,
    seed-0 random weights, 1,024 pages and 8 slots a worker,
    ``CudaWorker.ServiceArgs.workers`` 2); ``render``, ``push`` to a
    ``python -m dynamo_exp_tpu_torch.deploy.api_store`` process and
    ``deploy``; a ``DeploymentOperator`` on a ``MemoryBackend`` applies
    exactly the rendered documents, then nothing. This script then runs
    them as a kubelet would (``_Kubelet``): the artifact unpacked into a
    fresh directory with phase 2's kernel library (and its stamp) copied
    in, the coordinator, then each Deployment's command once a replica
    with only the unpacked tree on ``PYTHONPATH``. Phase 5's lengths as
    8 streamed chats (one seeded) of 32 tokens through the rendered
    HTTP Service: a burst, then twice one at a time: [DONE], usage,
    identical runs routed alike, both bf16 kernels launched in the
    workers. (b) Beside the fleet, ``python -m
    dynamo_exp_tpu_torch.components.router --workers CudaWorker
    --block-size 16`` names, for each of (a)'s prompts, the worker that
    served it with ``overlap_blocks`` its full pages (0 for a prompt
    never served), and ``python -m dynamo_exp_tpu_torch.components.metrics
    --component dynamo.CudaWorker`` shows every ``llm_kv_*`` gauge for
    both workers (``llm_kv_kv_total_blocks`` each worker's pool) and
    counts a third burst's routing decisions in
    ``llm_kv_hit_events_total``. Every process exits 0 on SIGTERM, and
    with the record deleted the operator's next pass collects every
    document. Both components start with the fleet, so that the router
    service sees (a)'s KV events."""
    import tarfile
    import tempfile
    from dataclasses import replace

    from dynamo_exp_tpu_torch import tokenizer as tokmod
    from dynamo_exp_tpu_torch.deploy import from_yaml, read_manifest, render_graph_manifests
    from dynamo_exp_tpu_torch.deploy.k8s import DEFAULT_IMAGE
    from dynamo_exp_tpu_torch.deploy.operator import DeploymentOperator, MemoryBackend
    from dynamo_exp_tpu_torch.http import client

    t_phase = time.perf_counter()
    free(torch, sh.device)
    mcfg = mcfg or replace(pkg.models.LLAMA_8B, num_layers=sh.layers)
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "model")
        # 8080: the Frontend's port inside its pod, the rendered HTTP
        # Service's targetPort; the kubelet maps it to a free host port.
        cfg = _p20_graph_cfg(sh, model_dir, 8080)
        cfg_path = os.path.join(tmp, "agg_router.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        art = os.path.join(tmp, f"{P20_NAME}.tar.gz")
        store_dir = os.path.join(tmp, "store")
        env = dict(os.environ, PYTHONPATH=HERE)
        procs: list[_Proc] = []
        rcs: dict = {}
        builder = None
        try:
            # The build and the store start while the model directory is
            # written (the config names it; the build reads only the config).
            t0 = time.perf_counter()
            builder = subprocess.Popen(
                [sys.executable, "-m", "dynamo_exp_tpu_torch.deploy.cli", "build", P20_GRAPH,
                 "-o", art, "-f", cfg_path, "--name", P20_NAME, "--src-root", HERE],
                cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            store = _Proc([sys.executable, "-m", "dynamo_exp_tpu_torch.deploy.api_store",
                           "--store-dir", store_dir, "--host", "127.0.0.1", "--port", "0"],
                          env, "api_store")
            procs.append(store)
            write_model_dir(model_dir, tokmod, mcfg, text)
            tok = tokmod.Tokenizer.from_pretrained(model_dir)
            text_ids = tok.encode(text).ids
            out_b, err_b = builder.communicate(timeout=300)
            assert builder.returncode == 0, err_b[-4000:]
            build = json.loads(out_b.strip().splitlines()[-1])
            t_build = time.perf_counter() - t0
            manifest = read_manifest(art)
            assert build["version"] == manifest.version
            assert [s.name for s in manifest.services] == ["CudaWorker", "Processor",
                                                           "Frontend"]
            yaml_text = _p20_cli("render", art, "--deployment", P20_NAME)
            docs = from_yaml(yaml_text)
            assert docs == render_graph_manifests(manifest, image=DEFAULT_IMAGE,
                                                  deployment=P20_NAME)
            _, line = asyncio.run(store.wait_line("api-store on ", 120))
            at_store = time.perf_counter() - t_phase
            store_url = line.split("api-store on ", 1)[1].strip()
            assert json.loads(_p20_cli("push", art, "--store", store_url)) == {
                "name": P20_NAME, "version": manifest.version}
            _p20_cli("deploy", P20_NAME, manifest.version, "--store", store_url,
                     "--deployment", P20_NAME)
            rec = asyncio.run(client.request(
                f"{store_url}/api/v1/deployments/{P20_NAME}")).json()
            assert rec["manifests_yaml"] == yaml_text, "the store rendered other documents"
            backend = MemoryBackend()
            op = DeploymentOperator(store_dir, backend)
            first = asyncio.run(op.reconcile_all())[P20_NAME]
            second = asyncio.run(op.reconcile_all())[P20_NAME]
            assert first.phase == "Ready" and first.applied == len(docs), first
            assert list(backend.applied[P20_NAME].values()) == docs
            assert (second.applied, second.deleted) == (0, 0), second
            at_op = time.perf_counter() - t_phase
            log(f"[deploy] (a) {smi}: artifact {P20_NAME} version {manifest.version} "
                f"({os.path.getsize(art)} bytes, {len(tarfile.open(art).getnames())} files, "
                f"built in {t_build:.1f} s) rendered to {len(docs)} documents "
                f"({', '.join(d['kind'] + ' ' + d['metadata']['name'] for d in docs)}); pushed, "
                f"deployed; the operator's first pass applied {first.applied} ({first.phase}), "
                f"its second {second.applied}; the store up at {at_store:.1f} s, the operator's "
                f"passes done at {at_op:.1f} s of the phase")

            # The kubelet: the artifact alone, phase 2's build beside it.
            root = os.path.join(tmp, "pod-root")
            with tarfile.open(art) as tar:
                tar.extractall(root, filter="data")
            copied = copy_kernel_build(os.path.join(root, "dynamo_exp_tpu_torch", "_build"))
            http = next(d for d in docs if d["metadata"]["name"] == f"{P20_NAME}-http")
            assert http["spec"]["ports"][0]["targetPort"] == cfg["Frontend"]["port"]
            kube = _Kubelet(docs, root, {f"{P20_NAME}-config": os.path.join(tmp, "etc-dynamo")},
                            cfg)
            t_kube = time.perf_counter()
            deployments = [d for d in docs if d["kind"] == "Deployment"]
            (coord,) = kube.run(deployments[0])
            procs.append(coord)
            asyncio.run(coord.wait_line("coordinator ready on", 120))
            coord_s = time.perf_counter() - t_kube
            for d in deployments[1:]:
                procs += kube.run(d)
            addr = kube.resolve(next(e["value"] for e in deployments[1]["spec"]["template"][
                "spec"]["containers"][0]["env"] if e["name"] == "DYN_COORDINATOR"))
            procs.append(_Proc([sys.executable, "-m", "dynamo_exp_tpu_torch.components.router",
                                "--coordinator", addr, "--workers", "CudaWorker",
                                "--block-size", str(PS)], env, "router"))
            procs.append(_Proc([sys.executable, "-m", "dynamo_exp_tpu_torch.components.metrics",
                                "--coordinator", addr, "--component", f"{P19_NS}.CudaWorker",
                                "--host", "127.0.0.1", "--port", "0", "--scrape-interval",
                                str(P20_SCRAPE_S)], env, "metrics"))
            out = asyncio.run(asyncio.wait_for(_p20_drive(
                np, smi, sh, tok, text_ids, model_dir, addr,
                "http://" + kube.resolve(f"{P20_NAME}-http:{http['spec']['ports'][0]['port']}"),
                procs), timeout=900))
            out["kubelet_s"] = time.perf_counter() - t_kube
            out["pre_kubelet_s"] = t_kube - t_phase
            out["coordinator_s"] = coord_s
            out["copied"] = copied

            # Teardown: the record goes, then every process; the
            # operator's next pass collects every document.
            r = asyncio.run(client.request(f"{store_url}/api/v1/deployments/{P20_NAME}",
                                           "DELETE"))
            assert r.status == 200, r.body
        finally:
            # The components and the pods together, then the coordinator,
            # then the store.
            if builder is not None and builder.poll() is None:
                builder.kill()
                builder.wait()
            t_stop = time.perf_counter()
            for group in (procs[2:], procs[1:2], procs[:1]):
                for p in group:
                    p.terminate()
                for p in group:
                    rcs[p.name] = p.stop()
            stop_s = time.perf_counter() - t_stop
        bad = {n: rc for n, rc in rcs.items() if rc != 0}
        assert not bad, "processes exited non-zero: " + "; ".join(
            f"{n} {rc}:\n{next(p for p in procs if p.name == n).tail(40)}"
            for n, rc in bad.items())
        gone = asyncio.run(op.reconcile_all())
        assert P20_NAME not in gone and backend.applied.get(P20_NAME, {}) == {}, backend.applied
    out["wall_s"] = time.perf_counter() - t_phase
    out["designs"] = {k: out["designs_a"][k] + out["designs_b"][k] for k in out["designs_a"]}
    log(f"[deploy] {smi}: {len(rcs)} processes stopped by SIGTERM in {stop_s:.1f} s, every "
        f"one exit 0 ({', '.join(sorted(rcs))}); the record deleted, the operator's next "
        f"pass collected all {len(docs)} documents; phase 20 wall {out['wall_s']:.1f} s "
        f"(to the kubelet's start {out['pre_kubelet_s']:.1f} s, the coordinator up "
        f"{out['coordinator_s']:.1f} s later, kubelet to the end {out['kubelet_s']:.1f} s; "
        f"{len(copied)} built libraries copied "
        f"into the unpacked tree: {copied})")
    log(json.dumps({"phase20": {k: out[k] for k in (
        "boot_s", "a", "one_at_a_time_s", "b", "designs_a", "designs_b", "overlaps",
        "pre_kubelet_s", "coordinator_s", "kubelet_s", "wall_s")}}))
    return out


# ------------------------------------------------------------ phase 21
# (a): the simulator's pressure harness (the JAX package's
# tests/test_sim.py PRESSURE_CFG): 4 slots over 8 pages of 8 tokens, a
# 0.05 s stall grace, fronted by a 6-in-flight admission controller
# with the shed watermark at 3.
P21_PRESSURE = dict(slots_per_instance=4, pages_per_instance=8, page_size=8,
                    preempt_stall_grace_s=0.05, max_inflight=6, shed_watermark=3,
                    initial_instances=1)
# (b): the contrasting pair's long-prompt target (the JAX package's
# tests/test_tune.py): every request in the 64-128 ISL and OSL buckets.
P21_PAIR_FP = dict(n=48, isl_hist=(0, 0, 0, 48, 0, 0, 0, 0, 0, 0, 0),
                   osl_hist=(0, 0, 0, 48, 0, 0, 0, 0, 0, 0, 0),
                   priority_mix=(0.0, 1.0, 0.0), arrival_rate_rps=8.0)


@dataclass(frozen=True)
class Phase21:
    """Phase 21's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, the tiny preset in place of llama-8b)."""

    device: str = "cuda"
    preset: str = "llama-8b"  # (a), (b): the preset at full width and depth
    kv_dtype: str = "bfloat16"
    small_layers: int = 2  # (b)'s contrasting pair and (c): 2 of its layers
    seeds: tuple = (0, 1, 2)  # (a): overload_burst seeds ...
    burst_n: int = 8  # ... of 8 requests ...
    osl_range: tuple = (6, 12)  # ... of 6-12 tokens, ...
    grace_s: float = 0.05  # ... the stall grace of both the sim and the engine
    prompt_lens: tuple = PROMPT_LENS  # (a)'s fit burst and (c): phase 5's prompts ...
    max_tokens: int = MAX_TOKENS  # ... at 32 tokens
    tune_requests: int = 32  # (b): the burst target's requests ...
    tune_budget: int = 32  # ... sim evaluations of the search ...
    top_k: int = 3  # ... candidates validated live ...
    validate_passes: int = 3  # ... each scored over this many measured passes
    tune_max_model_len: int = 2048 + MAX_TOKENS + PS  # (b)'s artifact holds (c)'s prompts
    timeout_s: float = 600.0  # (b)'s llmctl tune process
    # (c): mixed keys past this many tokens are left out of the prewarm
    # (0: none is; the CPU rehearsal's burst never reaches them).
    prewarm_max_tokens: int = 0


def _p21_llmctl(*argv) -> tuple[int, str, str]:
    """``llmctl`` in this process: (rc, stdout, stderr)."""
    import io

    from dynamo_exp_tpu_torch import llmctl as ctl

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ctl.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _p21_designs() -> dict:
    from dynamo_exp_tpu_torch.ops import ragged_attention as tra

    return dict(tra.KERNEL_LAUNCHES)


def _p21_add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def p21_calibration(torch, pkg, sh: Phase21, mcfg, model) -> dict:
    """(a) The calibration bridge: each seed's ``overload_burst`` through
    the live engine behind the real ``AdmissionController`` and through
    ``ClusterSim`` with the same config: completed and shed counts equal,
    preemptions within 2, no errors. The engine runs its dispatches
    eagerly (``cuda_graphs=False``): a first-use capture stalls the loop
    past the 0.05 s grace, which the sim does not model."""
    from dynamo_exp_tpu_torch.http.admission import AdmissionController, RequestShedError
    from dynamo_exp_tpu_torch.protocols.common import parse_priority
    from dynamo_exp_tpu_torch.runtime.transports.chaos import overload_burst
    from dynamo_exp_tpu_torch.sim import ClusterSim, SimConfig, burst_workload

    p = dict(P21_PRESSURE, preempt_stall_grace_s=sh.grace_s)
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=p["slots_per_instance"], page_size=p["page_size"],
        num_pages=p["pages_per_instance"], max_model_len=128, eos_token_ids=[],
        kv_dtype=sh.kv_dtype, preempt_stall_grace_s=p["preempt_stall_grace_s"],
        cuda_graphs=False,
    )
    eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
    eng.start()
    rows = []
    try:
        for seed in sh.seeds:
            burst = overload_burst(seed, n=sh.burst_n, osl_range=sh.osl_range)
            adm = AdmissionController(max_inflight=p["max_inflight"],
                                      shed_watermark=p["shed_watermark"])

            async def submit(b, adm=adm):
                try:
                    adm.acquire(parse_priority(b.priority))
                except RequestShedError as e:
                    return ("shed", e.status)
                try:
                    req = {"token_ids": list(b.prompt), "priority": parse_priority(b.priority),
                           "stop_conditions": {"max_tokens": b.max_tokens, "ignore_eos": True},
                           "sampling_options": {"temperature": 0.9, "seed": b.seed}}
                    final = None
                    async for item in await eng.generate(req):
                        final = item.get("finish_reason") or final
                    return ("done", final)
                finally:
                    adm.release()

            async def run_burst(burst=burst, submit=submit):
                return await asyncio.wait_for(asyncio.gather(*[submit(b) for b in burst]),
                                              timeout=300)

            before = eng.preempted
            t0 = time.perf_counter()
            results = asyncio.run(run_burst())
            wall = time.perf_counter() - t0
            live = dict(completed=sum(1 for r in results if r == ("done", "length")),
                        shed=sum(1 for r in results if r[0] == "shed"),
                        preemptions=eng.preempted - before, wall_s=wall)
            assert live["completed"] + live["shed"] == len(burst), (seed, results)
            rep = ClusterSim(SimConfig(seed=seed, **p),
                             burst_workload(seed, n=sh.burst_n, osl_range=sh.osl_range)).run()
            sim = dict(completed=rep.completed, shed=rep.shed, preemptions=rep.preemptions,
                       errors=rep.errors)
            log(f"[sim] (a) seed {seed}: live completed {live['completed']} shed "
                f"{live['shed']} preemptions {live['preemptions']} in {wall:.3f} s; sim "
                f"completed {sim['completed']} shed {sim['shed']} preemptions "
                f"{sim['preemptions']} errors {sim['errors']}")
            assert sim["completed"] == live["completed"] and sim["shed"] == live["shed"], (
                seed, live, sim)
            assert sim["errors"] == 0, (seed, sim)
            assert abs(sim["preemptions"] - live["preemptions"]) <= 2, (seed, live, sim)
            rows.append(dict(seed=seed, live=live, sim=sim))
        audit = eng.kv_audit()
    finally:
        eng.stop()
    assert audit["ok"], audit["violations"][:5]
    return dict(seeds=rows)


def p21_fit(torch, np, pkg, sh: Phase21, mcfg, model, tmp: str) -> dict:
    """(a) The service-time fit from spans the engine recorded: phase 5's
    prompts at 32 tokens through a graphed engine (a first burst
    captures, then the burst again with every request traced to a span
    file), then ``llmctl sim --trace-in <the burst as a trace>
    --fit-spans <spans>`` with phase 5's engine shape. Findings, not
    gates: the fitted prefill seconds per token and ITL, the sim's TTFT
    and ITL p50 beside the live burst's."""
    from dynamo_exp_tpu_torch import telemetry as T
    from dynamo_exp_tpu_torch.sim import ServiceTimeModel, SimRequest, save_trace

    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == SEEDED else {}}
        for i, ids in enumerate(phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens))
    ]
    max_len = max(sh.prompt_lens) + sh.max_tokens + PS
    pages = 8 * (-(-max_len // PS))
    ecfg = pkg.engine.EngineConfig(model=mcfg, max_decode_slots=8, page_size=PS,
                                   max_model_len=max_len, num_pages=pages, eos_token_ids=[],
                                   kv_dtype=sh.kv_dtype)
    eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
    spans_path = os.path.join(tmp, "p21_spans.jsonl")

    async def burst(traced: bool):
        async def collect(stream, sent):
            frames, n = [], 0
            async for item in stream:
                if item.get("token_ids"):
                    n += len(item["token_ids"])
                    frames.append(time.perf_counter())
            return dict(ttft=frames[0] - sent,
                        itl=(frames[-1] - frames[0]) / max(n - 1, 1), tokens=n)

        with eng.hold_admission():
            eng.reset_prefix_cache()
            sent = time.perf_counter()
            streams = []
            for r in requests:
                with T.span("http_request") if traced else contextlib.nullcontext():
                    streams.append(eng.submit(r))
        return await asyncio.gather(*(collect(s, sent) for s in streams))

    eng.start()
    try:
        t0 = time.perf_counter()
        asyncio.run(burst(False))
        cold = time.perf_counter() - t0
        T.get_telemetry().configure(spans_path)
        try:
            live = asyncio.run(burst(True))
        finally:
            T.get_telemetry().configure(None)
    finally:
        eng.stop()
    del eng
    assert all(r["tokens"] == sh.max_tokens for r in live), live
    trace_path = os.path.join(tmp, "p21_trace.jsonl")
    save_trace(trace_path, [SimRequest(index=i, arrival_s=0.0, prompt_len=len(r["token_ids"]),
                                       max_tokens=sh.max_tokens)
                            for i, r in enumerate(requests)])
    model_fit = ServiceTimeModel.from_spans([spans_path])
    rc, out, err = _p21_llmctl(
        "sim", "burst", "--trace-in", trace_path, "--fit-spans", spans_path,
        "--slots", "8", "--pages", str(pages), "--page-size", str(PS), "--max-inflight", "64")
    assert rc == 0, err
    rep = json.loads(out)
    assert rep["completed"] == len(requests) and rep["errors"] == 0, rep
    ttfts = sorted(r["ttft"] for r in live)
    itls = sorted(r["itl"] for r in live)
    res = dict(
        prefill_token_s=model_fit.prefill_token_s.median_s,
        prefill_sigma=model_fit.prefill_token_s.sigma,
        itl_s=model_fit.itl_s.median_s, itl_sigma=model_fit.itl_s.sigma,
        live_ttft_p50_s=ttfts[len(ttfts) // 2], live_itl_p50_s=itls[len(itls) // 2],
        sim_ttft_p50_s=rep["ttft_p50_s"], sim_itl_p50_s=rep["itl_p50_s"], cold_s=cold,
    )
    res["ttft_ratio"] = res["sim_ttft_p50_s"] / res["live_ttft_p50_s"]
    res["itl_ratio"] = res["sim_itl_p50_s"] / res["live_itl_p50_s"]
    log(f"[sim] (a) fit from {spans_path}'s spans (phase 5's prompts x {sh.max_tokens}, a "
        f"graphed burst after a capturing one of {cold:.1f} s): prefill "
        f"{res['prefill_token_s'] * 1e6:.3f} us/token (sigma {res['prefill_sigma']:.3f}), "
        f"ITL {res['itl_s'] * 1e3:.3f} ms (sigma {res['itl_sigma']:.3f}); llmctl sim "
        f"--trace-in --fit-spans: TTFT p50 {res['sim_ttft_p50_s']:.4f} s against live "
        f"{res['live_ttft_p50_s']:.4f} s (ratio {res['ttft_ratio']:.3f}), ITL p50 "
        f"{res['sim_itl_p50_s'] * 1e3:.3f} ms against live {res['live_itl_p50_s'] * 1e3:.3f} "
        f"ms (ratio {res['itl_ratio']:.3f})")
    return res


def p21_tune(torch, pkg, sh: Phase21, mcfg, small, small_model, tmp: str) -> dict:
    """(b) ``llmctl tune --top-k 3`` in a subprocess on ``sh.preset`` at
    full depth: rc 0, one journal line a trial, each of the three
    candidates served live on that preset's ``TorchEngine`` through the
    kernels (launches counted in the child), the artifact loads (the CPU
    rehearsal validates one candidate: on the CPU a step's time grows
    with its rows, which the sim's congestion model does not know). Then,
    in this process, the contrasting pair ``[{}, {"max_inflight": 1}]``
    at 2 layers: the sim and the engine both rank the default first,
    tau 1.0."""
    from dynamo_exp_tpu_torch.telemetry.fingerprint import WorkloadFingerprint
    from dynamo_exp_tpu_torch.tune import load_artifact, target_from_fingerprint
    from dynamo_exp_tpu_torch.tune.validate import validate_candidates

    journal, art_path = os.path.join(tmp, "p21_journal.jsonl"), os.path.join(tmp, "p21_art.json")
    argv = [sys.executable, "-m", "dynamo_exp_tpu_torch.llmctl", "tune", "--workload", "burst",
            "--seed", "0", "--requests", str(sh.tune_requests), "--budget",
            str(sh.tune_budget), "--eval-seeds", "1", "--top-k",
            str(sh.top_k), "--validate-passes", str(sh.validate_passes),
            "--preset", sh.preset, "--kv-dtype", sh.kv_dtype, "--max-model-len",
            str(sh.tune_max_model_len), "--journal", journal, "--out", art_path, "--check",
            "--json", "--device", sh.device]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=sh.timeout_s)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, (f"llmctl tune rc {proc.returncode}:\n{proc.stdout[-6000:]}\n"
                                  f"{proc.stderr[-4000:]}")
    summary = json.loads(proc.stdout)
    with open(journal, encoding="utf-8") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    trials = [ln for ln in lines if ln.get("kind") == "trial"]
    assert len(trials) == summary["trials"], (len(trials), summary["trials"])
    v = summary["validation"]
    cands = v["candidates"]
    assert len(cands) == sh.top_k, cands
    designs = {}
    for c in cands:
        live = c["live"]
        assert live["layers"] == mcfg.num_layers and live["device"] == sh.device, live
        if sh.device == "cuda":
            assert live["kernel_launches"]["mixed_tc_bf16"] > 0, live
            assert live["kernel_launches"]["decode_split"] > 0, live
        designs = _p21_add(designs, live["kernel_launches"])
    art = load_artifact(art_path)
    assert art["config_hash"] == summary["config_hash"] and art["manifest"], art.keys()
    log(f"[tune] (b) llmctl tune --workload burst --seed 0 --requests {sh.tune_requests} "
        f"--budget {sh.tune_budget} "
        f"--eval-seeds 1 --top-k {sh.top_k} --preset {sh.preset} --kv-dtype {sh.kv_dtype}: "
        f"rc 0 in "
        f"{wall:.1f} s, {summary['trials']} trials (one journal line each), best "
        f"{summary['best_overrides']} score {summary['best_score']} against the default's "
        f"{summary['default_score']}; validation on {mcfg.num_layers}-layer "
        f"{sh.preset} engines: Kendall tau {v['kendall_tau']}, top-1 "
        f"{'agrees' if v['top1_agreement'] else 'DISAGREES'}; live goodput "
        + ", ".join(f"{c['overrides']} {c['live']['goodput_per_chip_s']} tok/s "
                    f"(completed {c['live']['completed']}, shed {c['live']['shed']}, "
                    f"{c['live']['chip_seconds']} s a pass, passes "
                    f"{c['live']['pass_goodput']} in {c['live']['measured_attempts']} "
                    f"attempts, captures in the scored ones {c['live']['captures_measured']})"
                    for c in cands)
        + f"; sim scores {v['sim_scores']}; launches by kernel {designs}")
    fp = WorkloadFingerprint(**P21_PAIR_FP)
    reset_launches()
    t1 = time.perf_counter()
    pair = asyncio.run(validate_candidates(
        [{}, {"max_inflight": 1}], target_from_fingerprint(fp), seed=5, n=8,
        slo_ttft_s=1e9, slo_itl_s=1e9, device=sh.device, model=small, kv_dtype=sh.kv_dtype,
        llama=small_model))
    pair_designs = _p21_designs()
    log(f"[tune] (b) contrasting pair [{{}}, {{max_inflight: 1}}] at {small.num_layers} "
        f"layers: sim scores {pair['sim_scores']}, live {pair['live_scores']}, tau "
        f"{pair['kendall_tau']}, top-1 {pair['top1_agreement']} in "
        f"{time.perf_counter() - t1:.1f} s; launches by kernel {pair_designs}")
    assert pair["kendall_tau"] == 1.0 and pair["top1_agreement"], pair["candidates"]
    assert pair["sim_scores"][0] > pair["sim_scores"][1], pair["sim_scores"]
    assert pair["live_scores"][0] > pair["live_scores"][1], pair["live_scores"]
    return dict(art_path=art_path, summary=summary, wall_s=wall, tau=v["kendall_tau"],
                top1=v["top1_agreement"], designs=_p21_add(designs, pair_designs),
                pair_tau=pair["kendall_tau"],
                goodput=[c["live"]["goodput_per_chip_s"] for c in cands])


def p21_artifact_boot(torch, np, pkg, sh: Phase21, small, small_model, art_path: str,
                      tmp: str) -> dict:
    """(c) A warm boot from (b)'s artifact at 2 layers: the resolved
    knobs hash to its ``config_hash``; ``prewarm_engine`` with its graph
    manifest against a cache directory holding phase 2's build builds
    nothing; phase 5's prompts at 32 tokens, then again: no capture
    under traffic (``dynamo_compile_seconds`` gains no sample), the same
    tokens."""
    from dynamo_exp_tpu_torch.aot import prewarm_engine
    from dynamo_exp_tpu_torch.telemetry import get_telemetry
    from dynamo_exp_tpu_torch.tune import (
        engine_config_from_artifact,
        load_artifact,
        manifest_from_artifact,
    )
    from dynamo_exp_tpu_torch.tune.space import config_hash, resolved_engine_knobs

    art = load_artifact(art_path)
    ecfg = engine_config_from_artifact(art, model=small)
    assert config_hash(resolved_engine_knobs(ecfg)) == art["config_hash"], art["engine"]
    cache_dir = os.path.join(tmp, "p21_cache")
    copied = copy_kernel_build(cache_dir) if sh.device == "cuda" else []
    eng = pkg.engine.TorchEngine(ecfg, model=small_model, device=sh.device)
    manifest = manifest_from_artifact(art)
    if sh.prewarm_max_tokens:
        manifest.mixed = [k for k in manifest.mixed if k.tokens <= sh.prewarm_max_tokens]
    report = prewarm_engine(eng, manifest, cache_dir=cache_dir)
    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == SEEDED else {}}
        for i, ids in enumerate(phase5_prompts(np, small.vocab_size, sh.prompt_lens))
    ]

    def compile_samples() -> float:
        vals = _family_values(get_telemetry().render().decode())
        return sum(v for (name, _), v in vals.items() if name == "dynamo_compile_seconds_count")

    c0 = compile_samples()
    reset_launches()
    eng.start()
    try:
        runs = []
        for _ in range(2):
            out, wall, _, _ = asyncio.run(direct_burst(eng, requests))
            runs.append(([r["tokens"] for r in out], wall))
        m = eng.metrics()
    finally:
        eng.stop()
    designs = _p21_designs()
    captures = {k: m["dispatch"][k]["compile_misses"] for k in ("window", "mixed")}
    c1 = compile_samples()
    assert report.builds == 0, report
    assert c1 == c0 and not any(captures.values()), (c1 - c0, captures)
    assert runs[0][0] == runs[1][0], "the rerun gave other tokens"
    assert all(len(t) == sh.max_tokens for t in runs[0][0])
    log(f"[aot] (c) boot from the artifact ({art['overrides']}, config_hash "
        f"{art['config_hash']}; {small.num_layers} layers): prewarm {report.variants} window "
        f"+ {report.mixed_variants} mixed variants ({report.graphs} + {report.mixed_graphs} "
        f"graphs) in {report.seconds:.1f} s, builds {report.builds} against a cache dir "
        f"holding phase 2's build ({copied}); phase 5's prompts x {sh.max_tokens}: "
        f"{runs[0][1]:.3f} s, rerun {runs[1][1]:.3f} s, identical tokens; captures under "
        f"traffic {captures}, dynamo_compile_seconds samples +{c1 - c0:.0f}; launches by "
        f"kernel {designs}")
    rc, out, err = _p21_llmctl("aot", "list", "--preset", sh.preset, "--device", sh.device)
    assert rc == 0, err
    found = re.search(r"hash ([0-9a-f]{64})", err)
    assert found and json.loads(out)["engine"], err
    log(f"[aot] (c) llmctl aot list --preset {sh.preset}: rc 0, {err.strip()}")
    return dict(builds=report.builds, prewarm_s=report.seconds,
                graphs=report.graphs + report.mixed_graphs, captures=captures,
                walls=[w for _, w in runs], designs=designs, list_hash=found.group(1))


def p21_q_tile_engines(torch, np, pkg, sh: Phase21, small, small_model) -> dict:
    """(c) The engine at every ``ragged_q_tile`` of the tuning grid (a
    live knob of the artifact): llama-8b at 2 layers boots at q_tile 1,
    4, 8 and 16 and serves phase 5's prompts greedily at 8 tokens (eager
    dispatches), every row ``length``, its mixed dispatches through the
    bf16 mixed kernel at that q tile. Tokens against q_tile 8's are
    counted, not asserted: the q tile moves a row's queries between
    blocks, and bf16 ties may part."""
    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": 8, "ignore_eos": True}}
        for ids in phase5_prompts(np, small.vocab_size, sh.prompt_lens)
    ]
    max_len = max(sh.prompt_lens) + 8 + PS
    out, designs = {}, {}
    for qt in (1, 4, 8, 16):
        ecfg = pkg.engine.EngineConfig(
            model=small, max_decode_slots=8, page_size=PS, max_model_len=max_len,
            num_pages=8 * (-(-max_len // PS)), eos_token_ids=[], kv_dtype=sh.kv_dtype,
            ragged_q_tile=qt, cuda_graphs=False)
        eng = pkg.engine.TorchEngine(ecfg, model=small_model, device=sh.device)
        reset_launches()
        res, wall = run_engine(eng, requests)
        d = _p21_designs()
        assert all(f == "length" and len(t) == 8 for t, f, _ in res), (qt, res)
        if sh.device == "cuda":
            mixed = "mixed_tc_bf16" if sh.kv_dtype == "bfloat16" else "mixed_f32"
            assert d[mixed] > 0 and d["decode_split"] > 0, (qt, d)
        out[qt] = dict(tokens=[t for t, _, _ in res], wall_s=wall, designs=d)
        designs = _p21_add(designs, d)
        del eng
    same = {qt: sum(a == b for a, b in zip(r["tokens"], out[8]["tokens"]))
            for qt, r in out.items()}
    log(f"[q_tile] (c) llama-8b at {small.num_layers} layers, ragged_q_tile 1 / 4 / 8 / 16: "
        + ", ".join(f"q_tile {qt} {r['wall_s']:.3f} s, launches {r['designs']}, rows equal to "
                    f"q_tile 8's {same[qt]}/{len(requests)}" for qt, r in out.items()))
    return dict(same=same, walls={qt: r["wall_s"] for qt, r in out.items()}, designs=designs)


def phase21(torch, np, pkg, tra, smi: str, sh: Phase21 = Phase21(), mcfg=None,
            small=None) -> dict:
    """Phase 21: the cluster simulator and the autotuner against the
    card. (a) ``p21_calibration`` and ``p21_fit`` on ``sh.preset`` at
    full depth (``mcfg``), one set of seed-0 weights; (b) ``p21_tune``;
    (c) ``p21_artifact_boot``, (b)'s contrasting pair and (c) at
    ``small`` (the preset at ``sh.small_layers`` layers). Launches by
    kernel design: (a) in this process, (b) the tune process's
    validation engines plus the pair's, (c) the artifact boot."""
    import tempfile
    from dataclasses import replace

    t_phase = time.perf_counter()
    free(torch, sh.device)
    mcfg = mcfg or pkg.models.PRESETS[sh.preset]
    small = small or replace(mcfg, num_layers=sh.small_layers)
    out = {}
    with tempfile.TemporaryDirectory(prefix="smoke21_") as tmp:
        model = seeded_model(torch, pkg, mcfg, sh.device)
        reset_launches()
        t0 = time.perf_counter()
        out["calibration"] = p21_calibration(torch, pkg, sh, mcfg, model)
        out["fit"] = p21_fit(torch, np, pkg, sh, mcfg, model, tmp)
        out["designs_a"] = _p21_designs()
        out["a_s"] = time.perf_counter() - t0
        del model
        free(torch, sh.device)
        small_model = seeded_model(torch, pkg, small, sh.device)
        t0 = time.perf_counter()
        b = p21_tune(torch, pkg, sh, mcfg, small, small_model, tmp)
        out["designs_b"], out["b_s"] = b.pop("designs"), time.perf_counter() - t0
        out["tune"] = {k: v for k, v in b.items() if k != "summary"}
        t0 = time.perf_counter()
        c = p21_artifact_boot(torch, np, pkg, sh, small, small_model, b["art_path"], tmp)
        qts = p21_q_tile_engines(torch, np, pkg, sh, small, small_model)
        out["designs_c"] = _p21_add(c.pop("designs"), qts.pop("designs"))
        out["c_s"] = time.perf_counter() - t0
        out["boot"], out["q_tiles"] = c, qts
        del small_model
        free(torch, sh.device)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase21] {smi}: (a) {out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s; launches by kernel (a) {out['designs_a']}, (b) "
        f"{out['designs_b']}, (c) {out['designs_c']}")
    log(json.dumps({"phase21": {k: out[k] for k in (
        "calibration", "fit", "tune", "boot", "q_tiles", "designs_a", "designs_b", "designs_c",
        "a_s",
        "b_s", "c_s", "wall_s")}}, default=str))
    return out


# ------------------------------------------------------------ phase 22
@dataclass
class Phase22:
    """Phase 22's sizes: the card's by default; the CPU test rehearses
    it smaller (``device="cpu"``, the tiny preset and a tiny tower)."""

    device: str = "cuda"
    preset: str = "llama-8b"
    # (a): phase 5's burst once more, at full depth, under
    # set_sync_debug_mode("warn").
    prompt_lens: tuple = PROMPT_LENS
    max_tokens: int = MAX_TOKENS
    # (b): LLaVA-1.5's tower (CLIP ViT-L/14-336, 576 patches, feature
    # layer -2) in bf16 before the preset's width at 4 layers.
    vision: object = None  # a VisionConfig; None = vision.CLIP_VIT_L_336
    vision_dtype: str = "bfloat16"
    lm_layers: int = 4
    prompt_len: int = 8
    decode_tokens: int = 8
    tower_reps: int = 5
    prefill_reps: int = 3
    # (c): sp = 2 ranks over gloo, the preset's width at 2 layers, float32.
    ring_sp: int = 2
    ring_layers: int = 2
    ring_tokens: int = 4096
    ring_timeout_s: float = 300.0


def lint_sync_lines() -> tuple[set, tuple]:
    """The host-sync allowlist of the port's lint: every (file, line) of
    a waived host-sync finding's span, and the hot-path zones."""
    from dynamo_exp_tpu_torch.analysis import lint_tree
    from dynamo_exp_tpu_torch.analysis.zones import HOT_PATH_ZONES

    files = sorted(z.path for z in HOT_PATH_ZONES)
    lines = set()
    for f in lint_tree(HERE, rules=["host-sync"], files=files):
        if f.waived:
            lines.update((f.file, ln) for ln in range(f.line, f.end_line + 1))
    return lines, HOT_PATH_ZONES


def check_sync_sites(sites: dict) -> dict:
    """Hold the sync sites a run reported, {(file, line): count}, against
    the lint: every site in a hot-path zone is a waived host-sync line.
    Returns the sites split into zone (waived) and other."""
    from dynamo_exp_tpu_torch.analysis.core import zone_for

    lines, zones = lint_sync_lines()
    hot = {k: n for k, n in sites.items() if zone_for(zones, k[0]) is not None}
    unwaived = sorted(k for k in hot if k not in lines)
    assert not unwaived, f"sync sites in hot-path zones that the lint does not waive: {unwaived}"
    return {"hot": hot, "other": {k: n for k, n in sites.items() if k not in hot},
            "allowlist_lines": len(lines)}


def sync_warn_run(torch, fn, device: str) -> tuple:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, every
    sync warning recorded by the innermost frame of this checkout's port
    on the stack of the thread that raised it (the engine loop's thread
    too: ``warnings.showwarning`` is process-wide). On a card a control
    follows: one ``.item()`` on a thread of its own, which must be
    recorded (the recorder sees other threads' syncs). Returns (fn's
    result, {(file, line): count}, the messages seen, the control's
    warnings)."""
    import threading
    import traceback
    import warnings

    pkg_dir = os.path.join(HERE, "dynamo_exp_tpu_torch") + os.sep
    sites: dict = {}
    messages: set = set()
    control = {"thread": None, "seen": 0}

    def show(message, category, filename, lineno, file=None, line=None):
        if threading.get_ident() == control["thread"]:
            control["seen"] += 1
            return
        messages.add(str(message)[:120])
        site = (filename, lineno)
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(pkg_dir):
                site = (os.path.relpath(fr.filename, HERE), fr.lineno)
                break
        sites[site] = sites.get(site, 0) + 1

    def sync_once():
        control["thread"] = threading.get_ident()
        torch.ones(1, device="cuda").item()

    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*synchroniz.*")
        # Inserted in front of the line above: setting the mode warns
        # that it is a prototype, which is no sync.
        warnings.filterwarnings("ignore", message=".*prototype feature.*")
        warnings.showwarning = show
        if device == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            if device == "cuda":
                t = threading.Thread(target=sync_once)
                t.start()
                t.join(timeout=60)
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    return out, sites, sorted(messages), control["seen"]


def p22_sync_sites(torch, np, pkg, sh: Phase22, mcfg) -> dict:
    """(a) Phase 5's burst on a fresh engine under sync debug "warn":
    the sites, held against the lint's allowlist, and the tokens of
    every request (all 'length')."""
    model = seeded_model(torch, pkg, mcfg, sh.device)
    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": sh.max_tokens, "ignore_eos": True},
         "sampling_options": SEEDED_OPTIONS if i == min(SEEDED, len(sh.prompt_lens) - 1) else {}}
        for i, ids in enumerate(phase5_prompts(np, mcfg.vocab_size, sh.prompt_lens))
    ]
    max_len = max(sh.prompt_lens) + sh.max_tokens + PS
    ecfg = pkg.engine.EngineConfig(
        model=mcfg, max_decode_slots=8, page_size=PS, max_model_len=max_len,
        num_pages=8 * (-(-max_len // PS)),
        kv_dtype="bfloat16" if sh.device == "cuda" else "float32",
    )
    eng = pkg.engine.TorchEngine(ecfg, model=model, device=sh.device)
    reset_launches()
    (out, wall), sites, messages, control = sync_warn_run(
        torch, lambda: run_engine(eng, requests), sh.device)
    if sh.device == "cuda":
        assert control >= 1, "the recorder missed a control .item() on another thread"
    designs = _p21_designs()
    for toks, finish, _ in out:
        assert finish == "length" and len(toks) == sh.max_tokens, (finish, len(toks))
    checked = check_sync_sites(sites)
    del eng, model
    free(torch, sh.device)
    return {"wall_s": wall, "sites": {f"{f}:{ln}": n for (f, ln), n in sites.items()},
            "hot": {f"{f}:{ln}": n for (f, ln), n in checked["hot"].items()},
            "allowlist_lines": checked["allowlist_lines"], "messages": messages,
            "control_warnings": control, "designs": designs}


def _p22_greedy(torch, llama, model, cfg, logits, k, v, table, T: int, n: int, impl: str):
    """The prefill's greedy token, then ``n`` more from T=1 decode steps
    (through the decode kernel when ``impl`` is "kernel")."""
    dev = model.embed.device
    toks = [int(logits.argmax())]
    for i in range(n):
        lg, k, v = llama.forward(
            model, cfg, torch.tensor([[toks[-1]]], device=dev),
            torch.tensor([[T + i]], dtype=torch.int32, device=dev), table, k, v,
            attn_impl=impl)
        toks.append(int(lg[0, -1].argmax()))
    return toks


def p22_vision(torch, np, pkg, tra, sh: Phase22, lm_cfg) -> dict:
    """(b) The CLIP tower's 576 soft tokens and an 8-token prompt through
    one mixed dispatch of ``lm_cfg`` (``soft_token_prefill``: one
    ragged-kernel launch a layer), layer 0's attention held against the
    plain version (``close`` and ``close_to_f32``), the logits against
    the plain path's, ``token_embeds = embed[ids]`` bit-equal to the id
    path, then greedy tokens through the decode kernel, twice."""
    from dataclasses import replace

    from dynamo_exp_tpu_torch.examples.multimodal.components.encode_worker import VisionEncoder
    from dynamo_exp_tpu_torch.examples.multimodal.multimodal_demo import soft_token_prefill
    from dynamo_exp_tpu_torch.models import llama, vision

    dev = torch.device(sh.device)
    vcfg = replace(sh.vision or vision.CLIP_VIT_L_336, projector_dim=lm_cfg.hidden_size)
    vdt = getattr(torch, sh.vision_dtype)
    enc = VisionEncoder(lm_cfg.hidden_size, device=dev, cfg=vcfg, dtype=vdt, seed=0)
    image = np.random.RandomState(22).rand(vcfg.image_size, vcfg.image_size, 3).astype(np.float32)
    pixels = enc.preprocess(image)
    feats = enc.encode(pixels)[0]
    assert feats.shape == (vcfg.num_patches, lm_cfg.hidden_size), feats.shape
    assert torch.isfinite(feats.float()).all()
    out = {"patches": vcfg.num_patches}
    if sh.device == "cuda":
        out["tower_ms"] = _p22_event_ms(torch, lambda: enc.encode(pixels), sh.tower_reps)
    del enc
    model = seeded_model(torch, pkg, lm_cfg, sh.device)
    prompt = [int(t) for t in np.random.RandomState(23).randint(3, lm_cfg.vocab_size,
                                                                 size=sh.prompt_len)]
    orig, first = llama.ragged_paged_attention, []

    def spy(q, k, v, *args, **kw):
        res = orig(q, k, v, *args, **kw)
        first.append((q, k, v, args, kw, res))
        return res

    def prefill(impl):
        return soft_token_prefill(model, lm_cfg, feats, prompt, attn_impl=impl,
                                  reserve=sh.decode_tokens)

    reset_launches()
    llama.ragged_paged_attention = spy
    try:
        logits, k, v, table, T = prefill("kernel")
    finally:
        llama.ragged_paged_attention = orig
    one = dict(tra.KERNEL_LAUNCHES)
    assert T == vcfg.num_patches + sh.prompt_len
    # One dispatch: one attention call a layer, each one kernel launch.
    assert len(first) == lm_cfg.num_layers, len(first)
    if sh.device == "cuda":
        assert one["mixed_tc_bf16"] == lm_cfg.num_layers, one
    # Layer 0's attention, kernel against the plain version on the same
    # inputs (its pool slice holds what layer 0 wrote and read).
    q0, k0, v0, args, kw, got0 = first[0]
    table0, rows0, pos0 = args[:3]
    attn = {n: kw[n] for n in ("num_kv_heads", "sm_scale", "window", "softcap")}

    def plain(q, kc, vc):
        return tra.ragged_paged_attention_ref(q, kc, vc, table0, rows0, pos0, **attn)

    err0 = close(torch, got0, plain(q0, k0, v0), "soft-token prefill, layer 0")
    tight = (close_to_f32(torch, got0, plain, q0, k0, v0, "soft-token prefill, layer 0")
             if q0.dtype == torch.bfloat16 else (err0, 0.0))
    assert tight[1] <= 1.0, f"layer 0 beyond bf16 rounding of float32 plain: {tight}"
    ref_logits = prefill("reference")[0]
    lerr = float((logits - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    assert torch.isfinite(logits).all() and lerr <= 0.05 * scale, (lerr, scale)
    # token_embeds = embed[ids] through the same kernel: bit-equal.
    ids = torch.tensor(prompt, device=dev)
    n = -(-len(prompt) // 8) * 8
    pos = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pos[: len(prompt)] = torch.arange(len(prompt), dtype=torch.int32, device=dev)
    toks = torch.zeros(n, dtype=torch.long, device=dev)
    toks[: len(prompt)] = ids
    emb = torch.zeros((n, lm_cfg.hidden_size), dtype=model.embed.dtype, device=dev)
    emb[: len(prompt)] = model.embed[ids]

    def id_or_soft(**kw):
        kc, vc = llama.init_kv_cache(lm_cfg, 2, 16, device=dev)
        return llama.forward_ragged(
            model, lm_cfg, toks, pos, torch.zeros(n, dtype=torch.int32, device=dev),
            torch.tensor([[1]], dtype=torch.int32, device=dev), kc, vc,
            torch.tensor([len(prompt) - 1], device=dev), attn_impl="kernel", **kw)[0]

    assert torch.equal(id_or_soft(token_embeds=emb), id_or_soft()), "token_embeds != ids"
    greedy = _p22_greedy(torch, llama, model, lm_cfg, logits, k, v, table, T,
                         sh.decode_tokens, "kernel")
    designs = dict(tra.KERNEL_LAUNCHES)
    logits2, k2, v2, table2, _ = prefill("kernel")
    again = _p22_greedy(torch, llama, model, lm_cfg, logits2, k2, v2, table2, T,
                        sh.decode_tokens, "kernel")
    assert again == greedy, (greedy, again)
    if sh.device == "cuda":
        out["prefill_ms"] = _p22_event_ms(torch, lambda: prefill("kernel"), sh.prefill_reps)
    out.update(tokens=T, layer0_err=err0, layer0_ratio=tight[1], logit_err=lerr,
               logit_scale=scale, argmax=[int(logits.argmax()), int(ref_logits.argmax())],
               greedy=greedy, prefill_designs=one, designs=designs)
    del model, k, v, k2, v2
    free(torch, sh.device)
    return out


def _p22_event_ms(torch, fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _p22_ring_rank(rank: int, port: int, sh: Phase22, cfg, out) -> None:
    """One sp rank of (c): ``forward_ring_prefill`` of the whole prompt
    over the ring (gloo; a card's ranks share it), then the same prompt
    prefilled alone by one ``forward_ragged`` dispatch through the
    float32 kernel; this rank's shard of both compared. Puts (rank, ok,
    result or traceback) on ``out``."""
    import traceback

    try:
        sys.path.insert(0, HERE)
        import numpy as np
        import torch

        import dynamo_exp_tpu_torch as pkg
        from dynamo_exp_tpu_torch.models import llama
        from dynamo_exp_tpu_torch.ops import ragged_attention as tra
        from dynamo_exp_tpu_torch.parallel import (
            MultiNodeConfig,
            initialize_multihost,
            rank_layout,
            sp_tp_comms,
        )

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        layout = rank_layout(tp=1, rank=rank, sp=sh.ring_sp)
        comm = initialize_multihost(MultiNodeConfig(), f"127.0.0.1:{port}", layout=layout,
                                    backend="gloo", device=layout.device(sh.device))
        try:
            _, ring = sp_tp_comms(comm, sh.ring_sp, 1)
            dev = comm.device
            model = seeded_model(torch, pkg, cfg, dev.type)
            T = sh.ring_tokens
            ids = np.random.RandomState(24).randint(3, cfg.vocab_size, size=T)
            toks = torch.tensor(ids, device=dev)[None]
            pos = torch.arange(T, device=dev)[None]
            sync(torch, dev.type)
            t0 = time.perf_counter()
            logits, k, v = llama.forward_ring_prefill(model, cfg, toks, pos, ring=ring)
            sync(torch, dev.type)
            wall = time.perf_counter() - t0
            reset_launches()
            pages, n = T // PS, T // sh.ring_sp
            lo = ring.rank * n
            shape = (cfg.num_layers, T, cfg.num_kv_heads, cfg.head_dim_)
            refs = {}
            for impl in ("kernel", "reference"):
                kc, vc = llama.init_kv_cache(cfg, pages + 1, PS, torch.float32, device=dev)
                table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
                want, kc, vc = llama.forward_ragged(
                    model, cfg, toks[0], pos[0].to(torch.int32),
                    torch.zeros(T, dtype=torch.int32, device=dev), table, kc, vc,
                    torch.arange(T, device=dev), attn_impl=impl, q_tile=8)
                refs[impl] = (want[lo : lo + n],
                              *(c[:, 1 : pages + 1].reshape(shape)[:, lo : lo + n]
                                for c in (kc, vc)))
                if impl == "kernel":
                    designs = dict(tra.KERNEL_LAUNCHES)
                del kc, vc, want
            got = logits[0]
            ref = refs["kernel"][0]
            excess = float(((got - ref).abs() - (2e-3 + 1e-3 * ref.abs())).max())

            def by_layer(a, b):
                return [float((a[i] - b[i]).abs().max()) for i in range(cfg.num_layers)]

            mine = (k[:, 0], v[:, 0])
            kv = {name: [by_layer(x, y) for x, y in zip(mine, refs[name][1:])]
                  for name in ("kernel", "reference")}
            gap = [by_layer(x, y) for x, y in zip(refs["kernel"][1:], refs["reference"][1:])]
            res = {"rank": rank, "wall_s": wall, "rotate_s": ring.seconds,
                   "rotations": ring.calls, "logit_err": float((got - ref).abs().max()),
                   "logit_err_plain": float((got - refs["reference"][0]).abs().max()),
                   "logit_excess": excess, "kv_err_kernel": kv["kernel"],
                   "kv_err_plain": kv["reference"], "kv_gap_kernel_plain": gap,
                   "designs": designs, "finite": bool(torch.isfinite(got).all())}
        finally:
            comm.close()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def p22_ring(torch, pkg, sh: Phase22, cfg) -> dict:
    """(c) ``sh.ring_sp`` rank processes (spawned, one card shared over
    gloo), each ``_p22_ring_rank``; every wait has a deadline, and every
    process is stopped."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_p22_ring_rank, args=(r, port, sh, cfg, out), daemon=True)
             for r in range(sh.ring_sp)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + sh.ring_timeout_s
        while len(results) < sh.ring_sp:
            left = deadline - time.monotonic()
            assert left > 0, f"ring ranks {sorted(set(range(sh.ring_sp)) - set(results))} timed out"
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                assert not dead, f"a ring rank exited with {dead[0]}"
                continue
            assert ok, f"ring rank {rank} failed:\n{value}"
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    ranks = [results[r] for r in range(sh.ring_sp)]
    for r in ranks:
        assert r["finite"], r
        assert r["logit_excess"] <= 0, f"ring logits beyond atol 2e-3 + rtol 1e-3: {r}"
        # K/V (k then v, by layer): layer 0 is a function of the prompt
        # alone through the same products, held at atol 1e-5. A deeper
        # layer's K/V carry the float32 rounding of the attention before
        # it, which the residual stream's RMS norm magnifies (at this
        # width and init the two single-rank float32 prefills, kernel and
        # plain, part by up to 6e-5 there): the ring is held within atol
        # 1e-5 of the kernel's prefill beyond that gap.
        for t in range(2):
            errs, gaps = r["kv_err_kernel"][t], r["kv_gap_kernel_plain"][t]
            assert errs[0] <= 1e-5, f"ring layer-0 K/V beyond atol 1e-5: {r}"
            assert all(e <= 1e-5 + g for e, g in zip(errs, gaps)), (
                f"ring K/V beyond atol 1e-5 + the kernel-plain gap: {r}")
        assert r["rotations"] == (sh.ring_sp - 1) * cfg.num_layers, r
    designs = {}
    for r in ranks:
        designs = _p21_add(designs, r["designs"])
    if sh.device == "cuda":
        assert designs["mixed_f32"] == sh.ring_sp * cfg.num_layers, designs
    return {"ranks": ranks, "designs": designs, "spawn_to_done_s": time.perf_counter() - t0}


def phase22(torch, np, pkg, tra, smi: str, sh: Phase22 = Phase22(), mcfg=None) -> dict:
    """Phase 22: (a) ``p22_sync_sites``, (b) ``p22_vision``, (c)
    ``p22_ring``. Launches by kernel design: (a) the engine's, (b) the
    soft-token prefills and decode steps (both runs), (c) both ranks'
    single-rank reference dispatches."""
    from dataclasses import replace

    t_phase = time.perf_counter()
    free(torch, sh.device)
    mcfg = mcfg or pkg.models.PRESETS[sh.preset]
    out = {}
    t0 = time.perf_counter()
    out["a"] = p22_sync_sites(torch, np, pkg, sh, mcfg)
    out["a_s"] = time.perf_counter() - t0
    log(f"[sync] (a) {smi}: phase 5's burst under set_sync_debug_mode('warn') in "
        f"{out['a']['wall_s']:.3f} s, every request 'length': sync sites by count "
        f"{out['a']['sites'] or 'none'}; in hot-path zones {out['a']['hot'] or 'none'}, each "
        f"a waived line of the lint ({out['a']['allowlist_lines']} allowlisted lines); "
        f"warnings {out['a']['messages'] or 'none'}; a control .item() on another thread "
        f"raised {out['a']['control_warnings']} recorded warning(s)")
    t0 = time.perf_counter()
    lm = replace(mcfg, num_layers=sh.lm_layers)
    b = out["b"] = p22_vision(torch, np, pkg, tra, sh, lm)
    out["b_s"] = time.perf_counter() - t0
    timing = (f"tower {b['tower_ms']:.3f} ms an image, prefill {b['prefill_ms']:.3f} ms; "
              if "tower_ms" in b else "")
    log(f"[vision] (b) {smi}: {b['patches']} soft tokens + {sh.prompt_len} prompt tokens "
        f"({b['tokens']}) in one mixed dispatch, launches {b['prefill_designs']}; layer 0 "
        f"max abs err {b['layer0_err']:.3e} ({b['layer0_ratio']:.3f} of the bf16 limit); "
        f"logits vs plain {b['logit_err']:.4e} (scale {b['logit_scale']:.3f}), argmax "
        f"{b['argmax']}; token_embeds = embed[ids] bit-equal; greedy {b['greedy']} equal on "
        f"a rerun; {timing}width {lm.hidden_size}, {lm.num_layers} layers")
    t0 = time.perf_counter()
    rcfg = replace(mcfg, num_layers=sh.ring_layers, dtype="float32")
    c = out["c"] = p22_ring(torch, pkg, sh, rcfg)
    out["c_s"] = time.perf_counter() - t0
    r0 = c["ranks"][0]
    log(f"[ring] (c) {smi}: sp={sh.ring_sp} over gloo, width {rcfg.hidden_size}, "
        f"{rcfg.num_layers} layers, float32, T={sh.ring_tokens}: ring wall by rank "
        f"{[round(r['wall_s'], 4) for r in c['ranks']]} s, rotation "
        f"{[round(r['rotate_s'], 4) for r in c['ranks']]} s "
        f"({r0['rotate_s'] / max(r0['wall_s'], 1e-9):.3f} of rank 0's wall); logits max abs "
        f"err {[r['logit_err'] for r in c['ranks']]} (atol 2e-3 + rtol 1e-3; plain "
        f"{[r['logit_err_plain'] for r in c['ranks']]}) against one forward_ragged "
        f"dispatch through the float32 kernel; K/V by rank, (k, v) by layer: "
        f"{[r['kv_err_kernel'] for r in c['ranks']]} (layer 0 atol 1e-5; deeper within 1e-5 "
        f"+ the kernel-plain gap {[r['kv_gap_kernel_plain'] for r in c['ranks']]}; against "
        f"plain {[r['kv_err_plain'] for r in c['ranks']]}); launches {c['designs']}")
    out["designs_a"], out["designs_b"], out["designs_c"] = (
        out["a"]["designs"], b["designs"], c["designs"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase22] {smi}: (a) {out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s; launches by kernel (a) {out['designs_a']}, (b) "
        f"{out['designs_b']}, (c) {out['designs_c']}")
    log(json.dumps({"phase22": {k: out[k] for k in (
        "a", "b", "c", "a_s", "b_s", "c_s", "wall_s")}}, default=str))
    return out


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
    q_tiles = check_q_tiles(torch, np, tra, flush)
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
        f"the lone greedy request's HTTP text equals its direct-engine tokens decoded; (e) "
        f"a body with no model and no max_tokens got the request template's model and "
        f"{h['template']['completion_tokens']} tokens (max_completion_tokens "
        f"{TEMPLATE['max_completion_tokens']})")
    log(f"[http] launches of the HTTP requests alone {h['launches']}, by kernel "
        f"{h['designs']}: {h['per_burst']} in each (a) burst, {h['rest']} in (b), (c), "
        f"(d) and the lone request")
    log(f"[http] host text work: 2 chat requests templated and encoded in "
        f"{h['chat_preprocess_s'] * 1e3:.2f} ms ({h['chat_prompt_tokens']} tokens); "
        f"(a)'s prompts as text, {h['encode_chars']} chars -> {h['encode_tokens']} tokens, "
        f"encoded in {h['encode_s']:.3f} s")
    t7 = time.perf_counter()
    log(f"[smoke] phases 1-6 in {t7 - t_start:.1f} s")
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
    p16 = phase16(torch, np, pkg, tra, smi)
    log(f"[phase16] in {p16['wall_s']:.1f} s")
    p17 = phase17(torch, np, pkg, tra, smi)
    log(f"[phase17] in {p17['wall_s']:.1f} s")
    p18 = phase18(torch, np, pkg, tra, smi)
    log(f"[phase18] in {p18['wall_s']:.1f} s")
    log(f"[smoke] {smi}: phases 1-18 in {time.perf_counter() - t_start:.1f} s")
    p19 = phase19(torch, np, pkg, tra, smi)
    log(f"[phase19] in {p19['wall_s']:.1f} s")
    p20 = phase20(torch, np, pkg, tra, smi)
    log(f"[phase20] in {p20['wall_s']:.1f} s")
    p21 = phase21(torch, np, pkg, tra, smi)
    log(f"[phase21] in {p21['wall_s']:.1f} s")
    p22 = phase22(torch, np, pkg, tra, smi)
    log(f"[phase22] in {p22['wall_s']:.1f} s")
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
            "launches_moe": p16["designs"][design],
            "launches_sharing_f32": p16["designs_f32"][design],
            "launches_gguf": p17["designs"][design],
            "launches_gguf_dir": p17["designs_dir"][design],
            # Phase 18: rank 0's launches (every rank's are equal).
            "launches_tp2": p18["designs"][design],
            "launches_tp2_f32": p18["designs_f32"][design],
            "launches_tp2_moe": p18["designs_moe"][design],
            # Phase 19: the graph workers' ((a) + (b), both summed; (c)).
            "launches_graph": p19["designs"][design],
            "launches_graph_f32": p19["designs_f32"][design],
            # Phase 20: the rendered fleet's two workers, summed ((a); the
            # third burst of (b)).
            "launches_deploy": p20["designs_a"][design],
            "launches_components": p20["designs_b"][design],
            # Phase 21: (a) calibration and the fit burst; (b) the tune
            # process's three validation engines and the contrasting
            # pair; (c) the boot from the tuned artifact.
            "launches_sim_calibration": p21["designs_a"][design],
            "launches_tune_validation": p21["designs_b"][design],
            "launches_artifact_boot": p21["designs_c"][design],
            # Phase 22: (a) phase 5's burst under sync debug "warn"; (b)
            # the soft-token prefill and its decode steps; (c) the ring
            # ranks' single-rank float32 reference dispatches.
            "launches_sync_warn": p22["designs_a"][design],
            "launches_multimodal": p22["designs_b"][design],
            "launches_ring_reference": p22["designs_c"][design],
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
        # Phase 3's other q tiles (1, 4, 16) through the mixed designs:
        # the error at each case, and q_tile 16's timing at llama-8b's.
        if entry == "ragged_paged_attention":
            dname = "float32" if name.endswith("_f32") else "bfloat16"
            for qt in Q_TILES:
                for case in ("llama8b", "gemma2_d256_softcap_window"):
                    kernels[-1][f"q_tile{qt}_{case}_max_abs_err"] = (
                        q_tiles[f"q_tile{qt}_{case}_{dname}"]["max_abs_err"])
            kernels[-1]["q_tile16"] = {
                k: v for k, v in q_tiles[f"q_tile16_llama8b_{dname}"].items()}
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
