"""Continuous-batching paged-KV engine on one CUDA device.

Counterpart of ``dynamo_exp_tpu/engine/engine.py`` (``TPUEngine``) for
this slice. A loop thread owns the scheduler, the page manager and the
device state; ``generate()`` (the ``AsyncEngine`` seam) hands it a
``BackendInput`` dict and streams back ``LLMEngineOutput`` dicts.

One loop iteration admits what it can, then dispatches one ragged batch
per sampler partition (greedy rows apart from rows that need the full
penalty/top-k/top-p sampler), in one of two shapes:

- **mixed**: prefill chunks and single decode steps in one flat token
  stream through ``models.llama.forward_ragged``; each row samples at
  its last fed position, and a prompt completing its last chunk samples
  its first token in the same dispatch. With the kernel, every row's
  span is aligned to ``ragged_q_tile`` slots.
- **windowed**: pure decode, a Python loop of ``decode_window`` steps
  of ``models.llama.forward`` at T=1 (the kernel's decode shape). The
  next tokens and positions stay on the device between steps; a row
  parks at position -1 when it samples a stop token, spends its
  max_tokens budget, or reaches its page capacity. The host syncs once
  per window.

Every dispatch is consumed in the iteration that issued it. Left out of
this slice (ROADMAP): chained windows, speculation, logprobs, KV
offload/prefetch/persistence, leases, reclaim, telemetry and the flight
recorder.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import (
    Llama,
    check_supported,
    forward,
    forward_ragged,
    init_kv_cache,
    init_params,
    resolve_attn,
)
from ..ops.ragged_attention import ragged_supported
from ..ops.sampling import apply_penalties, sample_tokens_seeded, stop_token_hit
from ..protocols.common import BackendInput, FinishReason, LLMEngineOutput
from ..runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from .config import EngineConfig
from .kv_manager import KvEvent, KvPageManager
from .scheduler import Scheduler, Sequence, SeqState

log = logging.getLogger(__name__)

# Width of the per-row stop-token set a decode window checks on the device.
STOP_WIDTH = 8


def resolve_attn_impl(cfg: EngineConfig, device: torch.device) -> str:
    """``auto`` is the kernel on CUDA and the plain version on the CPU.
    On CUDA the kernel must take the layout: an unsupported one raises
    rather than quietly serving through the plain version."""
    impl = resolve_attn(cfg.attention_impl, device)
    if impl == "kernel" and device.type == "cuda":
        m = cfg.model
        for q_tile in (1, cfg.ragged_q_tile):
            if not ragged_supported(
                cfg.page_size, m.num_kv_heads, m.head_dim_, cfg.kv_torch_dtype,
                m.num_heads, q_tile,
            ):
                raise ValueError(
                    f"the ragged kernel does not take this layout (D="
                    f"{m.head_dim_}, H={m.num_heads}, Hkv={m.num_kv_heads}, "
                    f"q_tile={q_tile}, kv_dtype={cfg.kv_dtype})"
                )
    return impl


@dataclass
class _RaggedRow:
    """One row of a dispatch: a prefill chunk or a decode step/window."""

    seq: Sequence
    kind: str  # "decode" | "prefill"
    row: int  # per-row array index in the dispatch
    n_valid: int = 0  # decode: window steps the host may keep
    completing: bool = False  # prefill: the prompt finishes this chunk


class TorchEngine(AsyncEngine):
    """Continuous-batching paged-KV engine on one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        model: Llama | None = None,
        device="cuda",
        kv_event_cb: Callable[[KvEvent], None] | None = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        mcfg = cfg.model
        check_supported(mcfg)
        self.attn_impl = resolve_attn_impl(cfg, self.device)
        if model is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            model = init_params(mcfg, gen, self.device)
        self.model = model
        # KV pools [L, P, ps, Hkv*D], written in place by every forward.
        self.k_cache, self.v_cache = init_kv_cache(
            mcfg, cfg.num_pages, cfg.page_size, cfg.kv_torch_dtype, self.device
        )
        self.kv = KvPageManager(
            cfg.num_pages, cfg.page_size, event_cb=kv_event_cb,
            sharing=cfg.prefix_sharing,
        )
        self.sched = Scheduler(cfg, self.kv)
        # Penalty counts by slot; row B is the scratch row padding rows
        # gather from and scatter to.
        self._counts = torch.zeros(
            (cfg.max_decode_slots + 1, mcfg.vocab_size), dtype=torch.int32,
            device=self.device,
        )
        # Seeds for requests that pin none (draws are keyed by seed and
        # position, so a pinned seed reproduces a stream anywhere).
        self._seed_rng = random.Random(seed + 1)
        self._submit_q: queue.Queue[Sequence] = queue.Queue()
        self._wake = threading.Event()
        self._running = False
        self._held = False
        self._thread: threading.Thread | None = None
        self.steps = 0  # forward steps dispatched
        self.wasted_steps = 0  # window steps computed past a row's stop
        self.dispatches = {"mixed": 0, "windowed": 0}

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running or self._held:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="torch-engine-loop", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                log.error("engine loop did not exit within 60s")
                return
            self._thread = None

    @contextlib.contextmanager
    def hold_admission(self):
        """Pause the loop thread and queue what arrives meanwhile; on
        exit the loop's first iteration admits it together, as
        :meth:`submit` before :meth:`start` does, so a burst's schedule
        does not depend on its arrival times. Rows in flight pause too."""
        self.stop()
        if self._thread is not None:
            raise RuntimeError("engine loop did not pause; not holding admission")
        self._held = True
        try:
            yield
        finally:
            self._held = False
            self.start()

    def loop_cpu_seconds(self) -> float:
        """CPU seconds the current loop thread has used since it
        started (0 when it is not running)."""
        t = self._thread
        if t is None or t.ident is None:
            return 0.0
        return time.clock_gettime(time.pthread_getcpuclockid(t.ident))

    def queued(self) -> int:
        """Requests submitted and not yet taken by the loop."""
        return self._submit_q.qsize()

    def reset_prefix_cache(self) -> int:
        """Drop the reusable pages of finished requests, so that a
        repeated prompt is prefilled again (call while the loop is not
        running, e.g. inside :meth:`hold_admission`). Returns the number
        of pages dropped."""
        if self._running:
            raise RuntimeError("reset_prefix_cache needs the loop paused")
        return self.kv.reset_prefix_cache()

    async def generate(
        self, request, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        stream = self.submit(request, context)
        self.start()
        return stream

    def submit(
        self, request, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        """Queue a request and return its stream, without starting the
        loop thread (``generate`` is ``submit`` then ``start``). The
        loop's first iteration admits everything queued before
        :meth:`start` together, so the schedule (and every dispatch
        shape) of such a set does not depend on thread timing. Call
        from a running asyncio loop: the stream is fed through it."""
        ctx = context or AsyncEngineContext()
        binput = (
            request.copy()
            if isinstance(request, BackendInput)
            else BackendInput.from_dict(request)
        )
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        orphaned = threading.Event()

        def emit(tokens: list[int], reason: FinishReason | None) -> None:
            try:
                loop.call_soon_threadsafe(out_q.put_nowait, (tokens, reason))
            except RuntimeError:
                # The caller's event loop has closed: nobody reads this
                # stream any more. The loop thread lives on and cancels
                # the row on its next pass, freeing its slot and pages.
                orphaned.set()

        seed = binput.sampling_options.seed
        seq = Sequence(
            request_id=ctx.id,
            prompt=list(binput.token_ids),
            stop=binput,
            emit=emit,
            is_cancelled=lambda: ctx.is_stopped or orphaned.is_set(),
            submitted_at=time.time(),
            sample_seed=int(seed) if seed is not None else self._seed_rng.getrandbits(31),
        )
        self._submit_q.put(seq)
        self._wake.set()
        prompt_tokens = len(binput.token_ids)

        async def _gen() -> AsyncIterator[dict]:
            completion = 0
            while True:
                tokens, reason = await out_q.get()
                if tokens:
                    completion += len(tokens)
                    yield LLMEngineOutput(token_ids=tokens).to_dict()
                if reason is not None:
                    yield LLMEngineOutput(
                        finish_reason=reason,
                        prompt_tokens=prompt_tokens,
                        completion_tokens=completion,
                    ).to_dict()
                    return

        return ResponseStream(_gen(), ctx)

    def metrics(self) -> dict:
        m = self.sched.metrics()
        m["decode_steps"] = self.steps
        m["decode_wasted_steps"] = self.wasted_steps
        m["dispatches"] = dict(self.dispatches)
        return m

    # ------------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while self._running:
                while True:
                    try:
                        self.sched.submit(self._submit_q.get_nowait())
                    except queue.Empty:
                        break
                if not self.sched.has_work():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                for seq in list(self.sched.slots):
                    if seq is not None and seq.is_cancelled():
                        self.sched.finish(seq, FinishReason.CANCELLED)
                while self.sched.admit_next() is not None:
                    pass
                prefilling = [
                    s for s in self.sched.slots
                    if s is not None and s.state is SeqState.PREFILL
                ]
                if not self._dispatch_ragged(prefilling[: self.cfg.prefill_batch]):
                    # Pool dry / everything stalled: yield briefly.
                    self._wake.wait(timeout=0.001)
                    self._wake.clear()
        except Exception:  # engine death must not hang clients
            log.exception("engine loop crashed; failing in-flight requests")
            self._running = False
            pending = list(self.sched.slots) + list(self.sched.waiting)
            while not self._submit_q.empty():
                pending.append(self._submit_q.get_nowait())
            for seq in pending:
                if seq is not None:
                    seq.emit([], FinishReason.ERROR)
            raise

    def _dispatch_ragged(self, prefill_rows: list[Sequence]) -> bool:
        """Run this iteration's ragged batches, one per sampler
        partition: windowed when the partition is pure decode, mixed
        otherwise. Returns False when nothing could step."""
        cfg = self.cfg
        ps, K = cfg.page_size, cfg.decode_window
        parts: dict[bool, list] = {False: [], True: []}
        for seq in self.sched.slots:
            if seq is None or seq.state is not SeqState.ACTIVE:
                continue
            wpos = len(seq.tokens) - 1  # position of the token being fed
            self.sched.ensure_pages_until(seq, wpos + K - 1)
            cap = min(cfg.max_model_len, len(seq.page_ids) * ps) - 1
            if cap < wpos:
                if wpos // ps >= self.kv.num_pages:
                    # The row's context exceeds the whole pool: no wait
                    # can ever feed its next token here.
                    self.sched.finish(seq, FinishReason.LENGTH)
                continue  # pool dry: the row sits this iteration out
            parts[self._needs_sampler(seq)].append((seq, wpos, cap))
        pf_parts: dict[bool, list[Sequence]] = {False: [], True: []}
        for seq in prefill_rows:
            pf_parts[self._needs_sampler(seq)].append(seq)
        progressed = False
        for fs in (False, True):
            dec, pf = parts[fs], pf_parts[fs]
            if pf:
                self._run_mixed(dec, pf, fs)
            elif dec:
                self._run_windowed(dec, fs)
            progressed = progressed or bool(dec or pf)
        return progressed

    # ------------------------------------------------------------ row helpers
    @staticmethod
    def _needs_sampler(seq: Sequence) -> bool:
        so = seq.stop.sampling_options
        return bool(
            (so.temperature or 0.0) > 0.0
            or so.frequency_penalty
            or so.presence_penalty
            or (so.repetition_penalty or 1.0) != 1.0
        )

    def _stop_gates(self, seq: Sequence, g0: int) -> tuple[int, int]:
        """Window-step gates for a row with ``g0`` tokens generated: EOS
        counts at t >= eos_gate (check_stop's min_tokens rule) and the
        max_tokens budget runs out after the token sampled at
        t == budget_gate."""
        sc = seq.stop.stop_conditions
        eos_gate = max((sc.min_tokens or 0) - g0 - 1, 0)
        max_tokens = sc.max_tokens or self.cfg.default_max_tokens
        return eos_gate, max(max_tokens - g0 - 1, 0)

    def _stop_set(self, seq: Sequence) -> list[int]:
        sc = seq.stop.stop_conditions
        if sc.ignore_eos:
            return []
        stops = list(self.cfg.eos_token_ids) + list(sc.stop_token_ids)
        return stops[:STOP_WIDTH]

    @staticmethod
    def _sampler_arrays(n: int) -> tuple:
        """(seeds, temp, top_k, top_p, freq, pres, rep) for n rows."""
        return (
            np.zeros(n, np.int64), np.zeros(n, np.float32), np.zeros(n, np.int64),
            np.ones(n, np.float32), np.zeros(n, np.float32),
            np.zeros(n, np.float32), np.ones(n, np.float32),
        )

    @staticmethod
    def _row_sampler_args(seq: Sequence, r: int, arrs: tuple) -> None:
        seeds, temp, top_k, top_p, freq, pres, rep = arrs
        so = seq.stop.sampling_options
        seeds[r] = seq.sample_seed & 0x7FFFFFFF
        temp[r] = so.temperature if so.temperature is not None else 0.0
        top_k[r] = so.top_k or 0
        top_p[r] = so.top_p if so.top_p is not None else 1.0
        freq[r] = so.frequency_penalty or 0.0
        pres[r] = so.presence_penalty or 0.0
        rep[r] = so.repetition_penalty or 1.0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---------------------------------------------------------------- windowed
    def _run_windowed(self, part: list, full_sampler: bool) -> None:
        """``decode_window`` decode steps over the rows, feeding each
        step's tokens back on the device; one host sync at the end."""
        cfg, mcfg = self.cfg, self.cfg.model
        ps, K = cfg.page_size, cfg.decode_window
        nb = len(part)
        tokens = np.zeros(nb, np.int64)
        positions = np.full(nb, -1, np.int64)
        max_pos = np.full(nb, -1, np.int64)
        table = np.zeros((nb, cfg.max_pages_per_seq), np.int32)
        slot_map = np.full(nb, cfg.max_decode_slots, np.int64)
        stop_set = np.full((nb, STOP_WIDTH), -1, np.int64)
        eos_gate = np.zeros(nb, np.int64)
        budget_gate = np.full(nb, K, np.int64)
        arrs = self._sampler_arrays(nb)
        rows: list[_RaggedRow] = []
        max_pages = 1
        for r, (seq, wpos, cap) in enumerate(part):
            tokens[r] = seq.last_token()
            positions[r] = wpos
            max_pos[r] = cap
            table[r, : len(seq.page_ids)] = seq.page_ids
            slot_map[r] = seq.slot
            max_pages = max(max_pages, (min(wpos + K, cap + 1) + ps - 1) // ps)
            stops = self._stop_set(seq)
            stop_set[r, : len(stops)] = stops
            eos_gate[r], budget_gate[r] = self._stop_gates(seq, seq.generated)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=min(K, cap - wpos + 1)))

        tok_d, pos_d, max_d = self._dev(tokens), self._dev(positions), self._dev(max_pos)
        table_d, stop_d = self._dev(table), self._dev(stop_set)
        eos_d, budget_d = self._dev(eos_gate), self._dev(budget_gate)
        seeds, temp, top_k, top_p, freq, pres, rep = (self._dev(a) for a in arrs)
        slot_d = self._dev(slot_map)
        ar = torch.arange(nb, device=self.device)
        counts = self._counts[slot_d] if full_sampler else None
        sampled = []
        for t in range(K):
            logits, _, _ = forward(
                self.model, mcfg, tok_d[:, None], pos_d[:, None], table_d,
                self.k_cache, self.v_cache, attn_pages=max_pages,
                attn_impl=self.attn_impl,
            )
            logits = logits[:, 0]
            active = pos_d >= 0
            if full_sampler:
                shaped = apply_penalties(logits, counts, freq, pres, rep)
                nxt = sample_tokens_seeded(shaped, seeds, pos_d, temp, top_k, top_p)
                counts.index_put_((ar, nxt.long()), active.to(torch.int32), accumulate=True)
            else:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            tok_d = torch.where(active, nxt.long(), tok_d)
            # A row leaves the window (position -1, writes dropped) at a
            # stop token past its min-tokens gate, at its max_tokens
            # budget, or at its page/model-length capacity.
            done = (stop_token_hit(nxt.long(), stop_d) & (t >= eos_d)) | (t >= budget_d)
            pos_d = torch.where(active & ~done & (pos_d < max_d), pos_d + 1, -1)
            sampled.append(nxt)
        if full_sampler:
            self._counts[slot_d] = counts
        self.steps += K
        self.dispatches["windowed"] += 1
        self._consume_windowed(rows, torch.stack(sampled).cpu().numpy())

    def _consume_windowed(self, rows: list[_RaggedRow], sampled: np.ndarray) -> None:
        """Emit each row's kept tokens; the host's check_stop is
        authoritative (a row may have computed past its stop)."""
        for e in rows:
            seq = e.seq
            if seq.state is not SeqState.ACTIVE:
                self.wasted_steps += e.n_valid
                continue
            kept: list[int] = []
            reason = None
            for token in sampled[: e.n_valid, e.row]:
                token = int(token)
                kept.append(token)
                seq.tokens.append(token)
                seq.generated += 1
                reason = self.sched.check_stop(seq, token)
                if reason is not None:
                    break
            self.wasted_steps += e.n_valid - len(kept)
            self.sched.register_full_pages(seq)
            seq.emit(kept, None)
            if reason is not None:
                self.sched.finish(seq, reason)

    # ------------------------------------------------------------------ mixed
    def _ragged_align(self) -> int:
        """Each row's span in the flat stream is aligned to the kernel's
        q_tile, so every tile belongs to one row; the plain version
        packs tight."""
        return self.cfg.ragged_q_tile if self.attn_impl == "kernel" else 1

    def _run_mixed(self, dec: list, pf: list[Sequence], full_sampler: bool) -> None:
        """One flat stream carrying each prefill row's next chunk and
        each decode row's fed token; every row samples at its last fed
        position (a prompt's first token from the raw distribution,
        decode tokens through their penalty counts)."""
        cfg, mcfg = self.cfg, self.cfg.model
        ps = cfg.page_size
        B1 = cfg.max_decode_slots + 1
        align = self._ragged_align()
        flat_tokens: list[int] = []
        flat_pos: list[int] = []
        flat_row: list[int] = []
        table = np.zeros((B1, cfg.max_pages_per_seq), np.int32)
        q_last = np.zeros(B1, np.int64)
        pos0 = np.full(B1, -1, np.int64)
        is_decode = np.zeros(B1, np.bool_)
        slot_map = np.full(B1, cfg.max_decode_slots, np.int64)
        arrs = self._sampler_arrays(B1)

        def add_span(toks: list[int], poss: list[int], r: int) -> int:
            """Append one row's span, padded to ``align`` with position
            -1 (writes dropped, scores masked, output zeros)."""
            start = len(flat_tokens)
            pad = (-len(toks)) % align
            flat_tokens.extend(list(toks) + [0] * pad)
            flat_pos.extend(list(poss) + [-1] * pad)
            flat_row.extend([r] * (len(toks) + pad))
            return start

        rows: list[_RaggedRow] = []
        max_pages = 1
        r = 0
        for seq in pf:
            n = min(len(seq.prompt) - seq.prefill_sent, cfg.prefill_chunk)
            start = seq.prefill_sent
            qs = add_span(seq.prompt[start : start + n], range(start, start + n), r)
            seq.prefill_sent = start + n
            table[r, : len(seq.page_ids)] = seq.page_ids
            q_last[r] = qs + n - 1
            # The first token's draw is keyed by the prompt's last
            # position, as a decode step feeding that token would be.
            pos0[r] = start + n - 1
            max_pages = max(max_pages, (seq.prefill_sent + ps - 1) // ps)
            self._row_sampler_args(seq, r, arrs)
            rows.append(
                _RaggedRow(seq, "prefill", r, completing=seq.prefill_sent == len(seq.prompt))
            )
            r += 1
        for seq, wpos, _cap in dec:
            qs = add_span([seq.last_token()], [wpos], r)
            table[r, : len(seq.page_ids)] = seq.page_ids
            q_last[r] = qs
            pos0[r] = wpos
            is_decode[r] = True
            slot_map[r] = seq.slot
            max_pages = max(max_pages, wpos // ps + 1)
            self._row_sampler_args(seq, r, arrs)
            rows.append(_RaggedRow(seq, "decode", r, n_valid=1))
            r += 1

        # Flat padding goes to the scratch row B1 - 1 (at most
        # max_decode_slots rows hold slots).
        tokens = torch.tensor(flat_tokens, dtype=torch.int64, device=self.device)
        positions = torch.tensor(flat_pos, dtype=torch.int32, device=self.device)
        row_of = torch.tensor(flat_row, dtype=torch.int32, device=self.device)
        logits0, _, _ = forward_ragged(
            self.model, mcfg, tokens, positions, row_of, self._dev(table),
            self.k_cache, self.v_cache, self._dev(q_last),
            attn_pages=max_pages, attn_impl=self.attn_impl, q_tile=align,
        )
        if full_sampler:
            seeds, temp, top_k, top_p, freq, pres, rep = (self._dev(a) for a in arrs)
            slot_d, dec_d = self._dev(slot_map), self._dev(is_decode)
            counts = self._counts[slot_d]
            shaped = apply_penalties(logits0, counts, freq, pres, rep)
            tok0 = sample_tokens_seeded(
                torch.where(dec_d[:, None], shaped, logits0),
                seeds, self._dev(pos0), temp, top_k, top_p,
            )
            counts.index_put_(
                (torch.arange(B1, device=self.device), tok0.long()),
                dec_d.to(torch.int32), accumulate=True,
            )
            self._counts[slot_d] = counts
        else:
            tok0 = torch.argmax(logits0, dim=-1)
        self.steps += 1
        self.dispatches["mixed"] += 1
        self._consume_mixed(rows, tok0.cpu().numpy())

    def _consume_mixed(self, rows: list[_RaggedRow], tok0: np.ndarray) -> None:
        for e in rows:
            seq = e.seq
            if e.kind == "prefill":
                if e.completing:
                    self._finish_first_token(seq, int(tok0[e.row]))
                continue
            if seq.state is not SeqState.ACTIVE:
                self.wasted_steps += 1
                continue
            token = int(tok0[e.row])
            seq.tokens.append(token)
            seq.generated += 1
            reason = self.sched.check_stop(seq, token)
            self.sched.register_full_pages(seq)
            seq.emit([token], None)
            if reason is not None:
                self.sched.finish(seq, reason)

    def _finish_first_token(self, seq: Sequence, token: int) -> None:
        """The prompt's first sampled token: start its penalty counts,
        promote the sequence to decode, and emit."""
        seq.first_token_at = time.time()
        seq.state = SeqState.ACTIVE
        self._counts[seq.slot] = 0
        self._counts[seq.slot, token] += 1
        seq.tokens.append(token)
        seq.generated = 1
        self.sched.register_full_pages(seq)
        reason = self.sched.check_stop(seq, token)
        seq.emit([token], None)
        if reason is not None:
            self.sched.finish(seq, reason)
