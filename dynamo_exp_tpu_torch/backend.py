"""Backend: the detokenizing post-processor wrapping an execution engine.

Counterpart of ``dynamo_exp_tpu/backend.py``, unchanged in logic: takes
the token-in/token-out engine, detokenizes each streamed token
incrementally, checks stop conditions — including the "jail" that
withholds text which might be the start of a hidden stop sequence —
and maps finish reasons.
"""

from __future__ import annotations

from typing import AsyncIterator

from .protocols.common import BackendInput, FinishReason, LLMEngineOutput
from .runtime.engine import AsyncEngine, AsyncEngineContext, ResponseStream
from .tokenizer import Tokenizer


class StopSequenceJail:
    """Withholds streamed text that may be a prefix of a stop string.

    Hidden stop sequences must never reach the client — including their
    partial beginnings. Text is "jailed" while it could still grow into a
    stop string, released when it diverges, and discarded when a stop
    string completes.
    """

    def __init__(self, stop_sequences: list[str]):
        self._stops = [s for s in stop_sequences if s]
        self._jail = ""

    def feed(self, text: str) -> tuple[str, bool]:
        """Returns (text safe to emit, stop matched)."""
        if not self._stops:
            return text, False
        buf = self._jail + text
        for stop in self._stops:
            idx = buf.find(stop)
            if idx != -1:
                self._jail = ""
                return buf[:idx], True
        # Longest suffix of buf that is a proper prefix of any stop string
        # must stay jailed.
        keep = 0
        for stop in self._stops:
            for k in range(min(len(stop) - 1, len(buf)), 0, -1):
                if buf.endswith(stop[:k]):
                    keep = max(keep, k)
                    break
        if keep:
            self._jail = buf[-keep:]
            return buf[:-keep], False
        self._jail = ""
        return buf, False

    def flush(self) -> str:
        """Release anything still jailed (stream ended without a match)."""
        out, self._jail = self._jail, ""
        return out


class Backend:
    """Engine wrapper: BackendInput -> detokenized LLMEngineOutput stream."""

    def __init__(self, engine: AsyncEngine, tokenizer: Tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer

    async def generate(
        self, request: dict | BackendInput, context: AsyncEngineContext | None = None
    ) -> ResponseStream[dict]:
        ctx = context or AsyncEngineContext()
        binput = (
            request if isinstance(request, BackendInput) else BackendInput.from_dict(request)
        )
        stop = binput.stop_conditions
        stop_ids = set(stop.stop_token_ids)
        engine_stream = await self.engine.generate(binput.to_dict(), ctx)
        decoder = self.tokenizer.decode_stream()
        jail = StopSequenceJail(stop.stop)
        prompt_tokens = len(binput.token_ids)

        async def _gen() -> AsyncIterator[dict]:
            emitted = 0
            finished: FinishReason | None = None
            async for item in engine_stream:
                out = LLMEngineOutput.from_dict(item) if isinstance(item, dict) else item
                if out.finish_reason is not None:
                    finished = FinishReason(out.finish_reason)
                text_parts: list[str] = []
                for tid in out.token_ids:
                    emitted += 1
                    hit_eos = (
                        tid in stop_ids
                        and not stop.ignore_eos
                        and (stop.min_tokens is None or emitted >= stop.min_tokens)
                    )
                    if not hit_eos:
                        piece = decoder.step(tid)
                        if piece is not None:
                            safe, matched = jail.feed(piece)
                            if safe:
                                text_parts.append(safe)
                            if matched:
                                finished = FinishReason.STOP
                                break
                    else:
                        finished = FinishReason.EOS
                        break
                    if stop.max_tokens is not None and emitted >= stop.max_tokens:
                        finished = finished or FinishReason.LENGTH
                        break
                if finished is not None and finished is not FinishReason.STOP:
                    # Generation ended without a stop-string match: release
                    # any text the jail was still holding as a possible
                    # stop-sequence prefix.
                    text_parts.append(jail.flush())
                if text_parts or out.token_ids or finished:
                    yield LLMEngineOutput(
                        token_ids=out.token_ids,
                        text="".join(text_parts) or None,
                        finish_reason=finished,
                        prompt_tokens=prompt_tokens if finished else None,
                        completion_tokens=emitted if finished else None,
                        logprobs=out.logprobs,
                        top_logprobs=out.top_logprobs,
                    ).to_dict()
                if finished is not None:
                    ctx.stop_generating()
                    break
                if ctx.is_stopped:
                    yield LLMEngineOutput(finish_reason=FinishReason.CANCELLED).to_dict()
                    break
            else:
                # Engine stream ended without reporting a finish reason:
                # release jailed text and close the stream cleanly.
                tail = jail.flush()
                yield LLMEngineOutput(
                    text=tail or None,
                    finish_reason=FinishReason.EOS,
                    prompt_tokens=prompt_tokens,
                    completion_tokens=emitted,
                ).to_dict()

        return ResponseStream(_gen(), ctx)
