"""OpenAI-compatible HTTP ingress on ``asyncio`` streams.

Counterpart of ``dynamo_exp_tpu/http/service.py``. The JAX package
serves through aiohttp; the port keeps to the standard library, with a
small HTTP/1.1 reader and writer of its own: request bodies by
``Content-Length`` (``Expect: 100-continue`` answered), keep-alive, and
SSE as ``text/event-stream`` in chunked transfer encoding, ending with
``data: [DONE]``.

Routes: ``POST /v1/chat/completions``, ``POST /v1/completions`` (a list
of prompts fans out into one sub-request each, with re-indexed
choices), ``GET /v1/models``, ``GET /metrics`` (Prometheus text: the
``llm_http_service_*`` families of ``http/metrics.py`` and the process
telemetry registry), ``/health`` and ``/live``. The service always
streams from the engine and folds ``stream=false`` responses. Errors as
the JAX service sends them: 400 for bad JSON, a bad shape or too long a
prompt, 404 for an unknown model, 500 for an engine error (mid-stream:
an SSE ``event: error`` frame). A client that disconnects before its
response is complete kills the request's context, which frees its slot
and pages in the engine.

The priority class (body or nvext ``priority``, else the
``X-Request-Priority`` header; 400 for an invalid spelling) is written
into the forwarded payload, so the engine's preemption order sees it.
With an :class:`~.admission.AdmissionController` the request holds an
in-flight slot for its whole lifetime, its last frame included; a shed
request gets 429 (``request_shed``) or, at the hard cap, 503
(``service_overloaded``), both with ``Retry-After``. A ``timeout_s``
body field or ``X-Request-Timeout-S`` header arms the request's
deadline: the engine reaps it while it waits and finishes it at the
deadline once bound (``finish_reason`` ``error``), and a
``DeadlineExceededError`` raised before the response starts is a 504
``deadline_exceeded``. Behind a router (``out=dyn://``) no live or
healthy instance is a 503 ``service_unavailable`` with ``Retry-After``,
and a resumable stream that broke more often than the router recovers
is a 502 ``bad_gateway``. Chunks carry a cumulative ``seq_index``: one
at or below the emitted watermark is a replayed duplicate of a
mid-stream failover and is dropped (``dynamo_tokens_deduplicated_total``).
Each request is the root ``http_request`` span of its trace, and a
completed one is attributed against the SLO targets
(``telemetry/slo.py``): TTFT from arrival to the first content chunk,
ITL the mean gap after it. The ModelManager gains and loses models as
the ingress's ``ModelWatcher`` (``http/discovery.py``) sees workers come
and go. A ``request_template`` (``protocols/request_template.py``) fills
the fields a body leaves unset before it is parsed.

The HTTP/1.1 reader and writer are ``http/wire.py``'s, which the
port's small JSON and text services (the api-store, the metrics
exporter) share through its :class:`~.wire.PlainServer`.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Any

from ..preprocessor.preprocessor import InvalidRequestError, PromptTooLongError
from ..protocols.aggregator import aggregate_chat_stream, aggregate_completion_stream
from ..protocols.common import parse_priority
from ..protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    CompletionChunk,
    CompletionRequest,
    ModelInfo,
    ModelList,
)
from ..protocols.sse import encode_done, encode_frame
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, AsyncEngineContext, DeadlineExceededError
from ..runtime.push_router import NoInstancesError, RecoveryExhaustedError
from ..telemetry import get_telemetry, span
from .admission import AdmissionController, RequestShedError
from .metrics import CONTENT_TYPE_LATEST, ServiceMetrics
from .wire import _BadRequest, _Connection, _json_response, _Request, _Response

logger = logging.getLogger(__name__)

# Clients hint how soon to retry a 503 (no instances / breaker open):
# instance churn resolves within a lease TTL or breaker cooldown.
RETRY_AFTER_S = "1"


class ModelManager:
    """Per-model engine registry with dynamic attach / detach."""

    def __init__(self):
        self._chat: dict[str, AsyncEngine] = {}
        self._completion: dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completion_model(self, name: str, engine: AsyncEngine) -> None:
        self._completion[name] = engine

    def remove_chat_model(self, name: str) -> None:
        self._chat.pop(name, None)

    def remove_completion_model(self, name: str) -> None:
        self._completion.pop(name, None)

    def chat_engine(self, name: str) -> AsyncEngine | None:
        return self._chat.get(name)

    def completion_engine(self, name: str) -> AsyncEngine | None:
        return self._completion.get(name)

    def model_names(self) -> list[str]:
        return sorted(set(self._chat) | set(self._completion))


def _unavailable(e: Exception) -> _Response:
    return _error_response(503, str(e) or "no instances available", "service_unavailable",
                           headers={"Retry-After": RETRY_AFTER_S})


def _error_response(
    status: int, message: str, err_type: str = "invalid_request_error",
    headers: dict[str, str] | None = None,
) -> _Response:
    return _json_response(
        {"error": {"message": message, "type": err_type, "code": status}}, status, headers
    )


class HttpService:
    def __init__(
        self,
        manager: ModelManager | None = None,
        metrics: ServiceMetrics | None = None,
        host: str = "0.0.0.0",
        port: int = 8080,
        admission: AdmissionController | None = None,
        slo=None,
        request_template=None,
    ):
        self.manager = manager or ModelManager()
        self.metrics = metrics or ServiceMetrics()
        self.host = host
        self.port = port
        # Bounded in-flight work with priority-aware shedding; None
        # admits everything.
        self.admission = admission
        # A telemetry.SloAttribution fed each completed request's TTFT
        # and ITL at this edge; None measures nothing.
        self.slo = slo
        # Server-side defaults for the OpenAI routes (request_template.py).
        self.request_template = request_template
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self._routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._health,
        }

    # --- lifecycle ----------------------------------------------------
    async def start(self) -> int:
        """Start serving; returns the bound port."""
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP service listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # --- connections ----------------------------------------------------
    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    await conn.send(_error_response(e.status, str(e)), keep_alive=False)
                    return
                if req is None:
                    return
                handler = self._routes.get((req.method, req.path))
                if handler is None:
                    known = any(p == req.path for _, p in self._routes)
                    status = 405 if known else 404
                    resp = _error_response(status, f"{req.method} {req.path}: no such route")
                    await conn.send(resp, req.keep_alive)
                elif not await handler(req, conn):
                    return
                if not req.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(ConnectionError, asyncio.CancelledError):
                await writer.wait_closed()

    # --- handlers -------------------------------------------------------
    # Each returns False when the connection must close.
    async def _health(self, req: _Request, conn: _Connection) -> bool:
        body = {"status": "healthy", "models": self.manager.model_names()}
        await conn.send(_json_response(body), req.keep_alive)
        return True

    async def _models(self, req: _Request, conn: _Connection) -> bool:
        listing = ModelList(data=[ModelInfo(id=n) for n in self.manager.model_names()])
        await conn.send(_json_response(listing.to_dict()), req.keep_alive)
        return True

    async def _metrics(self, req: _Request, conn: _Connection) -> bool:
        resp = _Response(200, self.metrics.render(), CONTENT_TYPE_LATEST)
        await conn.send(resp, req.keep_alive)
        return True

    async def _chat(self, req: _Request, conn: _Connection) -> bool:
        return await self._serve_llm(
            req, conn,
            parse=ChatCompletionRequest.from_dict,
            lookup=self.manager.chat_engine,
            chunk_type=ChatCompletionChunk,
            aggregate=aggregate_chat_stream,
            endpoint="chat_completions",
        )

    async def _completions(self, req: _Request, conn: _Connection) -> bool:
        return await self._serve_llm(
            req, conn,
            parse=CompletionRequest.from_dict,
            lookup=self.manager.completion_engine,
            chunk_type=CompletionChunk,
            aggregate=aggregate_completion_stream,
            endpoint="completions",
            expand_batch=_expand_completion_batch,
        )

    async def _serve_llm(
        self, req: _Request, conn: _Connection, parse, lookup, chunk_type, aggregate,
        endpoint: str, expand_batch=None,
    ) -> bool:
        try:
            payload = json.loads(req.body)
            if self.request_template is not None and isinstance(payload, dict):
                payload = self.request_template.apply(payload)
            # Popped before parsing, as the JAX service does.
            timeout_s = _request_timeout_s(payload, req.headers)
            oreq = parse(payload)
            # Canonicalised into the forwarded payload, so a header-only
            # priority reaches the preprocessor and the engine's
            # preemption victim choice.
            priority = _request_priority(oreq, req.headers)
            if isinstance(payload, dict):
                payload["priority"] = priority
        except ValueError as e:  # JSONDecodeError, UnicodeDecodeError too
            await conn.send(_error_response(400, f"invalid request: {e}"), req.keep_alive)
            return True
        engine = lookup(oreq.model)
        if engine is None:
            resp = _error_response(404, f"model {oreq.model!r} not found", "model_not_found")
            await conn.send(resp, req.keep_alive)
            return True
        if self.admission is not None:
            # Above the shed watermark lower classes get 429; at the hard
            # cap everything gets 503. Both carry Retry-After: the
            # request was fine, the service is busy.
            try:
                self.admission.acquire(priority)
            except RequestShedError as e:
                self.metrics.count_shed(oreq.model, endpoint, e.status)
                resp = _error_response(
                    e.status, str(e),
                    "service_overloaded" if e.status == 503 else "request_shed",
                    headers={"Retry-After": str(max(int(e.retry_after_s), 1))},
                )
                await conn.send(resp, req.keep_alive)
                return True
        try:
            return await self._serve_admitted(
                req, conn, oreq, engine, timeout_s, payload=payload, chunk_type=chunk_type,
                aggregate=aggregate, endpoint=endpoint, expand_batch=expand_batch,
                priority=priority,
            )
        finally:
            # Released once the response is complete: in flight covers
            # the request's whole lifetime.
            if self.admission is not None:
                self.admission.release()

    async def _serve_admitted(
        self, req: _Request, conn: _Connection, oreq, engine: AsyncEngine,
        timeout_s: float | None, *, payload, chunk_type, aggregate, endpoint: str,
        expand_batch, priority: int,
    ) -> bool:
        # SLO clock: TTFT and ITL from the request's arrival at this edge.
        t_arrival = time.monotonic()
        lat = {"first": 0.0, "last": 0.0, "tokens": 0}
        sub_payloads = expand_batch(payload) if expand_batch else [payload]
        # One context per sub-request: a finished sub-stream must not stop
        # its batch siblings; a disconnect kills them all.
        ctxs = [AsyncEngineContext() for _ in sub_payloads]
        for c in ctxs:
            c.start_timeout(timeout_s)
        ctx = _FanoutContext(ctxs)
        request_type = "stream" if oreq.stream else "unary"
        # The root span of the request's trace: the engine's stages
        # parent onto it, and log lines emitted meanwhile carry its id.
        with span(
            "http_request", request_id=ctx.id, model=oreq.model, endpoint=endpoint,
            request_type=request_type,
        ) as root, self.metrics.track(oreq.model, endpoint, request_type) as tracker:
            logger.info("request %s: model=%s endpoint=%s type=%s",
                        ctx.id, oreq.model, endpoint, request_type)
            status = None
            try:
                streams = [await engine.generate(p, c) for p, c in zip(sub_payloads, ctxs)]
            except PromptTooLongError as e:
                status, resp = "rejected", _error_response(400, str(e), "context_length_exceeded")
            except InvalidRequestError as e:
                status, resp = "rejected", _error_response(400, str(e), "invalid_request_error")
            except NoInstancesError as e:
                # No live / healthy worker (breaker-open included): transient.
                status, resp = "unavailable", _unavailable(e)
            except DeadlineExceededError as e:
                status, resp = "deadline", _error_response(504, str(e), "deadline_exceeded")
            except Exception as e:
                logger.exception("engine rejected request")
                status, resp = "error", _error_response(500, str(e))
            if status is not None:
                tracker.status = status
                root.set(status=status)
                ctx.kill()
                await conn.send(resp, req.keep_alive)
                return True

            async def typed_chunks():
                for idx, stream in enumerate(streams):
                    # Chunks carry a cumulative ``seq_index``; one at or
                    # below the emitted watermark is a replayed duplicate
                    # of a failover splice and is dropped.
                    high = 0  # emitted watermark (cumulative tokens)
                    last = 0  # the previous chunk's index, arrival order
                    async for item in stream:
                        if oreq.stream:
                            tracker.first_token()
                        chunk = chunk_type.from_dict(item) if isinstance(item, dict) else item
                        si = getattr(chunk, "seq_index", None)
                        if si is not None:
                            if si <= high:
                                get_telemetry().tokens_deduplicated.inc(max(si - last, 0))
                                last = si
                                continue
                            delta = si - high
                            last = high = si
                        else:
                            delta = 1
                        if chunk.choices:
                            # SLO marks: first and last content chunk,
                            # and the chunk's tokens (its seq_index
                            # delta; one for a chunk without one), so a
                            # decode window's chunk counts every token.
                            now = time.monotonic()
                            if not lat["first"]:
                                lat["first"] = now
                            lat["last"] = now
                            lat["tokens"] += max(delta, 1)
                        if idx:
                            for choice in chunk.choices:
                                choice.index = idx
                        yield chunk

            respond = (
                self._stream_response(conn, typed_chunks(), ctx)
                if oreq.stream
                else self._unary_response(conn, aggregate(typed_chunks()), ctx, req.keep_alive)
            )
            serve = asyncio.ensure_future(respond)
            watch = asyncio.ensure_future(conn.watch_disconnect())
            try:
                await asyncio.wait({serve, watch}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                if not serve.done():
                    # Client went away (or the service is stopping): kill
                    # generation now so the engine frees the slot.
                    logger.info("client disconnected; killing request %s", ctx.id)
                    ctx.kill()
                    serve.cancel()
                watch.cancel()
                await asyncio.gather(serve, watch, return_exceptions=True)
            if serve.cancelled() or serve.exception() is not None:
                tracker.status = "disconnect"
                root.set(status="disconnect")
                return False
            status = serve.result()
            if status == "success":
                # Attributed only when the response completed: an errored
                # or abandoned request is not goodput.
                self._record_slo(priority, t_arrival, lat, root)
            else:
                tracker.status = status
                root.set(status=status)
            return not oreq.stream and req.keep_alive

    async def _unary_response(self, conn: _Connection, full, ctx, keep_alive: bool) -> str:
        """Send the folded response; returns the request's status."""
        status = "success"
        try:
            resp = _json_response((await full).to_dict())
        except RecoveryExhaustedError as e:
            # The upstream fleet kept dying mid-generation: a gateway
            # failure, not a client error and not "no instances".
            ctx.kill()
            status, resp = "recovery_exhausted", _error_response(502, str(e), "bad_gateway")
        except NoInstancesError as e:
            ctx.kill()
            status, resp = "unavailable", _unavailable(e)
        except DeadlineExceededError as e:
            ctx.kill()
            status, resp = "deadline", _error_response(504, str(e), "deadline_exceeded")
        except Exception as e:
            logger.exception("request failed")
            ctx.kill()
            status, resp = "error", _error_response(500, str(e))
        await conn.send(resp, keep_alive)
        return status

    async def _stream_response(self, conn: _Connection, chunks, ctx) -> str:
        """SSE in chunked encoding; the connection closes after it.
        Returns the request's status."""
        conn.write_head(
            200,
            {
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Transfer-Encoding": "chunked",
                "Connection": "close",
            },
        )
        status = "success"
        try:
            async for chunk in chunks:
                frame = encode_frame(Annotated.from_data(chunk.to_dict()))
                await conn.send_chunk(frame.encode())
            await conn.send_chunk(encode_done().encode())
        except (ConnectionError, asyncio.CancelledError):
            ctx.kill()
            raise
        except Exception as e:
            logger.exception("stream failed mid-flight")
            ctx.kill()
            status = "error"
            await conn.send_chunk(encode_frame(Annotated.from_error(str(e))).encode())
        await conn.send_chunk(b"")
        return status

    def _record_slo(self, priority: int, t_arrival: float, lat: dict, root) -> None:
        """One completed request into the SLO attribution: TTFT = arrival
        to the first content chunk, ITL = the mean interval after it
        (None for a one-token response: never a violation). The same
        marks stamp the root span (``ttft_s``, ``itl_s``, ``latency_s``,
        ``tokens``, ``priority``)."""
        if not lat["first"]:
            return
        ttft = max(lat["first"] - t_arrival, 0.0)
        itl = None
        if lat["tokens"] > 1:
            itl = max(lat["last"] - lat["first"], 0.0) / (lat["tokens"] - 1)
        root.set(ttft_s=round(ttft, 6), latency_s=round(max(lat["last"] - t_arrival, 0.0), 6),
                 tokens=lat["tokens"], priority=priority)
        if itl is not None:
            root.set(itl_s=round(itl, 6))
        if self.slo is not None:
            self.slo.record(priority, ttft_s=ttft, itl_s=itl)


class _FanoutContext:
    """Kill fan-out over a batch's per-sub-request contexts."""

    def __init__(self, ctxs: list[AsyncEngineContext]):
        self._ctxs = ctxs
        self.id = ctxs[0].id if ctxs else ""

    def kill(self) -> None:
        for c in self._ctxs:
            c.kill()


def _request_priority(oreq: Any, headers: dict[str, str]) -> int:
    """Priority class: the body/nvext ``priority`` field wins over the
    ``X-Request-Priority`` header; absent means ``normal``. An invalid
    spelling raises ``ValueError`` (a 400)."""
    raw = oreq.request_priority()
    if raw is None:
        raw = headers.get("x-request-priority")
    return parse_priority(raw)


def _request_timeout_s(payload: Any, headers: dict[str, str]) -> float | None:
    """Per-request deadline budget: the body's ``timeout_s`` (popped)
    wins over the ``X-Request-Timeout-S`` header; None when neither is
    given. A non-number or a value <= 0 raises ``ValueError`` (a 400),
    as in the JAX service."""
    raw = payload.pop("timeout_s", None) if isinstance(payload, dict) else None
    if raw is None:
        raw = headers.get("x-request-timeout-s")
    if raw is None:
        return None
    try:
        timeout_s = float(raw)
    except (TypeError, ValueError):
        raise ValueError(f"timeout_s must be a number, got {raw!r}") from None
    if timeout_s <= 0:
        raise ValueError("timeout_s must be positive")
    return timeout_s


def _expand_completion_batch(payload: dict) -> list[dict]:
    """Split a multi-prompt completion payload into per-prompt payloads."""
    prompt = payload.get("prompt")
    if isinstance(prompt, list) and prompt and not isinstance(prompt[0], int):
        return [{**payload, "prompt": p} for p in prompt]
    return [payload]


def build_pipeline_engine(mdc, core_engine) -> AsyncEngine:
    """preprocessor -> backend -> core engine, as one OpenAI-level engine."""
    from ..backend import Backend
    from ..preprocessor.preprocessor import OpenAIPreprocessor
    from ..runtime.pipeline import build_pipeline

    pre = OpenAIPreprocessor(mdc)
    backend = Backend(core_engine, pre.tokenizer)
    return build_pipeline([pre], backend)
