"""HTTP serving front-end: ``/generate``, ``/score``, ``/healthz``,
``/metrics``, ``/trace``.

Port of ``horovod_tpu/serve/server.py``: ``ThreadingHTTPServer`` with
HTTP/1.1 keep-alive and an explicit Content-Length on every buffered
response, Nagle off, daemon handler threads, and a ``/generate`` handler
thread that parks in ``Request.result()`` (or drains the request's
token stream) while the engine threads decode.

``/generate`` fields: ``tokens``, ``max_new_tokens``, ``eos_id``,
``timeout_s`` (or ``X-Request-Timeout-S``), ``qos`` (or ``X-QoS-Tier``),
``tenant`` (or ``X-Tenant-Id``), the sampling fields (``temperature``,
``top_k``, ``top_p``, ``n``, ``seed``), ``model`` (a resident variant,
``serve/registry.py``), ``logprobs: k`` (per-token logprobs with the
top k), ``schema`` (grammar-constrained decoding, ``serve/structured.py``;
needs ``eos_id``) and ``stream`` (or ``Accept: text/event-stream``):
Server-Sent Events over chunked transfer, one ``token`` event per
published token (``logprobs`` riding along when asked) and one terminal
``done`` event carrying the buffered body's outcome fields, or ``error``.
``POST /score`` answers the per-token logprobs of ``tokens`` under a
model (teacher-forced, no decoding; ``top_logprobs`` up to 16).

Status mapping:

* 200 — tokens generated (buffered JSON): ``tokens``, and for n > 1
  ``n`` and ``completions`` (one token list per sample, sample 0 equal
  to ``tokens``); the effective ``seed`` is echoed on every response,
  so replaying it reproduces a sampled answer; ``finish_reason``
  (``stop`` | ``length`` | ``grammar``) and ``logprobs`` when asked;
* 400 — malformed body, a field the request or the engine refuses (a
  sampling field ``validate_params`` refuses, an unsupported schema
  keyword, a schema without ``eos_id``, ``logprobs`` below 1, an
  unknown model, a prompt too long) — a streamed request that fails
  before its first byte answers the same buffered 400;
* 503 + ``Retry-After`` — shed: every healthy queue is full, no healthy
  replica (holding the model) exists, or the server is draining;
* 504 — the request's own deadline expired (queued or decoding).  After
  a stream's first byte, a failure is a terminal ``error`` event with
  the same code; a client that hangs up mid-stream cancels its sequence
  in the engine (outcome ``client_gone``).

Every 503 and 504 carries ``Retry-After`` (the load-aware hint, capped
by the client's remaining budget) and, when the client gave a budget,
``X-Deadline-Remaining-S``; a shed before any ``Request`` exists (the
drain refusal) reads the budget from ``X-Request-Timeout-S``.

Request tracing (``obs/``): an inbound ``X-Trace-Id`` continues the
upstream hop's trace while a tracer is installed (the upstream made the
sampling decision), else ``HVD_TRACE_SAMPLE`` rolls; the decision rides
the request into the engine and is never rolled again.  Every response
of a traced request carries ``X-Trace-Id`` and ``X-Span-Id`` under one
``http-handle`` root span; an untraced request echoes a well-formed
inbound ``X-Trace-Id``.  ``GET /trace`` serves the recent sampled span
trees.  A ``controller=`` (``serve/controller.py``) starts after the
scheduler and stops before it.

``python -m horovod_tpu_torch.serve`` runs ``run_commandline``
(``--autoscale`` or ``HVD_SERVE_CTL_ENABLE=1`` runs the controller).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..faultline import runtime as _faultline
from ..obs import tracing as _obs
from ..utils import get_logger
from .batcher import DeadlineExceededError, QueueFullError, Request
from .metrics import ServeMetrics
from .replica import NoHealthyReplicaError, ReplicaScheduler
from .streaming import (CHUNK_TERMINATOR, TokenStream, chunk_frame,
                        encode_sse, error_status_for, wants_stream)


class DrainingThreadingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` + graceful drain: ``begin_drain()`` makes
    handlers refuse new work (503 + ``Connection: close``), ``wait_idle()``
    blocks until every in-flight handler has answered.

    The listen backlog is 128, not ``socketserver``'s 5 (the JAX
    package's server keeps 5): a burst of more than ~6 connections
    overflows a backlog of 5, the kernel drops the extra SYNs, and each
    of those clients waits out a 1 s retransmit before it is even
    accepted.  The router opens one connection per forward, so a burst
    of concurrent requests through it is exactly such a burst."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()

    def request_began(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()

    def request_ended(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def begin_drain(self) -> None:
        self.draining = True

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        return self._idle.wait(timeout)


def arm_signal_event() -> threading.Event:
    """Install SIGTERM/SIGINT handlers that set (and return) an event,
    before the readiness banner prints."""
    import signal

    evt = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda signum, frame: evt.set())
        except ValueError:  # pragma: no cover - not the main thread
            break
    return evt


def serve_until_signal(drain_fn, evt: threading.Event) -> int:
    """Park until SIGTERM/SIGINT, then drain-then-exit 0."""
    try:
        while not evt.wait(0.5):
            pass
    finally:
        drain_fn()
    return 0


class _ServeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    #: The active request's trace context, set per POST: every reply,
    #: 200 and the 400/503/504 sheds alike, echoes its trace id.
    _trace_ctx = None
    _trace_echo = None  # inbound X-Trace-Id when untraced: still echoed

    def log_message(self, fmt, *args):
        get_logger().debug("serve: " + fmt % args)

    def _trace_id(self) -> Optional[str]:
        return (self._trace_ctx.trace_id if self._trace_ctx is not None
                else self._trace_echo)

    def _trace_headers(self) -> None:
        tid = self._trace_id()
        if tid is not None:
            self.send_header("X-Trace-Id", tid)
            if self._trace_ctx is not None:
                self.send_header("X-Span-Id", self._trace_ctx.span_id)

    def _reply(self, code: int, body: bytes,
               content_type: str = "application/json",
               extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self._trace_headers()
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, extra_headers=()) -> None:
        self._reply(code, json.dumps(obj).encode(),
                    extra_headers=extra_headers)

    def _retry_after_s(self) -> int:
        """Load-aware ``Retry-After``: fleet queue depth × the recent
        per-request service time over the healthy replicas, clamped to
        [1, ``HVD_SERVE_RETRY_AFTER_CAP_S``]."""
        metrics = self.server.metrics
        depth = sum(max(d, 0) for d in metrics._queue_depths().values())
        svc_s = metrics.recent_service_s()
        if depth <= 0 or svc_s <= 0.0:
            return 1
        healthy = sum(1 for r in self.server.scheduler.fleet()
                      if r.state == "healthy")
        cap = int(os.environ.get("HVD_SERVE_RETRY_AFTER_CAP_S", "8"))
        hint = -(-depth * svc_s // max(healthy, 1))
        return max(1, min(int(hint), max(cap, 1)))

    def _header_budget_s(self) -> Optional[float]:
        """The client budget visible at the HTTP layer alone, the
        ``X-Request-Timeout-S`` header: a shed before any Request exists
        (the drain refusal) still clamps its ``Retry-After`` by it."""
        raw = self.headers.get("X-Request-Timeout-S")
        try:
            budget = float(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None
        return budget if budget is not None and budget > 0 else None

    def _budget_headers(self, request=None) -> tuple:
        """503/504 headers: ``Retry-After`` capped by the client's
        remaining budget, which rides ``X-Deadline-Remaining-S``.
        Without a Request, the header budget stands in."""
        hint = self._retry_after_s()
        remaining = (request.remaining() if request is not None
                     else self._header_budget_s())
        if remaining is None:
            return (("Retry-After", str(hint)),)
        return (("Retry-After", str(min(hint, int(remaining)))),
                ("X-Deadline-Remaining-S", f"{remaining:.3f}"))

    @staticmethod
    def _safe_id(value):
        """Inbound trace / span ids are client input echoed into headers
        and forwarded onto KV requests: a sane id alphabet only (no CRLF
        header injection, no non-ASCII); anything else counts as
        absent."""
        if value and len(value) <= 128 and \
                all(c.isascii() and (c.isalnum() or c in "-_.")
                    for c in value):
            return value
        return None

    def do_GET(self):
        # Keep-alive reuses one handler instance across requests: the
        # per-request trace state resets.
        self._trace_ctx = None
        self._trace_echo = self._safe_id(self.headers.get("X-Trace-Id"))
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            health = self.server.scheduler.healthz()
            # The controller's brownout rung and the drain state ride the
            # health answer: the router's active poller reads them.
            health["brownout_level"] = self.server.metrics.brownout_level
            health["draining"] = bool(getattr(self.server, "draining",
                                              False))
            code = 200 if health["status"] != "unserving" else 503
            self._reply_json(code, health)
        elif path == "/metrics":
            self._reply(200, self.server.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")
        elif path == "/trace":
            # The sampled request span trees, newest first.
            tracer = _obs.TRACER
            self._reply_json(200, {
                "enabled": tracer is not None,
                "sample": tracer.sample if tracer is not None else 0.0,
                "traces": (tracer.recent_traces()
                           if tracer is not None else []),
            })
        else:
            self._reply_json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        # Trace ingress: an inbound X-Trace-Id continues the upstream
        # hop's trace (it made the sampling decision), otherwise
        # HVD_TRACE_SAMPLE decides.  Every POST outcome, the drain
        # refusal included, answers under ONE http-handle root span.
        tracer = _obs.TRACER
        hdr_tid = self._safe_id(self.headers.get("X-Trace-Id"))
        self._trace_echo = hdr_tid
        ctx = None
        if tracer is not None and (hdr_tid is not None
                                   or tracer.should_sample()):
            ctx = tracer.new_context(
                trace_id=hdr_tid,
                parent=self._safe_id(self.headers.get("X-Parent-Span")))
        self._trace_ctx = ctx
        if ctx is None:
            self._route_post(None)
            return
        t0 = time.monotonic()
        token = _obs.push(ctx)
        status = 500  # when the handler raises before replying
        try:
            status = self._route_post(ctx)
        finally:
            _obs.pop(token)
            try:
                tracer.emit_span(
                    ctx, "http-handle", t0, time.monotonic(), "server",
                    args={"status": status}, root=True)
            except Exception:
                pass  # tracing must never take down the HTTP plane

    def _route_post(self, ctx) -> int:
        """The POST body; returns the status it answered.  The drain
        refusal (503 + ``Connection: close``, ``Retry-After`` clamped by
        the header budget) answers outside began/ended, so it never
        holds the drain's idle-wait."""
        if getattr(self.server, "draining", False):
            self._shed_log("draining", None, "refused: draining")
            self._reply_json(
                503, {"error": "draining: server is shutting down"},
                extra_headers=tuple(self._budget_headers())
                + (("Connection", "close"),))
            return 503
        self.server.request_began()
        try:
            path = self.path.split("?", 1)[0]
            if path == "/generate":
                return self._handle_generate(ctx)
            if path == "/score":
                return self._handle_score()
            self._reply_json(
                404, {"error": f"POST /generate or /score, not {path}"})
            return 404
        finally:
            self.server.request_ended()

    def _shed_log(self, outcome: str, request, exc) -> None:
        """Shed / error forensics line carrying the trace id, so a
        client's retry correlates with the shed that caused it."""
        get_logger().debug(
            "serve: outcome=%s request=%s trace_id=%s (%s)", outcome,
            getattr(request, "request_id", "-"), self._trace_id() or "-",
            exc)

    def _known_model(self, model: str) -> bool:
        registry = self.server.registry
        if registry is not None:
            return registry.has(model)
        return any(model in r.engine._adapters
                   for r in self.server.scheduler.fleet())

    def _handle_generate(self, ctx) -> int:
        """The /generate body; returns the status it answered."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            prompt = payload["tokens"]
            if not isinstance(prompt, list) or not prompt:
                raise ValueError("'tokens' must be a non-empty list")
            timeout_s = payload.get("timeout_s")
            if timeout_s is None:
                header = self.headers.get("X-Request-Timeout-S")
                timeout_s = float(header) if header is not None else None
            if timeout_s is not None:
                timeout_s = float(timeout_s)  # Request rejects <= 0
            qos = payload.get("qos")
            if qos is None:
                qos = self.headers.get("X-QoS-Tier") or "latency"
            tenant = payload.get("tenant")
            if tenant is None:
                tenant = self.headers.get("X-Tenant-Id") or "default"
            # ``model`` selects a resident variant; a model unknown
            # everywhere is the caller's error (400, here, before
            # submit); known but with every holder dead is a 503 from
            # routing.
            model = payload.get("model")
            if model is not None:
                model = str(model)
                if not self._known_model(model):
                    raise ValueError(f"unknown model {model!r}")
            # The schema compiles here first, so an unsupported keyword
            # answers 400 at once; the engine compiles it again against
            # the model's vocabulary.
            schema = payload.get("schema")
            if schema is not None:
                from .structured import parse_schema
                parse_schema(schema)
                if payload.get("eos_id") is None:
                    raise ValueError(
                        "schema requires eos_id (EOS marks document "
                        "completion at accepting states)")
            request = Request(
                prompt,
                max_new_tokens=int(payload.get("max_new_tokens", 16)),
                eos_id=payload.get("eos_id"),
                timeout_s=timeout_s,
                request_id=payload.get("request_id"),
                temperature=payload.get("temperature", 0.0),
                top_k=payload.get("top_k"),
                top_p=payload.get("top_p", 1.0),
                n=payload.get("n", 1),
                seed=payload.get("seed"),
                qos=str(qos).strip().lower(),
                tenant=str(tenant),
                model=model,
                stream=wants_stream(payload, self.headers),
                logprobs=payload.get("logprobs"),
                schema=schema)
        except (KeyError, TypeError, ValueError) as e:
            self._shed_log("bad_request", None, e)
            self._reply_json(400, {"error": str(e)})
            return 400
        # Before submit (admission may be instant).  The front end OWNS
        # the sampling decision: ctx None means "rolled and lost" (or no
        # tracer), and the scheduler must not roll again.
        request.trace = ctx
        request._sampling_decided = True
        if request.stream:
            # The sink attaches BEFORE submit: the engine's first
            # publish may beat this thread back from submit().
            request.sink = TokenStream(
                logprobs=request.logprobs is not None)
        try:
            t_route = time.monotonic()
            replica = self.server.scheduler.submit(request)
            if ctx is not None and _obs.TRACER is not None:
                try:
                    _obs.TRACER.emit_span(
                        ctx, "route", t_route, time.monotonic(), "server",
                        args={"replica": replica.replica_id})
                except Exception:
                    pass
            if request.stream:
                return self._stream_response(request)
            tokens = request.result(timeout=self.server.request_timeout_s)
        except (QueueFullError, NoHealthyReplicaError) as e:
            self._shed_log("shed", request, e)
            self._reply_json(503, {"error": str(e)},
                             extra_headers=self._budget_headers(request))
            return 503
        except (DeadlineExceededError, TimeoutError) as e:
            self._shed_log("expired", request, e)
            self._reply_json(504, {"error": str(e)},
                             extra_headers=self._budget_headers(request))
            return 504
        except Exception as e:  # engine-side failure — surfaced, not hung
            self._shed_log("error", request, e)
            self._reply_json(500, {"error": str(e)})
            return 500
        body = self._outcome_body(request)
        body["tokens"] = tokens
        if request.n > 1:
            body["n"] = request.n
            body["completions"] = request.samples
        self._reply_json(200, body)
        return 200

    @staticmethod
    def _outcome_body(request: Request) -> dict:
        """The outcome fields shared verbatim by the buffered 200 body and
        the streamed ``done`` event: one builder, so "token events +
        done event == buffered response" holds by construction."""
        ttft_ms = None
        if request.first_token_at is not None:
            ttft_ms = round(
                (request.first_token_at - request.submitted_at) * 1e3, 3)
        body = {
            "request_id": request.request_id,
            "replica": request.replica_id,
            "requeues": request.requeues,
            "ttft_ms": ttft_ms,
            "seed": request.seed,
            "qos": request.qos,
            "tenant": request.tenant,
            "finish_reason": request.finish_reason,
            "usage": {
                "prompt_tokens": len(request.prompt),
                "completion_tokens": len(request.generated),
                "total_tokens":
                    len(request.prompt) + len(request.generated),
            },
        }
        if request.model is not None:
            body["model"] = request.model
        if request.token_logprobs is not None:
            body["logprobs"] = request.token_logprobs
        return body

    # -- streaming (serve/streaming.py) --------------------------------------

    def _write_stream_frame(self, request: Request, data: bytes) -> bool:
        """One chunked-transfer write, the ``stream.emit`` fault point
        consulted first: ``slow-client`` stalls this handler (the sink's
        bounded queue coalesces upstream), ``stream-disconnect`` raises
        the BrokenPipeError a real hangup gives.  False on a dead socket
        — the caller cancels the request in the engine."""
        try:
            for f in _faultline.fire("stream.emit", request.request_id):
                if f.kind == "slow-client":
                    time.sleep(f.param or 0.05)
                elif f.kind == "stream-disconnect":
                    raise BrokenPipeError(
                        "faultline: stream-disconnect injected")
            self.wfile.write(data)
            self.wfile.flush()
            return True
        except OSError as e:  # BrokenPipeError, ConnectionResetError
            self._shed_log("client_gone", request, e)
            return False

    def _stream_response(self, request: Request) -> int:
        """The /generate answer as SSE over chunked transfer.  A failure
        BEFORE the first byte answers buffered JSON (400/503/504/500, as
        the buffered path); after it, the stream ends with a terminal
        ``error`` event carrying the same code.  A dead client socket at
        any write cancels the sequence (``Request.cancel``: slot and
        blocks freed, outcome ``client_gone``; the root span reads 499).
        The engine lock is never held here: events come from the
        request's TokenStream.  Returns the status the root span
        records."""
        sink = request.sink
        deadline = time.monotonic() + self.server.request_timeout_s
        first = sink.next_event(timeout=self.server.request_timeout_s)
        if first is None:
            first = ("error", TimeoutError(
                f"{request.request_id} server cap "
                f"({self.server.request_timeout_s:.0f}s) expired before "
                f"the first token"))
        if first[0] == "error":
            exc = first[1]
            status = error_status_for(exc)
            if status == 504 and not isinstance(exc, DeadlineExceededError):
                request.cancel("server_cap")
            self._shed_log({503: "shed", 504: "expired"}.get(status, "error"),
                           request, exc)
            extra = (self._budget_headers(request)
                     if status in (503, 504) else ())
            self._reply_json(status, {"error": str(exc)},
                             extra_headers=extra)
            return status
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        # A body of unknown length owns its connection: no keep-alive.
        self.send_header("Connection", "close")
        self._trace_headers()
        self.end_headers()
        ev = first
        try:
            while True:
                kind, data = ev
                if kind == "token":
                    if not self._write_stream_frame(
                            request, chunk_frame(encode_sse("token", data))):
                        request.cancel()
                        return 499
                elif kind == "done":
                    body = self._outcome_body(request)
                    body["stream"] = sink.counters()
                    ok = self._write_stream_frame(
                        request, chunk_frame(encode_sse("done", body))
                        + CHUNK_TERMINATOR)
                    return 200 if ok else 499
                else:  # ("error", exc): a terminal failure mid-stream
                    status = error_status_for(data)
                    self._shed_log(
                        {503: "shed", 504: "expired"}.get(status, "error"),
                        request, data)
                    ok = self._write_stream_frame(request, chunk_frame(
                        encode_sse("error", {"error": str(data),
                                             "code": status}))
                        + CHUNK_TERMINATOR)
                    return status if ok else 499
                remaining = deadline - time.monotonic()
                ev = (sink.next_event(timeout=remaining)
                      if remaining > 0 else None)
                if ev is None:
                    # The server's cap expired mid-stream: a terminal 504
                    # event, and the engine reaps the sequence.
                    request.cancel("server_cap")
                    exc = TimeoutError(
                        f"{request.request_id} server cap "
                        f"({self.server.request_timeout_s:.0f}s) expired "
                        f"mid-stream")
                    self._shed_log("expired", request, exc)
                    ok = self._write_stream_frame(request, chunk_frame(
                        encode_sse("error", {"error": str(exc),
                                             "code": 504}))
                        + CHUNK_TERMINATOR)
                    return 504 if ok else 499
        finally:
            self.server.metrics.count_stream(sink.counters())

    # -- /score ------------------------------------------------------------------

    def _handle_score(self) -> int:
        """POST /score: per-token logprobs of ``tokens`` under the model,
        teacher-forced through the paged pipeline
        (``InferenceEngine.score_tokens``), on the least loaded healthy
        replica holding the model; position 0 scores null."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            tokens = payload["tokens"]
            if not isinstance(tokens, list) or not tokens:
                raise ValueError("'tokens' must be a non-empty list")
            tokens = [int(t) for t in tokens]
            top = int(payload.get("top_logprobs", 0))
            if not 0 <= top <= 16:
                raise ValueError(
                    f"top_logprobs must be in [0, 16], got {top}")
            model = payload.get("model")
            if model is not None:
                model = str(model)
        except (KeyError, TypeError, ValueError) as e:
            self._shed_log("bad_request", None, e)
            self._reply_json(400, {"error": str(e)})
            return 400
        target = None
        for r in self.server.scheduler.fleet():
            if r.state != "healthy":
                continue
            if model is not None and model not in r.engine._adapters:
                continue
            if target is None or r.engine.load() < target.engine.load():
                target = r
        if target is None:
            e = NoHealthyReplicaError(
                f"no healthy replica holds model {model!r}"
                if model is not None else "no healthy replica")
            self._shed_log("shed", None, e)
            self._reply_json(503, {"error": str(e)},
                             extra_headers=self._budget_headers())
            return 503
        try:
            entries = target.engine.score_tokens(tokens, model=model,
                                                 top=top)
        except (KeyError, ValueError) as e:
            self._shed_log("bad_request", None, e)
            self._reply_json(400, {"error": str(e)})
            return 400
        except Exception as e:
            self._shed_log("error", None, e)
            self._reply_json(500, {"error": str(e)})
            return 500
        body = {"tokens": tokens, "logprobs": entries,
                "replica": target.replica_id}
        if model is not None:
            body["model"] = model
        self._reply_json(200, body)
        return 200


class ServeServer:
    """Owns the HTTP listener + the scheduler lifecycle (and the optional
    fleet controller's, which starts after the scheduler and stops
    before it: a controller actuating into a stopping fleet would race
    ``mark_dead`` against the shutdown drain)."""

    def __init__(self, scheduler: ReplicaScheduler,
                 metrics: Optional[ServeMetrics] = None,
                 request_timeout_s: Optional[float] = None,
                 controller=None, registry=None):
        self.scheduler = scheduler
        self.metrics = metrics or scheduler.metrics
        # Optional ModelRegistry (serve/registry.py): the unknown-model
        # gate asks it first; without one the handler scans the fleet's
        # resident adapters.
        self.registry = registry
        self.controller = controller
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else float(os.environ.get("HVD_SERVE_REQUEST_TIMEOUT_S", "120")))
        self.httpd: Optional[DrainingThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Request tracing's env bootstrap at the front door (the engines
        # bootstrap too; whichever comes up first installs).
        _obs.maybe_install_from_env()

    def start(self, port: int = 0, host: str = "0.0.0.0") -> int:
        self.scheduler.start()
        if self.controller is not None:
            self.controller.start()
        self.httpd = DrainingThreadingHTTPServer((host, port),
                                                 _ServeHandler)
        self.httpd.scheduler = self.scheduler
        self.httpd.metrics = self.metrics
        self.httpd.registry = self.registry
        self.httpd.request_timeout_s = self.request_timeout_s
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="hvd-serve-http")
        self._thread.start()
        bound = self.httpd.server_address[1]
        get_logger().info("hvdserve listening on :%d (%d replica(s))",
                          bound, len(self.scheduler.replicas))
        return bound

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def drain(self, grace_s: Optional[float] = None) -> bool:
        """Refuse new requests, wait up to ``grace_s``
        (``HVD_SERVE_DRAIN_S``) for in-flight ones, then stop.  Returns
        True when the drain finished inside the grace window."""
        if grace_s is None:
            grace_s = float(os.environ.get("HVD_SERVE_DRAIN_S", "30"))
        drained = True
        if self.httpd is not None:
            self.httpd.begin_drain()
            drained = self.httpd.wait_idle(timeout=grace_s)
            if not drained:
                get_logger().warning(
                    "hvdserve: drain grace (%.1fs) expired with "
                    "requests still in flight", grace_s)
        self.stop()
        return bool(drained)

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            if not self._thread.is_alive():
                self._thread = None
        if self.controller is not None:
            self.controller.stop()
        self.scheduler.stop()
        self.metrics.maybe_emit_timeline(force=True)


# ---------------------------------------------------------------------------
# hvdserve CLI
# ---------------------------------------------------------------------------

def _build_adapter_factory(args):
    """Model factory for the CLI; the replicas share the one weight
    copy.  ``mlp``: the engine-mechanics MLP over a ``--vocab-size``
    vocabulary from ``--seed``, as the JAX CLI builds it.  GPT-2 serves
    in f32, as the JAX CLI does: the parameters of ``--checkpoint`` (the
    port's checkpoint directory, or one holding the JAX package's
    parameter tree, ``registry.load_serving_params``), else random
    weights from ``--seed``."""
    import dataclasses

    import torch
    if args.model == "mlp":
        from ..models import create_mlp
        from .engine import MLPAdapter
        vocab = args.vocab_size
        mlp = create_mlp((64, vocab), in_features=vocab, device=args.device,
                         seed=args.seed)
        return lambda: MLPAdapter(mlp, vocab_size=vocab,
                                  max_len=args.max_len)
    from ..models import GPT2_LARGE, GPT2_MEDIUM, GPT2_SMALL, create_gpt2
    from .engine import TransformerAdapter
    size = args.model.split("-", 1)[1] if "-" in args.model else "small"
    if getattr(args, "checkpoint", None):
        from .registry import load_serving_params
        base = {"small": GPT2_SMALL, "medium": GPT2_MEDIUM,
                "large": GPT2_LARGE}[size]
        cfg = dataclasses.replace(base, max_len=args.max_len,
                                  dtype=torch.float32)
        # Host tensors: on the device in f32 once, so every replica's
        # adapter lays out views of the one copy.
        params = {k: v.to(args.device, torch.float32)
                  if v.is_floating_point() else v.to(args.device)
                  for k, v in load_serving_params(args.checkpoint).items()}
    else:
        params = create_gpt2(size, device=args.device, seed=args.seed,
                             max_len=args.max_len, dtype=torch.float32)
        cfg = params.cfg
        get_logger().warning(
            "hvdserve: no --checkpoint given — serving RANDOM weights "
            "from seed %d (stack exercise only)", args.seed)
    return lambda: TransformerAdapter(cfg, params, max_len=args.max_len,
                                      device=args.device)


def run_commandline(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="hvdserve",
        description="Continuous-batching GPT-2 serving on one CUDA card "
                    "(the PyTorch port of hvdserve)")
    parser.add_argument("--model", default="mlp",
                        choices=("mlp", "gpt2-small", "gpt2-medium",
                                 "gpt2-large"))
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory of the transformer's "
                             "parameters (checkpoint.save_model)")
    parser.add_argument("--replicas", type=int, default=None,
                        help="serving replicas (default HVD_SERVE_REPLICAS "
                             "or 1)")
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("HVD_SERVE_PORT",
                                                   "8000")))
    parser.add_argument("--max-batch", type=int, default=None,
                        help="slots per replica (HVD_SERVE_MAX_BATCH)")
    parser.add_argument("--max-len", type=int, default=256)
    parser.add_argument("--vocab-size", type=int, default=256,
                        help="mlp model vocab")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--autoscale", action="store_true",
                        default=os.environ.get("HVD_SERVE_CTL_ENABLE", "0")
                        not in ("0", "false"),
                        help="run the SLO-aware fleet controller "
                             "(HVD_SERVE_CTL_* knobs)")
    parser.add_argument("--tier-kv", default=None, metavar="HOST:PORT",
                        help="enable the tiered KV hierarchy and point its "
                             "fleet block directory at a KV server "
                             "(HVD_SERVE_TIER_* knobs)")
    args = parser.parse_args(argv)
    if args.tier_kv:
        os.environ["HVD_SERVE_TIER"] = "1"
        os.environ["HVD_SERVE_TIER_KV"] = args.tier_kv

    import torch
    # Serving math is f32 (HVD_SERVE_DTYPE) and keeps the argmax far
    # from dtype noise; TF32 products would keep about 3 decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .. import core as _core
    if not _core.is_initialized():
        # The replicas are process sets of the world (build_replicas).
        _core.init(device=args.device)
    from .replica import build_replicas
    scheduler = build_replicas(_build_adapter_factory(args),
                               num_replicas=args.replicas,
                               max_batch=args.max_batch)
    if _core._state.timeline is not None:
        scheduler.metrics.set_timeline(_core._state.timeline)
    controller = None
    if args.autoscale:
        from .controller import FleetController
        controller = FleetController(scheduler)
    server = ServeServer(scheduler, controller=controller)
    # Arm the drain signals BEFORE the readiness banner.
    evt = arm_signal_event()
    port = server.start(port=args.port)
    print(f"hvdserve: listening on :{port} — POST /generate, GET /healthz, "
          f"GET /metrics", flush=True)
    return serve_until_signal(server.drain, evt)
