"""HTTP serving front-end: ``/generate``, ``/score``, ``/healthz``,
``/metrics``.

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

``python -m horovod_tpu_torch.serve`` runs ``run_commandline``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..faultline import runtime as _faultline
from ..utils import get_logger
from .batcher import DeadlineExceededError, QueueFullError, Request
from .metrics import ServeMetrics
from .replica import NoHealthyReplicaError, ReplicaScheduler
from .streaming import (CHUNK_TERMINATOR, TokenStream, chunk_frame,
                        encode_sse, error_status_for, wants_stream)


class DrainingThreadingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` + graceful drain: ``begin_drain()`` makes
    handlers refuse new work (503 + ``Connection: close``), ``wait_idle()``
    blocks until every in-flight handler has answered."""

    daemon_threads = True

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

    def log_message(self, fmt, *args):
        get_logger().debug("serve: " + fmt % args)

    def _reply(self, code: int, body: bytes,
               content_type: str = "application/json",
               extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
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

    def _budget_headers(self, request=None) -> tuple:
        """503/504 headers: ``Retry-After`` capped by the client's
        remaining budget, which rides ``X-Deadline-Remaining-S``."""
        hint = self._retry_after_s()
        remaining = request.remaining() if request is not None else None
        if remaining is None:
            return (("Retry-After", str(hint)),)
        return (("Retry-After", str(min(hint, int(remaining)))),
                ("X-Deadline-Remaining-S", f"{remaining:.3f}"))

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            health = self.server.scheduler.healthz()
            health["draining"] = bool(getattr(self.server, "draining",
                                              False))
            code = 200 if health["status"] != "unserving" else 503
            self._reply_json(code, health)
        elif path == "/metrics":
            self._reply(200, self.server.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply_json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        if getattr(self.server, "draining", False):
            self._reply_json(
                503, {"error": "draining: server is shutting down"},
                extra_headers=tuple(self._budget_headers())
                + (("Connection", "close"),))
            return
        self.server.request_began()
        try:
            path = self.path.split("?", 1)[0]
            if path == "/generate":
                self._handle_generate()
            elif path == "/score":
                self._handle_score()
            else:
                self._reply_json(
                    404, {"error": f"POST /generate or /score, not {path}"})
        finally:
            self.server.request_ended()

    def _known_model(self, model: str) -> bool:
        registry = self.server.registry
        if registry is not None:
            return registry.has(model)
        return any(model in r.engine._adapters
                   for r in self.server.scheduler.fleet())

    def _handle_generate(self) -> None:
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
            self._reply_json(400, {"error": str(e)})
            return
        if request.stream:
            # The sink attaches BEFORE submit: the engine's first
            # publish may beat this thread back from submit().
            request.sink = TokenStream(
                logprobs=request.logprobs is not None)
        try:
            self.server.scheduler.submit(request)
            if request.stream:
                self._stream_response(request)
                return
            tokens = request.result(timeout=self.server.request_timeout_s)
        except (QueueFullError, NoHealthyReplicaError) as e:
            self._reply_json(503, {"error": str(e)},
                             extra_headers=self._budget_headers(request))
            return
        except (DeadlineExceededError, TimeoutError) as e:
            self._reply_json(504, {"error": str(e)},
                             extra_headers=self._budget_headers(request))
            return
        except Exception as e:  # engine-side failure — surfaced, not hung
            self._reply_json(500, {"error": str(e)})
            return
        body = self._outcome_body(request)
        body["tokens"] = tokens
        if request.n > 1:
            body["n"] = request.n
            body["completions"] = request.samples
        self._reply_json(200, body)

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
            get_logger().debug("serve: %s client gone (%s)",
                               request.request_id, e)
            return False

    def _stream_response(self, request: Request) -> None:
        """The /generate answer as SSE over chunked transfer.  A failure
        BEFORE the first byte answers buffered JSON (400/503/504/500, as
        the buffered path); after it, the stream ends with a terminal
        ``error`` event carrying the same code.  A dead client socket at
        any write cancels the sequence (``Request.cancel``: slot and
        blocks freed, outcome ``client_gone``).  The engine lock is
        never held here: events come from the request's TokenStream."""
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
            extra = (self._budget_headers(request)
                     if status in (503, 504) else ())
            self._reply_json(status, {"error": str(exc)},
                             extra_headers=extra)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        # A body of unknown length owns its connection: no keep-alive.
        self.send_header("Connection", "close")
        self.end_headers()
        ev = first
        try:
            while True:
                kind, data = ev
                if kind == "token":
                    if not self._write_stream_frame(
                            request, chunk_frame(encode_sse("token", data))):
                        request.cancel()
                        return
                elif kind == "done":
                    body = self._outcome_body(request)
                    body["stream"] = sink.counters()
                    self._write_stream_frame(
                        request, chunk_frame(encode_sse("done", body))
                        + CHUNK_TERMINATOR)
                    return
                else:  # ("error", exc): a terminal failure mid-stream
                    self._write_stream_frame(request, chunk_frame(
                        encode_sse("error", {"error": str(data),
                                             "code": error_status_for(
                                                 data)}))
                        + CHUNK_TERMINATOR)
                    return
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
                    self._write_stream_frame(request, chunk_frame(
                        encode_sse("error", {"error": str(exc),
                                             "code": 504}))
                        + CHUNK_TERMINATOR)
                    return
        finally:
            self.server.metrics.count_stream(sink.counters())

    # -- /score ------------------------------------------------------------------

    def _handle_score(self) -> None:
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
            self._reply_json(400, {"error": str(e)})
            return
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
            self._reply_json(503, {"error": str(e)},
                             extra_headers=self._budget_headers())
            return
        try:
            entries = target.engine.score_tokens(tokens, model=model,
                                                 top=top)
        except (KeyError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        except Exception as e:
            self._reply_json(500, {"error": str(e)})
            return
        body = {"tokens": tokens, "logprobs": entries,
                "replica": target.replica_id}
        if model is not None:
            body["model"] = model
        self._reply_json(200, body)


class ServeServer:
    """Owns the HTTP listener + the scheduler lifecycle."""

    def __init__(self, scheduler: ReplicaScheduler,
                 metrics: Optional[ServeMetrics] = None,
                 request_timeout_s: Optional[float] = None,
                 registry=None):
        self.scheduler = scheduler
        self.metrics = metrics or scheduler.metrics
        # Optional ModelRegistry (serve/registry.py): the unknown-model
        # gate asks it first; without one the handler scans the fleet's
        # resident adapters.
        self.registry = registry
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else float(os.environ.get("HVD_SERVE_REQUEST_TIMEOUT_S", "120")))
        self.httpd: Optional[DrainingThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int = 0, host: str = "0.0.0.0") -> int:
        self.scheduler.start()
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
        self.scheduler.stop()


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
    args = parser.parse_args(argv)

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
    server = ServeServer(scheduler)
    # Arm the drain signals BEFORE the readiness banner.
    evt = arm_signal_event()
    port = server.start(port=args.port)
    print(f"hvdserve: listening on :{port} — POST /generate, GET /healthz, "
          f"GET /metrics", flush=True)
    return serve_until_signal(server.drain, evt)
