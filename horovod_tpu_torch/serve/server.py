"""HTTP serving front-end: ``/generate``, ``/healthz``, ``/metrics``.

Port of ``horovod_tpu/serve/server.py``: ``ThreadingHTTPServer`` with
HTTP/1.1 keep-alive and an explicit Content-Length on every response,
Nagle off, daemon handler threads, and a ``/generate`` handler thread
that parks in ``Request.result()`` while the engine threads decode.

Status mapping:

* 200 — tokens generated (buffered JSON);
* 400 — malformed body, or a field that needs a module the port has not
  ported yet (``stream``, ``schema``, ``logprobs``, ``temperature > 0``,
  ``n > 1``, ``model``; ``POST /score``) — the error names the missing
  feature, the field is never silently ignored;
* 503 + ``Retry-After`` — shed: every healthy queue is full, no healthy
  replica exists, or the server is draining;
* 504 — the request's own deadline expired (queued or decoding).

``python -m horovod_tpu_torch.serve`` runs ``run_commandline``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import get_logger
from .batcher import DeadlineExceededError, QueueFullError, Request
from .engine import unported_feature
from .metrics import ServeMetrics
from .replica import NoHealthyReplicaError, ReplicaScheduler


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


def _wants_stream(payload: dict, headers) -> bool:
    """The streaming opt-in: ``"stream": true`` in the body, or an
    ``Accept: text/event-stream`` header."""
    return (bool(payload.get("stream"))
            or "text/event-stream" in (headers.get("Accept") or ""))


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
                self._reply_json(400, {"error": (
                    "/score (logprob scoring) is not supported by "
                    "horovod_tpu_torch yet")})
            else:
                self._reply_json(
                    404, {"error": f"POST /generate, not {path}"})
        finally:
            self.server.request_ended()

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
            model = payload.get("model")
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
                model=None if model is None else str(model),
                stream=_wants_stream(payload, self.headers),
                logprobs=payload.get("logprobs"),
                schema=payload.get("schema"))
            feature = unported_feature(request)
            if feature is not None:
                raise ValueError(f"{feature} is not supported by "
                                 f"horovod_tpu_torch yet")
        except (KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        try:
            self.server.scheduler.submit(request)
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
        ttft_ms = None
        if request.first_token_at is not None:
            ttft_ms = round(
                (request.first_token_at - request.submitted_at) * 1e3, 3)
        self._reply_json(200, {
            "tokens": tokens,
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
                "completion_tokens": len(tokens),
                "total_tokens": len(request.prompt) + len(tokens),
            },
        })


class ServeServer:
    """Owns the HTTP listener + the scheduler lifecycle."""

    def __init__(self, scheduler: ReplicaScheduler,
                 metrics: Optional[ServeMetrics] = None,
                 request_timeout_s: Optional[float] = None):
        self.scheduler = scheduler
        self.metrics = metrics or scheduler.metrics
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
    """Model factory for the CLI: GPT-2 with random weights drawn from
    ``--seed`` (loading checkpoints is not ported yet); the replicas
    share the one weight copy."""
    from ..models import create_gpt2
    from .engine import TransformerAdapter
    size = args.model.split("-", 1)[1] if "-" in args.model else "small"
    model = create_gpt2(size, device=args.device, seed=args.seed,
                        max_len=args.max_len)
    get_logger().warning(
        "hvdserve: serving RANDOM weights from seed %d (stack exercise "
        "only)", args.seed)
    return lambda: TransformerAdapter(model.cfg, model, max_len=args.max_len,
                                      device=args.device)


def run_commandline(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="hvdserve",
        description="Continuous-batching GPT-2 serving on one CUDA card "
                    "(the PyTorch port of hvdserve)")
    parser.add_argument("--model", default="gpt2-small",
                        choices=("gpt2-small", "gpt2-medium", "gpt2-large"))
    parser.add_argument("--replicas", type=int, default=None,
                        help="serving replicas (default HVD_SERVE_REPLICAS "
                             "or 1)")
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("HVD_SERVE_PORT",
                                                   "8000")))
    parser.add_argument("--max-batch", type=int, default=None,
                        help="slots per replica (HVD_SERVE_MAX_BATCH)")
    parser.add_argument("--max-len", type=int, default=256)
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
    from .replica import build_replicas
    scheduler = build_replicas(_build_adapter_factory(args),
                               num_replicas=args.replicas,
                               max_batch=args.max_batch)
    server = ServeServer(scheduler)
    # Arm the drain signals BEFORE the readiness banner.
    evt = arm_signal_event()
    port = server.start(port=args.port)
    print(f"hvdserve: listening on :{port} — POST /generate, GET /healthz, "
          f"GET /metrics", flush=True)
    return serve_until_signal(server.drain, evt)
