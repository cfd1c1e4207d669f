"""HTTP front for the hvdroute router: ``/generate`` ``/healthz``
``/metrics`` + the ``hvdroute`` CLI.

Copied from ``horovod_tpu/serve/router_server.py`` over the port's
``DrainingThreadingHTTPServer`` and ``_ServeHandler``.

Same transport discipline as the serve plane (serve/server.py):
``DrainingThreadingHTTPServer`` (HTTP/1.1 keep-alive, explicit
Content-Length, Nagle off, daemon handler threads) — and the same drain
contract, because it IS the same implementation: SIGTERM finishes
in-flight forwards, refuses new requests with 503 + ``Connection:
close`` (Retry-After clamped by the header budget), and exits 0.

The handler is deliberately thin: parse the hop (body, headers, trace
context), hand it to :class:`~horovod_tpu_torch.serve.router.Router.handle`,
write back whatever it returns.  All routing/retry/hedging policy lives
in serve/router.py where tests can drive it without sockets.

``python -m horovod_tpu_torch.serve.router --endpoints
host:port,host:port`` stands the tier up in the foreground.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..obs import tracing as _obs
from ..utils import get_logger
from .router import Router
from .server import (DrainingThreadingHTTPServer, _ServeHandler,
                     arm_signal_event, serve_until_signal)
from .streaming import CHUNK_TERMINATOR, chunk_frame


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True  # serve/server.py transport notes

    _trace_ctx = None
    _trace_echo = None

    def log_message(self, fmt, *args):
        get_logger().debug("hvdroute: " + fmt % args)

    def _reply(self, code: int, body: bytes, extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        tid = (self._trace_ctx.trace_id if self._trace_ctx is not None
               else self._trace_echo)
        if tid is not None:
            self.send_header("X-Trace-Id", tid)
        sent = set()
        for k, v in extra_headers:
            self.send_header(k, v)
            sent.add(k.lower())
        if "content-type" not in sent:
            self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, extra_headers=()) -> None:
        self._reply(code, json.dumps(obj).encode(),
                    extra_headers=extra_headers)

    def _drain_headers(self) -> tuple:
        """Drain-refusal headers: Retry-After from the router's probe
        window, clamped by the HEADER budget (no Request object exists
        on this hop at all — the serve-side clamp satellite, applied
        here by construction)."""
        hint = max(int(self.server.router.config.probe_s), 1)
        raw = self.headers.get("X-Request-Timeout-S")
        try:
            budget = float(raw) if raw is not None else None
        except (TypeError, ValueError):
            budget = None
        if budget is not None and budget > 0:
            return (("Retry-After", str(min(hint, int(budget)))),
                    ("X-Deadline-Remaining-S", f"{budget:.3f}"),
                    ("Connection", "close"))
        return (("Retry-After", str(hint)), ("Connection", "close"))

    def _begin_stream(self, status: int, out_headers):
        """Router.handle's ``stream`` callback: send the event-stream
        response head, hand back a chunk writer.  ``write(bytes)``
        frames SSE payload bytes as one HTTP/1.1 chunk (False =
        downstream client hung up); ``write(None)`` ends the chunked
        body.  ``Connection: close`` — the socket's framing ends with
        the stream, same as the serve plane."""
        self.send_response(status)
        tid = (self._trace_ctx.trace_id if self._trace_ctx is not None
               else self._trace_echo)
        if tid is not None:
            self.send_header("X-Trace-Id", tid)
        sent = set()
        for k, v in out_headers:
            if k.lower() == "x-trace-id" and tid is not None:
                continue  # this hop's id wins; the span tree links them
            self.send_header(k, v)
            sent.add(k.lower())
        if "content-type" not in sent:
            self.send_header("Content-Type", "text/event-stream")
        if "cache-control" not in sent:
            self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()

        def write(data) -> bool:
            try:
                if data is None:
                    self.wfile.write(CHUNK_TERMINATOR)
                else:
                    self.wfile.write(chunk_frame(data))
                self.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError, OSError):
                return False

        return write

    def do_GET(self):
        self._trace_ctx = None
        self._trace_echo = _ServeHandler._safe_id(
            self.headers.get("X-Trace-Id"))
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            health = self.server.router.healthz()
            health["draining"] = bool(self.server.draining)
            code = 200 if health["status"] != "unserving" else 503
            self._reply_json(code, health)
        elif path == "/metrics":
            self._reply(200, self.server.router.render_metrics().encode(),
                        extra_headers=(
                            ("Content-Type",
                             "text/plain; version=0.0.4"),))
        else:
            self._reply_json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        safe = _ServeHandler._safe_id
        self._trace_echo = safe(self.headers.get("X-Trace-Id"))
        self._trace_ctx = None
        if self.path.split("?", 1)[0] != "/generate":
            self._reply_json(404, {"error": "POST /generate only"})
            return
        if self.server.draining:
            self.server.router.metrics.count_request("refused")
            self._reply_json(
                503, {"error": "draining: router is shutting down"},
                extra_headers=self._drain_headers())
            return
        self.server.request_began()
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(length) if length > 0 else b""
            tracer = _obs.TRACER
            ctx = None
            if tracer is not None and (self._trace_echo is not None
                                       or tracer.should_sample()):
                ctx = tracer.new_context(
                    trace_id=self._trace_echo,
                    parent=safe(self.headers.get("X-Parent-Span")))
            self._trace_ctx = ctx
            t0 = time.monotonic()
            status = 500
            try:
                status, headers, resp_body = self.server.router.handle(
                    body, self.headers, ctx, stream=self._begin_stream)
                if headers is not None:
                    self._reply(status, resp_body, extra_headers=headers)
                # headers is None: an event-stream was piped through
                # _begin_stream and the body is already on the wire.
            finally:
                if ctx is not None and tracer is not None:
                    try:
                        tracer.emit_span(
                            ctx, "http-handle", t0, time.monotonic(),
                            "router", args={"status": status}, root=True)
                    except Exception:
                        pass  # tracing never takes down the front door
        finally:
            self.server.request_ended()


class RouterServer:
    """Owns the front-door listener + the router's lifecycle (the
    ServeServer shape: start/port/drain/stop)."""

    def __init__(self, router: Router):
        self.router = router
        self.httpd: Optional[DrainingThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int = 0, host: str = "0.0.0.0") -> int:
        self.router.start()
        self.httpd = DrainingThreadingHTTPServer((host, port),
                                                 _RouterHandler)
        self.httpd.router = self.router
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="hvd-route-http")
        self._thread.start()
        try:
            bound = self.httpd.server_address[1]
            get_logger().info(
                "hvdroute listening on :%d (%d endpoint(s))", bound,
                len(self.router.endpoints_snapshot()))
        except Exception:
            # Same stop-path contract as ServeServer.start: never leak
            # the acceptor on a failed start.
            self.stop()
            raise
        return bound

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def drain(self, grace_s: Optional[float] = None) -> bool:
        """Refuse new requests, finish in-flight forwards (up to
        ``HVD_ROUTE_DRAIN_S``), then stop.  The SIGTERM path."""
        if grace_s is None:
            grace_s = float(os.environ.get("HVD_ROUTE_DRAIN_S", "30"))
        httpd = self.httpd
        drained = True
        if httpd is not None:
            httpd.begin_drain()
            drained = httpd.wait_idle(timeout=grace_s)
            if not drained:
                get_logger().warning(
                    "hvdroute: drain grace (%.1fs) expired with "
                    "forwards still in flight", grace_s)
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
        self.router.stop()


# ---------------------------------------------------------------------------
# hvdroute CLI
# ---------------------------------------------------------------------------

def run_commandline(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="hvdroute",
        description="Fault-tolerant prefix-affinity front door over N "
                    "hvdserve endpoints")
    parser.add_argument("--endpoints",
                        default=os.environ.get("HVD_ROUTE_ENDPOINTS", ""),
                        help="comma-separated host:port serve endpoints "
                             "(or HVD_ROUTE_ENDPOINTS)")
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("HVD_ROUTE_PORT",
                                                   "8100")))
    args = parser.parse_args(argv)
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if not endpoints:
        parser.error("no endpoints: pass --endpoints host:port[,...] "
                     "or set HVD_ROUTE_ENDPOINTS")
    server = RouterServer(Router(endpoints))
    # Arm the drain signals BEFORE the readiness banner: a supervisor
    # may SIGTERM the instant it sees the banner.
    evt = arm_signal_event()
    port = server.start(port=args.port)
    print(f"hvdroute: listening on :{port} — routing to "
          f"{len(endpoints)} endpoint(s)", flush=True)
    # SIGTERM/SIGINT → drain-then-exit 0 (shared with hvdserve).
    return serve_until_signal(server.drain, evt)
