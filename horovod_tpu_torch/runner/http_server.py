"""HTTP KV store + rendezvous server.

Copy of ``horovod_tpu/runner/http_server.py`` (framework-free; the port
keeps its own copy because it imports nothing of the JAX package).  The
server has the JAX package's two backends behind one API: the C++ server
of ``csrc/kv_server.cc`` (the default, ``HVD_TPU_KV_SERVER=native``) and
the Python ``_KVHandler`` (``HVD_TPU_KV_SERVER=python``).  Unlike the
JAX package, a native server that cannot be built or bound raises, with
the compiler's output, instead of falling back to Python.  The client
fires the ``kv.request`` fault point and, under a traced request's
scope, sends ``X-Trace-Id`` / ``X-Parent-Span``.  The launcher, the
elastic driver, ``hvd.run``, Spark and Ray, the data service, the
engine's KV client and the serving fleet's preemption watcher and KV
tier use it; the eager engine negotiates over the world's c10d store
instead.

Reference: horovod/runner/http/http_server.py:35 (KVStoreHandler: PUT/GET
scoped key-value store), :152 (RendezvousHandler), :192 (RendezvousServer:
publishes the host allocation plan that workers read to discover their slot
info).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..utils.logging import get_logger


class _KVHandler(BaseHTTPRequestHandler):
    """Scoped KV store over PUT/GET (http_server.py:35 KVStoreHandler).

    HTTP/1.1 so clients keep one persistent connection per thread (the
    eager control plane issues one request per dispatch; per-request
    connection setup dominated its latency).  Every response carries an
    explicit Content-Length — without it a 1.1 keep-alive client would
    block waiting for connection close.

    TCP_NODELAY is mandatory on both ends: a successful GET is two socket
    writes (status+headers flush, then the body), and with Nagle on, the
    body write sits behind the peer's delayed ACK — measured 44 ms p50 per
    successful GET on loopback, which multiplied into ~830 ms
    negotiations at np=16 (the coordinator GETs every rank's request).
    With NODELAY the same GET is ~0.15 ms."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True  # TCP_NODELAY on accepted sockets

    def log_message(self, fmt, *args):  # silence default stderr spam
        get_logger().debug("kvstore: " + fmt % args)

    def _empty(self, code: int) -> None:
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _cond(self, scope: str):
        """Per-scope condition (all sharing the cache lock): a PUT wakes
        only the waiters of ITS scope.  With one global condition every
        request-PUT woke every verdict waiter in the world — at np=16 a
        thundering herd of ~size^2 wakeups per negotiation."""
        return self.server.scope_conds.setdefault(
            scope, threading.Condition(self.server.cache_lock))

    def _notify(self, scope: str) -> None:
        c = self.server.scope_conds.get(scope)
        if c is not None:
            c.notify_all()

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        with self.server.cache_lock:
            scope_dict = self.server.cache.setdefault(self._scope(), {})
            scope_dict[self._key()] = value
            self._notify(self._scope())  # wake this scope's waiters
        self._empty(200)

    def do_POST(self):
        if self._key():
            self._put_wait()
            return
        # Batch put: POST /{scope} with JSON {key: base64(value)} writes
        # every pair under one lock acquisition and one wakeup.  This is
        # the transport for the eager engine's per-cycle dispatch-stream
        # flush (ops/negotiation.py): one request carries a whole cycle's
        # records instead of one request per dispatch — the single
        # highest-volume stream on the control plane.
        import base64
        length = int(self.headers.get("Content-Length", 0))
        try:
            items = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._empty(400)
            return
        with self.server.cache_lock:
            scope_dict = self.server.cache.setdefault(self._scope(), {})
            for k, v in items.items():
                scope_dict[k] = base64.b64decode(v)
            self._notify(self._scope())
        self._empty(200)

    def _put_wait(self):
        # Put-then-await: POST /{scope}/{key}?ascope=S&akey=K&wait=s stores
        # the body at scope/key, then holds the request until S/K exists
        # and returns its value (404 on timeout).  This folds a worker's
        # "announce my negotiation request, then long-poll the verdict"
        # into ONE round-trip — at np=16 on a single server the request
        # COUNT is the latency floor, so halving the per-rank requests
        # halves new-signature negotiation time.
        import time as _time
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(self.path).query)
        try:
            ascope = q["ascope"][0]
            akey = q["akey"][0]
        except (KeyError, IndexError):
            self._empty(400)
            return
        try:
            wait_s = min(float(q.get("wait", ["0"])[0]), 60.0)
        except ValueError:
            wait_s = 0.0
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        deadline = None
        with self.server.cache_lock:
            self.server.cache.setdefault(self._scope(), {})[self._key()] = \
                value
            self._notify(self._scope())
            while True:
                out = self.server.cache.get(ascope, {}).get(akey)
                if out is not None:
                    break
                now = _time.monotonic()
                if deadline is None:
                    deadline = now + wait_s
                if now >= deadline:
                    break
                self._cond(ascope).wait(deadline - now)
        if out is None:
            self._empty(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def do_GET(self):
        key = self._key()
        if key == "":
            self._scope_scan()
            return
        # Long-poll: GET /{scope}/{key}?wait=<seconds> blocks until the key
        # exists (or the wait elapses -> 404).  This is what keeps the
        # control plane off the server's CPU at scale: a worker waiting for
        # a negotiation verdict costs ~1 request/second instead of a
        # 200-requests/second polling loop (measured: np=16 cached-dispatch
        # p50 went 64 ms -> <2 ms when pollers stopped starving the server).
        wait_s = 0.0
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(self.path).query)
        if "wait" in q:
            try:
                wait_s = min(float(q["wait"][0]), 60.0)
            except ValueError:
                wait_s = 0.0
        deadline = None
        with self.server.cache_lock:
            while True:
                value = self.server.cache.get(self._scope(), {}).get(key)
                if value is not None or wait_s <= 0:
                    break
                import time as _time
                now = _time.monotonic()
                if deadline is None:
                    deadline = now + wait_s
                if now >= deadline:
                    break
                # Re-fetch each iteration: _gc_cond may have replaced the
                # scope's condition while this waiter slept.
                self._cond(self._scope()).wait(deadline - now)
        if value is None:
            self._empty(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def _scope_scan(self):
        # Scope scan: GET /{scope} returns the whole scope as JSON
        # {key: base64(value)} — one request where per-key polling
        # would be O(keys) (e.g. the elastic init barrier reading
        # every rank's presence each poll, or the negotiation
        # coordinator collecting every rank's request).
        #
        # Long-poll variant: GET /{scope}?min=N&wait=s holds the request
        # until the scope has >= N keys (or the wait elapses, returning
        # whatever is there).  The negotiation coordinator uses it to
        # collect all ranks' requests in ONE blocking request instead of a
        # sleep-scan loop whose 10 ms quantum put a floor under every
        # new-signature negotiation.
        import base64
        import json as _json
        import time as _time
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(self.path).query)
        min_keys, wait_s = 0, 0.0
        try:
            min_keys = int(q["min"][0]) if "min" in q else 0
            wait_s = min(float(q["wait"][0]), 60.0) if "wait" in q else 0.0
        except ValueError:
            pass
        deadline = None
        with self.server.cache_lock:
            while True:
                scope = self.server.cache.get(self._scope(), {})
                if min_keys <= 0 or len(scope) >= min_keys or wait_s <= 0:
                    scope = dict(scope)
                    break
                now = _time.monotonic()
                if deadline is None:
                    deadline = now + wait_s
                if now >= deadline:
                    scope = dict(scope)
                    break
                self._cond(self._scope()).wait(deadline - now)
        body = _json.dumps({
            k: base64.b64encode(v).decode("ascii")
            for k, v in scope.items()}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_DELETE(self):
        with self.server.cache_lock:
            key = self._key()
            if key == "":
                # Scope delete: DELETE /{scope} drops the whole scope in
                # one request (the negotiation coordinator GCs each
                # per-(name, epoch) request scope this way instead of every
                # rank deleting its own key).
                self.server.cache.pop(self._scope(), None)
                self._gc_cond(self._scope())
            else:
                scope_dict = self.server.cache.get(self._scope())
                if scope_dict is not None:
                    scope_dict.pop(key, None)
                    if not scope_dict:
                        # GC the emptied scope: per-(name, epoch)
                        # negotiation scopes would otherwise leak one dict
                        # per negotiation for the launcher's lifetime.
                        self.server.cache.pop(self._scope(), None)
                        self._gc_cond(self._scope())
        self._empty(200)

    def _gc_cond(self, scope: str) -> None:
        """Drop a deleted scope's condition (bounds memory to live scopes)
        after waking its waiters — a waiter left on the popped condition
        would otherwise sleep out its full timeout even if the key
        reappeared (the reappearing PUT creates a NEW condition).  Woken
        waiters re-check and, still-unsatisfied, time out their chunk and
        re-issue, re-entering on the fresh condition."""
        c = self.server.scope_conds.pop(scope, None)
        if c is not None:
            c.notify_all()

    def _path_parts(self):
        # Path segments are percent-encoded by KVStoreClient, so a literal
        # '?' or '/' in a scope/key round-trips instead of being parsed as
        # query/separator; the query (?wait=...) is split off first.
        from urllib.parse import unquote, urlsplit
        path = urlsplit(self.path).path
        return [unquote(p) for p in path.strip("/").split("/")]

    def _scope(self) -> str:
        parts = self._path_parts()
        return parts[0] if parts else ""

    def _key(self) -> str:
        parts = self._path_parts()
        return "/".join(parts[1:]) if len(parts) > 1 else ""


#: Servers started in this process, by backend.
STARTS = {"native": 0, "python": 0}


class _KVHTTPServer(ThreadingHTTPServer):
    """The Python backend's listener.  Its backlog is 128, not
    ``socketserver``'s 5 (the JAX package's): a world's ranks connect at
    once, the kernel drops the SYNs beyond the backlog, and each dropped
    connect waits out a 1 s retransmit (a put-wait fan-out to 16 ranks
    took ~1 s)."""

    request_queue_size = 128


class KVStoreServer:
    """KV server (RendezvousServer base, http_server.py:192).

    Two interchangeable backends behind one API: the C++ server
    (csrc/kv_server.cc, the default; chip_smoke.py phase 19 times both
    per request) and this module's Python ``_KVHandler``
    (``HVD_TPU_KV_SERVER=python``).  A native server that fails to build
    or bind raises: nothing falls back quietly.  Both keep the store
    readable through ``get``/``scan_scope`` after ``stop()`` — launcher
    code gathers worker results after shutdown (runner/__init__.py)."""

    def __init__(self, verbose: bool = False):
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._native = None
        self._cache: Optional[dict] = None
        self._lock: Optional[threading.Lock] = None

    def start(self, port: int = 0) -> int:
        if os.environ.get("HVD_TPU_KV_SERVER", "native") != "python":
            from ..csrc.native import NativeKVServer
            native = NativeKVServer()
            bound = native.start(port)
            self._native = native
            STARTS["native"] += 1
            return bound
        STARTS["python"] += 1
        self.httpd = _KVHTTPServer(("0.0.0.0", port), _KVHandler)
        self.httpd.cache = self._cache = {}
        self.httpd.cache_lock = self._lock = threading.Lock()
        # Long-poll waiters sleep on per-scope conditions (all sharing the
        # cache lock); a PUT wakes only its scope's waiters.
        # daemon_threads so a blocked long-poll never prevents interpreter
        # exit.
        self.httpd.scope_conds = {}
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="hvd-kvstore")
        self._thread.start()
        return self.httpd.server_address[1]

    @property
    def port(self) -> int:
        if self._native is not None:
            return self._native.port
        return self.httpd.server_address[1]

    def put(self, scope: str, key: str, value: bytes):
        if self._native is not None:
            self._native.put(scope, key, value)
            return
        with self._lock:
            self._cache.setdefault(scope, {})[key] = value
            if self.httpd is not None:
                c = self.httpd.scope_conds.get(scope)
                if c is not None:
                    c.notify_all()

    def get(self, scope: str, key: str) -> Optional[bytes]:
        if self._native is not None:
            return self._native.get(scope, key)
        with self._lock:
            return self._cache.get(scope, {}).get(key)

    def scan_scope(self, scope: str) -> Dict[str, bytes]:
        """Server-side scope snapshot (no HTTP round-trip)."""
        if self._native is not None:
            return self._native.scan_scope(scope)
        with self._lock:
            return dict(self._cache.get(scope, {}))

    def stop(self):
        if self._native is not None:
            self._native.stop()
            return
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self._thread is not None:
            # serve_forever was told to exit; join it so stop() leaves no
            # acceptor thread behind (daemon=True stays the interpreter-
            # exit backstop — a handler blocked in a long-poll must never
            # pin exit, module doc).
            self._thread.join(timeout=10)
            if not self._thread.is_alive():
                self._thread = None


class RendezvousServer(KVStoreServer):
    """Publishes the host allocation plan (http_server.py:192
    RendezvousServer.init)."""

    SCOPE = "rendezvous"

    def init(self, host_alloc_plan) -> None:
        """host_alloc_plan: list of SlotInfo (runner/hosts.py).  Keys are
        published both by rank and by (hostname, local_rank) like the
        reference's elastic handler."""
        for slot in host_alloc_plan:
            payload = json.dumps(slot.to_dict()).encode()
            self.put(self.SCOPE, f"rank/{slot.rank}", payload)
            self.put(self.SCOPE,
                     f"slot/{slot.hostname}/{slot.local_rank}", payload)
        self.put(self.SCOPE, "size",
                 str(len(host_alloc_plan)).encode())


class KVStoreClient:
    """Worker-side client (runner/http/http_client.py analog).

    Keeps one persistent HTTP/1.1 connection per thread: the control plane
    issues a KV request per eager dispatch (ops/negotiation.py
    publish_dispatch), and per-request connection setup tripled its cost
    (~1.5 ms → ~0.4 ms with keep-alive).

    Transport errors are RETRIED with capped jittered exponential backoff
    (``HVD_KV_RETRY_MAX`` attempts total, delays ``HVD_KV_RETRY_BASE_MS``
    · 2^n capped at ``HVD_KV_RETRY_CAP_MS``, each scaled by a uniform
    [0.5, 1) jitter so a fleet retrying the same dead server doesn't
    stampede in lockstep): connect failures, timeouts, and mid-response
    disconnects are transient by nature — the KV server restarting or a
    link flapping — and every verb here is idempotent (PUT/GET/DELETE/
    scan; put_wait's re-put is its documented re-issue).  HTTP 4xx
    responses are FATAL and never retried: the server answered, the
    request itself is wrong, and retrying would just repeat the answer
    (callers raise OSError on them immediately)."""

    def __init__(self, addr: str, port: int):
        self.addr = addr
        self.port = port
        self.base = f"http://{addr}:{port}"
        import threading
        self._local = threading.local()
        self.retry_max = max(int(os.environ.get("HVD_KV_RETRY_MAX", "3")),
                             1)
        self.retry_base_s = float(
            os.environ.get("HVD_KV_RETRY_BASE_MS", "10")) / 1e3
        self.retry_cap_s = float(
            os.environ.get("HVD_KV_RETRY_CAP_MS", "2000")) / 1e3
        from ..faultline import runtime as _flrt
        _flrt.maybe_install_from_env()
        from ..obs import tracing as _tr
        _tr.maybe_install_from_env()

    def _retry_backoff_s(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based): capped exponential
        with jitter (class docstring)."""
        import random
        base = min(self.retry_base_s * (2 ** (attempt - 1)),
                   self.retry_cap_s)
        return base * (0.5 + random.random() / 2)

    def _conn(self, fresh: bool = False):
        sock = getattr(self._local, "sock", None)
        if sock is None or fresh:
            if sock is not None:
                try:
                    sock.close()
                except Exception:
                    pass
            sock = socket.create_connection((self.addr, self.port),
                                            timeout=30)
            # Mirror the server's TCP_NODELAY (see _KVHandler docstring).
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
            self._local.buf = b""
        return sock

    @staticmethod
    def _path(scope: str, key: str = "") -> str:
        """Percent-encode each segment so scopes/keys with '?', '#', '%',
        spaces or non-URL bytes round-trip (tensor names are user input);
        '/' inside keys stays a segment separator, matching the server's
        split-then-unquote."""
        from urllib.parse import quote
        enc = quote(scope, safe="")
        if key:
            enc += "/" + "/".join(quote(p, safe="")
                                  for p in key.split("/"))
        return "/" + enc

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        """Hand-rolled HTTP/1.1 over the persistent per-thread socket: a
        minimal writer/parser in place of ``http.client``, whose per-request
        host CPU would add to every control-plane round trip
        (chip_smoke.py phase 19 times a round trip on both servers)."""
        import time as _time

        from ..faultline import runtime as _flrt
        from ..obs import tracing as _tr
        trace_ctx = None
        trace_extra = ""
        if _tr.TRACER is not None:
            # Wire propagation: a KV round-trip issued while a traced
            # request is active on this thread carries the trace headers,
            # and each RETRY attempt becomes a kv-retry span.  One
            # module-attribute read when tracing is off.
            trace_ctx = _tr.current()
            if trace_ctx is not None:
                trace_extra = (
                    f"X-Trace-Id: {trace_ctx.trace_id}\r\n"
                    f"X-Parent-Span: {trace_ctx.span_id}\r\n")
        req = (f"{method} {path} HTTP/1.1\r\nHost: {self.addr}\r\n"
               f"{trace_extra}"
               f"Content-Length: {len(body) if body else 0}\r\n\r\n"
               .encode("ascii"))
        if body:
            req += body
        for attempt in range(self.retry_max):
            sock = None
            attempt_t0 = _time.monotonic()
            try:
                if _flrt.PLAN is not None:
                    # ``kv.request`` injection point (one consult per
                    # ATTEMPT, so a drop train of length n exercises n
                    # retries): delay-kv stalls the request, drop-kv-
                    # response fails it as a transport error, landing in
                    # the retry path a real flake takes.
                    for f in _flrt.fire("kv.request",
                                        f"{self.addr}:{self.port}"):
                        if f.kind == "delay-kv":
                            _time.sleep(f.param or 0.02)
                        elif f.kind == "drop-kv-response":
                            raise ConnectionError(
                                "faultline: dropped KV response")
                sock = self._conn(fresh=attempt > 0)
                sock.sendall(req)
                return self._read_response(sock)
            except (ConnectionError, OSError) as e:
                if trace_ctx is not None and _tr.TRACER is not None:
                    try:
                        _tr.TRACER.emit_span(
                            trace_ctx, "kv-retry", attempt_t0,
                            _time.monotonic(), "kv-client",
                            args={"attempt": attempt + 1,
                                  "of": self.retry_max,
                                  "method": method,
                                  "error": str(e)[:120]})
                    except Exception:
                        pass
                if attempt + 1 >= self.retry_max:
                    # Out of budget.  Drop the desynced socket: a request
                    # went out, so a LATE response may still arrive — a
                    # later request reusing this socket would consume it
                    # as its own.
                    if sock is not None:
                        try:
                            sock.close()
                        except Exception:
                            pass
                    self._local.sock = None
                    raise
                delay = self._retry_backoff_s(attempt + 1)
                get_logger().debug(
                    "KV %s %s attempt %d/%d failed (%s); retrying in "
                    "%.0f ms", method, path, attempt + 1, self.retry_max,
                    e, delay * 1e3)
                _time.sleep(delay)
        raise AssertionError("unreachable")

    def _read_response(self, sock):
        """Parse one response: status line + headers + Content-Length body
        (both servers always send Content-Length; leftover bytes stay in
        the per-thread buffer for the next response)."""
        buf = self._local.buf
        while True:
            end = buf.find(b"\r\n\r\n")
            if end >= 0:
                break
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("KV server closed the connection")
            buf += chunk
        head, rest = buf[:end], buf[end + 4:]
        status_line, _, header_block = head.partition(b"\r\n")
        status = int(status_line.split(b" ", 2)[1])
        clen = 0
        for line in header_block.split(b"\r\n"):
            if line[:15].lower() == b"content-length:":
                clen = int(line[15:])
                break
        while len(rest) < clen:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("KV server closed mid-body")
            rest += chunk
        self._local.buf = rest[clen:]
        return status, rest[:clen]

    def put(self, scope: str, key: str, value: bytes):
        status, _ = self._request("PUT", self._path(scope, key), body=value)
        if status >= 400:
            raise OSError(f"KV put {scope}/{key} failed: HTTP {status}")

    def put_batch(self, scope: str, items: Dict[str, bytes]) -> None:
        """Write many keys in ONE request (server applies them under one
        lock, in iteration order).  The eager dispatch-stream flusher rides
        this: a whole cycle's records cost one round-trip."""
        import base64
        body = json.dumps({
            k: base64.b64encode(v).decode("ascii")
            for k, v in items.items()}).encode()
        status, _ = self._request("POST", self._path(scope), body=body)
        if status >= 400:
            raise OSError(f"KV put_batch {scope} failed: HTTP {status}")

    def get(self, scope: str, key: str,
            wait: float = 0.0) -> Optional[bytes]:
        """``wait`` > 0 long-polls: the server holds the request until the
        key exists or the wait elapses (then 404 -> None).  One long-poll
        replaces hundreds of poll requests — the difference between a
        healthy and a saturated control plane at np >= 16."""
        path = self._path(scope, key)
        if wait > 0:
            # Stay well under the 30 s client socket timeout.
            path += f"?wait={min(wait, 25.0):.3f}"
        status, data = self._request("GET", path)
        if status == 404:
            return None
        if status >= 400:
            raise OSError(f"KV get {scope}/{key} failed: HTTP {status}")
        return data

    def put_wait(self, scope: str, key: str, value: bytes,
                 await_scope: str, await_key: str,
                 wait: float) -> Optional[bytes]:
        """Store ``value`` at scope/key, then block server-side until
        ``await_scope``/``await_key`` exists and return its value (None on
        timeout — re-issue; the re-put is idempotent).  One round-trip for
        the announce-request-then-await-verdict pattern."""
        from urllib.parse import quote
        path = (self._path(scope, key)
                + f"?ascope={quote(await_scope, safe='')}"
                + f"&akey={quote(await_key, safe='')}"
                + f"&wait={min(wait, 25.0):.3f}")
        status, data = self._request("POST", path, body=value)
        if status == 404:
            return None
        if status >= 400:
            raise OSError(f"KV put_wait {scope}/{key} failed: HTTP {status}")
        return data

    def delete(self, scope: str, key: str) -> None:
        status, _ = self._request("DELETE", self._path(scope, key))
        if status >= 400 and status != 404:
            raise OSError(f"KV delete {scope}/{key} failed: HTTP {status}")

    def delete_scope(self, scope: str) -> None:
        """Drop a whole scope in one request."""
        status, _ = self._request("DELETE", self._path(scope))
        if status >= 400 and status != 404:
            raise OSError(f"KV delete_scope {scope} failed: HTTP {status}")

    def scan(self, scope: str, wait: float = 0.0,
             min_keys: int = 0) -> dict:
        """Fetch a whole scope in ONE request: {key: value-bytes}.
        With ``min_keys`` > 0 and ``wait`` > 0, the server holds the
        request until the scope has at least that many keys (or the wait
        elapses — the caller re-checks and re-issues)."""
        import base64
        path = self._path(scope)
        if min_keys > 0 and wait > 0:
            path += f"?min={min_keys}&wait={min(wait, 25.0):.3f}"
        status, data = self._request("GET", path)
        if status >= 400:
            raise OSError(f"KV scan {scope} failed: HTTP {status}")
        return {k: base64.b64decode(v)
                for k, v in json.loads(data or b"{}").items()}
