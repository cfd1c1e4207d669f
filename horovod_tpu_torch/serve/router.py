"""hvdroute — fault-tolerant prefix-affinity front door.

Copied from ``horovod_tpu/serve/router.py`` (pure Python; the port keeps
its own copy).  It keys affinity by the port's ``blocks.chain_hashes``
and ``registry.model_salt``, which hash as the JAX package's do, so a
router places a prompt on the same endpoint whichever package serves
it; endpoints may be port or JAX servers alike.

One ``ThreadingHTTPServer`` per host tops out long before "millions of
concurrent sessions"; the missing tier is a thin, stateless router in
front of N independent serve endpoints.  Stateless is the point — the
paper's coordinator/worker split survives worker churn because the
coordinator holds no request state it cannot re-derive, and this router
follows the same discipline: every routing input is either carried by
the request itself (tokens → affinity key, ``X-Request-Timeout-S`` →
retry budget) or re-observable (endpoint health), so a router restart
loses nothing and N routers need no coordination.

Routing:

* **Prefix affinity** — the prompt's block-chain hash (the SAME
  ``chain_hashes`` + ``model_salt`` the backends key their prefix caches
  and the tiered-KV fleet directory by) lands on a consistent-hash ring of
  endpoints (``HVD_ROUTE_VNODES`` virtual nodes each), so repeat
  sessions reach the replica already holding their KV blocks.  The key
  hashes the chain at a small fixed depth (``HVD_ROUTE_AFFINITY_BLOCKS``
  blocks) rather than the deepest block: multi-turn prompts grow
  append-only, and a fixed-depth key keeps a session pinned while its
  transcript grows.  Ring positions come from blake2b — NEVER ``hash()``
  on strings, which is per-process salted — so every router instance
  agrees on the ring.
* **Bounded load** — when the affinity target is hot (in-flight above
  ``HVD_ROUTE_BOUNDED_LOAD`` × the fleet mean) or browned out, the
  router power-of-two-chooses between it and the next endpoint on the
  ring.  A non-affinity landing recomputes the session's prefix there
  (a tiered-KV fleet directory that migrates the blocks instead is not
  ported yet).

Robustness (the reason this tier exists):

* **Deadline-bounded retries** — the client budget (payload
  ``timeout_s`` / ``X-Request-Timeout-S``) caps every retry: capped
  jittered exponential backoff (the ``HVD_KV_RETRY_*`` discipline under
  ``HVD_ROUTE_RETRY_*`` knobs), definitive answers (2xx/4xx/504) pass
  through untouched, 503s are honored as backpressure (their
  ``Retry-After`` is slept, clamped to the remaining budget), transport
  errors and 5xx fail over to the next ring candidate.
* **Tail hedging** — latency-tier requests optionally race a second
  endpoint after ``HVD_ROUTE_HEDGE_MS`` of silence; first winner is
  used, the loser abandoned.  Safe because ``/generate`` is seeded: both
  endpoints produce the identical answer.
* **Passive + active health** — ``HVD_ROUTE_EJECT_FAILURES`` consecutive
  transport failures eject an endpoint for ``HVD_ROUTE_PROBE_S``; one
  half-open probe readmits it.  An optional active poller
  (``HVD_ROUTE_HEALTH_S``) consumes each endpoint's ``/healthz`` —
  status, ``brownout_level``, ``draining`` — instead of re-deriving
  fleet health from failures alone, so a draining or unserving endpoint
  stops receiving work BEFORE connections start dying.

Chaos: every forward attempt consults the ``router.forward`` faultline
point (``drop-route`` / ``slow-route`` / ``blackhole-endpoint``, plus
``kill-rank`` for routing-time loss detection).
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..faultline import runtime as _faultline
from ..obs import tracing as _obs
from ..utils import get_logger
from .blocks import chain_hashes
from .metrics import Histogram
from .registry import model_salt
from .streaming import encode_sse, wants_stream


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RouterConfig:
    """``HVD_ROUTE_*`` knobs, read once at construction."""

    def __init__(self, **overrides):
        self.affinity_blocks = max(
            _env_int("HVD_ROUTE_AFFINITY_BLOCKS", 2), 1)
        self.block_tokens = max(
            _env_int("HVD_SERVE_BLOCK_TOKENS", 16), 1)
        self.vnodes = max(_env_int("HVD_ROUTE_VNODES", 64), 1)
        self.bounded_load = max(
            _env_float("HVD_ROUTE_BOUNDED_LOAD", 2.0), 1.0)
        self.hedge_s = max(
            _env_float("HVD_ROUTE_HEDGE_MS", 0.0), 0.0) / 1e3
        self.retry_max = max(_env_int("HVD_ROUTE_RETRY_MAX", 3), 1)
        self.retry_base_s = max(
            _env_float("HVD_ROUTE_RETRY_BASE_MS", 10.0), 0.0) / 1e3
        self.retry_cap_s = max(
            _env_float("HVD_ROUTE_RETRY_CAP_MS", 2000.0), 0.0) / 1e3
        self.eject_failures = max(
            _env_int("HVD_ROUTE_EJECT_FAILURES", 3), 1)
        self.probe_s = max(_env_float("HVD_ROUTE_PROBE_S", 1.0), 0.01)
        self.health_s = max(_env_float("HVD_ROUTE_HEALTH_S", 0.0), 0.0)
        self.connect_timeout_s = max(
            _env_float("HVD_ROUTE_CONNECT_TIMEOUT_S", 2.0), 0.01)
        self.default_timeout_s = max(
            _env_float("HVD_ROUTE_DEFAULT_TIMEOUT_S", 30.0), 0.01)
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown RouterConfig field {k!r}")
            setattr(self, k, v)


class _HashRing:
    """Consistent-hash ring with virtual nodes.  Positions come from
    blake2b so every process agrees on them (``hash()`` over str is
    per-process salted — fine for the int chain hashes, never for
    endpoint names)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, str]] = []  # sorted (position, name)
        self._names: set = set()

    @staticmethod
    def _pos(s: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")

    def add(self, name: str) -> None:
        if name in self._names:
            return
        self._names.add(name)
        for i in range(self.vnodes):
            bisect.insort(self._ring, (self._pos(f"{name}#{i}"), name))

    def remove(self, name: str) -> None:
        if name not in self._names:
            return
        self._names.discard(name)
        self._ring = [e for e in self._ring if e[1] != name]

    def lookup(self, key: int, count: Optional[int] = None) -> List[str]:
        """Distinct endpoint names clockwise from ``key``'s position —
        the request's full preference order (index 0 is the affinity
        target; the rest are its stable failover sequence)."""
        if not self._ring:
            return []
        want = len(self._names) if count is None else count
        start = bisect.bisect_left(self._ring, (self._pos(repr(key)), ""))
        out: List[str] = []
        for i in range(len(self._ring)):
            name = self._ring[(start + i) % len(self._ring)][1]
            if name not in out:
                out.append(name)
                if len(out) >= want:
                    break
        return out


class _Endpoint:
    """Router-side view of one serve endpoint.  All mutable state is
    guarded by the owning Router's lock."""

    __slots__ = ("name", "host", "port", "inflight", "failures",
                 "admitted", "ejected_until", "probing",
                 "blackholed_until", "health_status", "brownout_level",
                 "draining")

    def __init__(self, name: str):
        host, _, port = name.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"endpoint must be host:port, got {name!r}")
        self.name = name
        self.host = host
        self.port = int(port)
        self.inflight = 0
        self.failures = 0          # consecutive transport failures
        self.admitted = True       # False == ejected (half-open after
        self.ejected_until = 0.0   # ejected_until passes)
        self.probing = 0.0         # half-open probe window deadline:
        #                            one probe at a time, but a timed
        #                            window (not a flag) so a probe
        #                            candidate that never gets tried
        #                            cannot wedge the endpoint ejected
        self.blackholed_until = 0.0
        self.health_status = "ok"  # active-poll /healthz status
        self.brownout_level = 0
        self.draining = False

    def to_dict(self) -> dict:
        return {"name": self.name, "admitted": self.admitted,
                "inflight": self.inflight, "failures": self.failures,
                "health": self.health_status,
                "brownout_level": self.brownout_level,
                "draining": self.draining}


class RouterMetrics:
    """``hvd_route_*`` counters (render/snapshot mirror ServeMetrics'
    single-lock design; endpoint gauges live in Router.render_metrics
    because their state does)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[str, int] = {
            "ok": 0, "shed": 0, "expired": 0, "error": 0, "refused": 0}
        self.forwards_total = 0
        self.retries_total = 0
        self.hedges_total = 0
        self.hedges_won_total = 0
        self.ejections_total = 0
        self.readmissions_total = 0
        self.affinity_hits = 0
        self.affinity_total = 0
        self.request_ms = Histogram()

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter + "_total",
                    getattr(self, counter + "_total") + n)

    def count_request(self, outcome: str) -> None:
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1

    def observe_request(self, ms: float, affinity_hit: bool) -> None:
        with self._lock:
            self.request_ms.observe(ms)
            self.affinity_total += 1
            if affinity_hit:
                self.affinity_hits += 1

    def affinity_hit_rate(self) -> float:
        with self._lock:
            if not self.affinity_total:
                return 0.0
            return self.affinity_hits / self.affinity_total

    def snapshot(self) -> dict:
        with self._lock:
            rate = (self.affinity_hits / self.affinity_total
                    if self.affinity_total else 0.0)
            return {
                "requests": dict(self.requests),
                "forwards": self.forwards_total,
                "retries": self.retries_total,
                "hedges": self.hedges_total,
                "hedges_won": self.hedges_won_total,
                "ejections": self.ejections_total,
                "readmissions": self.readmissions_total,
                "affinity": {"hits": self.affinity_hits,
                             "total": self.affinity_total,
                             "hit_rate": round(rate, 4)},
                "request_ms": self.request_ms.to_dict(),
            }

    def render(self) -> str:
        """Prometheus text exposition (``hvd_route_*`` families)."""
        with self._lock:
            lines = []
            lines.append("# TYPE hvd_route_requests_total counter")
            for outcome, n in sorted(self.requests.items()):
                lines.append(
                    f'hvd_route_requests_total{{outcome="{outcome}"}} {n}')
            for name, n in (("forwards", self.forwards_total),
                            ("retries", self.retries_total),
                            ("hedges", self.hedges_total),
                            ("hedges_won", self.hedges_won_total),
                            ("ejections", self.ejections_total),
                            ("readmissions", self.readmissions_total)):
                lines.append(f"# TYPE hvd_route_{name}_total counter")
                lines.append(f"hvd_route_{name}_total {n}")
            rate = (self.affinity_hits / self.affinity_total
                    if self.affinity_total else 0.0)
            lines.append("# TYPE hvd_route_affinity_hit_rate gauge")
            lines.append(f"hvd_route_affinity_hit_rate {rate:g}")
            h = self.request_ms
            lines.append("# TYPE hvd_route_request_ms histogram")
            for bound, c in zip(h.bounds, h.counts):
                lines.append(
                    f'hvd_route_request_ms_bucket{{le="{bound:g}"}} {c}')
            lines.append(
                f'hvd_route_request_ms_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"hvd_route_request_ms_sum {h.sum:g}")
            lines.append(f"hvd_route_request_ms_count {h.count}")
            return "\n".join(lines) + "\n"


#: Response statuses the router passes through without failover: the
#: backend ANSWERED — success, the caller's own error, or the caller's
#: expired budget.  Everything else is the backend failing, not the
#: request, and is the router's job to hide.
_DEFINITIVE = frozenset((504,)) | frozenset(range(200, 500))


class _StreamReader:
    """A live backend event-stream held open across :meth:`Router.handle`.

    ``read1`` returns decoded SSE bytes from at most ONE underlying
    chunk (``HTTPResponse.read1`` — a plain ``read(n)`` would block
    accumulating ``n`` bytes and destroy time-to-first-token), ``b""``
    at end of stream.  ``close()`` hangs up the connection: the backend
    sees a client disconnect at its next write and aborts the sequence
    (slot freed, blocks released) — this is how an abandoned hedge
    loser or a vanished downstream client propagates."""

    __slots__ = ("_conn", "_resp", "on_close", "_closed")

    def __init__(self, conn, resp):
        self._conn = conn
        self._resp = resp
        self.on_close = None
        self._closed = False

    def read1(self, n: int = 8192) -> bytes:
        return self._resp.read1(n)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._conn.close()
        except Exception:
            pass
        if self.on_close is not None:
            self.on_close()


class Router:
    """Prefix-affinity routing + retry/hedge/health core.  Transport-
    agnostic below :meth:`handle`: tests monkeypatch :meth:`_transport`
    to drive the whole state machine without sockets."""

    def __init__(self, endpoints, config: Optional[RouterConfig] = None,
                 metrics: Optional[RouterMetrics] = None):
        if not endpoints:
            raise ValueError("router needs at least one endpoint")
        self.config = config or RouterConfig()
        self.metrics = metrics or RouterMetrics()
        self._lock = threading.Lock()
        self._endpoints: Dict[str, _Endpoint] = {}
        self._ring = _HashRing(self.config.vnodes)
        for name in endpoints:
            self._endpoints[name] = _Endpoint(name)
            self._ring.add(name)
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        _faultline.maybe_install_from_env()
        _obs.maybe_install_from_env()

    # -- membership -----------------------------------------------------------

    def add_endpoint(self, name: str) -> None:
        with self._lock:
            if name not in self._endpoints:
                self._endpoints[name] = _Endpoint(name)
                self._ring.add(name)

    def remove_endpoint(self, name: str) -> None:
        with self._lock:
            self._endpoints.pop(name, None)
            self._ring.remove(name)

    def endpoints_snapshot(self) -> List[dict]:
        with self._lock:
            return [e.to_dict() for e in self._endpoints.values()]

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Router":
        if self.config.health_s > 0 and self._health_thread is None:
            self._stop.clear()
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="hvd-route-health")
            self._health_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10)
            self._health_thread = None

    # -- affinity -------------------------------------------------------------

    def affinity_key(self, tokens, model: Optional[str] = None) -> int:
        """The request's ring key: its block-chain hash at a fixed small
        depth (module doc — append-only prompts keep a stable key), under
        the backend fleet's own version-salted hash (registry.model_salt,
        version 0: the router is stateless and need not match the exact
        rolled version — only be deterministic per model)."""
        salt = model_salt(str(model), 0) if model else 0
        chain = chain_hashes(tokens, self.config.block_tokens, salt=salt)
        if chain:
            return chain[min(len(chain), self.config.affinity_blocks) - 1]
        # Sub-block prompt: no full block to hash; the raw token tuple
        # is process-stable under hash() (ints, not strs).
        return hash((salt, tuple(tokens)))

    def _candidates(self, key: int) -> Tuple[Optional[str], List[str]]:
        """(affinity target, available endpoints in preference order).
        The affinity target is reported even when unavailable — the hit
        metric measures where requests LAND vs where their blocks
        live."""
        order = self._ring.lookup(key)
        now = time.monotonic()
        avail: List[str] = []
        with self._lock:
            total_inflight = 0
            for name in order:
                ep = self._endpoints.get(name)
                if ep is None:
                    continue
                if ep.draining or ep.health_status == "unserving":
                    continue
                if not ep.admitted:
                    if now < ep.ejected_until or now < ep.probing:
                        continue
                    # This request IS the half-open probe.
                    ep.probing = now + self.config.probe_s
                avail.append(name)
                total_inflight += ep.inflight
            # Bounded-load fallback: when the affinity target is hot or
            # browned out, power-of-two-choose between it and the next
            # ring candidate (least loaded wins, affinity on ties).
            if len(avail) >= 2:
                a = self._endpoints[avail[0]]
                b = self._endpoints[avail[1]]
                mean = total_inflight / len(avail)
                hot = (a.inflight >= self.config.bounded_load
                       * max(mean, 1.0)) or a.brownout_level > 0
                if hot and (b.inflight, b.brownout_level) < \
                        (a.inflight, a.brownout_level):
                    avail[0], avail[1] = avail[1], avail[0]
        affinity = order[0] if order else None
        return affinity, avail

    # -- health bookkeeping ---------------------------------------------------

    def _note_success(self, name: str) -> None:
        readmitted = False
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            ep.failures = 0
            ep.probing = 0.0
            if not ep.admitted:
                ep.admitted = True
                ep.ejected_until = 0.0
                readmitted = True
                self.metrics.count("readmissions")
        if readmitted:
            get_logger().info("hvdroute: endpoint %s readmitted", name)

    def _note_failure(self, name: str) -> None:
        ejected = False
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            ep.failures += 1
            ep.probing = 0.0
            now = time.monotonic()
            if ep.admitted and ep.failures >= self.config.eject_failures:
                ep.admitted = False
                ep.ejected_until = now + self.config.probe_s
                ejected = True
                self.metrics.count("ejections")
            elif not ep.admitted:
                # Failed half-open probe: stay ejected another window.
                ep.ejected_until = now + self.config.probe_s
        if ejected:
            get_logger().warning(
                "hvdroute: endpoint %s ejected after %d consecutive "
                "failures (probe in %.2fs)", name,
                self.config.eject_failures, self.config.probe_s)

    def _next_probe_wait(self) -> Optional[float]:
        """Seconds until the nearest ejected endpoint's half-open window
        opens, or None when no probe can ever help (every endpoint is
        draining/unserving, not merely ejected).  A fully-ejected fleet
        is a TRANSIENT — shedding instantly would lose a request whose
        budget could have covered the probe."""
        now = time.monotonic()
        wait = None
        with self._lock:
            for ep in self._endpoints.values():
                if ep.draining or ep.health_status == "unserving":
                    continue
                w = max(ep.ejected_until - now, ep.probing - now, 0.0)
                if wait is None or w < wait:
                    wait = w
        return wait

    def _force_eject(self, name: str) -> None:
        """kill-rank at router.forward: loss detected at routing time —
        immediate ejection, the half-open probe decides readmission."""
        ejected = False
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            ep.failures = max(ep.failures, self.config.eject_failures)
            if ep.admitted:
                ep.admitted = False
                ep.ejected_until = (time.monotonic()
                                    + self.config.probe_s)
                ejected = True
                self.metrics.count("ejections")
        if ejected:
            get_logger().warning(
                "hvdroute: endpoint %s force-ejected (kill-rank)", name)

    # -- transport ------------------------------------------------------------

    def _transport(self, ep_host: str, ep_port: int, method: str,
                   path: str, body: Optional[bytes], headers,
                   timeout_s: float):
        """One HTTP exchange → (status, header dict, body bytes).  The
        seam tests monkeypatch; everything above it is pure routing."""
        conn = http.client.HTTPConnection(
            ep_host, ep_port,
            timeout=max(min(timeout_s, 3600.0), 0.001))
        try:
            conn.request(method, path, body=body, headers=dict(headers))
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _transport_stream(self, ep_host: str, ep_port: int, method: str,
                          path: str, body: Optional[bytes], headers,
                          timeout_s: float):
        """Streaming twin of :meth:`_transport` — its OWN seam so the
        many tests that monkeypatch ``_transport`` keep exercising the
        buffered path unchanged.  Returns ``(status, header dict, body
        bytes or None, reader or None)``: a 200 ``text/event-stream``
        answer comes back with the connection still open as a
        :class:`_StreamReader` (body None); anything else is read to
        completion and closed, exactly like ``_transport`` (reader
        None).  The socket timeout gets slack past the client budget so
        the BACKEND's own deadline machinery answers first (a 504 error
        event beats a router-side socket timeout)."""
        conn = http.client.HTTPConnection(
            ep_host, ep_port,
            timeout=max(min(timeout_s + 5.0, 3600.0), 0.001))
        try:
            conn.request(method, path, body=body, headers=dict(headers))
            resp = conn.getresponse()
        except Exception:
            conn.close()
            raise
        ctype = resp.getheader("Content-Type") or ""
        if resp.status != 200 or "text/event-stream" not in ctype:
            try:
                data = resp.read()
            finally:
                conn.close()
            return resp.status, dict(resp.getheaders()), data, None
        return (resp.status, dict(resp.getheaders()), None,
                _StreamReader(conn, resp))

    def _forward_once(self, name: str, body: bytes, headers,
                      timeout_s: float, want_stream: bool = False):
        """One forward attempt: faultline consult, blackhole gate, then
        the transport.  Raises ``ConnectionError``/``OSError`` on
        transport failure; returns (status, headers, body), or with
        ``want_stream`` (status, headers, body-or-None, reader-or-None)
        via :meth:`_transport_stream`.  A live reader keeps the
        endpoint's inflight gauge held until ``close()`` — the bounded-
        load signal must see open streams, not just open exchanges."""
        now = time.monotonic()
        if _faultline.PLAN is not None:
            # ``router.forward`` injection point, consulted once per
            # ATTEMPT with the candidate endpoint as the instance (so a
            # spec can target one endpoint's forwards specifically).
            for f in _faultline.fire("router.forward", name):
                victim = f.target or name
                if f.kind == "kill-rank":
                    self._force_eject(victim)
                    if victim == name:
                        raise ConnectionError(
                            f"endpoint {name} killed (faultline)")
                elif f.kind == "blackhole-endpoint":
                    with self._lock:
                        ep = self._endpoints.get(victim)
                        if ep is not None:
                            ep.blackholed_until = now + (f.param or 5.0)
                elif f.kind == "slow-route":
                    time.sleep(min(f.param or 0.05,
                                   max(timeout_s, 0.0)))
                elif f.kind == "drop-route":
                    raise ConnectionError(
                        f"forward to {name} dropped (faultline)")
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                raise ConnectionError(f"endpoint {name} removed")
            if ep.blackholed_until > time.monotonic():
                raise ConnectionError(
                    f"endpoint {name} unreachable (blackholed)")
            ep.inflight += 1
            host, port = ep.host, ep.port
        self.metrics.count("forwards")
        try:
            if want_stream:
                status, hdrs, data, reader = self._transport_stream(
                    host, port, "POST", "/generate", body, headers,
                    timeout_s)
            else:
                reader = None
                status, hdrs, data = self._transport(
                    host, port, "POST", "/generate", body, headers,
                    timeout_s)
        except (OSError, http.client.HTTPException) as e:
            self._release_inflight(name)
            raise ConnectionError(f"forward to {name} failed: {e}") from e
        if reader is not None:
            reader.on_close = lambda: self._release_inflight(name)
            return status, hdrs, data, reader
        self._release_inflight(name)
        if want_stream:
            return status, hdrs, data, None
        return status, hdrs, data

    def _release_inflight(self, name: str) -> None:
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is not None:
                ep.inflight = max(ep.inflight - 1, 0)

    def _backoff_s(self, attempt: int) -> float:
        """Capped jittered exponential backoff — the KVStoreClient
        discipline (runner/http_server.py) under HVD_ROUTE_RETRY_*."""
        import random
        base = min(self.config.retry_base_s * (2 ** (attempt - 1)),
                   self.config.retry_cap_s)
        return base * (0.5 + random.random() / 2)

    # -- hedging --------------------------------------------------------------

    def _hedged_forward(self, primary: str, secondary: str, body: bytes,
                        headers, deadline: float):
        """Race ``primary`` against ``secondary`` launched after the
        hedge delay; first DEFINITIVE answer wins, the loser is
        abandoned (its response is discarded — idempotent by the seeded
        /generate contract).  Returns (winner name, status, headers,
        body, hedged, hedge_won); raises the primary path's error only
        when every launched attempt failed."""
        results: "queue.Queue" = queue.Queue()

        def attempt(name: str) -> None:
            try:
                remaining = deadline - time.monotonic()
                results.put(
                    (name, self._forward_once(name, body, headers,
                                              max(remaining, 0.001)),
                     None))
            except Exception as e:
                results.put((name, None, e))

        threading.Thread(target=attempt, args=(primary,), daemon=True,
                         name="hvd-route-fwd").start()
        launched = 1
        hedged = False
        try:
            got = results.get(timeout=self.config.hedge_s)
        except queue.Empty:
            hedged = True
            self.metrics.count("hedges")
            threading.Thread(target=attempt, args=(secondary,),
                             daemon=True, name="hvd-route-hedge").start()
            launched = 2
            got = results.get(
                timeout=max(deadline - time.monotonic(), 0.001))
        errors = []
        for _ in range(launched):
            name, resp, err = got
            if err is None:
                hedge_won = hedged and name == secondary
                if hedge_won:
                    self.metrics.count("hedges_won")
                return name, resp[0], resp[1], resp[2], hedged, hedge_won
            errors.append((name, err))
            self._note_failure(name)
            if len(errors) < launched:
                got = results.get(
                    timeout=max(deadline - time.monotonic(), 0.001))
        raise errors[0][1]

    def _hedged_forward_stream(self, primary: str, secondary: str,
                               body: bytes, headers, deadline: float):
        """Hedging for a streamed request: the race is decided at
        FIRST BYTE (response headers received), never later.  The
        winner is claimed atomically under ``claim_lock`` the moment
        its attempt has an answer in hand; a loser that lands after
        the claim closes its own connection — the backend sees the
        hangup and aborts that sequence, so the fleet never decodes
        two copies of the stream past the race window.  Errors still
        flow to the caller's queue so a failed primary fails over to
        the hedge exactly like the buffered race.  Returns (winner
        name, status, headers, body-or-None, reader-or-None, hedged,
        hedge_won)."""
        results: "queue.Queue" = queue.Queue()
        claim_lock = threading.Lock()
        claimed: List[str] = []

        def attempt(name: str) -> None:
            try:
                remaining = deadline - time.monotonic()
                res = self._forward_once(name, body, headers,
                                         max(remaining, 0.001),
                                         want_stream=True)
            except Exception as e:
                results.put((name, None, e))
                return
            with claim_lock:
                if not claimed:
                    claimed.append(name)
                    results.put((name, res, None))
                    return
            # Lost the first-byte race: abandon our own answer.  A live
            # reader must be hung up (aborts the backend sequence);
            # buffered answers were already read and closed.
            if res[3] is not None:
                res[3].close()

        threading.Thread(target=attempt, args=(primary,), daemon=True,
                         name="hvd-route-fwd").start()
        launched = 1
        hedged = False
        try:
            got = results.get(timeout=self.config.hedge_s)
        except queue.Empty:
            hedged = True
            self.metrics.count("hedges")
            threading.Thread(target=attempt, args=(secondary,),
                             daemon=True, name="hvd-route-hedge").start()
            launched = 2
            got = results.get(
                timeout=max(deadline - time.monotonic(), 0.001))
        errors = []
        for _ in range(launched):
            name, res, err = got
            if err is None:
                hedge_won = hedged and name == secondary
                if hedge_won:
                    self.metrics.count("hedges_won")
                return (name, res[0], res[1], res[2], res[3],
                        hedged, hedge_won)
            errors.append((name, err))
            self._note_failure(name)
            if len(errors) < launched:
                got = results.get(
                    timeout=max(deadline - time.monotonic(), 0.001))
        raise errors[0][1]

    # -- request path ---------------------------------------------------------

    @staticmethod
    def _parse_budget_s(payload, headers) -> Optional[float]:
        """Client budget: payload ``timeout_s`` wins over the
        ``X-Request-Timeout-S`` header (the ServeServer precedence)."""
        raw = None
        if isinstance(payload, dict):
            raw = payload.get("timeout_s")
        if raw is None:
            raw = headers.get("X-Request-Timeout-S")
        try:
            budget = float(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None
        return budget if budget is not None and budget > 0 else None

    def handle(self, body: bytes, headers, ctx=None, stream=None):
        """Route one ``/generate`` request end to end.  Returns
        ``(status, [(header, value)], body bytes)`` — whatever transport
        wraps this (router_server, tests) just writes it out.

        ``stream`` is the pass-through seam for token streaming: a
        callable ``stream(status, [(header, value)]) -> write`` the
        router invokes once the backend's event-stream headers arrive;
        ``write(bytes) -> bool`` forwards SSE payload bytes downstream
        (False = downstream client gone), ``write(None)`` terminates
        the response body.  When the request asks for streaming
        (payload ``"stream": true`` or ``Accept: text/event-stream``)
        AND a ``stream`` callback is given, a 200 event-stream answer
        is piped chunk by chunk WITHOUT buffering and handle returns
        ``(status, None, None)`` (body already delivered).  Everything
        else — buffered answers, pre-first-byte errors, shed/expired —
        returns the buffered triple unchanged, so a streaming client
        still gets an ordinary JSON error when no stream ever opened."""
        t0 = time.monotonic()
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            payload = None
        want_stream = stream is not None and wants_stream(
            payload if isinstance(payload, dict) else {}, headers)
        tokens = payload.get("tokens") if isinstance(payload, dict) \
            else None
        model = payload.get("model") if isinstance(payload, dict) else None
        qos = None
        if isinstance(payload, dict):
            qos = payload.get("qos")
        if qos is None:
            qos = headers.get("X-QoS-Tier") or "latency"
        qos = str(qos).strip().lower()
        budget = self._parse_budget_s(payload, headers)
        timeout_s = budget if budget is not None \
            else self.config.default_timeout_s
        deadline = t0 + timeout_s
        if isinstance(tokens, list) and tokens and \
                all(isinstance(t, int) for t in tokens):
            key = self.affinity_key(tokens, model)
        else:
            # Unparseable/malformed body: still routed (the backend owns
            # the 400), keyed by raw bytes so retries stay sticky.
            key = int.from_bytes(
                hashlib.blake2b(body or b"", digest_size=8).digest(),
                "big")

        fwd_headers = {"Content-Type": "application/json"}
        for h in ("X-Request-Timeout-S", "X-QoS-Tier", "X-Tenant-Id",
                  "Accept"):
            v = headers.get(h)
            if v is not None:
                fwd_headers[h] = v
        if ctx is not None:
            # Trace propagation through the extra hop: the backend's
            # http-handle span parents under this router's route span.
            for k, v in ctx.headers():
                fwd_headers[k] = v

        attempts = 0
        retries = 0
        hedged = hedge_won = False
        affinity = None
        served_by = None
        failed: set = set()
        outcome = ("error", 502, {"error": "router: no forward attempted"})
        status, resp_headers, resp_body = None, {}, b""
        reader = None
        while True:
            reader = None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                outcome = ("expired", 504,
                           {"error": "router: client budget exhausted "
                                     "before an endpoint answered"})
                status = None
                break
            affinity, avail = self._candidates(key)
            cand = [n for n in avail if n not in failed] or avail
            if not cand:
                # Nothing available RIGHT NOW.  If the budget covers the
                # nearest half-open window, wait for it instead of
                # shedding — a fully-ejected fleet after a fault train
                # is transient, and zero-lost means spending the
                # client's budget before giving up.
                wait = self._next_probe_wait()
                if wait is not None and wait < remaining - 0.01:
                    time.sleep(min(max(wait, 0.01), remaining))
                    failed.clear()
                    continue
                outcome = ("shed", 503,
                           {"error": "router: no available endpoint"})
                status = None
                break
            try:
                use_hedge = (attempts == 0 and not hedged
                             and qos == "latency"
                             and self.config.hedge_s > 0
                             and len(cand) >= 2)
                if use_hedge:
                    if want_stream:
                        (served_by, status, resp_headers, resp_body,
                         reader, hedged, hedge_won) = \
                            self._hedged_forward_stream(
                                cand[0], cand[1], body, fwd_headers,
                                deadline)
                    else:
                        (served_by, status, resp_headers, resp_body,
                         hedged, hedge_won) = self._hedged_forward(
                            cand[0], cand[1], body, fwd_headers, deadline)
                    attempts += 2 if hedged else 1
                elif want_stream:
                    served_by = cand[0]
                    (status, resp_headers, resp_body,
                     reader) = self._forward_once(
                        served_by, body, fwd_headers, remaining,
                        want_stream=True)
                    attempts += 1
                else:
                    served_by = cand[0]
                    status, resp_headers, resp_body = self._forward_once(
                        served_by, body, fwd_headers, remaining)
                    attempts += 1
            except (ConnectionError, OSError, queue.Empty) as e:
                if not use_hedge:
                    self._note_failure(cand[0])
                failed.update(cand[:2] if use_hedge else cand[:1])
                attempts = max(attempts + 1, 1)
                if attempts >= self.config.retry_max:
                    outcome = ("error", 502,
                               {"error": f"router: {attempts} forward "
                                         f"attempt(s) failed: {e}"})
                    status = None
                    break
                retries += 1
                self.metrics.count("retries")
                time.sleep(min(self._backoff_s(attempts),
                               max(deadline - time.monotonic(), 0.0)))
                continue
            if status in _DEFINITIVE:
                self._note_success(served_by)
                break
            if status == 503:
                # Backpressure, not failure: the endpoint answered.
                # Honor its Retry-After (clamped to the remaining
                # budget) before the next candidate; pass the 503
                # through once the retry budget is spent.
                self._note_success(served_by)
                failed.add(served_by)
                attempts += 0  # the forward already counted
                retries += 1
                self.metrics.count("retries")
                if attempts >= self.config.retry_max:
                    break
                try:
                    ra = float(resp_headers.get("Retry-After", 0))
                except (TypeError, ValueError):
                    ra = 0.0
                wait = min(max(ra, 0.0), self.config.retry_cap_s,
                           max(deadline - time.monotonic(), 0.0))
                if len([n for n in avail if n not in failed]) == 0 \
                        and wait > 0:
                    time.sleep(wait)
                    failed.clear()
                continue
            # 5xx: the backend broke on this request — fail over.
            self._note_failure(served_by)
            failed.add(served_by)
            retries += 1
            self.metrics.count("retries")
            if attempts >= self.config.retry_max:
                break
            time.sleep(min(self._backoff_s(attempts),
                           max(deadline - time.monotonic(), 0.0)))

        if reader is not None:
            return self._pipe_stream(
                stream, reader, served_by, status, resp_headers, ctx,
                t0, affinity, attempts, retries, hedged, hedge_won)

        now = time.monotonic()
        affinity_hit = (served_by is not None and served_by == affinity
                        and status is not None)
        if status is not None:
            # A backend answered (definitive, or a passed-through
            # 503/5xx after retry exhaustion).
            if status < 400:
                self.metrics.count_request("ok")
            elif status == 503:
                self.metrics.count_request("shed")
            elif status == 504:
                self.metrics.count_request("expired")
            else:
                self.metrics.count_request(
                    "error" if status >= 500 else "ok")
            out_headers = [("Content-Type",
                            resp_headers.get("Content-Type",
                                             "application/json"))]
            for h in ("Retry-After", "X-Deadline-Remaining-S"):
                v = resp_headers.get(h)
                if v is not None:
                    if h == "Retry-After":
                        # Never advertise a wait past the client budget.
                        try:
                            v = str(min(int(float(v)),
                                        max(int(deadline - now), 0)))
                        except (TypeError, ValueError):
                            pass
                    out_headers.append((h, v))
            body_out = resp_body
        else:
            kind, code, err = outcome
            self.metrics.count_request(kind)
            status = code
            out_headers = [("Content-Type", "application/json")]
            if code == 503:
                # The router's own shed: hint at the next probe window,
                # clamped by the remaining client budget (the same
                # header-budget contract the backends honor).
                hint = max(int(self.config.probe_s), 1)
                rem = deadline - now
                out_headers.append(
                    ("Retry-After", str(max(min(hint, int(rem)), 0)
                                        if rem >= 0 else 0)))
            if budget is not None:
                out_headers.append(
                    ("X-Deadline-Remaining-S",
                     f"{max(deadline - now, 0.0):.3f}"))
            body_out = json.dumps(err).encode()
        self.metrics.observe_request((now - t0) * 1e3, affinity_hit)
        if ctx is not None and _obs.TRACER is not None:
            try:
                _obs.TRACER.emit_span(
                    ctx, "route", t0, now, "router",
                    args={"endpoint": served_by, "status": status,
                          "attempts": attempts, "retries": retries,
                          "hedged": hedged, "hedge_won": hedge_won,
                          "affinity_hit": affinity_hit})
            except Exception:
                pass  # tracing must never take down the front door
        return status, out_headers, body_out

    def _pipe_stream(self, stream, reader, served_by: str, status: int,
                     resp_headers, ctx, t0: float, affinity,
                     attempts: int, retries: int, hedged: bool,
                     hedge_won: bool):
        """Pipe a claimed backend event-stream downstream without
        buffering.  Past the first byte there is NO silent retry: a
        backend that dies mid-stream has already emitted tokens the
        client consumed, and a seeded replay on another endpoint would
        re-send them — so the failure surfaces as a terminal SSE
        ``error`` event instead.  A downstream hangup closes the
        backend connection (the engine aborts the sequence and frees
        its blocks).  Returns ``(status, None, None)``: the body has
        already been written through the ``stream`` callback."""
        out_headers = [(k, v) for k, v in resp_headers.items()
                       if k.lower() in ("content-type", "cache-control",
                                        "x-trace-id")]
        outcome = "ok"
        write = None
        try:
            write = stream(status, out_headers)
            while True:
                try:
                    data = reader.read1(8192)
                except (OSError, http.client.HTTPException) as e:
                    self._note_failure(served_by)
                    outcome = "error"
                    write(encode_sse("error", {
                        "error": f"router: upstream {served_by} failed "
                                 f"mid-stream: {e}",
                        "code": 502}))
                    break
                if not data:
                    break  # backend finished; its terminal event is sent
                if not write(data):
                    outcome = "client_gone"
                    break
            if outcome != "client_gone":
                write(None)  # end of chunked body
        except Exception:
            outcome = "client_gone"
        finally:
            reader.close()
        now = time.monotonic()
        self.metrics.count_request(outcome)
        self.metrics.observe_request(
            (now - t0) * 1e3, served_by == affinity)
        if ctx is not None and _obs.TRACER is not None:
            try:
                _obs.TRACER.emit_span(
                    ctx, "route", t0, now, "router",
                    args={"endpoint": served_by, "status": status,
                          "attempts": attempts, "retries": retries,
                          "hedged": hedged, "hedge_won": hedge_won,
                          "affinity_hit": served_by == affinity,
                          "streamed": True, "stream_outcome": outcome})
            except Exception:
                pass  # tracing must never take down the front door
        return status, None, None

    # -- active health --------------------------------------------------------

    def _probe_health(self, name: str) -> None:
        """One active /healthz poll: consume the backend's own health
        verdict (status / brownout_level / draining — serve/server.py)
        instead of re-deriving it from transport failures."""
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            host, port = ep.host, ep.port
            blackholed = ep.blackholed_until > time.monotonic()
        if blackholed:
            self._note_failure(name)
            return
        try:
            conn = http.client.HTTPConnection(
                host, port, timeout=self.config.connect_timeout_s)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                health = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            self._note_failure(name)
            return
        status = str(health.get("status", "ok"))
        with self._lock:
            ep = self._endpoints.get(name)
            if ep is None:
                return
            ep.health_status = status
            ep.brownout_level = int(health.get("brownout_level", 0) or 0)
            ep.draining = bool(health.get("draining", False))
        if status != "unserving" and not health.get("draining"):
            self._note_success(name)

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_s):
            with self._lock:
                names = list(self._endpoints)
            for name in names:
                if self._stop.is_set():
                    return
                self._probe_health(name)

    # -- export ---------------------------------------------------------------

    def render_metrics(self) -> str:
        """Counter families plus the per-endpoint gauges whose state
        lives here."""
        lines = [self.metrics.render().rstrip("\n")]
        lines.append("# TYPE hvd_route_endpoint_admitted gauge")
        for ep in self.endpoints_snapshot():
            lines.append(
                f'hvd_route_endpoint_admitted{{endpoint="{ep["name"]}"}} '
                f'{1 if ep["admitted"] else 0}')
        lines.append("# TYPE hvd_route_endpoint_inflight gauge")
        for ep in self.endpoints_snapshot():
            lines.append(
                f'hvd_route_endpoint_inflight{{endpoint="{ep["name"]}"}} '
                f'{ep["inflight"]}')
        return "\n".join(lines) + "\n"

    def healthz(self) -> dict:
        eps = self.endpoints_snapshot()
        admitted = sum(1 for e in eps if e["admitted"])
        if admitted == 0:
            status = "unserving"
        elif admitted < len(eps):
            status = "degraded"
        else:
            status = "ok"
        return {"status": status, "admitted": admitted,
                "total": len(eps), "endpoints": eps}


if __name__ == "__main__":  # pragma: no cover - python -m entry
    import sys

    from .router_server import run_commandline

    sys.exit(run_commandline())
