"""Distributed request tracing in the Dapper/OpenTelemetry mold.

Copied from ``horovod_tpu/obs/tracing.py`` (pure Python; the port keeps
its own copy and never imports the JAX package).  ``install`` wires the
port's own timeline (``core._state.timeline``) and ``core.rank()``.

The Horovod Timeline (timeline.py) is per-process and op-centric: it
shows WHAT each rank was doing, but a serving request that crosses the
HTTP front-end, the router, a replica's batcher, chunked prefill, the
decode loop, KV-transport retries, tier-fault stalls (the ``tier-fault``
span hvdtier emits when a host/fleet KV fetch loses its prefetch race,
not ported yet), and possibly a failover resubmission leaves no single
artifact saying where ITS latency went.  This module adds the
per-request plane:

* a :class:`TraceContext` (trace_id, span_id, parent) carried in a
  ``contextvars.ContextVar`` on the thread doing request work and ON the
  request object across thread handoffs (HTTP handler → batcher queue →
  engine loop), propagated over the wire via ``X-Trace-Id`` /
  ``X-Parent-Span`` headers (serve/server.py inbound+echo, the runner KV
  client outbound);
* a process-global :class:`Tracer` (``TRACER``) that records spans
  retroactively — callers capture ``time.monotonic()`` marks where work
  happens and emit the whole span at its end — into (a) per-component
  JSONL *trace shards* under ``HVD_TRACE_DIR`` for fleet-wide merging
  (obs/merge.py, the ``hvdtrace`` CLI), (b) the ambient Timeline as
  Chrome async/flow events so request spans interleave with the
  training-op lifecycle, FAULTLINE instants, and SERVE counters in one
  Perfetto view, and (c) a bounded recent-trace buffer the sampled
  ``/trace`` endpoint serves as JSON span trees;
* sampling via ``HVD_TRACE_SAMPLE`` (probability a new root request is
  traced; while the tracer is installed — any sample > 0 — an incoming
  ``X-Trace-Id`` header bypasses the local roll, because the upstream
  hop made the sampling decision).  Off by default with zero hot-path
  cost: the guard every instrumented path uses is ``tracing.TRACER is
  not None`` — one module-attribute read, matching faultline's
  discipline.  With the tracer off, inbound trace ids are only ECHOED
  (correlation survives the untraced hop), never traced.

Clock alignment for the fleet merge: every shard opens with an anchor
record pairing ``time.time_ns()`` with ``time.monotonic_ns()``, and
:func:`publish_clock_anchor` additionally publishes the anchor through
the rendezvous KV with the measured put round-trip time — the merger
aligns shards on the wall-clock anchors and bounds the residual
cross-host skew by the KV RTT.
"""

from __future__ import annotations

import contextvars
import json
import os
import queue
import random
import socket
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

#: KV scope clock anchors are exchanged through (publish_clock_anchor /
#: merge.kv_anchors).
CLOCK_SCOPE = "hvdtrace-clock"

#: The active tracer, or None (the default — instrumented paths no-op
#: behind a single attribute read).
TRACER: Optional["Tracer"] = None

_env_lock = threading.Lock()
_env_checked = False

_current: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("hvdtrace_ctx", default=None)

_id_rng = random.Random()
_id_lock = threading.Lock()


def _gen_id(nibbles: int) -> str:
    with _id_lock:
        return "%0*x" % (nibbles, _id_rng.getrandbits(nibbles * 4))


def _proc_tag() -> str:
    """Host-qualified process identity for shard filenames and KV
    anchor keys.  A bare pid is NOT unique across hosts (containerized
    replicas are routinely all pid 1): two hosts sharing an
    HVD_TRACE_DIR would append to the same shard and wall-align each
    other's events with the wrong clock anchor."""
    host = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in socket.gethostname()) or "host"
    return f"{host}-{os.getpid()}"


class TraceContext:
    """One request's identity at one point in the span tree: the
    trace_id names the request end-to-end, span_id this hop's span, and
    parent_id the upstream hop's span (None at the root)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def headers(self) -> List[Tuple[str, str]]:
        """Wire form: what a downstream hop receives (its parent is THIS
        hop's span)."""
        return [("X-Trace-Id", self.trace_id),
                ("X-Parent-Span", self.span_id)]

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id})")


def current() -> Optional[TraceContext]:
    """The thread/task's active trace context (None untraced)."""
    return _current.get()


def current_trace_id() -> Optional[str]:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


def push(ctx: Optional[TraceContext]):
    """Set the active context; returns the token for :func:`pop`."""
    return _current.set(ctx)


def pop(token) -> None:
    _current.reset(token)


class scope:
    """``with tracing.scope(ctx): ...`` — context-manager form of
    push/pop for code that does request work on its own thread."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


class Tracer:
    """Process-global span recorder (module doc).

    ``sample`` is the probability a NEW root request is traced;
    ``shard_dir`` (``HVD_TRACE_DIR``) enables per-component JSONL shard
    files for the fleet merge; ``recent`` bounds the in-memory buffer
    the ``/trace`` endpoint reads.  All sinks are best-effort: tracing
    must never take down the serving path.
    """

    def __init__(self, sample: float = 0.0,
                 shard_dir: Optional[str] = None,
                 recent: Optional[int] = None,
                 rank: Optional[int] = None):
        self.sample = max(float(sample), 0.0)
        self.shard_dir = shard_dir or None
        self.rank = int(rank) if rank is not None else 0
        self._recent_cap = recent if recent is not None else int(
            os.environ.get("HVD_TRACE_RECENT", "128"))
        self._lock = threading.Lock()
        self._rng = random.Random()
        # trace_id -> list of event records, insertion-ordered so the
        # buffer evicts the OLDEST trace when past the cap.
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._flow_state: Dict[str, bool] = {}  # trace_id -> flow started
        self._timeline = None
        self._closed = False
        self.spans_emitted = 0
        # Shard IO runs on a dedicated writer thread behind a BOUNDED
        # queue (the timeline.py discipline): request-path threads —
        # engine loops, HTTP handlers, KV clients — must never sit on a
        # disk write inside the tracer lock.  Past the cap, records
        # DROP and are counted (spans_dropped); the in-memory recent
        # buffer and the timeline sink are unaffected.
        self.spans_dropped = 0
        self._wq: "queue.Queue[Optional[Tuple[str, str]]]" = queue.Queue(
            maxsize=8192)
        self._writer_thread: Optional[threading.Thread] = None
        self._writers: Dict[str, object] = {}  # writer-thread only

    # -- wiring ---------------------------------------------------------------

    def set_timeline(self, timeline) -> None:
        """Register a ``timeline.Timeline``; spans additionally render as
        Chrome async/flow events in the in-process trace."""
        self._timeline = timeline

    # -- sampling / context ---------------------------------------------------

    def should_sample(self) -> bool:
        if self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < self.sample

    def new_context(self, trace_id: Optional[str] = None,
                    parent: Optional[str] = None) -> TraceContext:
        """A new span context: fresh trace when ``trace_id`` is None,
        continuation of an upstream hop otherwise (``parent`` = the
        upstream span id from ``X-Parent-Span``)."""
        return TraceContext(trace_id or _gen_id(16), _gen_id(8), parent)

    # -- emission -------------------------------------------------------------

    def emit_span(self, ctx: TraceContext, name: str,
                  t0: float, t1: float, component: str,
                  args: Optional[dict] = None, root: bool = False) -> dict:
        """Record one completed span.  ``t0``/``t1`` are
        ``time.monotonic()`` seconds captured where the work happened
        (retroactive emission keeps the hot path to clock reads).  A
        ``root`` span IS ``ctx``'s own span (parent = ctx.parent_id);
        a non-root span becomes a fresh child of ``ctx``."""
        rec = {"type": "span", "trace": ctx.trace_id,
               "span": ctx.span_id if root else _gen_id(8),
               "parent": ctx.parent_id if root else ctx.span_id,
               "name": name, "proc": component,
               "t0_ns": int(t0 * 1e9), "t1_ns": int(max(t1, t0) * 1e9),
               "args": args or {}}
        self._record(component, rec)
        tl = self._timeline
        if tl is not None:
            try:
                tl.trace_span(ctx.trace_id, name, component,
                              rec["t0_ns"],
                              (rec["t1_ns"] - rec["t0_ns"]) / 1e3,
                              args=dict(rec["args"], span=rec["span"],
                                        parent=rec["parent"]))
            except Exception:
                pass  # telemetry must never take down the request path
        return rec

    def instant(self, ctx: TraceContext, name: str, component: str,
                args: Optional[dict] = None,
                t: Optional[float] = None) -> dict:
        """Request-scoped point event (deadline expiry, resubmission,
        preemption)."""
        t = time.monotonic() if t is None else t
        rec = {"type": "instant", "trace": ctx.trace_id,
               "parent": ctx.span_id, "name": name, "proc": component,
               "t_ns": int(t * 1e9), "args": args or {}}
        self._record(component, rec)
        tl = self._timeline
        if tl is not None:
            try:
                tl.trace_instant(ctx.trace_id, name, component,
                                 args=rec["args"], mono_ns=rec["t_ns"])
            except Exception:
                pass
        return rec

    def flow(self, ctx: TraceContext, name: str, component: str,
             end: bool = False) -> None:
        """Per-decode-iteration flow: the first call per trace emits the
        flow START, later calls STEPs, ``end=True`` the FINISH — Perfetto
        draws the token stream as arrows through the request's spans."""
        with self._lock:
            started = self._flow_state.get(ctx.trace_id, False)
            if end:
                self._flow_state.pop(ctx.trace_id, None)
            else:
                self._flow_state[ctx.trace_id] = True
        phase = "f" if end else ("t" if started else "s")
        rec = {"type": "flow", "trace": ctx.trace_id, "name": name,
               "proc": component, "phase": phase,
               "t_ns": time.monotonic_ns()}
        self._record(component, rec)
        tl = self._timeline
        if tl is not None:
            try:
                tl.trace_flow(ctx.trace_id, name, component, phase,
                              mono_ns=rec["t_ns"])
            except Exception:
                pass

    # -- sinks ----------------------------------------------------------------

    def _record(self, component: str, rec: dict) -> None:
        # Serialization outside the lock (pure CPU); the ENQUEUE stays
        # inside the _closed-checked section — a put racing close()
        # past the check would land behind the shutdown sentinel and
        # vanish uncounted.  put_nowait never blocks, so no IO happens
        # under the lock; file writes live on the writer thread.
        line = json.dumps(rec) if self.shard_dir is not None else None
        with self._lock:
            if self._closed:
                return
            self.spans_emitted += 1
            spans = self._traces.get(rec["trace"])
            if spans is None:
                spans = self._traces[rec["trace"]] = []
                while len(self._traces) > self._recent_cap:
                    evicted, _ = self._traces.popitem(last=False)
                    self._flow_state.pop(evicted, None)
            spans.append(rec)
            if line is not None:
                if self._writer_thread is None:
                    self._writer_thread = threading.Thread(
                        target=self._drain_shards, daemon=True,
                        name="hvdtrace-writer")
                    self._writer_thread.start()
                try:
                    self._wq.put_nowait((component, line))
                except queue.Full:
                    # A full queue drops the record (counted) rather
                    # than stalling the request path.
                    self.spans_dropped += 1

    # -- shard writer thread --------------------------------------------------

    def _drain_shards(self) -> None:
        while True:
            item = self._wq.get()
            if item is None:
                return
            component, line = item
            try:
                self._writer(component).write(line + "\n")
            except Exception:
                self.shard_dir = None  # disk trouble: stop shard IO

    def _writer(self, component: str):
        """Per-component shard file, opened lazily (WRITER THREAD only)
        with a clock-anchor header (merge.py aligns shards on it).
        Filenames are host-qualified — a bare pid collides across
        hosts (_proc_tag)."""
        fh = self._writers.get(component)
        if fh is None:
            os.makedirs(self.shard_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in component)
            path = os.path.join(
                self.shard_dir, f"trace-{_proc_tag()}-{safe}.jsonl")
            fh = open(path, "a", buffering=1)
            fh.write(json.dumps(clock_anchor(component,
                                             rank=self.rank)) + "\n")
            self._writers[component] = fh
        return fh

    # -- /trace endpoint ------------------------------------------------------

    def recent_traces(self, limit: Optional[int] = None) -> List[dict]:
        """The most recent traces as span trees (newest first) — the
        ``/trace`` endpoint's payload.  ``limit`` defaults to the full
        buffer (``HVD_TRACE_RECENT``) — the knob that sizes what the
        endpoint serves."""
        from .merge import build_tree, local_roots
        limit = self._recent_cap if limit is None else limit
        with self._lock:
            items = list(self._traces.items())[-max(limit, 1):]
        out = []
        for trace_id, recs in reversed(items):
            spans = [r for r in recs if r["type"] == "span"]
            out.append({
                "trace_id": trace_id,
                # A trace continued from upstream roots at a span whose
                # parent lives on the other service — still complete
                # locally once that root span is emitted.
                "complete": bool(local_roots(spans)),
                "events": len(recs),
                "tree": build_tree(spans),
            })
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            writer = self._writer_thread
            self._writer_thread = None
        if writer is not None:
            from ..timeline import force_put_sentinel

            def count_drop():
                with self._lock:
                    self.spans_dropped += 1
            # _closed is set, so no new records enqueue.
            force_put_sentinel(self._wq, count_drop)
            writer.join(timeout=5)
            if writer.is_alive():
                return  # wedged on disk: abandon, daemon dies with us
        writers, self._writers = dict(self._writers), {}
        for fh in writers.values():
            try:
                fh.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# clock anchors
# ---------------------------------------------------------------------------

def clock_anchor(label: str, rank: int = 0) -> dict:
    """A (wall, monotonic) clock pairing for shard alignment, keyed by
    host-qualified process identity (a bare pid collides across
    hosts)."""
    return {"type": "anchor", "label": label, "pid": os.getpid(),
            "proc": _proc_tag(), "rank": int(rank),
            "wall_ns": time.time_ns(), "mono_ns": time.monotonic_ns()}


def publish_clock_anchor(kv_client, label: str, rank: int = 0) -> dict:
    """Publish this process's clock anchor through the rendezvous KV
    (scope ``hvdtrace-clock``) with the measured put round-trip time —
    the merge refines shard alignment with these and reports the RTT as
    the cross-host skew bound (module doc)."""
    anchor = clock_anchor(label, rank=rank)
    key = f"{_proc_tag()}-{label}"
    t0 = time.monotonic_ns()
    kv_client.put(CLOCK_SCOPE, key, json.dumps(anchor).encode())
    anchor["rtt_ns"] = time.monotonic_ns() - t0
    # Second put carries the RTT measurement itself (idempotent key).
    kv_client.put(CLOCK_SCOPE, key, json.dumps(anchor).encode())
    return anchor


# ---------------------------------------------------------------------------
# install / env bootstrap
# ---------------------------------------------------------------------------

def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process's active tracer and wire the ambient
    timeline (if one is running) so spans land in the in-process
    Chrome trace too."""
    global TRACER
    try:
        from .. import core as _core
        tl = getattr(_core._state, "timeline", None)
        if tl is not None:
            tracer.set_timeline(tl)
        if _core.is_initialized():
            tracer.rank = _core.rank()
    except Exception:
        pass
    TRACER = tracer
    return tracer


def active_tracer() -> Optional["Tracer"]:
    """The live tracer (None when off).  Importable consumers must read
    through this (or ``tracing.TRACER``) — a ``from ... import TRACER``
    snapshot taken before install() stays None forever."""
    return TRACER


def uninstall() -> None:
    global TRACER
    t = TRACER
    TRACER = None
    if t is not None:
        t.close()


def maybe_install_from_env() -> Optional[Tracer]:
    """One-shot env bootstrap (``HVD_TRACE_SAMPLE`` / ``HVD_TRACE_DIR``),
    constructor-time like faultline's: the env is read when the first
    instrumented subsystem comes up.  Checked once per process; a
    programmatically-installed tracer is never overridden."""
    global _env_checked
    if TRACER is not None:
        return TRACER
    with _env_lock:
        if _env_checked or TRACER is not None:
            return TRACER
        _env_checked = True
        try:
            sample = float(os.environ.get("HVD_TRACE_SAMPLE", "0"))
        except ValueError:
            sample = 0.0
        if sample <= 0.0:
            return None
        return install(Tracer(sample=sample,
                              shard_dir=os.environ.get("HVD_TRACE_DIR")
                              or None))
