"""Horovod-Timeline-compatible Chrome-trace profiler.

Copy of ``horovod_tpu/timeline.py`` (the port keeps its own copy: it
imports nothing of the JAX package); the writer, its bounded queue with
counted drops and ``mark_cycle`` are unchanged.

Reference: horovod/common/timeline.{h,cc} — a Chrome trace JSON
(``HOROVOD_TIMELINE=/path`` or the ``horovod_start_timeline`` runtime API,
operations.cc:1077).  Each tensor gets a lifecycle: NEGOTIATE_<OP> instant
events as ranks' requests arrive, then a top-level op state, then nested
*activities* (macros common.h:80-114).  Events flow through a bounded
queue to a dedicated writer thread (timeline.h:84-92) so the hot path
never blocks on IO.

In the port an op's span covers the host's part of it: negotiation and
the enqueue of the NCCL (or gloo) call.  NCCL runs asynchronously on the
card, so the span ends when the collective is queued, not when it has
run, as the JAX package's spans cover an asynchronous dispatch.  The
device plane is ``torch.profiler``'s.  The file is valid Chrome-trace
JSON (array form, openable in chrome://tracing / Perfetto).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

# Activity names preserved from the reference (common.h:80-114).
QUEUE = "QUEUE"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
WAIT_FOR_OTHER_TENSOR_DATA = "WAIT_FOR_OTHER_TENSOR_DATA"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
XLA_EXECUTE = "XLA_EXECUTE"
TRACE_CACHE_HIT = "TRACE_CACHE_HIT"
TRACE_COMPILE = "TRACE_COMPILE"

# Ring-collective hop events (no reference analog — the reference has no
# ring/sequence parallelism).  RING_HOP carries the traced hop schedule
# (parallel/ring.py set_ring_timeline); RING_KERNEL / RING_TRANSFER carry
# measured per-hop spans (bench.py ring microbench) so kernel time and ICI
# transfer time are separable in the trace viewer.
RING_HOP = "RING_HOP"
RING_KERNEL = "RING_KERNEL"
RING_TRANSFER = "RING_TRANSFER"

# Serving-plane counters (no reference analog — the reference is
# training-only).  serve/metrics.py publishes engine statistics (tokens,
# batch occupancy, queue depth, latency quantiles) as counter events under
# SERVE/<component> so a serving run's trace charts them next to any
# training-side op lifecycle in the same viewer.
SERVE = "SERVE"

# Fault-injection firings (faultline/plan.py): every fault a FaultPlan
# fires is an instant event under FAULTLINE/<kind>, so a chaos run's
# trace shows exactly what broke, where (injection point + instance),
# and at which step index — the reproducibility artifact two same-seed
# runs must agree on (docs/fault_injection.md).
FAULTLINE = "FAULTLINE"

# Brownout rung transitions (serve/controller.py ladder): every rung
# change the fleet controller walks is an instant event under
# BROWNOUT/<direction>, so a soak's trace shows exactly when the fleet
# started degrading, how deep it went, and when it recovered — next to
# the FAULTLINE instants that caused it.
BROWNOUT = "BROWNOUT"

# Live weight hot-swap transitions (serve/registry.py roll): every
# per-replica phase of a rollout — drain, swap, alive, abort — is an
# instant event under SWAP/<model>, so a trace shows the replica-by-
# replica walk of a roll next to the replica death/revival events it
# rides on, and exactly where an aborted roll stopped.
SWAP = "SWAP"

# Lock-witness findings (analysis/witness.py, HVD_SANITIZE=1): every
# observed lock-order inversion / naked wait is an instant event under
# WITNESS/<rule>, so a sanitized run's trace shows the near-deadlock at
# the moment it happened, next to the serve/fault events.
WITNESS = "WITNESS"

# Static per-step collective census (no reference analog — the reference
# only learns the collective set at runtime through negotiation; on TPU
# the jaxpr checker reads it off the traced program, analysis/
# jaxpr_check.py).  Rendered as Chrome-trace counter events so the
# viewer charts collective count/bytes per primitive next to the op
# lifecycle.
COLLECTIVE_CENSUS = "COLLECTIVE_CENSUS"

# Static per-step MEMORY census (hvdmem, analysis/memplan.py): the
# jaxpr liveness walk's peak-live-bytes estimate and per-primitive
# allocation breakdown, plus the serve engine's pool-budget plan
# (pool + weights vs HVD_MEM_BUDGET_BYTES).  Rendered as counter
# events so the viewer charts the footprint a program was PLANNED to
# have next to what the op lifecycle actually did with it.
MEMORY_CENSUS = "MEMORY_CENSUS"

# Static per-step COMMUNICATION census (hvdshard, analysis/
# shardplan.py): per-collective wire bytes (payload x communicator
# group size), the ICI vs DCN fabric split per mesh axis, implicit-
# reshard bytes (HVD400), and the comm-budget headrooms
# (HVD_COMM_BUDGET_BYTES / HVD_COMM_DCN_BUDGET_BYTES).  Rendered as
# counter events so the viewer charts what a step was PLANNED to move
# over each fabric next to the op lifecycle that moved it.
COMM_CENSUS = "COMM_CENSUS"

# Elastic world transitions (elastic/__init__.py): instant events
# around the scale-down/scale-up barriers — reset entered (old world
# still up), world adopted (new world initialized) — so a wedged or
# flaky resize leaves a post-mortem trail of WHICH barrier the stall
# sat in and which world versions were involved.
ELASTIC = "ELASTIC"

# Distributed request tracing (obs/tracing.py, docs/observability.md):
# per-request spans render as Chrome ASYNC events ("b"/"e") keyed by the
# request's trace_id, so one /generate call's http-handle → route →
# queue-wait → prefill → decode lifecycle nests in its own lane next to
# the training-op lifecycle, FAULTLINE instants, and SERVE counters.
# Per-decode-iteration progress renders as FLOW events ("s"/"t"/"f")
# under the same id — Perfetto draws the token stream as arrows through
# the request's spans.
HVDTRACE = "hvdtrace"
HVDTRACE_FLOW = "hvdtrace-flow"


def force_put_sentinel(q: "queue.Queue", on_drop) -> None:
    """Deliver a ``None`` shutdown sentinel to a bounded queue WITHOUT
    blocking: the producer side must already be closed (no new puts),
    so if the queue is full, discard queued items — accounting each via
    ``on_drop()``, they will never be written — until the sentinel
    fits.  Shared by the Timeline and Tracer writer shutdown paths: a
    silently-lost sentinel leaves a healthy writer parked in ``get()``
    forever."""
    while True:
        try:
            q.put_nowait(None)
            return
        except queue.Full:
            try:
                q.get_nowait()
                on_drop()
            except queue.Empty:
                continue


class Timeline:
    """Chrome-trace writer with a background writer thread
    (TimelineWriter, timeline.h:48)."""

    def __init__(self, path: str, mark_cycles: bool = False, rank: int = 0,
                 queue_cap: Optional[int] = None):
        self.path = path
        self.mark_cycles = mark_cycles
        self.rank = rank
        # BOUNDED event queue (HVD_TIMELINE_QUEUE_CAP): a stalled writer
        # thread (wedged disk, dead NFS mount) must cost bounded memory —
        # the hot path drops events past the cap rather than queueing
        # unbounded, and every drop is COUNTED so a truncated trace is
        # never mistaken for a complete one (the total surfaces as a
        # counter event at close and as
        # ``hvd_timeline_dropped_events_total`` on serve /metrics).
        cap = queue_cap if queue_cap is not None else int(
            os.environ.get("HVD_TIMELINE_QUEUE_CAP", str(1 << 16)))
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=max(cap, 2))
        self._dropped = 0
        self._drop_lock = threading.Lock()
        self._start = time.monotonic_ns()
        self._closed = False
        self._fh = open(path, "w")
        self._fh.write("[\n")
        self._first = True
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="hvd-timeline-writer")
        self._writer.start()
        self._emit_meta()

    # -- event api ----------------------------------------------------------

    def _ts_us(self) -> float:
        return (time.monotonic_ns() - self._start) / 1e3

    def ts_of(self, mono_ns: int) -> float:
        """Map a caller-captured ``time.monotonic_ns()`` stamp onto this
        timeline's microsecond axis (retroactive span emission: the
        tracer records span boundaries where they happen and emits the
        whole span at its end)."""
        return (mono_ns - self._start) / 1e3

    @property
    def dropped_events(self) -> int:
        """Events dropped at the bounded queue so far (module doc)."""
        with self._drop_lock:
            return self._dropped

    def _put(self, ev: dict) -> None:
        if self._closed:
            return
        try:
            self._queue.put_nowait(ev)
        except queue.Full:
            # Drop rather than stall the hot path (reference SPSC
            # behavior) — but ACCOUNT the drop (class doc).
            with self._drop_lock:
                self._dropped += 1

    def _emit_meta(self):
        self._put({"name": "process_name", "ph": "M", "pid": self.rank,
                   "args": {"name": f"horovod_tpu rank {self.rank}"}})

    def negotiate_start(self, tensor_name: str, op_type: str):
        """NEGOTIATE_<OP> phase begin (timeline.cc NegotiateStart)."""
        self._put({"name": f"NEGOTIATE_{op_type}", "ph": "B",
                   "ts": self._ts_us(), "pid": self.rank, "tid": tensor_name})

    def negotiate_rank_ready(self, tensor_name: str, req_rank: int):
        """Instant event per rank whose request arrived (timeline.cc
        NegotiateRankReady)."""
        self._put({"name": str(req_rank), "ph": "i", "s": "t",
                   "ts": self._ts_us(), "pid": self.rank, "tid": tensor_name})

    def negotiate_end(self, tensor_name: str, op_type: str):
        self._put({"name": f"NEGOTIATE_{op_type}", "ph": "E",
                   "ts": self._ts_us(), "pid": self.rank, "tid": tensor_name})

    def start(self, tensor_name: str, op_type: str):
        """Top-level op state begin (timeline.cc Start)."""
        self._put({"name": op_type, "ph": "B", "ts": self._ts_us(),
                   "pid": self.rank, "tid": tensor_name})

    def activity_start(self, tensor_name: str, activity: str):
        self._put({"name": activity, "ph": "B", "ts": self._ts_us(),
                   "pid": self.rank, "tid": tensor_name})

    def activity_end(self, tensor_name: str, activity: str):
        self._put({"name": activity, "ph": "E", "ts": self._ts_us(),
                   "pid": self.rank, "tid": tensor_name})

    def end(self, tensor_name: str, op_type: str):
        self._put({"name": op_type, "ph": "E", "ts": self._ts_us(),
                   "pid": self.rank, "tid": tensor_name})

    def ring_hop(self, tensor_name: str, hop: int, *, bytes_rotated: int,
                 mask: str = "none", schedule: str = "overlap",
                 skipped_shards: int = 0, dur_us: float = 0.0):
        """One ring-collective hop of the traced schedule (complete-event
        form): hop index, K/V bytes rotated over ICI that hop, the mask
        rule, the hop schedule, and how many shards take the true-skip arm
        instead of running a kernel.  Emitted at TRACE time by
        parallel/ring.py when a timeline is registered via
        ``set_ring_timeline`` — the device plane inside jit is invisible to
        the host (module docstring), so these document the schedule, while
        ``ring_span`` carries measured spans."""
        self._put({"name": f"{RING_HOP}_{hop}", "ph": "X",
                   "ts": self._ts_us(), "dur": dur_us,
                   "pid": self.rank, "tid": tensor_name,
                   "args": {"hop": hop, "bytes_rotated": bytes_rotated,
                            "mask": mask, "schedule": schedule,
                            "skipped_shards": skipped_shards}})

    def ring_span(self, tensor_name: str, hop: int, kind: str,
                  start_us: float, dur_us: float, **args):
        """Measured span for one ring hop: ``kind`` is RING_KERNEL (per-hop
        attention/fold compute) or RING_TRANSFER (the K/V ppermute).  Used
        by the bench ring microbench, which times single-hop programs to
        attribute step time to kernel vs transfer."""
        self._put({"name": f"{kind}_{hop}", "ph": "X", "ts": start_us,
                   "dur": dur_us, "pid": self.rank, "tid": tensor_name,
                   "args": dict(args, hop=hop)})

    def collective_census(self, step_name: str, census: dict):
        """Per-step collective census from the jaxpr checker
        (HVD_ANALYZE=1, analysis/hook.py): ``census`` maps primitive name
        → {"count", "bytes"}.  One counter event per primitive —
        count/bytes chart as stacked counters in the trace viewer."""
        for prim in sorted(census):
            info = census[prim]
            self._put({"name": f"{COLLECTIVE_CENSUS}/{step_name}/{prim}",
                       "ph": "C", "ts": self._ts_us(), "pid": self.rank,
                       "args": {"count": int(info.get("count", 0)),
                                "bytes": int(info.get("bytes", 0))}})

    def memory_census(self, step_name: str, mem: dict):
        """Per-program memory census from the hvdmem liveness walk
        (HVD_ANALYZE=1, analysis/memplan.py): one totals counter (peak /
        input / output / budget-headroom bytes) plus one counter per
        allocating primitive, mirroring ``collective_census``."""
        totals = {"peak_live_bytes": int(mem.get("peak_live_bytes", 0)),
                  "input_bytes": int(mem.get("input_bytes", 0)),
                  "output_bytes": int(mem.get("output_bytes", 0))}
        if mem.get("headroom_bytes") is not None:
            totals["headroom_bytes"] = int(mem["headroom_bytes"])
        self._put({"name": f"{MEMORY_CENSUS}/{step_name}", "ph": "C",
                   "ts": self._ts_us(), "pid": self.rank, "args": totals})
        by_prim = mem.get("by_primitive") or {}
        for prim in sorted(by_prim):
            info = by_prim[prim]
            self._put({"name": f"{MEMORY_CENSUS}/{step_name}/{prim}",
                       "ph": "C", "ts": self._ts_us(), "pid": self.rank,
                       "args": {"count": int(info.get("count", 0)),
                                "bytes": int(info.get("bytes", 0))}})

    def comm_census(self, step_name: str, comm: dict):
        """Per-program communication census from the hvdshard walk
        (HVD_ANALYZE=1, analysis/shardplan.py): one totals counter
        (total/DCN wire bytes, reshard bytes, budget headrooms), one
        counter per collective primitive, and one per mesh axis with
        its ICI/DCN fabric — mirroring ``memory_census``."""
        totals = {"total_wire_bytes": int(comm.get("total_wire_bytes", 0)),
                  "dcn_wire_bytes": int(comm.get("dcn_wire_bytes", 0)),
                  "reshard_bytes": int(comm.get("reshard_bytes", 0))}
        if comm.get("headroom_bytes") is not None:
            totals["headroom_bytes"] = int(comm["headroom_bytes"])
        if comm.get("dcn_headroom_bytes") is not None:
            totals["dcn_headroom_bytes"] = int(comm["dcn_headroom_bytes"])
        self._put({"name": f"{COMM_CENSUS}/{step_name}", "ph": "C",
                   "ts": self._ts_us(), "pid": self.rank, "args": totals})
        by_prim = comm.get("by_primitive") or {}
        for prim in sorted(by_prim):
            info = by_prim[prim]
            self._put({"name": f"{COMM_CENSUS}/{step_name}/{prim}",
                       "ph": "C", "ts": self._ts_us(), "pid": self.rank,
                       "args": {"count": int(info.get("count", 0)),
                                "bytes": int(info.get("bytes", 0)),
                                "wire_bytes":
                                    int(info.get("wire_bytes", 0)),
                                "dcn_bytes":
                                    int(info.get("dcn_bytes", 0))}})
        by_axis = comm.get("by_axis") or {}
        for axis in sorted(by_axis):
            info = by_axis[axis]
            self._put({"name":
                       f"{COMM_CENSUS}/{step_name}/axis/{axis}"
                       f"[{info.get('fabric', 'ici')}]",
                       "ph": "C", "ts": self._ts_us(), "pid": self.rank,
                       "args": {"count": int(info.get("count", 0)),
                                "wire_bytes":
                                    int(info.get("wire_bytes", 0)),
                                "size": int(info.get("size", 1))}})

    def elastic_event(self, phase: str, version: int, detail: str = ""):
        """One elastic world transition (elastic/__init__.py):
        process-scoped instant event carrying the phase (``reset`` when
        the old world starts tearing down, ``world`` when the new one is
        adopted) and the world version — the post-mortem breadcrumbs a
        flaky scale-down/scale-up run leaves around its barriers."""
        self._put({"name": f"{ELASTIC}/{phase}", "ph": "i", "s": "p",
                   "ts": self._ts_us(), "pid": self.rank, "tid": "elastic",
                   "args": {"world_version": int(version),
                            "detail": detail}})

    def serve_counter(self, component: str, values: dict):
        """Serving-engine counter sample (serve/metrics.py): ``values``
        maps statistic name → number.  One counter event per sample —
        occupancy/queue/token counters chart as stacked series in the
        trace viewer under SERVE/<component>."""
        self._put({"name": f"{SERVE}/{component}", "ph": "C",
                   "ts": self._ts_us(), "pid": self.rank,
                   "args": {k: (float(v) if isinstance(v, float) else int(v))
                            for k, v in values.items()}})

    def fault_event(self, kind: str, point: str, instance: str,
                    step: int, trace_id: Optional[str] = None):
        """One fault firing (faultline): process-scoped instant event
        carrying the injection point, instance, and step index — plus
        the request trace_id when the fault fired inside a traced
        request scope (obs/tracing.py), so a chaos run's trace shows
        WHICH request each fault hit."""
        args = {"point": point, "instance": instance, "step": int(step)}
        if trace_id is not None:
            args["trace_id"] = trace_id
        self._put({"name": f"{FAULTLINE}/{kind}", "ph": "i", "s": "p",
                   "ts": self._ts_us(), "pid": self.rank, "tid": point,
                   "args": args})

    def brownout_event(self, direction: str, level: int,
                       rung: str = ""):
        """One brownout rung transition (serve/controller.py):
        process-scoped instant event carrying the walk direction
        (``up``/``down``), the rung now in effect, and its description
        — the trace-side record of WHEN the fleet degraded gracefully
        and when it recovered."""
        self._put({"name": f"{BROWNOUT}/{direction}", "ph": "i",
                   "s": "p", "ts": self._ts_us(), "pid": self.rank,
                   "tid": "hvdctl",
                   "args": {"level": int(level), "rung": rung}})

    def swap_event(self, model: str, replica: str, phase: str,
                   version: int):
        """One hot-swap phase transition (serve/registry.py roll):
        process-scoped instant event carrying the replica being walked,
        the phase (``drain``/``swap``/``alive``/``abort``), and the
        target version — the trace-side record of a live rollout's
        replica-by-replica progress."""
        self._put({"name": f"{SWAP}/{model}", "ph": "i", "s": "p",
                   "ts": self._ts_us(), "pid": self.rank,
                   "tid": "hvdswap",
                   "args": {"replica": replica, "phase": phase,
                            "version": int(version)}})

    def witness_event(self, rule: str, site_path: str, site_line: int,
                      thread_name: str):
        """One lock-witness finding (analysis/witness.py HVD210/HVD211):
        process-scoped instant event carrying the violating acquisition
        site and the thread that performed it."""
        self._put({"name": f"{WITNESS}/{rule}", "ph": "i", "s": "p",
                   "ts": self._ts_us(), "pid": self.rank,
                   "tid": thread_name,
                   "args": {"site": f"{site_path}:{int(site_line)}",
                            "thread": thread_name}})

    def trace_span(self, trace_id: str, name: str, tid: str,
                   start_mono_ns: int, dur_us: float,
                   args: Optional[dict] = None):
        """One request-trace span (obs/tracing.py): Chrome ASYNC begin/end
        pair keyed by the request's trace_id, so every span of one
        request nests in one lane across components.  ``start_mono_ns``
        is a caller-captured ``time.monotonic_ns()`` stamp (spans are
        emitted retroactively at their end)."""
        ts = self.ts_of(start_mono_ns)
        base = {"cat": HVDTRACE, "id": trace_id, "name": name,
                "pid": self.rank, "tid": tid}
        self._put(dict(base, ph="b", ts=ts, args=args or {}))
        self._put(dict(base, ph="e", ts=ts + max(dur_us, 0.0)))

    def trace_flow(self, trace_id: str, name: str, tid: str, phase: str,
                   mono_ns: Optional[int] = None):
        """One request-trace flow event (``phase`` in s/t/f): the
        per-decode-iteration token stream renders as arrows through the
        request's spans in Perfetto."""
        ts = self.ts_of(mono_ns) if mono_ns is not None else self._ts_us()
        ev = {"cat": HVDTRACE_FLOW, "id": trace_id, "name": name,
              "ph": phase, "ts": ts, "pid": self.rank, "tid": tid}
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice's end
        self._put(ev)

    def trace_instant(self, trace_id: str, name: str, tid: str,
                      args: Optional[dict] = None,
                      mono_ns: Optional[int] = None):
        """Request-scoped instant event (deadline expiry, resubmission,
        preemption) carrying the trace_id in its args."""
        ts = self.ts_of(mono_ns) if mono_ns is not None else self._ts_us()
        self._put({"name": f"{HVDTRACE}/{name}", "ph": "i", "s": "p",
                   "ts": ts, "pid": self.rank, "tid": tid,
                   "args": dict(args or {}, trace_id=trace_id)})

    def mark_cycle(self):
        """Optional cycle marker (HOROVOD_TIMELINE_MARK_CYCLES,
        timeline.cc MarkCycle)."""
        if self.mark_cycles:
            self._put({"name": "CYCLE", "ph": "i", "s": "g",
                       "ts": self._ts_us(), "pid": self.rank, "tid": "cycles"})

    class _Activity:
        def __init__(self, tl, name, activity):
            self.tl, self.name, self.activity = tl, name, activity

        def __enter__(self):
            self.tl.activity_start(self.name, self.activity)
            return self

        def __exit__(self, *exc):
            self.tl.activity_end(self.name, self.activity)
            return False

    def activity(self, tensor_name: str, activity: str) -> "_Activity":
        return self._Activity(self, tensor_name, activity)

    # -- writer thread ------------------------------------------------------

    def _drain(self):
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            line = json.dumps(ev)
            if not self._first:
                self._fh.write(",\n")
            self._first = False
            self._fh.write(line)

    def close(self):
        if self._closed:
            return
        self._closed = True

        def count_drop():
            with self._drop_lock:
                self._dropped += 1
        force_put_sentinel(self._queue, count_drop)
        self._writer.join(timeout=5)
        if self._writer.is_alive():
            # Writer wedged mid-write (dead disk): appending the trailer
            # from this thread would interleave with its writes and
            # closing the handle would crash it — abandon the file; the
            # daemon thread dies with the process.
            return
        with self._drop_lock:
            dropped = self._dropped
        # Drop accounting belongs IN the artifact: a trace missing events
        # must say so.  The writer has exited, so the trailer writes go
        # straight to the file handle.
        line = json.dumps({"name": "hvd_timeline_dropped_events_total",
                           "ph": "C", "ts": self._ts_us(),
                           "pid": self.rank,
                           "args": {"dropped": dropped}})
        if not self._first:
            self._fh.write(",\n")
        self._first = False
        self._fh.write(line)
        self._fh.write("\n]\n")
        self._fh.flush()
        self._fh.close()
