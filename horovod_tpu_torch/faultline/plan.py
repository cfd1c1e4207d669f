"""Deterministic fault schedules: what breaks, where, and at which step.

Copied from ``horovod_tpu/faultline/plan.py``, ``KINDS`` and ``POINTS``
whole.  One difference: the port has no request tracing (``obs/``) yet,
so a firing records no trace id (``_active_trace_id`` returns None).

No reference analog — the reference (and Horovod upstream) proves its
elastic paths with hand-built one-off failure tests.  The model here is
the Jepsen-family discipline instead: faults are DATA (a seeded
schedule), the system under test is instrumented with named *injection
points*, and a run is reproducible because the schedule — not wall-clock
chance — decides when each fault fires.

Vocabulary:

* a **fault kind** names the failure mode (``KINDS``): ``kill-rank``
  (a host's preemption notice / rank loss), ``delay-kv`` /
  ``drop-kv-response`` (control-plane transport flakes), ``poison-step``
  (an engine iteration raises mid-flight), ``slow-decode`` (a stalled
  decode step), ``pool-corrupt-block`` (a cached KV block's contents
  become suspect and must leave the prefix registry),
  ``delay-tier-fetch`` / ``drop-tier-block`` (tiered-KV prefetch /
  migration transport flakes at the ``tier.fetch`` boundary),
  ``drop-route`` / ``slow-route`` / ``blackhole-endpoint`` (front-door
  forwarding flakes at the hvdroute ``router.forward`` boundary),
  ``stream-disconnect`` / ``slow-client`` (a streaming client hanging
  up or stalling at the ``stream.emit`` write boundary);
* an **injection point** names a code location that consults the plan
  (``POINTS``): the serve engine's step boundary (``engine.step``), the
  scheduler's routing path (``replica.route``), the KV client's request
  boundary (``kv.request``), and the preemption sentinel's poll
  (``preempt.poll``);
* a **step index** is that point's own invocation counter (per
  ``instance`` — a replica id, a host name, a client address), so "the
  3rd decode iteration of replica-1" is a stable coordinate across runs.

A :class:`FaultSpec` without an explicit step gets one drawn from
``random.Random(seed)`` in spec order — the whole schedule is a pure
function of (seed, spec list), which is the reproducibility contract
(tests pin identical seed → identical schedule → identical firing log).
Every firing is appended to ``plan.log`` and emitted as a FAULTLINE/*
timeline instant event so a chaos run's trace shows exactly what broke
and when.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Tuple

#: Fault kinds (docs/fault_injection.md has the per-kind semantics).
KINDS = ("kill-rank", "delay-kv", "drop-kv-response", "poison-step",
         "slow-decode", "pool-corrupt-block", "load-spike", "swap-abort",
         "delay-tier-fetch", "drop-tier-block", "drop-route",
         "slow-route", "blackhole-endpoint", "stream-disconnect",
         "slow-client")

#: Injection points threaded through the codebase.  ``sp.prefill`` is
#: the sequence-parallel prefill unit boundary (serve/seqpar.py via
#: engine._sp_step): consulted once per (rank, chunk) compute unit with
#: the replica id as the instance — ``kill-rank`` there acts out losing
#: a rank mid-SP-prefill (every rank's transient extent blocks must
#: free and the request resubmits whole, falling back to single-rank
#: prefill on retry).
POINTS = ("engine.step", "replica.route", "kv.request", "preempt.poll",
          "ctl.poll", "registry.roll", "tier.fetch", "router.forward",
          "stream.emit", "sp.prefill")

#: Default injection point per kind (a spec may override, e.g. kill-rank
#: at replica.route fires report_rank_lost directly instead of going
#: through the sentinel's marker publication).
DEFAULT_POINT = {
    "kill-rank": "preempt.poll",
    "delay-kv": "kv.request",
    "drop-kv-response": "kv.request",
    "poison-step": "engine.step",
    "slow-decode": "engine.step",
    "pool-corrupt-block": "engine.step",
    # A burst of ``param`` synthetic throughput-tier admissions at the
    # fleet controller's poll boundary (serve/controller.py) — the
    # overload the autoscaler/brownout ladder must absorb, as a seeded
    # scheduled fault rather than wall-clock client chance.
    "load-spike": "ctl.poll",
    # Kill a live weight rollout mid-fleet (serve/registry.py roll):
    # fires BEFORE the next replica is touched, so the half-rolled fleet
    # keeps serving both versions and the roll stays resumable.
    "swap-abort": "registry.roll",
    # The tiered-KV prefetcher's fetch boundary (serve/tiering.py):
    # consulted once per ATTEMPT, riding the KV client's retry backoff
    # discipline — ``delay-tier-fetch`` stalls an attempt by ``param``
    # seconds (a prefetch losing its race shows up as a counted
    # tier-fault stall), ``drop-tier-block`` fails it as a transport
    # error; a train longer than HVD_KV_RETRY_MAX exhausts the fetch and
    # the engine degrades to recompute (bit-identical by construction).
    "delay-tier-fetch": "tier.fetch",
    "drop-tier-block": "tier.fetch",
    # The hvdroute front door's forward boundary (serve/router.py):
    # consulted once per forward ATTEMPT with the candidate endpoint as
    # the instance — ``drop-route`` fails the attempt as a transport
    # error (the router's retry/failover discipline absorbs it),
    # ``slow-route`` stalls it by ``param`` seconds (the tail the hedging
    # arm must beat), ``blackhole-endpoint`` makes the TARGET endpoint
    # unreachable for ``param`` seconds (every attempt fails, half-open
    # probes included — the ejection/readmission walk under test).
    # ``kill-rank`` may be pointed here too (/router.forward): a rank
    # loss DETECTED at the front door, acted out as immediate ejection
    # of the target endpoint.
    "drop-route": "router.forward",
    "slow-route": "router.forward",
    "blackhole-endpoint": "router.forward",
    # The streamed-response write boundary (serve/server.py
    # _write_stream_frame): consulted once per SSE frame with the
    # request id as the instance — ``stream-disconnect`` acts out the
    # client hanging up mid-stream (a BrokenPipeError exactly where a
    # real hangup surfaces, so the abort-frees-blocks walk is the REAL
    # one), ``slow-client`` stalls the write by ``param`` seconds (the
    # slow consumer the bounded token queue must absorb by coalescing,
    # never by dropping).
    "stream-disconnect": "stream.emit",
    "slow-client": "stream.emit",
}

#: Step-assignment window for specs without an explicit ``@step``: drawn
#: uniformly from [1, HORIZON] so seeded runs spread faults over the
#: early steady state instead of stacking them all on step 0.
HORIZON = 16


def _active_trace_id():
    """The request trace active on the FAULTING thread, if any
    (obs/tracing.py contextvar): a fault firing inside a traced request
    scope — a dropped KV response under a traced /generate handler, a
    kill-rank at a traced routing decision — records WHICH request it
    hit, so a chaos run's trace correlates faults with victims."""
    # The port has no ``obs/`` package yet: no request is ever traced,
    # so there is no trace id to record.  Restore the lookup of
    # ``obs.tracing.current_trace_id()`` when ``obs/`` is ported.
    return None


class FaultInjected(Exception):
    """Raised by an injection point acting out ``poison-step`` (and the
    error in-flight requests observe).  A distinct type so tests and
    recovery paths can tell an injected fault from an organic one."""


class FaultSpec:
    """One scheduled fault.

    ``step`` is the firing index at ``point`` (per instance); ``repeat``
    widens it to a window of consecutive indices (a flake *train* — e.g.
    two dropped KV responses in a row exercises retry exhaustion, one
    does not).  ``target`` narrows the firing to a single instance
    (replica id / host / client); None fires at whichever instance's
    counter reaches the index first and then never again.
    """

    __slots__ = ("kind", "point", "step", "target", "repeat", "param",
                 "fired")

    def __init__(self, kind: str, point: Optional[str] = None,
                 step: Optional[int] = None, target: Optional[str] = None,
                 repeat: int = 1, param: float = 0.0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        self.kind = kind
        self.point = point or DEFAULT_POINT[kind]
        if self.point not in POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; one of {POINTS}")
        self.step = step            # None until the plan assigns it
        self.target = target
        self.repeat = max(int(repeat), 1)
        self.param = float(param)
        self.fired = 0              # firings so far (<= repeat)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "point": self.point, "step": self.step,
                "target": self.target, "repeat": self.repeat,
                "param": self.param, "fired": self.fired}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultSpec({self.kind}@{self.point}:{self.step}"
                f"{'/' + self.target if self.target else ''}"
                f"x{self.repeat})")


def parse_spec(text: str) -> FaultSpec:
    """One spec from the ``HVD_FAULTLINE_PLAN`` grammar:

    ``kind[:target][@step][*repeat][~param][/point]``

    e.g. ``kill-rank:chaos-host@4*3``, ``drop-kv-response@1*2``,
    ``poison-step:replica-1@6``, ``slow-decode~0.05``.  The suffix
    markers may appear in any order (``slow-decode~0.05@2`` ==
    ``slow-decode@2~0.05``); each at most once.
    """
    import re
    m = re.match(r"^([^:@*~/]+)(?::([^@*~/]+))?((?:[@*~/][^@*~/]+)*)$",
                 text.strip())
    if not m:
        raise ValueError(f"unparseable fault spec {text!r}")
    kind, target, rest = m.group(1), m.group(2), m.group(3)
    point, step = None, None
    repeat, param = 1, 0.0
    seen = set()
    for marker, value in re.findall(r"([@*~/])([^@*~/]+)", rest or ""):
        if marker in seen:
            raise ValueError(
                f"duplicate '{marker}' in fault spec {text!r}")
        seen.add(marker)
        if marker == "@":
            step = int(value)
        elif marker == "*":
            repeat = int(value)
        elif marker == "~":
            param = float(value)
        else:
            point = value
    return FaultSpec(kind, point=point, step=step, target=target,
                     repeat=repeat, param=param)


def parse_plan(text: str, seed: int = 0) -> "FaultPlan":
    """``HVD_FAULTLINE_PLAN``: comma-separated :func:`parse_spec` items."""
    specs = [parse_spec(t) for t in text.split(",") if t.strip()]
    return FaultPlan(specs, seed=seed)


def diurnal_load(steps: int, peak: int, base: int = 0, seed: int = 0,
                 jitter: float = 0.25) -> List[int]:
    """Seeded diurnal load shape: per-step request counts sweeping
    ``base`` → ``peak`` → ``base`` over ``steps`` ticks (half-sine)
    with seeded multiplicative jitter — realistic texture, yet a pure
    function of its arguments, so the chaos soak and the bench
    autoscale arm replay the identical curve (docs/fault_injection.md).
    The same discipline as fault steps: LOAD is data, not wall-clock
    chance."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if not 0 <= base <= peak:
        raise ValueError(f"need 0 <= base <= peak, got {base}/{peak}")
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    rng = random.Random(seed)
    out: List[int] = []
    for i in range(steps):
        level = base + (peak - base) * math.sin(
            math.pi * (i + 0.5) / steps)
        level *= 1.0 + jitter * (rng.random() * 2.0 - 1.0)
        out.append(max(int(round(level)), 0))
    return out


class FaultPlan:
    """A seeded fault schedule plus the firing state of one run.

    Construction assigns every step-less spec its index from
    ``random.Random(seed)`` **in spec order** — the schedule is decided
    up front, before anything runs, so two processes given the same
    (seed, specs) agree on it without coordination.  ``fire`` is the
    single runtime entry: an injection point reports "I am instance X of
    point P at my next index" and receives the specs that fire there.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        # COPY the specs: the plan assigns steps and tracks firing state
        # on them, and mutating the caller's objects would break the
        # pure-function-of-(seed, specs) contract — a second plan built
        # from the same list would inherit the first run's assigned
        # steps and fired counts (silently inert faults).
        self.specs = [FaultSpec(s.kind, point=s.point, step=s.step,
                                target=s.target, repeat=s.repeat,
                                param=s.param) for s in specs]
        rng = random.Random(self.seed)
        for s in self.specs:
            # Draw for EVERY spec (explicit steps too): the stream
            # position then depends only on spec order, so adding an
            # explicit step to one spec never reshuffles the others.
            drawn = rng.randint(1, HORIZON)
            if s.step is None:
                s.step = drawn
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        #: Ordered firing log: dicts of point/instance/step/kind/target.
        self.log: List[dict] = []
        self._timeline = None

    # -- wiring ---------------------------------------------------------------

    def set_timeline(self, timeline) -> None:
        """Register a ``timeline.Timeline``; firings emit FAULTLINE/*
        instant events (runtime.install wires the ambient one)."""
        self._timeline = timeline

    def schedule(self) -> List[dict]:
        """The assigned schedule (inspectable before anything runs)."""
        return [s.to_dict() for s in self.specs]

    def targets_point(self, point: str) -> bool:
        """Does any spec fire at ``point``?  Injection points use this to
        gate behavior substitutions (e.g. the sentinel's unreachable-
        metadata→NONE reading) to plans that actually exercise them — a
        plan poking only the KV layer must not change preemption
        semantics on a real cluster."""
        return any(s.point == point for s in self.specs)

    # -- runtime --------------------------------------------------------------

    def count(self, point: str, instance: Optional[str] = None) -> int:
        """How many times ``instance`` consulted ``point`` so far."""
        with self._lock:
            return self._counters.get((point, instance or ""), 0)

    def fire(self, point: str,
             instance: Optional[str] = None) -> List[FaultSpec]:
        """Advance ``instance``'s counter at ``point``; return the specs
        whose firing window covers the new index (and record them)."""
        key = (point, instance or "")
        fired: List[FaultSpec] = []
        with self._lock:
            idx = self._counters.get(key, 0)
            self._counters[key] = idx + 1
            for s in self.specs:
                if s.point != point:
                    continue
                if s.target is not None and instance is not None \
                        and s.target != instance:
                    continue
                if s.step <= idx < s.step + s.repeat and s.fired < s.repeat:
                    s.fired += 1
                    fired.append(s)
                    self.log.append({
                        "point": point, "instance": instance or "",
                        "step": idx, "kind": s.kind, "target": s.target,
                        "trace_id": _active_trace_id()})
            events = list(self.log[-len(fired):]) if fired else []
        for ev in events:
            self._emit(ev)
        return fired

    def firing_sequence(self) -> List[Tuple[str, int, str]]:
        """(point, step, kind) triples in firing order — the acceptance
        artifact two same-seed runs must agree on."""
        with self._lock:
            return [(e["point"], e["step"], e["kind"]) for e in self.log]

    def exhausted(self) -> bool:
        """True once every spec has fired its full window."""
        with self._lock:
            return all(s.fired >= s.repeat for s in self.specs)

    # -- telemetry ------------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        from ..utils import get_logger
        get_logger().warning(
            "faultline: %s fired at %s[%s] step %d%s", ev["kind"],
            ev["point"], ev["instance"], ev["step"],
            f" trace_id={ev['trace_id']}" if ev.get("trace_id") else "")
        tl = self._timeline
        if tl is None:
            return
        try:
            tl.fault_event(ev["kind"], ev["point"], ev["instance"],
                           ev["step"], trace_id=ev.get("trace_id"))
        except Exception:
            pass  # telemetry must never amplify the injected fault
