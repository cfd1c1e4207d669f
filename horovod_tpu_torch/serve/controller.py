"""hvdctl: SLO-aware fleet controller — autoscaling, QoS-aware brownout.

Copied from ``horovod_tpu/serve/controller.py`` (pure Python; the port
keeps its own copy).  It observes the port's fleet (``ReplicaScheduler``,
``ServeMetrics``) and actuates through ``mark_alive`` / ``mark_dead`` and
the batchers' and engines' brownout fields.

The fleet's closing layer: every input already exists —
``hvd_serve_stage_ms`` per-stage latency histograms, per-replica queue
depth, ``kv_headroom_bytes`` — and the grow/shrink primitives
(``mark_alive`` / ``add_replica`` / ``mark_dead``) are proven under
faultline chaos, but nothing closed the loop.  This module does: a
controller thread polls a fleet snapshot, feeds it through a PURE
decision function, and actuates the result.

Design (three deliberately separated pieces):

* **``decide()`` is a pure function** over ``(config, state, snapshot,
  now)`` — table-driven tests exercise every transition (scale-up,
  scale-down, brownout rungs, hysteresis, cooldowns) with no fleet, no
  HTTP, no threads.
* **``FleetController``** owns the poll loop: gathers the snapshot,
  runs ``decide`` under its lock, then actuates OUTSIDE the lock —
  ``mark_alive``/``mark_dead`` take the scheduler's and batchers' locks,
  and holding the controller lock across them would build lock-order
  edges a lock-order checker would (rightly) flag.
* **Hysteresis everywhere**: pressure and idleness must be SUSTAINED
  (``up_polls`` / ``down_polls`` consecutive polls) before any action;
  each scale direction has its own cooldown; the dead band between
  ``queue_low`` and ``queue_high`` resets both counters — so a faultline
  kill-spike (one poll of chaos) never causes flapping, and the fleet
  never oscillates at a band edge.

Pressure is any of: per-healthy-replica queue depth ≥ ``queue_high``,
windowed latency-tier p99 ≥ the SLO, or minimum ``kv_headroom_bytes``
under the floor.  The p99 is WINDOWED: the controller diffs the
latency-tier request-latency histogram's bucket counts between polls,
so an old latency spike cannot hold the fleet scaled up forever (a
cumulative histogram's p99 only ever decays asymptotically).

The brownout ladder engages only under pressure the fleet
CANNOT scale out of (at the ``max_replicas`` envelope or out of
spares), one rung per sustained observation, and walks back down with
its own hysteresis once pressure clears:

1. shed new throughput-tier submissions (latency tier unaffected);
2. \\+ cap effective ``max_new_tokens`` at ``brownout_max_new``;
3. \\+ disable speculative decoding and n>1 forking (both are
   throughput optimizations that multiply per-request block footprint;
   greedy spec fallback is bit-identical by the exactness contract);
4. \\+ latency-tier-only admission: queued throughput-tier work is
   purged (failed with ``QueueFullError`` → the client's 503/retry
   path, counted as shed).

Every rung change is logged, counted (``hvd_serve_ctl_events_total``),
surfaced as the ``hvd_serve_brownout_level`` gauge, and emitted as a
BROWNOUT timeline instant — an operator replaying a trace sees exactly
when and why the fleet degraded.

Faultline integration: the poll loop is itself an injection point
(``ctl.poll``) — a ``load-spike`` spec fires a burst of synthetic
throughput-tier admissions through the controller's ``load_injector``
callback, so chaos plans can manufacture exactly the overload the
controller must absorb.
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..faultline import runtime as _faultline
from ..utils import get_logger
from .metrics import ServeMetrics

__all__ = ["BROWNOUT_MAX_LEVEL", "ControllerConfig", "ControllerState",
           "FleetController", "FleetSnapshot", "decide", "windowed_p99"]

#: Highest brownout rung (latency-tier-only admission).
BROWNOUT_MAX_LEVEL = 4

#: Human-readable rung descriptions (logged on every transition).
BROWNOUT_RUNGS = {
    0: "off",
    1: "shed throughput tier",
    2: "cap max_new_tokens",
    3: "disable speculation and n>1 forking",
    4: "latency-tier-only admission",
}


@dataclass
class ControllerConfig:
    """Tuning knobs, every one env-overridable (``HVD_SERVE_CTL_*``,
    the JAX package's knobs).  Defaults are deliberately conservative: several
    sustained observations and a cooldown before any fleet mutation."""

    poll_s: float = 0.5
    min_replicas: int = 1
    max_replicas: int = 64
    queue_high: float = 8.0        # per-healthy-replica queued requests
    queue_low: float = 1.0         # below this (and no pressure) = idle
    slo_ms: float = 0.0            # latency-tier p99 SLO; 0 disables
    ttft_slo_ms: float = 0.0       # windowed TTFT p99 SLO; 0 disables
    headroom_min_bytes: int = 0    # kv_headroom floor; 0 disables
    up_polls: int = 3              # consecutive pressure polls to grow
    down_polls: int = 6            # consecutive idle polls to shrink
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 5.0
    brownout_polls: int = 2        # at-envelope pressure polls per rung up
    brownout_clear_polls: int = 4  # clear polls per rung down
    brownout_max_new: int = 32     # effective max_new_tokens cap (rung 2+)

    @classmethod
    def from_env(cls) -> "ControllerConfig":
        e = os.environ.get
        return cls(
            poll_s=float(e("HVD_SERVE_CTL_POLL_S", "0.5")),
            min_replicas=int(e("HVD_SERVE_CTL_MIN_REPLICAS", "1")),
            max_replicas=int(e("HVD_SERVE_CTL_MAX_REPLICAS", "64")),
            queue_high=float(e("HVD_SERVE_CTL_QUEUE_HIGH", "8")),
            queue_low=float(e("HVD_SERVE_CTL_QUEUE_LOW", "1")),
            slo_ms=float(e("HVD_SERVE_CTL_SLO_MS", "0")),
            ttft_slo_ms=float(e("HVD_SERVE_CTL_TTFT_SLO_MS", "0")),
            headroom_min_bytes=int(
                e("HVD_SERVE_CTL_HEADROOM_MIN_BYTES", "0")),
            up_polls=int(e("HVD_SERVE_CTL_UP_POLLS", "3")),
            down_polls=int(e("HVD_SERVE_CTL_DOWN_POLLS", "6")),
            up_cooldown_s=float(e("HVD_SERVE_CTL_UP_COOLDOWN_S", "2")),
            down_cooldown_s=float(
                e("HVD_SERVE_CTL_DOWN_COOLDOWN_S", "5")),
            brownout_polls=int(e("HVD_SERVE_CTL_BROWNOUT_POLLS", "2")),
            brownout_clear_polls=int(
                e("HVD_SERVE_CTL_BROWNOUT_CLEAR_POLLS", "4")),
            brownout_max_new=int(
                e("HVD_SERVE_CTL_BROWNOUT_MAX_NEW", "32")),
        )

    def validate(self) -> "ControllerConfig":
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.queue_low > self.queue_high:
            raise ValueError("queue_low > queue_high (no hysteresis band)")
        if self.poll_s <= 0:
            raise ValueError("poll_s must be positive")
        return self


@dataclass
class FleetSnapshot:
    """One poll's observation of the fleet — everything ``decide``
    consumes, nothing else (pure-function contract)."""

    healthy: int                 # replicas in the routing set
    spares: int                  # revivable dead replicas (+1 if a
    #                              replica_factory can mint new ones)
    queued: int                  # total queued across healthy replicas
    active: int = 0              # total in-flight sequences
    latency_p99_ms: Optional[float] = None  # windowed latency-tier p99
    ttft_p99_ms: Optional[float] = None     # windowed TTFT p99
    kv_headroom_bytes: Optional[int] = None  # min across replicas

    def per_replica_queue(self) -> float:
        return self.queued / max(self.healthy, 1)


@dataclass
class ControllerState:
    """Mutable decision state between polls: hysteresis counters,
    cooldown stamps, current brownout rung.  ``decide`` advances it;
    the controller guards it with ``FleetController._lock``."""

    hot_polls: int = 0           # consecutive polls under pressure
    cold_polls: int = 0          # consecutive idle polls
    stuck_polls: int = 0         # pressure polls while unable to scale
    clear_polls: int = 0         # pressure-free polls (brownout descent)
    brownout_level: int = 0
    last_scale_up_t: float = field(default=-math.inf)
    last_scale_down_t: float = field(default=-math.inf)


def _pressure(cfg: ControllerConfig, snap: FleetSnapshot) -> bool:
    if snap.per_replica_queue() >= cfg.queue_high:
        return True
    if (cfg.slo_ms > 0 and snap.latency_p99_ms is not None
            and snap.latency_p99_ms >= cfg.slo_ms):
        return True
    # Interactive/streamed clients feel time-to-first-token, not
    # end-to-end latency — a fleet can hold the request-latency SLO
    # while prefill queueing wrecks every stream's opening beat, so
    # TTFT gets its own (env-gated, default-off) windowed-p99 term.
    if (cfg.ttft_slo_ms > 0 and snap.ttft_p99_ms is not None
            and snap.ttft_p99_ms >= cfg.ttft_slo_ms):
        return True
    if (cfg.headroom_min_bytes > 0 and snap.kv_headroom_bytes is not None
            and snap.kv_headroom_bytes < cfg.headroom_min_bytes):
        return True
    return False


def decide(cfg: ControllerConfig, state: ControllerState,
           snap: FleetSnapshot, now: float) -> List[str]:
    """Advance ``state`` by one observation and return the actions to
    actuate, in order.  Possible actions: ``scale_up`` / ``scale_down``
    (one replica each), ``brownout_up`` / ``brownout_down`` (one rung
    each — ``state.brownout_level`` is already updated when returned).

    Pure over its arguments: no clock, no environment, no fleet — the
    table-driven tests replay synthetic
    snapshot sequences through it.
    """
    actions: List[str] = []
    pressure = _pressure(cfg, snap)
    idle = not pressure and snap.per_replica_queue() <= cfg.queue_low

    # Hysteresis counters: the dead band between queue_low and
    # queue_high (neither pressure nor idle) resets BOTH — only
    # consecutive same-direction observations accumulate.
    if pressure:
        state.hot_polls += 1
        state.cold_polls = 0
        state.clear_polls = 0
    else:
        state.hot_polls = 0
        state.stuck_polls = 0
        state.clear_polls += 1
        state.cold_polls = state.cold_polls + 1 if idle else 0

    # -- scale up (or brownout when the envelope is exhausted) --------------
    if pressure and state.hot_polls >= cfg.up_polls:
        at_envelope = (snap.healthy >= cfg.max_replicas
                       or snap.spares <= 0)
        if at_envelope:
            # Pressure the fleet CANNOT scale out of: walk the brownout
            # ladder, one rung per ``brownout_polls`` stuck observations.
            state.stuck_polls += 1
            if (state.stuck_polls >= cfg.brownout_polls
                    and state.brownout_level < BROWNOUT_MAX_LEVEL):
                state.brownout_level += 1
                state.stuck_polls = 0
                actions.append("brownout_up")
        elif now - state.last_scale_up_t >= cfg.up_cooldown_s:
            # hot_polls deliberately NOT reset while the cooldown holds
            # the action back: the moment it expires under continued
            # pressure, the next poll fires.
            state.hot_polls = 0
            state.stuck_polls = 0
            state.last_scale_up_t = now
            actions.append("scale_up")

    # -- brownout descent (its own, slower hysteresis) ----------------------
    if (state.brownout_level > 0
            and state.clear_polls >= cfg.brownout_clear_polls):
        state.brownout_level -= 1
        state.clear_polls = 0
        actions.append("brownout_down")

    # -- scale down ---------------------------------------------------------
    # Never while any brownout rung is active: shedding work and
    # shrinking the fleet at the same time would be self-defeating.
    if (state.brownout_level == 0
            and state.cold_polls >= cfg.down_polls
            and snap.healthy > cfg.min_replicas
            and now - state.last_scale_down_t >= cfg.down_cooldown_s):
        state.cold_polls = 0
        state.last_scale_down_t = now
        actions.append("scale_down")

    return actions


def windowed_p99(bounds: List[float], prev_counts: Optional[List[int]],
                 counts: List[int], prev_total: int,
                 total: int) -> Optional[float]:
    """p99 (bucket upper bound) of the observations BETWEEN two
    cumulative-histogram snapshots — ``None`` when the window is empty.
    Cumulative bucket counts only ever grow, so the element-wise delta
    is itself a valid histogram of just the window's observations."""
    window = total - prev_total
    if window <= 0:
        return None
    prev = prev_counts if prev_counts is not None else [0] * len(counts)
    target = 0.99 * window
    for i, b in enumerate(bounds):
        if counts[i] - prev[i] >= target:
            return b
    return bounds[-1] if bounds else None


class FleetController:
    """The hvdctl loop: snapshot → ``decide`` → actuate (module doc).

    ``replica_factory`` (optional) mints a brand-new ``Replica`` for
    ``add_replica`` growth beyond reviving dead spares;
    ``load_injector`` (optional) is the faultline ``load-spike`` sink —
    called with the burst size, it submits that many synthetic
    throughput-tier requests (the chip smoke supplies one; without
    it a load-spike spec is logged and dropped, never an error)."""

    def __init__(self, scheduler, config: Optional[ControllerConfig] = None,
                 metrics: Optional[ServeMetrics] = None,
                 replica_factory: Optional[Callable[[], object]] = None,
                 load_injector: Optional[Callable[[int], int]] = None,
                 name: str = "hvdctl"):
        self.scheduler = scheduler
        self.cfg = (config or ControllerConfig.from_env()).validate()
        self.metrics = metrics if metrics is not None else scheduler.metrics
        self.replica_factory = replica_factory
        self.load_injector = load_injector
        self.name = name
        # Guards ONLY the decision state and the event tallies below.
        # Actuation (mark_alive / mark_dead / brownout propagation) runs
        # outside it: those paths take the scheduler's and batchers'
        # locks, and nesting them under ours would add lock-order edges
        # for no benefit — the poll loop is the sole state writer.
        self._lock = threading.Lock()
        self.state = ControllerState()
        self.scale_events = {"scale_up": 0, "scale_down": 0,
                             "brownout_up": 0, "brownout_down": 0}
        self.brownout_seconds = 0.0
        self._brownout_since: Optional[float] = None
        self._prev_counts: Optional[List[int]] = None
        self._prev_total = 0
        self._prev_ttft_counts: Optional[List[int]] = None
        self._prev_ttft_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-serve-ctl")
        self._thread.start()
        get_logger().info(
            "hvdctl: started (poll=%.3gs envelope=[%d,%d] slo=%.3gms)",
            self.cfg.poll_s, self.cfg.min_replicas, self.cfg.max_replicas,
            self.cfg.slo_ms)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Close the open brownout interval so brownout_seconds is exact
        # even when the server stops mid-rung.
        with self._lock:
            if self._brownout_since is not None:
                self.brownout_seconds += (time.monotonic()
                                          - self._brownout_since)
                self._brownout_since = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception as e:
                # The controller must outlive transient trouble (a dead
                # controller means the fleet never scales again); the
                # failure is logged and counted, never swallowed silently.
                get_logger().warning("hvdctl: poll error (%s); continuing",
                                     e)
                self.metrics.count_ctl_event("poll_error")
            self._stop.wait(self.cfg.poll_s)

    # -- one poll ------------------------------------------------------------

    def poll(self) -> List[str]:
        """One observation → decision → actuation round.  Public so the
        smoke and tests can drive the loop deterministically (no sleep
        races); the background thread calls exactly this."""
        self._consume_faults()
        snap = self.snapshot()
        now = time.monotonic()
        with self._lock:
            actions = decide(self.cfg, self.state, snap, now)
            level = self.state.brownout_level
            for a in actions:
                self.scale_events[a] += 1
            if actions:  # brownout interval accounting
                if level > 0 and self._brownout_since is None:
                    self._brownout_since = now
                elif level == 0 and self._brownout_since is not None:
                    self.brownout_seconds += now - self._brownout_since
                    self._brownout_since = None
        for action in actions:  # actuate OUTSIDE the lock (class doc)
            if action == "scale_up":
                self._scale_up(snap)
            elif action == "scale_down":
                self._scale_down()
            else:
                self._apply_brownout(level, action)
            self.metrics.count_ctl_event(action)
        return actions

    def _consume_faults(self) -> None:
        if _faultline.PLAN is None:
            return
        for f in _faultline.fire("ctl.poll", self.name):
            if f.kind != "load-spike":
                continue
            burst = int(f.param) if f.param is not None else 8
            if self.load_injector is None:
                get_logger().warning(
                    "hvdctl: load-spike(%d) fired with no load_injector; "
                    "dropped", burst)
                continue
            injected = self.load_injector(burst)
            get_logger().warning("hvdctl: load-spike injected %s/%d "
                                 "synthetic request(s)", injected, burst)

    def snapshot(self) -> FleetSnapshot:
        """Observe the fleet: replica states and queue depths from the
        scheduler, minimum KV headroom across replicas, and the WINDOWED
        latency-tier p99 (bucket-count delta since the previous poll)."""
        replicas = self.scheduler.fleet()
        healthy = [r for r in replicas if r.state == "healthy"]
        # A replica mid-roll (registry.roll drain->swap->revive) is
        # transiently dead but NOT spare capacity: counting it would
        # tempt decide() into a scale_up that _scale_up cannot honor
        # (and reviving it early would serve a half-swapped engine).
        dead = [r for r in replicas
                if r.state == "dead" and not getattr(r, "rolling", False)]
        queued = 0
        active = 0
        headroom: Optional[int] = None
        for r in healthy:
            queued += r.engine.batcher.depth()
            active += r.engine.active_count
            kv = r.engine.kv_stats()
            if kv is not None and "kv_headroom_bytes" in kv:
                h = int(kv["kv_headroom_bytes"])
                headroom = h if headroom is None else min(headroom, h)
        bounds, counts, total = self.metrics.request_window("latency")
        p99 = windowed_p99(bounds, self._prev_counts, counts,
                           self._prev_total, total)
        self._prev_counts = counts
        self._prev_total = total
        ttft_p99 = None
        if self.cfg.ttft_slo_ms > 0:
            tb, tc, tt = self.metrics.ttft_window()
            ttft_p99 = windowed_p99(tb, self._prev_ttft_counts, tc,
                                    self._prev_ttft_total, tt)
            self._prev_ttft_counts = tc
            self._prev_ttft_total = tt
        spares = len(dead) + (1 if self.replica_factory is not None else 0)
        return FleetSnapshot(healthy=len(healthy), spares=spares,
                             queued=queued, active=active,
                             latency_p99_ms=p99, ttft_p99_ms=ttft_p99,
                             kv_headroom_bytes=headroom)

    # -- actuation (never under self._lock) ----------------------------------

    def _scale_up(self, snap: FleetSnapshot) -> None:
        dead = [r for r in self.scheduler.fleet()
                if r.state == "dead" and not getattr(r, "rolling", False)]
        if dead:
            self.scheduler.mark_alive(dead[0].replica_id,
                                      reason="hvdctl: sustained pressure")
            return
        if self.replica_factory is not None:
            try:
                self.scheduler.add_replica(self.replica_factory())
            except Exception as e:
                get_logger().warning("hvdctl: add_replica failed (%s)", e)
                self.metrics.count_ctl_event("scale_up_failed")

    def _scale_down(self) -> None:
        healthy = sorted(
            (r for r in self.scheduler.fleet() if r.state == "healthy"),
            key=lambda r: r.load())
        if len(healthy) <= self.cfg.min_replicas:
            return
        # Least-loaded victim: at sustained idleness that is a drained
        # replica, so mark_dead's drain requeues NOTHING (tested — the
        # scale-down-drain satellite) and the shrink is work-free.
        self.scheduler.mark_dead(healthy[0].replica_id,
                                 reason="hvdctl: sustained idleness")

    def _apply_brownout(self, level: int, action: str) -> None:
        cap = self.cfg.brownout_max_new if level >= 2 else 0
        for r in self.scheduler.fleet():
            # Plain int attributes, read lock-free (GIL-atomic) on the
            # submit/decode hot paths — a rung change is advisory and
            # takes effect within one admission round.
            r.engine.batcher.brownout_level = level
            r.engine.batcher.brownout_max_new = cap
            r.engine.brownout_level = level
        self.metrics.set_brownout_level(level, reason=action)
        get_logger().warning("hvdctl: brownout %s -> level %d (%s)",
                             action.split("_", 1)[1], level,
                             BROWNOUT_RUNGS.get(level, "?"))

    # -- export --------------------------------------------------------------

    def stats(self) -> dict:
        """Controller-side record for the chip smoke and the tests: event tallies, current rung, rung-active
        seconds (open interval included)."""
        with self._lock:
            seconds = self.brownout_seconds
            if self._brownout_since is not None:
                seconds += time.monotonic() - self._brownout_since
            return {"scale_events": dict(self.scale_events),
                    "brownout_level": self.state.brownout_level,
                    "brownout_seconds": round(seconds, 3)}
