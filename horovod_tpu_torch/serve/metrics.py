"""Serving metrics: latency histograms, occupancy, throughput counters.

Port of ``horovod_tpu/serve/metrics.py`` reduced to the families the
port's serving path feeds: TTFT and token-step histograms, the
per-stage and per-tier request latency, token / decode-step / request
outcome counters (per tenant too), batch occupancy, queue depth, the
prefill/decode token split, the speculative-decoding counters, and the
paged-KV gauges (blocks, CoW copies, n>1 fork counters, prefix-cache
hit rate, bytes per token, attention impl and KV dtype), the request
surface's families (warmup duration and runs per replica, a model
roll's progress, the streamed-token counters) and the windowed
histogram snapshots (``ttft_window``, ``request_window``), and the fleet
control plane's: the brownout rung (``set_brownout_level``), the fleet
controller's actions (``count_ctl_event``) and the preemption watcher's
survived KV errors (``count_preempt_poll_error``).  The families keep
the JAX package's names and labels, so one dashboard reads both.
``set_timeline`` wires a ``timeline.Timeline`` that receives a roll's
phase transitions (``swap_event``), BROWNOUT instants and the
rate-limited SERVE counters (``maybe_emit_timeline``, every
``HVD_SERVE_TIMELINE_EVERY`` decode steps).

Everything is guarded by one lock: observers run on engine threads while
``/metrics`` renders on HTTP handler threads.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .tenancy import TenantAccounting

#: Histogram bucket upper bounds in milliseconds (Prometheus ``le`` label).
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-bucket latency histogram (Prometheus semantics: cumulative
    bucket counts, +Inf implicit via ``count``)."""

    def __init__(self, buckets_ms=DEFAULT_BUCKETS_MS):
        self.bounds: List[float] = list(buckets_ms)
        self.counts: List[int] = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, value_ms: float) -> None:
        self.count += 1
        self.sum += value_ms
        for i, b in enumerate(self.bounds):
            if value_ms <= b:
                self.counts[i] += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts (upper bound of the
        bucket containing the q-th observation)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        for i, b in enumerate(self.bounds):
            if self.counts[i] >= target:
                return b
        return self.bounds[-1]

    def to_dict(self) -> dict:
        return {"count": self.count, "sum_ms": round(self.sum, 3),
                "p50_ms": self.quantile(0.5), "p99_ms": self.quantile(0.99)}


class ServeMetrics:
    """One instance per server (shared across that server's replicas —
    replica identity travels in the per-counter labels where it matters)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self.ttft_ms = Histogram()
        self.token_step_ms = Histogram()
        # Per-request stage decomposition: an exact partition of each
        # completed request's end-to-end latency (Request.stage_add).
        self.stage_ms: Dict[str, Histogram] = {
            s: Histogram() for s in ("queue", "prefill", "decode",
                                     "spec", "retry")}
        self.request_ms: Dict[str, Histogram] = {
            "latency": Histogram(), "throughput": Histogram()}
        self.tokens_total = 0
        self.decode_steps_total = 0
        self.prefills_total = 0
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0
        self.iterations_total = 0
        # Speculative decoding: draft/verify token accounting —
        # acceptance_rate = accepted / drafted, and decode_steps_total
        # counts TARGET-model invocations (one per verify step), so
        # target calls per emitted token read straight off the snapshot.
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        self.spec_rejected_total = 0
        self.spec_steps_total = 0
        # Request outcomes: ok / shed (queue full) / expired (deadline) /
        # requeued (drained off a dead replica, re-routed) / preempted
        # (evicted for KV blocks, re-admitted locally) / error.
        self.requests: Dict[str, int] = {"ok": 0, "shed": 0, "expired": 0,
                                         "requeued": 0, "preempted": 0,
                                         "error": 0}
        self._tenants = TenantAccounting()
        self.tenant_requests: Dict[Tuple[str, str], int] = {}
        self.tenant_stage_ms: Dict[Tuple[str, str], Histogram] = {}
        self.replica_events: Dict[str, int] = {"mark_dead": 0,
                                               "mark_alive": 0}
        # Preemption-watcher health: transient KV errors the poller
        # survived (replica.watch_preemption).
        self.preempt_poll_errors = 0
        # Fleet-controller plane (serve/controller.py): the current
        # brownout rung (gauge) and the controller's action counters.
        self.brownout_level = 0
        self.ctl_events: Dict[str, int] = {}
        # A live weight roll's progress per model (serve/registry.py):
        # (replicas at the target version, replicas holding the model).
        self.swap_progress: Dict[str, Tuple[int, int]] = {}
        # Engine warmup: wall ms of the last pass and the passes each
        # replica ran (every engine start, mark_alive included).
        self.warmup_ms: Dict[str, float] = {}
        self.warmup_runs: Dict[str, int] = {}
        # Streamed responses (serve/streaming.py TokenStream.counters):
        # tokens published, merged into a pending event by a full
        # queue, and replayed positions dropped.
        self.stream_tokens: Dict[str, int] = {
            "published": 0, "coalesced": 0, "duplicates": 0}
        # Tiered KV (serve/tiering.py): fault-stall episodes (iterations
        # where the prefetch lost its race and the loop had nothing
        # runnable), the bytes moved each direction and the migrations.
        self.tier_stall_ms = Histogram()
        self.tier_faults_total = 0
        self.tier_spill_bytes = 0
        self.tier_promote_bytes = 0
        self.tier_demote_bytes = 0
        self.tier_migrated_tokens = 0
        self.tier_migrations_total = 0
        # Sequence-parallel prefill (serve/seqpar.py): jobs, prompt
        # tokens they covered, handoff bytes shipped to the decode owner,
        # ring hops folded and kill-rank / preemption aborts.
        self.sp_prefills_total = 0
        self.sp_tokens_total = 0
        self.sp_handoff_bytes = 0
        self.sp_ring_hops_total = 0
        self.sp_aborts_total = 0
        self._timeline = None
        self._timeline_every = int(os.environ.get(
            "HVD_SERVE_TIMELINE_EVERY", "16"))
        self._steps_since_emit = 0
        self._service_ms: Optional[float] = None
        self.occupancy_last = 0
        self.occupancy_max = 0
        self.occupancy_sum = 0
        self.occupancy_samples = 0
        self._queue_depth_fns: Dict[str, object] = {}
        self._kv_stats_fns: Dict[str, object] = {}

    # -- observers (engine/batcher threads) ---------------------------------

    def observe_ttft(self, ms: float) -> None:
        with self._lock:
            self.ttft_ms.observe(ms)
            self.prefills_total += 1
            self.tokens_total += 1  # the prefill's first generated token

    def observe_decode_step(self, ms: float, occupancy: int,
                            new_tokens: int) -> None:
        with self._lock:
            self.token_step_ms.observe(ms)
            self.decode_steps_total += 1
            self.tokens_total += new_tokens
            self.occupancy_last = occupancy
            self.occupancy_max = max(self.occupancy_max, occupancy)
            self.occupancy_sum += occupancy
            self.occupancy_samples += 1
            self._steps_since_emit += 1

    def observe_iteration(self, prefill_tokens: int,
                          decode_tokens: int) -> None:
        """One engine iteration's prefill-vs-decode token split."""
        with self._lock:
            self.prefill_tokens_total += prefill_tokens
            self.decode_tokens_total += decode_tokens
            self.iterations_total += 1

    def count_tokens(self, n: int) -> None:
        """Tokens emitted outside the TTFT/decode-step observers (the
        n-1 extra first tokens an n>1 fork moment draws)."""
        with self._lock:
            self.tokens_total += n

    def observe_spec(self, drafted: int, accepted: int,
                     rejected: int) -> None:
        """One speculative step's draft accounting (engine._spec_once)."""
        with self._lock:
            self.spec_drafted_total += drafted
            self.spec_accepted_total += accepted
            self.spec_rejected_total += rejected
            self.spec_steps_total += 1

    def count_sp_prefill(self, tokens: int, handoff_bytes: int,
                         ring_hops: int) -> None:
        """One completed sequence-parallel prefill (engine._sp_complete):
        prompt tokens covered, handoff bytes, ring hops folded."""
        with self._lock:
            self.sp_prefills_total += 1
            self.sp_tokens_total += int(tokens)
            self.sp_handoff_bytes += int(handoff_bytes)
            self.sp_ring_hops_total += int(ring_hops)

    def count_sp_abort(self) -> None:
        """One SP job abort (kill-rank drill, preemption, lost slot); the
        request resubmits whole and is also counted preempted."""
        with self._lock:
            self.sp_aborts_total += 1

    def observe_tier_stall(self, ms: float) -> None:
        """One tier-fault stall episode: the engine loop waited ``ms`` for
        an in-flight tier fetch with nothing else runnable."""
        with self._lock:
            self.tier_stall_ms.observe(ms)
            self.tier_faults_total += 1

    def count_tier_bytes(self, spill: int = 0, promote: int = 0,
                         demote: int = 0) -> None:
        """Bytes moved across tier boundaries: device → host (spill),
        host → device (promote), host → KV server (demote)."""
        with self._lock:
            self.tier_spill_bytes += spill
            self.tier_promote_bytes += promote
            self.tier_demote_bytes += demote

    def count_tier_migration(self, tokens: int) -> None:
        """One cross-replica prefix migration worth ``tokens`` tokens of
        skipped prefill."""
        with self._lock:
            self.tier_migrated_tokens += tokens
            self.tier_migrations_total += 1

    def count_request(self, outcome: str,
                      tenant: Optional[str] = None) -> None:
        # label() takes the accounting's own (leaf) lock BEFORE we take
        # self._lock — never nested inside it, so no new ordering edge.
        label = self._tenants.label(tenant) if tenant is not None else None
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1
            if label is not None:
                key = (label, outcome)
                self.tenant_requests[key] = \
                    self.tenant_requests.get(key, 0) + 1

    def observe_stage(self, stage: str, ms: float) -> None:
        with self._lock:
            h = self.stage_ms.get(stage)
            if h is None:
                h = self.stage_ms[stage] = Histogram()
            h.observe(ms)

    def observe_tenant_stage(self, tenant: str, stage: str,
                             ms: float) -> None:
        label = self._tenants.label(tenant)
        with self._lock:
            key = (label, stage)
            h = self.tenant_stage_ms.get(key)
            if h is None:
                h = self.tenant_stage_ms[key] = Histogram()
            h.observe(ms)

    def observe_request_ms(self, tier: str, ms: float) -> None:
        """One completed request's end-to-end latency by QoS tier; also
        advances the service-time EWMA the Retry-After hint reads."""
        with self._lock:
            h = self.request_ms.get(tier)
            if h is None:
                h = self.request_ms[tier] = Histogram()
            h.observe(ms)
            self._service_ms = (ms if self._service_ms is None
                                else 0.2 * ms + 0.8 * self._service_ms)

    def recent_service_s(self) -> float:
        with self._lock:
            return (self._service_ms or 0.0) / 1e3

    def request_window(self, tier: str):
        """``(bounds, cumulative bucket counts, total count)`` snapshot
        of one tier's request-latency histogram: two snapshots diff into
        a windowed distribution."""
        with self._lock:
            h = self.request_ms.get(tier)
            if h is None:
                return ([], [], 0)
            return (list(h.bounds), list(h.counts), h.count)

    def ttft_window(self):
        """The time-to-first-token histogram's snapshot, in
        ``request_window``'s form (streamed clients feel TTFT)."""
        with self._lock:
            h = self.ttft_ms
            return (list(h.bounds), list(h.counts), h.count)

    def set_swap_progress(self, model: str, done: int,
                          total: int) -> None:
        """A roll's progress (serve/registry.py): ``done`` of ``total``
        replicas serve the target version."""
        with self._lock:
            self.swap_progress[model] = (int(done), int(total))

    def set_timeline(self, timeline) -> None:
        """Register a ``timeline.Timeline``: a roll's instants, BROWNOUT
        instants and the rate-limited SERVE counters."""
        with self._lock:
            self._timeline = timeline
            self._steps_since_emit = 0

    def set_brownout_level(self, level: int, reason: str = "") -> None:
        """The controller's rung walk: gauge update + BROWNOUT timeline
        instant (``reason`` is the action, e.g. ``brownout_up``)."""
        with self._lock:
            self.brownout_level = int(level)
            tl = self._timeline
        if tl is None:
            return
        try:
            tl.brownout_event(
                "down" if reason.endswith("down") else "up",
                level, rung=reason)
        except Exception:
            pass  # the metrics path must never take down the controller

    def count_ctl_event(self, event: str) -> None:
        with self._lock:
            self.ctl_events[event] = self.ctl_events.get(event, 0) + 1

    def count_preempt_poll_error(self) -> None:
        with self._lock:
            self.preempt_poll_errors += 1

    def maybe_emit_timeline(self, force: bool = False,
                            kv_stats: Optional[dict] = None) -> None:
        """Rate-limited SERVE/* counter emission (every
        ``HVD_SERVE_TIMELINE_EVERY`` decode steps, or ``force``).
        ``kv_stats`` (the paged engine's block ``stats`` callable, read
        only when a sample is due) adds block-utilization and
        prefix-hit-rate counters."""
        with self._lock:
            tl = self._timeline
            if tl is None:
                return
            if not force and self._steps_since_emit < self._timeline_every:
                return
            self._steps_since_emit = 0
        if callable(kv_stats):
            kv_stats = kv_stats()
        depth = sum(max(d, 0) for d in self._queue_depths().values())
        with self._lock:
            occ_mean = (self.occupancy_sum / self.occupancy_samples
                        if self.occupancy_samples else 0.0)
            counters = {
                "tokens_total": self.tokens_total,
                "occupancy": self.occupancy_last,
                "occupancy_mean": round(occ_mean, 3),
                "queue_depth": depth,
                "ttft_p50_ms": self.ttft_ms.quantile(0.5),
                "token_step_p50_ms": self.token_step_ms.quantile(0.5),
                "prefill_tokens_total": self.prefill_tokens_total,
                "decode_tokens_total": self.decode_tokens_total,
            }
            if kv_stats is not None:
                counters["kv_blocks_used"] = kv_stats.get("used", 0)
                counters["kv_blocks_free"] = kv_stats.get("free", 0)
                counters["kv_blocks_retained"] = kv_stats.get("retained", 0)
                counters["prefix_hit_rate"] = round(
                    kv_stats.get("prefix_hit_rate", 0.0), 4)
        try:
            tl.serve_counter("engine", counters)
        except Exception:
            pass  # the metrics path must never take down the decode loop

    def swap_event(self, model: str, replica: str, phase: str,
                   version: int) -> None:
        """One roll phase transition (``drain``/``swap``/``alive``/
        ``abort``) as a SWAP timeline instant; read the timeline under
        the lock, emit outside it, and never let the trace break the
        roll."""
        with self._lock:
            tl = self._timeline
        if tl is None:
            return
        try:
            tl.swap_event(model, replica, phase, version)
        except Exception:
            pass

    def observe_warmup(self, replica_id: str, ms: float) -> None:
        """One engine warmup pass: last duration and run count."""
        with self._lock:
            self.warmup_ms[replica_id] = float(ms)
            self.warmup_runs[replica_id] = \
                self.warmup_runs.get(replica_id, 0) + 1

    def count_stream(self, counters: dict) -> None:
        """Add one finished stream's ``TokenStream.counters()``."""
        with self._lock:
            for kind in self.stream_tokens:
                self.stream_tokens[kind] += int(counters.get(kind, 0))

    def count_replica_event(self, event: str) -> None:
        with self._lock:
            self.replica_events[event] = \
                self.replica_events.get(event, 0) + 1

    def register_queue_depth(self, replica_id: str, fn) -> None:
        """``fn`` is sampled at render time (queue depth is a gauge)."""
        with self._lock:
            self._queue_depth_fns[replica_id] = fn

    def register_kv_stats(self, replica_id: str, fn) -> None:
        """``fn`` returns the replica engine's ``kv_stats()`` dict (None
        in slot mode)."""
        with self._lock:
            self._kv_stats_fns[replica_id] = fn

    # -- export -------------------------------------------------------------

    def _queue_depths(self) -> Dict[str, int]:
        # NEVER called under self._lock: the depth fns take the batchers'
        # locks, and an engine thread shedding under a batcher lock may
        # need self._lock (count_request) — sampling under self._lock
        # would be the other half of an AB/BA deadlock.
        with self._lock:
            fns = dict(self._queue_depth_fns)
        out = {}
        for rid, fn in fns.items():
            try:
                out[rid] = int(fn())
            except Exception:
                out[rid] = -1
        return out

    def _kv_stats(self) -> Dict[str, dict]:
        # Same locking discipline as _queue_depths.
        with self._lock:
            fns = dict(self._kv_stats_fns)
        out = {}
        for rid, fn in fns.items():
            try:
                stats = fn()
            except Exception:
                stats = None
            if stats is not None:
                out[rid] = stats
        return out

    def snapshot(self) -> dict:
        depths = self._queue_depths()
        kv = self._kv_stats()
        with self._lock:
            elapsed = max(time.monotonic() - self.started_at, 1e-9)
            occ_mean = (self.occupancy_sum / self.occupancy_samples
                        if self.occupancy_samples else 0.0)
            return {
                "tokens_total": self.tokens_total,
                "tokens_per_sec": round(self.tokens_total / elapsed, 2),
                "decode_steps": self.decode_steps_total,
                "prefills": self.prefills_total,
                "requests": dict(self.requests),
                "replica_events": dict(self.replica_events),
                "brownout_level": self.brownout_level,
                "ctl_events": dict(self.ctl_events),
                "preempt_poll_errors": self.preempt_poll_errors,
                "request_latency": {t: h.to_dict()
                                    for t, h in self.request_ms.items()},
                "occupancy": {"last": self.occupancy_last,
                              "max": self.occupancy_max,
                              "mean": round(occ_mean, 3)},
                "queue_depth": depths,
                "ttft": self.ttft_ms.to_dict(),
                "token_step": self.token_step_ms.to_dict(),
                "stage": {s: h.to_dict()
                          for s, h in self.stage_ms.items()},
                "token_split": {
                    "prefill_tokens": self.prefill_tokens_total,
                    "decode_tokens": self.decode_tokens_total,
                    "iterations": self.iterations_total,
                },
                "spec": {
                    "drafted": self.spec_drafted_total,
                    "accepted": self.spec_accepted_total,
                    "rejected": self.spec_rejected_total,
                    "steps": self.spec_steps_total,
                    "acceptance_rate": round(
                        self.spec_accepted_total
                        / self.spec_drafted_total, 4)
                    if self.spec_drafted_total else 0.0,
                },
                "tier": {
                    "faults": self.tier_faults_total,
                    "fault_stall": self.tier_stall_ms.to_dict(),
                    "spill_bytes": self.tier_spill_bytes,
                    "promote_bytes": self.tier_promote_bytes,
                    "demote_bytes": self.tier_demote_bytes,
                    "migrations": self.tier_migrations_total,
                    "migrated_tokens": self.tier_migrated_tokens,
                },
                "sp": {
                    "prefills": self.sp_prefills_total,
                    "tokens": self.sp_tokens_total,
                    "handoff_bytes": self.sp_handoff_bytes,
                    "ring_hops": self.sp_ring_hops_total,
                    "aborts": self.sp_aborts_total,
                },
                "seq_forks": sum(s.get("seq_forks", 0)
                                 for s in kv.values()),
                "kv_blocks": kv,
                "swap": {m: {"done": d, "total": t}
                         for m, (d, t) in self.swap_progress.items()},
                "warmup": {"ms": dict(self.warmup_ms),
                           "runs": dict(self.warmup_runs)},
                "stream": dict(self.stream_tokens),
            }

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4 format)."""
        depths = self._queue_depths()
        kv = self._kv_stats()
        with self._lock:
            lines = []

            def hist(name, h: Histogram, help_=None, labels=""):
                if help_ is not None:
                    lines.append(f"# HELP {name} {help_}")
                    lines.append(f"# TYPE {name} histogram")
                sep = labels + "," if labels else ""
                suffix = "{" + labels + "}" if labels else ""
                for bound, c in zip(h.bounds, h.counts):
                    lines.append(
                        f'{name}_bucket{{{sep}le="{bound:g}"}} {c}')
                lines.append(f'{name}_bucket{{{sep}le="+Inf"}} {h.count}')
                lines.append(f"{name}_sum{suffix} {h.sum:g}")
                lines.append(f"{name}_count{suffix} {h.count}")

            def gauge_per_replica(name, kind, value_of):
                lines.append(f"# TYPE {name} {kind}")
                for rid, s in sorted(kv.items()):
                    value = value_of(s)
                    if value is not None:
                        lines.append(f'{name}{{replica="{rid}"}} {value}')

            hist("hvd_serve_ttft_ms", self.ttft_ms,
                 "Time to first token (prefill wait + compute), ms")
            hist("hvd_serve_token_step_ms", self.token_step_ms,
                 "Decode step duration (per-output-token latency), ms")
            lines.append("# HELP hvd_serve_stage_ms per-request latency "
                         "by lifecycle stage (queue|prefill|decode|"
                         "spec|retry), ms")
            lines.append("# TYPE hvd_serve_stage_ms histogram")
            for stage in sorted(self.stage_ms):
                if "|" in stage:
                    s, tier = stage.split("|", 1)
                    labels = f'stage="{s}",tier="{tier}"'
                else:
                    labels = f'stage="{stage}"'
                hist("hvd_serve_stage_ms", self.stage_ms[stage],
                     labels=labels)
            for (label, stage) in sorted(self.tenant_stage_ms):
                hist("hvd_serve_stage_ms",
                     self.tenant_stage_ms[(label, stage)],
                     labels=f'stage="{stage}",tenant="{label}"')
            lines.append("# HELP hvd_serve_request_ms end-to-end "
                         "request latency by QoS tier, ms")
            lines.append("# TYPE hvd_serve_request_ms histogram")
            for tier in sorted(self.request_ms):
                hist("hvd_serve_request_ms", self.request_ms[tier],
                     labels=f'tier="{tier}"')
            lines.append("# TYPE hvd_serve_tokens_total counter")
            lines.append(f"hvd_serve_tokens_total {self.tokens_total}")
            lines.append("# TYPE hvd_serve_decode_steps_total counter")
            lines.append(
                f"hvd_serve_decode_steps_total {self.decode_steps_total}")
            lines.append("# TYPE hvd_serve_requests_total counter")
            for outcome, n in sorted(self.requests.items()):
                lines.append(
                    f'hvd_serve_requests_total{{outcome="{outcome}"}} {n}')
            lines.append("# TYPE hvd_serve_tenant_requests_total counter")
            for (label, outcome), n in sorted(
                    self.tenant_requests.items()):
                lines.append(
                    f'hvd_serve_tenant_requests_total{{tenant="{label}",'
                    f'outcome="{outcome}"}} {n}')
            lines.append("# TYPE hvd_serve_swap_progress gauge")
            for model, (done, total) in sorted(
                    self.swap_progress.items()):
                frac = done / total if total else 0.0
                lines.append(
                    f'hvd_serve_swap_progress{{model="{model}"}} '
                    f'{frac:g}')
            lines.append("# TYPE hvd_serve_warmup_ms gauge")
            for rid, ms in sorted(self.warmup_ms.items()):
                lines.append(
                    f'hvd_serve_warmup_ms{{replica="{rid}"}} {ms:g}')
            lines.append("# TYPE hvd_serve_warmup_runs_total counter")
            for rid, n in sorted(self.warmup_runs.items()):
                lines.append(
                    f'hvd_serve_warmup_runs_total{{replica="{rid}"}} '
                    f'{n}')
            lines.append("# TYPE hvd_serve_stream_tokens_total counter")
            for kind, n in sorted(self.stream_tokens.items()):
                lines.append(
                    f'hvd_serve_stream_tokens_total{{kind="{kind}"}} {n}')
            lines.append(
                "# TYPE hvd_serve_preempt_poll_errors_total counter")
            lines.append(f"hvd_serve_preempt_poll_errors_total "
                         f"{self.preempt_poll_errors}")
            lines.append("# TYPE hvd_serve_replica_events_total counter")
            for event, n in sorted(self.replica_events.items()):
                lines.append(
                    f'hvd_serve_replica_events_total{{event="{event}"}} '
                    f'{n}')
            lines.append("# TYPE hvd_serve_brownout_level gauge")
            lines.append(
                f"hvd_serve_brownout_level {self.brownout_level}")
            lines.append("# TYPE hvd_serve_ctl_events_total counter")
            for event, n in sorted(self.ctl_events.items()):
                lines.append(
                    f'hvd_serve_ctl_events_total{{event="{event}"}} {n}')
            lines.append("# TYPE hvd_serve_batch_occupancy gauge")
            lines.append(f"hvd_serve_batch_occupancy {self.occupancy_last}")
            lines.append("# TYPE hvd_serve_batch_occupancy_max gauge")
            lines.append(
                f"hvd_serve_batch_occupancy_max {self.occupancy_max}")
            occ_mean = (self.occupancy_sum / self.occupancy_samples
                        if self.occupancy_samples else 0.0)
            lines.append("# TYPE hvd_serve_batch_occupancy_mean gauge")
            lines.append(f"hvd_serve_batch_occupancy_mean {occ_mean:g}")
            lines.append("# TYPE hvd_serve_queue_depth gauge")
            for rid, depth in sorted(depths.items()):
                lines.append(
                    f'hvd_serve_queue_depth{{replica="{rid}"}} {depth}')
            lines.append("# TYPE hvd_serve_prefill_tokens_total counter")
            lines.append(
                f"hvd_serve_prefill_tokens_total "
                f"{self.prefill_tokens_total}")
            lines.append("# TYPE hvd_serve_decode_tokens_total counter")
            lines.append(
                f"hvd_serve_decode_tokens_total {self.decode_tokens_total}")
            lines.append("# TYPE hvd_serve_kv_blocks gauge")
            for rid, s in sorted(kv.items()):
                for state in ("used", "free", "retained"):
                    lines.append(
                        f'hvd_serve_kv_blocks{{replica="{rid}",'
                        f'state="{state}"}} {s.get(state, 0)}')
            gauge_per_replica("hvd_serve_kv_cow_copies_total", "counter",
                              lambda s: s.get("cow", 0))
            # n>1 parallel sampling: sequences forked off a shared prompt
            # through CoW block tables, and the requests that forked.
            gauge_per_replica("hvd_serve_cow_forks_total", "counter",
                              lambda s: s.get("seq_forks", 0))
            gauge_per_replica("hvd_serve_forked_requests_total", "counter",
                              lambda s: s.get("forked_requests", 0))
            lines.append("# TYPE hvd_serve_spec_tokens_total counter")
            for result, n in (("drafted", self.spec_drafted_total),
                              ("accepted", self.spec_accepted_total),
                              ("rejected", self.spec_rejected_total)):
                lines.append(
                    f'hvd_serve_spec_tokens_total{{result="{result}"}} '
                    f'{n}')
            lines.append("# TYPE hvd_serve_spec_steps_total counter")
            lines.append(
                f"hvd_serve_spec_steps_total {self.spec_steps_total}")
            lines.append("# TYPE hvd_serve_spec_acceptance_rate gauge")
            rate = (self.spec_accepted_total / self.spec_drafted_total
                    if self.spec_drafted_total else 0.0)
            lines.append(f"hvd_serve_spec_acceptance_rate {rate:g}")
            for name, n in (
                    ("hvd_serve_sp_prefills_total", self.sp_prefills_total),
                    ("hvd_serve_sp_tokens_total", self.sp_tokens_total),
                    ("hvd_serve_sp_handoff_bytes_total",
                     self.sp_handoff_bytes),
                    ("hvd_serve_sp_ring_hops_total",
                     self.sp_ring_hops_total),
                    ("hvd_serve_sp_aborts_total", self.sp_aborts_total)):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {n}")
            # Tiered KV: the fault-stall histogram, bytes per direction,
            # migrations and the per-replica host-tier occupancy.
            hist("hvd_serve_tier_fault_stall_ms", self.tier_stall_ms,
                 "Engine-loop stall waiting on a tier fetch that lost "
                 "its prefetch race, ms")
            lines.append("# TYPE hvd_serve_tier_faults_total counter")
            lines.append(
                f"hvd_serve_tier_faults_total {self.tier_faults_total}")
            lines.append("# TYPE hvd_serve_tier_bytes_total counter")
            for direction, n in (("spill", self.tier_spill_bytes),
                                 ("promote", self.tier_promote_bytes),
                                 ("demote", self.tier_demote_bytes)):
                lines.append(
                    f'hvd_serve_tier_bytes_total{{direction='
                    f'"{direction}"}} {n}')
            lines.append("# TYPE hvd_serve_tier_migrations_total counter")
            lines.append(f"hvd_serve_tier_migrations_total "
                         f"{self.tier_migrations_total}")
            lines.append(
                "# TYPE hvd_serve_tier_migrated_tokens_total counter")
            lines.append(f"hvd_serve_tier_migrated_tokens_total "
                         f"{self.tier_migrated_tokens}")
            gauge_per_replica(
                "hvd_serve_tier_host_blocks", "gauge",
                lambda s: (s["tier"].get("host_blocks", 0)
                           if "tier" in s else None))
            gauge_per_replica("hvd_serve_prefix_cache_hit_rate", "gauge",
                              lambda s: f'{s.get("prefix_hit_rate", 0.0):g}')
            gauge_per_replica(
                "hvd_serve_kv_bytes_per_token", "gauge",
                lambda s: (f'{s["kv_bytes_per_token"]:g}'
                           if "kv_bytes_per_token" in s else None))
            # Attention implementation and KV storage dtype per replica:
            # info gauges (constant 1, identity in the labels).
            lines.append("# TYPE hvd_serve_attention_impl gauge")
            for rid, s in sorted(kv.items()):
                if "attn_impl" in s:
                    lines.append(
                        f'hvd_serve_attention_impl{{replica="{rid}",'
                        f'impl="{s["attn_impl"]}"}} 1')
            lines.append("# TYPE hvd_serve_kv_dtype gauge")
            for rid, s in sorted(kv.items()):
                if "kv_dtype" in s:
                    lines.append(
                        f'hvd_serve_kv_dtype{{replica="{rid}",'
                        f'dtype="{s["kv_dtype"]}"}} 1')
            elapsed = max(time.monotonic() - self.started_at, 1e-9)
            lines.append("# TYPE hvd_serve_tokens_per_sec gauge")
            lines.append(
                f"hvd_serve_tokens_per_sec {self.tokens_total / elapsed:g}")
            return "\n".join(lines) + "\n"
