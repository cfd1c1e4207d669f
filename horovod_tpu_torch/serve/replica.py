"""Replica scheduler: least-loaded routing over serving replicas, with
failover.

Port of ``horovod_tpu/serve/replica.py``.  A serving replica is an
independent copy of the model with its own engine, batcher and KV block
pool; requests route to the least-loaded healthy replica (load =
in-flight sequences + queued requests).  ``mark_dead`` removes a replica
from routing and requeues its queued and in-flight work at the front of
the survivors' queues (greedy decoding makes the eventual answer
identical, and seeded sampling keys every draw by position);
``mark_alive`` re-admits it.  After ``hvd.init()`` the replicas are the
world's ``partition_process_sets``; without it, an explicit count.
Requests naming a ``model`` route only to replicas where it is resident
(``serve/registry.py``), and a dead replica's orphans re-deal only to
survivors holding their model.

The fleet also grows back: ``report_rank_recovered`` and ``mark_alive``
revive a dead replica, ``add_replica`` admits a new one.
``watch_preemption`` polls the rendezvous KV scope ``preempt`` (the
markers ``elastic/preemption.PreemptionSentinel`` publishes): a marked
host's replicas are marked dead (their work fails over), and revived
when the marker clears; a failed poll is counted, backed off and
survived.  ``submit`` is the ``replica.route`` fault point (a
``kill-rank`` there is a loss detected at routing time) and the
sampling point of requests that arrive without an HTTP front end.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..faultline import runtime as _faultline
from ..obs import tracing as _obs
from ..utils import get_logger
from .batcher import DynamicBatcher, QueueFullError, Request
from .engine import InferenceEngine
from .metrics import ServeMetrics


class NoHealthyReplicaError(Exception):
    """Every replica is dead — the server answers 503 from /generate and
    ``/healthz`` reports ``unserving``."""


class Replica:
    """One serving replica: a process set (None without a runtime), an
    engine, and its batcher."""

    def __init__(self, replica_id: str, process_set,
                 engine: InferenceEngine):
        self.replica_id = replica_id
        self.process_set = process_set
        self.engine = engine
        self.state = "healthy"  # healthy | dead
        # True only while registry.roll() walks THIS replica through
        # drain -> swap -> revive.
        self.rolling = False

    @property
    def ranks(self) -> List[int]:
        if self.process_set is None:
            return []
        if self.process_set.ranks is None:
            return list(range(self.process_set.size() or 0))
        return list(self.process_set.ranks)

    def load(self) -> int:
        return self.engine.load()

    def to_dict(self) -> dict:
        out = {"id": self.replica_id, "state": self.state,
               "ranks": self.ranks, "load": self.load(),
               "active": self.engine.active_count,
               "queued": self.engine.batcher.depth(),
               "kv_mode": self.engine.kv_mode,
               "attn_impl": self.engine.attn_impl,
               "kv_dtype": self.engine.kv_dtype,
               "rolling": self.rolling,
               "models": {name: self.engine._model_versions.get(name, 0)
                          for name in sorted(self.engine._adapters)}}
        kv = self.engine.kv_stats()
        if kv is not None:
            # The fork counters and spec config ride healthz next to the
            # block stats (an MLP's pool reports no bytes per block), and
            # so do the SP prefill world's geometry and counters.
            out["kv_blocks"] = {k: kv[k] for k in
                                ("total", "used", "free", "retained",
                                 "bytes_per_block", "pool_bytes",
                                 "weight_bytes", "kv_headroom_bytes",
                                 "seq_forks", "forked_requests", "spec_k",
                                 "sp")
                                if k in kv}
        return out


class ReplicaScheduler:
    """Routes requests across replicas; drains dead ones (module doc)."""

    def __init__(self, replicas: Sequence[Replica],
                 metrics: Optional[ServeMetrics] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas: List[Replica] = list(replicas)
        self.metrics = metrics or ServeMetrics()
        self._lock = threading.Lock()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._started = False
        for r in self.replicas:
            self._register_metrics(r)
        _faultline.maybe_install_from_env()

    def _register_metrics(self, r: Replica) -> None:
        self.metrics.register_queue_depth(r.replica_id, r.engine.batcher.depth)
        self.metrics.register_kv_stats(r.replica_id, r.engine.kv_stats)

    def _healthy(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == "healthy"]

    def fleet(self) -> List[Replica]:
        """Point-in-time copy of the replica list (any state)."""
        with self._lock:
            return list(self.replicas)

    def submit(self, request: Request) -> Replica:
        """Least-loaded routing with failover: a replica at queue capacity
        backpressures; the next-least-loaded healthy replica is tried
        before the request is shed."""
        if _faultline.PLAN is not None:
            # ``replica.route`` injection point: a kill-rank here is a
            # loss detected at routing time (an all-numeric target is a
            # slot rank, anything else a replica id).  The spec's target
            # names the victim, so no instance is passed.
            for f in _faultline.fire("replica.route"):
                if f.kind != "kill-rank" or f.target is None:
                    continue
                if f.target.isdigit():
                    self.report_rank_lost(int(f.target))
                else:
                    self.mark_dead(f.target, reason="faultline kill-rank")
        if _obs.TRACER is not None and not request._sampling_decided:
            # Ingress without an HTTP front end (direct submits): the
            # scheduler samples and the engine emits the root span at
            # completion.  A request the front end already decided on is
            # not rolled again.
            request._sampling_decided = True
            if _obs.TRACER.should_sample():
                request.trace = _obs.TRACER.new_context()
                request._emit_root = True
        candidates = sorted(self._healthy(), key=lambda r: r.load())
        if request.model is not None:
            # Only replicas where the model is resident.  A model known
            # to SOME replicas while all of them are dead is a fleet
            # condition (503); an unknown-everywhere model is the
            # caller's error, answered 400 by the server before this.
            candidates = [r for r in candidates
                          if request.model in r.engine._adapters]
        if not candidates:
            self.metrics.count_request("error", tenant=request.tenant)
            raise NoHealthyReplicaError(
                "no healthy replicas" if request.model is None else
                f"no healthy replica holds model {request.model!r}")
        last_exc: Optional[Exception] = None
        for replica in candidates:
            try:
                replica.engine.batcher.submit(request)
                return replica
            except QueueFullError as e:
                last_exc = e
        self.metrics.count_request("shed", tenant=request.tenant)
        raise last_exc  # every healthy queue is full: explicit shed

    def start(self) -> "ReplicaScheduler":
        self._started = True
        for r in self.replicas:
            r.engine.start()
        return self

    def stop(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=10)
            self._watch_thread = None
        for r in self.replicas:
            for req in r.engine.batcher.close():
                req.fail(NoHealthyReplicaError("server shutting down"))
            # drain() (not stop()) so in-flight requests fail NOW instead
            # of parking their handler threads for the full timeout.
            for req in r.engine.drain():
                req.fail(NoHealthyReplicaError("server shutting down"))

    def report_rank_lost(self, rank: int) -> Optional[str]:
        """A lost slot rank kills the healthy replica whose process set
        holds it.  Returns that replica's id (None when the rank maps to
        no healthy replica)."""
        with self._lock:
            victim = next((r for r in self.replicas
                           if r.state == "healthy" and rank in r.ranks),
                          None)
        if victim is None:
            return None
        self.mark_dead(victim.replica_id, reason=f"rank {rank} lost")
        return victim.replica_id

    def mark_dead(self, replica_id: str, reason: str = "") -> None:
        """Remove a replica from routing and requeue ITS work (queued +
        in-flight) onto the survivors, round-robin from the least
        loaded."""
        with self._lock:
            victim = next((r for r in self.replicas
                           if r.replica_id == replica_id), None)
            if victim is None or victim.state == "dead":
                return
            victim.state = "dead"
        self.metrics.count_replica_event("mark_dead")
        get_logger().warning("serve: replica %s marked dead (%s); draining",
                             replica_id, reason or "operator request")
        # CLOSE (not merely drain) the victim's batcher: a late submit
        # then raises QueueFullError and fails over instead of queueing
        # where nothing polls.
        queued = victim.engine.batcher.close()
        now = time.monotonic()
        for req in queued:
            req.requeues += 1  # engine.drain() bumps its own
            req.resubmitted_at = now
        orphans = queued + victim.engine.drain()
        try:
            # A tiered engine withdraws its fleet-directory entries: a
            # peer mid-migration toward a dead holder must miss fast and
            # recompute, not wait out fetch retries.
            victim.engine.tier_unpublish()
        except Exception:
            get_logger().warning(
                "serve: %s tier unpublish failed on mark_dead",
                replica_id, exc_info=True)
        if not orphans:
            return
        if _obs.TRACER is not None:
            # Failover forensics: each traced orphan gets a resubmit
            # instant naming the dead replica; the resubmission span
            # closes at the survivor's admission.
            for req in orphans:
                if req.trace is None:
                    continue
                try:
                    _obs.TRACER.instant(
                        req.trace, "resubmit", replica_id,
                        args={"from": replica_id,
                              "reason": reason or "mark_dead"})
                except Exception:
                    pass
        survivors = sorted(self._healthy(), key=lambda r: r.load())
        if not survivors:
            for req in orphans:
                self.metrics.count_request("error", tenant=req.tenant)
                req.fail(NoHealthyReplicaError(
                    f"replica {replica_id} lost with no survivors"))
            return
        # Dealt round-robin from the least loaded survivor; a request
        # pinned to a model goes only to survivors holding it (during a
        # roll, exactly the replicas still serving the variant).
        chunks = {s.replica_id: [] for s in survivors}
        rr: Dict[Optional[str], int] = {}  # per-model deal cursor
        for req in orphans:
            eligible = survivors if req.model is None else [
                s for s in survivors if req.model in s.engine._adapters]
            if not eligible:
                self.metrics.count_request("error", tenant=req.tenant)
                req.fail(NoHealthyReplicaError(
                    f"no surviving replica holds model {req.model!r}"))
                continue
            i = rr.get(req.model, 0)
            rr[req.model] = i + 1
            self.metrics.count_request("requeued", tenant=req.tenant)
            chunks[eligible[i % len(eligible)].replica_id].append(req)
        for s in survivors:
            s.engine.batcher.requeue_front(chunks[s.replica_id])
        get_logger().warning("serve: requeued %d request(s) from %s",
                             len(orphans), replica_id)

    def mark_alive(self, replica_id: str, reason: str = "") -> None:
        """Re-admit a dead replica: reopen its batcher, restart its loop
        (which re-runs warmup when it is enabled).  Safe on the existing
        pool: drain freed every block reference and the attention masks
        everything past a live sequence's length."""
        with self._lock:
            replica = next((r for r in self.replicas
                            if r.replica_id == replica_id), None)
            if replica is None or replica.state == "healthy":
                return
            replica.state = "healthy"
        replica.engine.batcher.reopen()
        if self._started:
            replica.engine.start()
        self.metrics.count_replica_event("mark_alive")
        get_logger().warning("serve: replica %s re-admitted (%s)",
                             replica_id, reason or "operator request")

    def report_rank_recovered(self, rank: int) -> Optional[str]:
        """A recovered slot rank revives the dead replica whose process
        set holds it.  Returns that replica's id (None when the rank maps
        to no dead replica: a new process set enters by
        ``add_replica``)."""
        with self._lock:
            dead = next((r for r in self.replicas
                         if r.state == "dead" and rank in r.ranks), None)
        if dead is None:
            return None
        self.mark_alive(dead.replica_id, reason=f"rank {rank} recovered")
        return dead.replica_id

    def add_replica(self, replica: Replica) -> None:
        """Admit a new replica into the routing set: its metrics are
        registered and, once the scheduler has started, its engine
        starts (with its warmup when enabled)."""
        with self._lock:
            if any(r.replica_id == replica.replica_id
                   for r in self.replicas):
                raise ValueError(
                    f"replica id {replica.replica_id} already registered")
            self.replicas.append(replica)
        self._register_metrics(replica)
        if self._started:
            replica.engine.start()
        self.metrics.count_replica_event("mark_alive")
        get_logger().warning("serve: replica %s added (scale-up); fleet "
                             "size now %d", replica.replica_id,
                             len(self.replicas))

    def watch_preemption(self, kv_client, host_ranks: Dict[str, List[int]],
                         poll_s: Optional[float] = None) -> None:
        """Poll the rendezvous KV scope ``preempt`` and turn marker churn
        into fleet transitions: a host appearing kills the replicas its
        ranks map to (``report_rank_lost``), a marked host disappearing
        revives them (``report_rank_recovered``).  ``host_ranks`` maps a
        discovery hostname to the slot ranks it carries.  Every failed
        poll is counted (``hvd_serve_preempt_poll_errors_total``), backed
        off exponentially (capped at 30 s) and retried: the watcher
        never dies of a KV flake."""
        from ..elastic.preemption import PREEMPT_SCOPE
        poll_s = poll_s if poll_s is not None else float(
            os.environ.get("HVD_SERVE_PREEMPT_POLL_S", "1"))

        def loop():
            marked_prev: set = set()
            errors = 0
            while not self._watch_stop.is_set():
                try:
                    marked = set(kv_client.scan(PREEMPT_SCOPE))
                    for host in marked - marked_prev:
                        for rank in host_ranks.get(host, []):
                            self.report_rank_lost(rank)
                    for host in marked_prev - marked:
                        for rank in host_ranks.get(host, []):
                            self.report_rank_recovered(rank)
                    marked_prev = marked
                    errors = 0
                except Exception as e:
                    # The marker diff is kept: the next good scan sees
                    # exactly the churn this one missed.
                    errors += 1
                    self.metrics.count_preempt_poll_error()
                    backoff = min(poll_s * (2 ** min(errors, 5)), 30.0)
                    get_logger().warning(
                        "preempt watcher: poll error #%d (%s); retrying "
                        "in %.1fs", errors, e, backoff)
                    self._watch_stop.wait(backoff)
                    continue
                self._watch_stop.wait(poll_s)

        self._watch_thread = threading.Thread(
            target=loop, daemon=True, name="hvd-serve-preempt-watch")
        self._watch_thread.start()

    def healthz(self) -> dict:
        with self._lock:
            replicas = [r.to_dict() for r in self.replicas]
        healthy = sum(1 for r in replicas if r["state"] == "healthy")
        if healthy == len(replicas):
            status = "ok"
        elif healthy > 0:
            status = "degraded"
        else:
            status = "unserving"
        return {"status": status, "healthy": healthy,
                "total": len(replicas), "replicas": replicas}


def build_replicas(adapter_factory: Callable[[], object],
                   num_replicas: Optional[int] = None,
                   max_batch: Optional[int] = None,
                   metrics: Optional[ServeMetrics] = None,
                   **engine_kwargs) -> ReplicaScheduler:
    """Partition the initialized world into ``num_replicas`` process sets
    and stand up one engine per set, calling ``adapter_factory`` once per
    replica — each replica owns its adapter and KV block pool.
    ``engine_kwargs`` pass through to each ``InferenceEngine`` (kv_mode /
    num_blocks / prefill_chunk / prefix_cache / spec_k).

    After ``hvd.init()`` the count defaults to ``HVD_SERVE_REPLICAS`` or
    ``max(num_slots() // 2, 1)`` and the sets come from
    ``partition_process_sets``, whose registration is collective: every
    rank calls this in the same order.  With no runtime (pure local
    serving) the count defaults to ``HVD_SERVE_REPLICAS`` or 1 and no
    process set is made."""
    from .. import core as _core
    if _core.is_initialized():
        from ..process_sets import partition_process_sets
        n = num_replicas if num_replicas is not None else int(
            os.environ.get("HVD_SERVE_REPLICAS",
                           str(max(_core.num_slots() // 2, 1))))
        sets: List[Optional[object]] = list(partition_process_sets(n))
    else:
        n = num_replicas or int(os.environ.get("HVD_SERVE_REPLICAS", "1"))
        sets = [None] * n
    metrics = metrics or ServeMetrics()
    replicas = []
    for i, ps in enumerate(sets):
        rid = f"replica-{i}"
        engine = InferenceEngine(adapter_factory(),
                                 batcher=DynamicBatcher(),
                                 metrics=metrics, max_batch=max_batch,
                                 replica_id=rid, **engine_kwargs)
        replicas.append(Replica(rid, ps, engine))
    return ReplicaScheduler(replicas, metrics=metrics)
