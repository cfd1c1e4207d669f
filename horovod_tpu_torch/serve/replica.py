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

Not ported yet: the preemption watcher, the ``replica.route`` fault
point and the tracing hooks.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

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
            # block stats (an MLP's pool reports no bytes per block).
            out["kv_blocks"] = {k: kv[k] for k in
                                ("total", "used", "free", "retained",
                                 "bytes_per_block", "pool_bytes",
                                 "weight_bytes", "kv_headroom_bytes",
                                 "seq_forks", "forked_requests", "spec_k")
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
        self._started = False
        for r in self.replicas:
            self.metrics.register_queue_depth(
                r.replica_id, r.engine.batcher.depth)
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
        for r in self.replicas:
            for req in r.engine.batcher.close():
                req.fail(NoHealthyReplicaError("server shutting down"))
            # drain() (not stop()) so in-flight requests fail NOW instead
            # of parking their handler threads for the full timeout.
            for req in r.engine.drain():
                req.fail(NoHealthyReplicaError("server shutting down"))

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
        if not orphans:
            return
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
