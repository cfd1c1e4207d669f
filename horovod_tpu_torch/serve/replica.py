"""Replica scheduler: least-loaded routing over serving replicas, with
failover.

Port of ``horovod_tpu/serve/replica.py``.  A serving replica is an
independent copy of the model with its own engine, batcher and KV block
pool; requests route to the least-loaded healthy replica (load =
in-flight sequences + queued requests).  ``mark_dead`` removes a replica
from routing and requeues its queued and in-flight work at the front of
the survivors' queues (greedy decoding makes the eventual answer
identical); ``mark_alive`` re-admits it.

Not ported yet: the process-set branch of ``build_replicas`` (it needs
the port of ``core.py``; the port always takes the no-runtime branch
with an explicit replica count), the preemption watcher, and the
faultline/tracing hooks.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..utils import get_logger
from .batcher import DynamicBatcher, QueueFullError, Request
from .engine import InferenceEngine
from .metrics import ServeMetrics


class NoHealthyReplicaError(Exception):
    """Every replica is dead — the server answers 503 from /generate and
    ``/healthz`` reports ``unserving``."""


class Replica:
    """One serving replica: an engine and its batcher (``process_set`` is
    None until process sets are ported)."""

    def __init__(self, replica_id: str, process_set,
                 engine: InferenceEngine):
        self.replica_id = replica_id
        self.process_set = process_set
        self.engine = engine
        self.state = "healthy"  # healthy | dead

    @property
    def ranks(self) -> List[int]:
        return []

    def load(self) -> int:
        return self.engine.load()

    def to_dict(self) -> dict:
        out = {"id": self.replica_id, "state": self.state,
               "ranks": self.ranks, "load": self.load(),
               "active": self.engine.active_count,
               "queued": self.engine.batcher.depth(),
               "kv_mode": self.engine.kv_mode,
               "attn_impl": self.engine.attn_impl,
               "kv_dtype": self.engine.kv_dtype}
        kv = self.engine.kv_stats()
        out["kv_blocks"] = {k: kv[k] for k in
                            ("total", "used", "free", "retained",
                             "bytes_per_block", "pool_bytes",
                             "weight_bytes")}
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
        if not candidates:
            self.metrics.count_request("error", tenant=request.tenant)
            raise NoHealthyReplicaError("no healthy replicas")
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
        chunks = {s.replica_id: [] for s in survivors}
        for i, req in enumerate(orphans):
            self.metrics.count_request("requeued", tenant=req.tenant)
            chunks[survivors[i % len(survivors)].replica_id].append(req)
        for s in survivors:
            s.engine.batcher.requeue_front(chunks[s.replica_id])

    def mark_alive(self, replica_id: str, reason: str = "") -> None:
        """Re-admit a dead replica: reopen its batcher, restart its loop.
        Safe on the existing pool: drain freed every block reference and
        the attention masks everything past a live sequence's length."""
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
    """Stand up ``num_replicas`` engines (``HVD_SERVE_REPLICAS``, default
    1), calling ``adapter_factory`` once per replica — each replica owns
    its adapter and KV block pool.  ``engine_kwargs`` pass through to each
    ``InferenceEngine`` (num_blocks / prefill_chunk / prefix_cache).

    This is the JAX package's no-runtime branch: replicas are not mapped
    onto process sets until ``core.py`` is ported."""
    n = num_replicas or int(os.environ.get("HVD_SERVE_REPLICAS", "1"))
    metrics = metrics or ServeMetrics()
    replicas = []
    for i in range(n):
        rid = f"replica-{i}"
        engine = InferenceEngine(adapter_factory(),
                                 batcher=DynamicBatcher(),
                                 metrics=metrics, max_batch=max_batch,
                                 replica_id=rid, **engine_kwargs)
        replicas.append(Replica(rid, None, engine))
    return ReplicaScheduler(replicas, metrics=metrics)
