"""Per-tenant fairness and quotas for the serving plane (hvdtenant).

Copied unchanged from ``horovod_tpu/serve/tenancy.py`` (pure Python;
the port keeps its own copy and never imports the JAX package).

The multi-tenant half of the serving platform (docs/serving.md
multi-tenancy): every request carries a ``tenant`` identity (the
``X-Tenant-Id`` header / ``tenant`` payload field, ``"default"`` when
absent) and the batcher's admission order interleaves tenants by
**weighted deficit round robin** (Shreedhar & Varghese '95) UNDER the
existing QoS-tier ordering — requeued work still outranks everything,
``latency`` still beats ``throughput``, but WITHIN each of those classes
tenants share admission in proportion to their configured weights
instead of first-come-first-served (one bursty tenant can no longer
starve the rest of the queue).

Quotas (``HVD_SERVE_TENANT_*`` knobs, docs/knobs.md):

* **weights** — ``HVD_SERVE_TENANT_WEIGHTS="acme:3,beta:1"``; unlisted
  tenants weigh 1.  With zero or one distinct tenant in the queue the
  reorder is a no-op, so single-tenant deployments keep the exact
  pre-hvdtenant admission order (tests pin this).
* **queue bound** — ``HVD_SERVE_TENANT_QUEUE``: max queued requests per
  tenant (0 = unbounded); exceeding it sheds with ``QueueFullError``
  (HTTP 503) exactly like the global bound.
* **token quota** — ``HVD_SERVE_TENANT_TOKENS``: max summed
  ``prompt + max_new_tokens`` a tenant may hold queued (0 = unbounded) —
  the cost currency is the same lifetime-token footprint the paged
  admission budget accounts, so a tenant cannot sidestep its share with
  few-but-huge requests.

Deficit state persists across admission rounds on the batcher's
scheduler instance, so long-run admitted shares converge to the weights
even when each round admits only a handful of requests.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

#: The implicit tenant of untagged requests.
TENANT_DEFAULT = "default"


def safe_tenant(value) -> Optional[str]:
    """Sanitize a client-supplied tenant id (same alphabet discipline as
    the server's trace-id handling: no CRLF header injection, nothing
    that breaks the Prometheus label or the timeline JSON).  Returns the
    id, or None when the value is unusable."""
    if isinstance(value, str) and 0 < len(value) <= 64 and \
            all(c.isascii() and (c.isalnum() or c in "-_.")
                for c in value):
        return value
    return None


def parse_weights(spec: str) -> Dict[str, float]:
    """``"acme:3,beta:1"`` → ``{"acme": 3.0, "beta": 1.0}``.  Bare names
    weigh 1; a non-positive weight is a configuration error and raises
    loudly (a zero-weight tenant would silently starve forever)."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if safe_tenant(name) is None:
            raise ValueError(f"invalid tenant name {name!r} in weights")
        weight = float(w) if w.strip() else 1.0
        if not weight > 0:
            raise ValueError(
                f"tenant {name!r} weight must be > 0, got {weight}")
        out[name] = weight
    return out


class TenantConfig:
    """Parsed per-tenant policy (weights + quotas, module doc)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 max_queue: int = 0, max_tokens: int = 0,
                 quantum: int = 64):
        self.weights: Dict[str, float] = dict(weights or {})
        self.max_queue = int(max_queue)
        self.max_tokens = int(max_tokens)
        if int(quantum) < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = int(quantum)

    @classmethod
    def from_env(cls) -> "TenantConfig":
        return cls(
            weights=parse_weights(
                os.environ.get("HVD_SERVE_TENANT_WEIGHTS", "")),
            max_queue=int(os.environ.get("HVD_SERVE_TENANT_QUEUE", "0")),
            max_tokens=int(os.environ.get("HVD_SERVE_TENANT_TOKENS", "0")),
            quantum=int(os.environ.get("HVD_SERVE_TENANT_QUANTUM", "64")))

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)


def request_cost(r) -> int:
    """The fairness/quota cost currency: one request's lifetime token
    footprint (prompt + decode budget) — the same quantity the paged
    admission budget reserves, so the two planes cannot disagree about
    what a request 'costs'."""
    return len(r.prompt) + r.max_new_tokens


def _class_key(r):
    """The priority class WDRR must never reorder across: requeued work
    is one class regardless of tier (batcher._order_key's contract),
    then one class per QoS tier."""
    if r.requeues:
        return (0,)
    return (1, r.qos)


class DeficitRoundRobin:
    """Persistent weighted-DRR admission interleave (module doc).

    ``reorder`` reorders a queue ALREADY sorted by the batcher's
    ``_order_key``: within each contiguous run of equal priority class it
    interleaves tenants by deficit round robin (preserving each tenant's
    own EDF/FIFO order), and returns runs with zero or one distinct
    tenant untouched — single-tenant traffic keeps the exact legacy
    order.  Deficits persist across calls so long-run shares converge to
    the weights.  Not thread-safe by itself; the owning batcher calls it
    under its queue lock."""

    def __init__(self, config: Optional[TenantConfig] = None):
        self.config = config or TenantConfig()
        self.deficits: Dict[str, float] = {}

    def reorder(self, queue: List) -> List:
        if len(queue) < 2:
            return queue
        out: List = []
        run: List = []
        run_key = None
        for r in queue + [None]:  # sentinel flushes the last run
            key = _class_key(r) if r is not None else None
            if key != run_key and run:
                out.extend(self._interleave(run))
                run = []
            run_key = key
            if r is not None:
                run.append(r)
        return out

    def _interleave(self, run: List) -> List:
        per_tenant: Dict[str, List] = {}
        order: List[str] = []  # first-appearance order: deterministic
        for r in run:
            t = getattr(r, "tenant", TENANT_DEFAULT)
            if t not in per_tenant:
                per_tenant[t] = []
                order.append(t)
            per_tenant[t].append(r)
        if len(order) < 2:
            return run
        cfg = self.config
        out: List = []
        remaining = len(run)
        while remaining:
            for t in order:
                q = per_tenant[t]
                if not q:
                    continue
                self.deficits[t] = self.deficits.get(t, 0.0) \
                    + cfg.quantum * cfg.weight(t)
                while q and self.deficits[t] >= request_cost(q[0]):
                    r = q.pop(0)
                    self.deficits[t] -= request_cost(r)
                    out.append(r)
                    remaining -= 1
                if not q:
                    # Classic DRR: an emptied flow's deficit resets —
                    # idle credit must not accumulate into a burst later.
                    self.deficits[t] = 0.0
        return out


class TenantAccounting:
    """Bounded-cardinality per-tenant label registry (the metrics-plane
    half of the cardinality cap): the first ``max_labels`` distinct
    tenants get their own label, every later one collapses into
    ``"other"`` — a hostile or misconfigured client cannot blow up the
    ``/metrics`` series count by inventing tenant ids."""

    OVERFLOW = "other"

    def __init__(self, max_labels: Optional[int] = None):
        self.max_labels = max_labels if max_labels is not None else int(
            os.environ.get("HVD_SERVE_TENANT_MAX_LABELS", "32"))
        self._labels: set = set()
        self._lock = threading.Lock()

    def label(self, tenant: Optional[str]) -> str:
        t = tenant or TENANT_DEFAULT
        with self._lock:
            if t in self._labels:
                return t
            if len(self._labels) < self.max_labels:
                self._labels.add(t)
                return t
        return self.OVERFLOW
