"""Dynamic request batcher: bounded queue, size/deadline admission
triggers, shape bucketing, explicit backpressure.

Copied unchanged from ``horovod_tpu/serve/batcher.py`` (pure Python;
the port keeps its own copy and never imports the JAX package).

No reference analog (the reference is training-only).  The design follows
the serving literature: admission happens at *token-step* granularity
(Orca's iteration-level scheduling) — the engine polls ``get_admission``
between decode steps, so a request never waits for a whole running batch
to finish — and the queue is bounded with EXPLICIT shedding (an unbounded
queue converts overload into unbounded latency; a 503 at admission keeps
tail latency honest and lets the client retry against another front-end).

Triggers:

* **size** — enough queued requests to fill the engine's free slots: admit
  immediately (a fuller batch costs nothing extra per Orca's argument —
  the decode step is memory-bound on batch-1 anyway);
* **deadline** — the oldest queued request has waited
  ``HVD_SERVE_MAX_WAIT_MS``: admit whatever is there (bounds the latency
  cost of batch formation when traffic is sparse).

Shape bucketing: prompt lengths are padded up to power-of-two buckets
(floor ``HVD_SERVE_BUCKET_MIN``) so the engine compiles one prefill per
bucket instead of one per length — ``bucket_requests`` groups an admitted
set by bucket and the engine runs one prefill per group.

Block budget (paged engine, docs/serving.md): ``get_admission`` also
accepts a resource budget + per-request cost — free KV blocks — and
admits the FIFO prefix that fits, so admission is bounded by actual
cache memory instead of slot count.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from .tenancy import (TENANT_DEFAULT, DeficitRoundRobin, TenantConfig,
                      request_cost, safe_tenant)

#: QoS admission tiers (docs/serving.md control plane): ``latency`` is
#: the SLO-bearing interactive class, ``throughput`` the best-effort
#: batch class — first shed under brownout, bounded separately.
QOS_TIERS = ("latency", "throughput")


class QueueFullError(Exception):
    """Backpressure: the bounded queue is at capacity — shed the request
    (HTTP 503 at the front-end) instead of queueing unbounded latency."""


class DeadlineExceededError(Exception):
    """The request's client-supplied deadline expired while queued."""


class _Counter:
    lock = threading.Lock()
    n = 0

    @classmethod
    def next(cls) -> int:
        with cls.lock:
            cls.n += 1
            return cls.n


class Request:
    """One generation request travelling batcher → engine → completion.

    Completion is a per-request event: HTTP handler threads block in
    ``result()`` while engine threads call ``complete``/``fail``.  A
    request drained off a dead replica is *resubmitted* — generated
    tokens are discarded and it restarts cleanly elsewhere; the
    position-keyed decoding contract (greedy argmax, and sampled draws
    keyed by (seed, sample, position) — serve/sampling.py) makes the
    eventual answer identical (tests pin this).

    Sampling fields (docs/serving.md): ``temperature`` 0 = greedy (the
    default), ``top_k``/``top_p`` filter the sampled distribution,
    ``n`` > 1 asks for n parallel completions forked off one prompt
    prefill (CoW block tables), ``seed`` keys every draw and is always
    echoed in the response (server-assigned when absent) so sampled
    outputs are reproducible.  Validation is strict per field
    (sampling.validate_params; the server maps ValueError to HTTP 400).
    """

    def __init__(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: float = 1.0,
                 n: int = 1,
                 seed: Optional[int] = None,
                 qos: str = "latency",
                 tenant: str = TENANT_DEFAULT,
                 model: Optional[str] = None,
                 stream: bool = False,
                 logprobs: Optional[int] = None,
                 schema=None):
        from .sampling import validate_params
        (self.temperature, self.top_k, self.top_p, self.n,
         self.seed) = validate_params(temperature, top_k, top_p, n, seed)
        # hvdstream interactive-API fields (serve/streaming.py,
        # serve/structured.py): ``stream`` opts the response into SSE
        # token events, ``logprobs`` asks for top-k alternatives per
        # generated token, ``schema`` constrains decoding to a
        # JSON-Schema subset.  All three are n==1 features — the fork
        # path has no per-sample sink/mask plumbing, and a silent
        # single-sample downgrade would be worse than a 400.
        if not isinstance(stream, bool):
            raise ValueError(f"stream must be a boolean, got {stream!r}")
        self.stream = stream
        if logprobs is not None:
            if isinstance(logprobs, bool) or not isinstance(logprobs, int):
                raise ValueError(
                    f"logprobs must be an integer, got {logprobs!r}")
            if not 0 < logprobs <= 16:
                raise ValueError(
                    f"logprobs must be in [1, 16], got {logprobs}")
        self.logprobs = logprobs
        if schema is not None and not isinstance(schema, dict):
            raise ValueError(
                f"schema must be a JSON object, got "
                f"{type(schema).__name__}")
        self.schema = schema
        if self.n > 1 and (stream or logprobs is not None
                           or schema is not None):
            raise ValueError(
                "stream/logprobs/schema require n == 1")
        # Multi-tenant identity + model variant (serve/tenancy.py,
        # serve/registry.py): both share the tenant alphabet discipline
        # — they become Prometheus labels and routing keys, so a hostile
        # value must die HERE (the server maps ValueError to HTTP 400).
        if safe_tenant(tenant) is None:
            raise ValueError(
                f"invalid tenant id {tenant!r} (ascii alnum/-_. , "
                "1-64 chars)")
        self.tenant = tenant
        if model is not None and safe_tenant(model) is None:
            raise ValueError(
                f"invalid model name {model!r} (ascii alnum/-_. , "
                "1-64 chars)")
        self.model = model
        if qos not in QOS_TIERS:
            # The server maps this to HTTP 400 like every other
            # validation error — an unknown tier must never silently
            # land in the default class.
            raise ValueError(
                f"qos must be one of {QOS_TIERS}, got {qos!r}")
        self.qos = qos
        if not prompt:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            # Prefill always produces one token; a request for zero would
            # silently be answered with one (and pay the prefill anyway).
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if timeout_s is not None and not float(timeout_s) > 0:
            # A zero/negative timeout used to collapse to "no deadline"
            # (0 is falsy) and park the handler for the server-side cap;
            # reject it loudly instead — the server maps this to 400.
            raise ValueError(
                f"timeout_s must be positive, got {timeout_s}")
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.request_id = request_id or f"req-{_Counter.next()}"
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + timeout_s
                         if timeout_s else None)
        self.generated: List[int] = []
        # n>1 parallel sampling: one completed token list per sample
        # index, filled by the engine as forks finish; ``generated``
        # mirrors sample 0 at completion (the legacy single-sample
        # surface).  None for n == 1.
        self.samples: Optional[List[Optional[List[int]]]] = (
            [None] * self.n if self.n > 1 else None)
        self.replica_id: Optional[str] = None
        self.requeues = 0
        self.first_token_at: Optional[float] = None
        # Sequence-parallel prefill admission verdict (serve/seqpar.py):
        # set by _take when the engine passes an SP budget — True means
        # admission could NOT reserve transient per-rank extent blocks
        # for this long prompt (the SP world is busy), so the engine
        # prefills it on the proven single-rank chunked path instead of
        # serializing it behind another SP job.
        self.sp_denied = False
        # Request tracing (obs/tracing.py): ``trace`` is the sampled
        # request's TraceContext — it travels ON the request because the
        # lifecycle crosses threads (HTTP handler → batcher queue →
        # engine loop) where a contextvar cannot follow.  None (the
        # default) means untraced; every span-emission site guards on
        # it.  ``resubmitted_at`` marks a failover/preemption requeue so
        # the NEXT admission can emit the resubmission span
        # retroactively.
        self.trace = None
        self.resubmitted_at: Optional[float] = None
        self._emit_root = False  # scheduler-sampled (no HTTP root span)
        # True once an ingress point ROLLED the sampling decision (even
        # if the answer was "don't trace"): the scheduler's fallback
        # sampling must not re-roll a request the HTTP front-end already
        # decided against — that would double the effective sample rate
        # and trace requests whose responses carry no X-Trace-Id.
        self._sampling_decided = False
        # Per-stage latency decomposition (docs/observability.md): an
        # EXACT partition of [submitted_at, completion] into queue /
        # prefill / decode / retry milliseconds, advanced by stage_add
        # at each lifecycle boundary — the engine feeds the totals into
        # the hvd_serve_stage_ms histograms at completion (the
        # per-stage inputs ROADMAP item 4's autoscaler consumes).
        # Always on: the cost is one clock read per boundary.
        self.stage_ms: Dict[str, float] = {"queue": 0.0, "prefill": 0.0,
                                           "decode": 0.0, "spec": 0.0,
                                           "retry": 0.0}
        self._stage_mark = self.submitted_at
        # hvdstream runtime state: ``sink`` is the per-request
        # TokenStream the engine publishes into (serve/streaming.py;
        # None for buffered requests), ``grammar`` the compiled
        # TokenGrammar the engine attaches at admission,
        # ``token_logprobs`` the per-token logprob records when
        # ``logprobs`` was requested, ``finish_reason`` the terminal
        # cause ("stop" | "length" | "grammar").  ``cancelled`` is the
        # client-disconnect flag: the HTTP handler sets it at write
        # time (cancel()), the engine reaps the sequence at its next
        # step — slot freed, paged blocks released, the outcome
        # counted under ``cancel_reason``.
        self.sink = None
        self.grammar = None
        self.token_logprobs: Optional[List] = (
            [] if logprobs is not None else None)
        self.finish_reason: Optional[str] = None
        self.cancelled = False
        self.cancel_reason: Optional[str] = None
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def stage_add(self, stage: str, now: Optional[float] = None) -> float:
        """Credit the time since the last boundary to ``stage`` and
        advance the mark; returns the previous mark (span emitters use
        it as the retroactive span's start)."""
        now = time.monotonic() if now is None else now
        prev = self._stage_mark
        self.stage_ms[stage] += max(now - prev, 0.0) * 1e3
        self._stage_mark = now
        return prev

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) >= self.deadline)

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds of deadline budget left (None without a deadline;
        clamped at 0).  The server returns this on 503/504 so a client
        knows how much retry budget its request still has."""
        if self.deadline is None:
            return None
        return max(self.deadline - (now or time.monotonic()), 0.0)

    def cancel(self, reason: str = "client_gone") -> None:
        """Client-disconnect signal (hvdstream): flag only — the engine
        observes it at its next step and reaps the sequence (blocks
        freed, slot cleared, outcome counted under ``reason``).  Safe
        from any thread; idempotent."""
        self.cancelled = True
        if self.cancel_reason is None:
            self.cancel_reason = reason

    def complete(self) -> None:
        # Terminal-event contract (serve/streaming.py module doc):
        # wiring the sink HERE — not at the engine's call sites — means
        # every completion path, present and future, lands a terminal
        # event in the stream.  finish() also flushes any unpublished
        # tail of ``generated``, making concatenated-stream ==
        # buffered-response a hard invariant.
        if self.sink is not None:
            self.sink.finish(self.generated, self.token_logprobs)
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self._error = exc
        if self.sink is not None:
            # Mid-stream deadline expiry, brownout shed, failed
            # failover, engine error: one terminal error event, never
            # a silent hangup.
            self.sink.abort(exc)
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"{self.request_id} not finished after {timeout}s")
        if self._error is not None:
            raise self._error
        return list(self.generated)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def sampled(self) -> bool:
        """True when this request draws from the sampled distribution
        (greedy requests never touch a PRNG key)."""
        return self.temperature > 0


def sp_extent_tokens(prompt_len: int, ranks: int,
                     block_tokens: int) -> int:
    """Per-rank sequence extent of a sequence-parallel prefill
    (serve/seqpar.py): ``ceil(prompt_len / ranks)`` rounded UP to a
    whole block.  Block-aligned extents are what keep the post-prefill
    handoff whole-block (rank r's extent starts exactly at global block
    ``r * extent // block_tokens``), so admission costing, the SP world's
    per-rank allocation, and the handoff all agree on one number."""
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    ext = -(-int(prompt_len) // int(ranks))
    bt = max(int(block_tokens), 1)
    return -(-ext // bt) * bt


def prompt_bucket(length: int, *, floor: Optional[int] = None,
                  cap: Optional[int] = None) -> int:
    """Pad a prompt length up to its power-of-two bucket."""
    floor = floor if floor is not None else int(
        os.environ.get("HVD_SERVE_BUCKET_MIN", "8"))
    b = max(floor, 1)
    while b < length:
        b *= 2
    if cap is not None:
        b = min(b, cap)
    return b


def bucket_requests(requests: Sequence[Request],
                    *, floor: Optional[int] = None,
                    cap: Optional[int] = None) -> Dict[int, List[Request]]:
    """Group an admitted set by padded prompt-length bucket (one prefill
    compile/run per group)."""
    groups: Dict[int, List[Request]] = {}
    for r in requests:
        groups.setdefault(
            prompt_bucket(len(r.prompt), floor=floor, cap=cap), []).append(r)
    return groups


def _order_key(r: Request):
    """Admission order within the queue (sorted at take time, QoS tiers):

    1. requeued work first, in its CURRENT queue position (the
       ``requeue_front`` contract — already-accepted work drained off a
       dead replica outranks everything, and Python's stable sort keeps
       the chunk order ``mark_dead`` dealt);
    2. latency tier before throughput tier;
    3. earliest deadline first within a tier (EDF — the expiry check
       alone sheds late work but never PRIORITIZES urgent work);
    4. FIFO arrival (stable sort) for deadline-less peers — exactly the
       pre-QoS order, so single-tier deadline-less traffic is untouched.
    """
    if r.requeues:
        return (0, 0, 0.0)
    return (1, 0 if r.qos == "latency" else 1,
            r.deadline if r.deadline is not None else math.inf)


class DynamicBatcher:
    """Bounded FIFO with size/deadline admission triggers (module doc)."""

    def __init__(self, max_queue: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 on_shed: Optional[Callable[[Request, str], None]] = None,
                 tenants: Optional[TenantConfig] = None):
        self.max_queue = max_queue if max_queue is not None else int(
            os.environ.get("HVD_SERVE_MAX_QUEUE", "256"))
        self.max_wait_s = (max_wait_ms if max_wait_ms is not None else float(
            os.environ.get("HVD_SERVE_MAX_WAIT_MS", "5"))) / 1e3
        # Per-tier queue bounds (0 = unbounded within max_queue): the
        # throughput tier is typically bounded tighter so a batch burst
        # can never crowd interactive traffic out of the shared queue.
        self.tier_bounds: Dict[str, int] = {
            "latency": int(os.environ.get("HVD_SERVE_QOS_LAT_QUEUE", "0")),
            "throughput": int(
                os.environ.get("HVD_SERVE_QOS_TPT_QUEUE", "0"))}
        # Brownout rung (serve/controller.py ladder), set by the
        # FleetController and read lock-free here (plain int, GIL-atomic;
        # a rung change is advisory and takes effect on the next submit):
        # >=1 sheds new throughput-tier submissions, >=3 rejects n>1
        # forking, >=4 purges already-queued throughput work at
        # admission time.  ``brownout_max_new`` (rung 2+; 0 = no cap)
        # caps each taken request's effective max_new_tokens.
        self.brownout_level = 0
        self.brownout_max_new = 0
        # Per-tenant policy (serve/tenancy.py): quotas enforced at
        # submit, weighted-DRR interleave applied at take time UNDER the
        # QoS ordering.  Deficit state lives on _drr and persists across
        # admission rounds.
        self.tenants = tenants if tenants is not None \
            else TenantConfig.from_env()
        self._drr = DeficitRoundRobin(self.tenants)
        self._on_shed = on_shed
        self._queue: List[Request] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def submit(self, request: Request) -> None:
        level = self.brownout_level
        if level >= 1 and request.qos == "throughput":
            raise QueueFullError(
                f"brownout level {level}: throughput tier shed")
        if level >= 3 and request.n > 1:
            raise QueueFullError(
                f"brownout level {level}: n>1 forking disabled")
        with self._cond:
            if self._closed:
                raise QueueFullError("batcher is closed")
            if len(self._queue) >= self.max_queue:
                # Explicit backpressure: reject NOW.  The caller (server
                # or scheduler) turns this into a 503 / reroute; counting
                # happens there so shed-at-replica vs shed-at-server stay
                # distinguishable.
                raise QueueFullError(
                    f"queue at capacity ({self.max_queue})")
            bound = self.tier_bounds.get(request.qos, 0)
            if bound and sum(1 for r in self._queue
                             if r.qos == request.qos) >= bound:
                raise QueueFullError(
                    f"{request.qos} tier at capacity ({bound})")
            # Per-tenant quotas (serve/tenancy.py): a queue-slot bound
            # and a token-footprint quota, both over this tenant's
            # currently-queued work — requeue_front bypasses them (the
            # already-accepted-work contract above).
            tq = self.tenants.max_queue
            if tq and sum(1 for r in self._queue
                          if r.tenant == request.tenant) >= tq:
                raise QueueFullError(
                    f"tenant {request.tenant!r} queue at capacity "
                    f"({tq})")
            tt = self.tenants.max_tokens
            if tt:
                held = sum(request_cost(r) for r in self._queue
                           if r.tenant == request.tenant)
                if held + request_cost(request) > tt:
                    raise QueueFullError(
                        f"tenant {request.tenant!r} token quota "
                        f"exceeded ({held} held + "
                        f"{request_cost(request)} > {tt})")
            self._queue.append(request)
            self._cond.notify_all()

    def requeue_front(self, requests: Sequence[Request]) -> None:
        """Re-admit already-accepted work at the FRONT of the queue (dead
        replica drain).  Deliberately bypasses the capacity bound: these
        requests were admitted once — shedding them now would turn a
        replica loss into dropped accepted work."""
        if not requests:
            return
        with self._cond:
            self._queue[0:0] = list(requests)
            self._cond.notify_all()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def _pop_expired(self, now: float, expired: List[Request]) -> None:
        # Caller holds the lock.  Only REMOVES from the queue; failing
        # the requests and firing on_shed happen after the lock is
        # released (get_admission's finally) — on_shed reaches into
        # ServeMetrics, and calling it here would order batcher-lock →
        # metrics-lock against /metrics' metrics-lock → batcher-lock
        # queue-depth sampling (AB/BA deadlock).
        kept = []
        for r in self._queue:
            # Cancelled (client-gone) requests leave with the expired
            # set — same remove-here / fail-outside-the-lock discipline,
            # distinguished at fail time.
            (expired if r.expired(now) or r.cancelled
             else kept).append(r)
        self._queue = kept

    def _take(self, free_slots: int, budget: Optional[int], cost,
              hard_cap: Optional[int],
              sp_min_tokens: Optional[int] = None,
              sp_capacity: Optional[int] = None,
              sp_cost=None) -> List[Request]:
        # Caller holds the lock.  FIFO prefix bounded by BOTH the free
        # slot count and the caller's resource budget (free KV blocks in
        # the paged engine): the walk stops at the first request the
        # budget cannot cover — never skips past the head, so a cheap
        # late request cannot starve an expensive early one.  Requests
        # whose cost exceeds ``hard_cap`` (the pool's total capacity) are
        # taken regardless: no amount of waiting helps, and the engine
        # fails them loudly at admission.
        #
        # SP admission costing (serve/seqpar.py): long prompts (>=
        # ``sp_min_tokens``) are ADDITIONALLY charged ``sp_cost(r)``
        # transient per-rank extent blocks against ``sp_capacity`` — the
        # sequence-parallel world's free prefill-pool blocks.  Unlike the
        # owner-pool budget this never blocks admission: a long prompt
        # the SP pools cannot take is admitted with ``sp_denied`` set and
        # prefills single-rank (SP is a latency optimization, not a
        # capacity requirement).
        taken: List[Request] = []
        remaining = budget
        sp_remaining = sp_capacity
        cap = self.brownout_max_new
        while self._queue and len(taken) < free_slots:
            r = self._queue[0]
            if cap and r.max_new_tokens > cap:
                # Brownout rung 2+ caps the effective max_new_tokens
                # HERE, before cost() sees the request — the admission
                # budget, block allocation, and fork-tail reserves must
                # all agree on the capped lifetime.
                r.max_new_tokens = cap
            if cost is not None:
                c = cost(r)
                if hard_cap is not None and c > hard_cap:
                    self._sp_charge(r, sp_min_tokens, sp_remaining,
                                    sp_cost)
                    taken.append(self._queue.pop(0))
                    continue
                if remaining is not None and c > remaining:
                    break
                if remaining is not None:
                    remaining -= c
            sp_remaining = self._sp_charge(r, sp_min_tokens,
                                           sp_remaining, sp_cost)
            taken.append(self._queue.pop(0))
        return taken

    @staticmethod
    def _sp_charge(r: Request, sp_min_tokens: Optional[int],
                   sp_remaining: Optional[int], sp_cost):
        """Charge one admitted request against the SP extent budget
        (see _take); returns the remaining capacity.  Prompts below the
        threshold are untouched (their stale ``sp_denied`` from a prior
        admission round is reset — requeued requests re-qualify)."""
        if sp_min_tokens is None or sp_cost is None:
            return sp_remaining
        r.sp_denied = False
        if len(r.prompt) < sp_min_tokens:
            return sp_remaining
        c = int(sp_cost(r))
        if sp_remaining is not None and c > sp_remaining:
            r.sp_denied = True
            return sp_remaining
        return None if sp_remaining is None else sp_remaining - c

    def get_admission(self, free_slots: int,
                      block_s: float = 0.0,
                      budget: Optional[int] = None,
                      cost=None,
                      hard_cap: Optional[int] = None,
                      sp_min_tokens: Optional[int] = None,
                      sp_capacity: Optional[int] = None,
                      sp_cost=None) -> List[Request]:
        """Up to ``free_slots`` requests, honoring the size/deadline
        triggers.  ``block_s`` > 0 waits that long for the triggers when
        the queue cannot fire them yet (the engine blocks when idle and
        polls with 0 between decode steps).

        ``budget``/``cost``/``hard_cap`` account a second resource beyond
        slots (the paged engine's free KV blocks, docs/serving.md): the
        admitted set is the FIFO prefix whose summed ``cost(request)``
        fits ``budget`` (see ``_take``).  ``sp_min_tokens``/
        ``sp_capacity``/``sp_cost`` account a THIRD, advisory resource —
        the sequence-parallel prefill world's transient extent blocks
        (serve/seqpar.py): long prompts that do not fit are still
        admitted, marked ``sp_denied`` (see ``_sp_charge``)."""
        if free_slots <= 0:
            return []
        deadline = time.monotonic() + block_s
        expired: List[Request] = []
        purged: List[Request] = []
        try:
            with self._cond:
                while True:
                    now = time.monotonic()
                    self._pop_expired(now, expired)
                    if self.brownout_level >= 4 and self._queue:
                        # Rung 4 (latency-tier-only admission): queued
                        # throughput-tier work is purged — removed here,
                        # failed after the lock drops (the expiry
                        # discipline; see _pop_expired).
                        kept = []
                        for r in self._queue:
                            (purged if r.qos == "throughput"
                             else kept).append(r)
                        self._queue = kept
                    if self._queue:
                        # The EDF sort below means queue[0] need not be
                        # the oldest arrival — the deadline trigger
                        # scans for the true oldest.
                        oldest_age = now - min(r.submitted_at
                                               for r in self._queue)
                        if (len(self._queue) >= free_slots
                                or oldest_age >= self.max_wait_s):
                            # QoS/EDF ordering happens at TAKE time, not
                            # submit time — tiers and deadlines can only
                            # reorder work that actually waited
                            # (_order_key; stable, so deadline-less
                            # single-tier traffic keeps exact FIFO).
                            self._queue.sort(key=_order_key)
                            if len({r.tenant for r in self._queue}) > 1:
                                # Weighted-DRR tenant interleave UNDER
                                # the class order (serve/tenancy.py):
                                # reorders only within runs of equal
                                # (requeued, tier) class; single-tenant
                                # queues skip entirely, keeping the
                                # legacy admission order byte-exact.
                                self._queue[:] = self._drr.reorder(
                                    self._queue)
                            taken = self._take(free_slots, budget, cost,
                                               hard_cap, sp_min_tokens,
                                               sp_capacity, sp_cost)
                            if taken:
                                return taken
                            # Head too expensive for the current budget:
                            # nothing admits this round — the engine
                            # retries after the next decode step frees
                            # blocks (a condition wait can't observe
                            # block frees, only submits).
                            return []
                        # Triggers not fired: wait only until the oldest
                        # ages out (never past the caller's budget).
                        wait = min(self.max_wait_s - oldest_age,
                                   max(deadline - now, 0.0))
                    else:
                        wait = deadline - now
                    if self._closed or wait <= 0:
                        return []
                    self._cond.wait(wait)
        finally:
            # Lock released (the with-block exits before finally runs).
            for r in expired:
                if r.cancelled and not r.expired():
                    # Client vanished while queued: nobody is listening
                    # for this failure — the outcome label is the point.
                    r.fail(QueueFullError(
                        f"{r.request_id} client disconnected in queue"))
                    if self._on_shed:
                        self._on_shed(r, r.cancel_reason or "client_gone")
                    continue
                r.fail(DeadlineExceededError(
                    f"{r.request_id} expired after "
                    f"{time.monotonic() - r.submitted_at:.3f}s in queue"))
                if self._on_shed:
                    self._on_shed(r, "expired")
            for r in purged:
                # QueueFullError → the client's 503/Retry-After path: a
                # brownout purge is a shed, not a deadline miss.
                r.fail(QueueFullError(
                    f"brownout level {self.brownout_level}: "
                    f"latency-tier-only admission"))
                if self._on_shed:
                    self._on_shed(r, "shed")

    def drain(self) -> List[Request]:
        """Empty the queue and return the requests (dead-replica path —
        they will be resubmitted, not failed)."""
        with self._cond:
            taken, self._queue = self._queue, []
            return taken

    def peek(self, n: int) -> List[tuple]:
        """Non-consuming look at the next ``n`` queued requests as
        ``(prompt, model)`` pairs — the tier prefetcher hashes these to
        warm host-side prefix blocks ahead of admission.  Prompts are
        copied so the caller never aliases queue-owned state."""
        with self._cond:
            head = self._queue[:max(n, 0)]
            return [(list(r.prompt), r.model) for r in head]

    def close(self) -> List[Request]:
        with self._cond:
            self._closed = True
            taken, self._queue = self._queue, []
            self._cond.notify_all()
            return taken

    def reopen(self) -> None:
        """Re-admit a closed batcher (mark_alive scale-up: the revived
        replica's queue starts empty and accepting).  A no-op on an open
        batcher."""
        with self._cond:
            self._closed = False
            self._cond.notify_all()
