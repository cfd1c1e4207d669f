"""Coordinator negotiation of the eager collectives, over the c10d store.

Port of ``horovod_tpu/ops/negotiation.py:76-646`` (``Negotiator``).  On
the eager path each process issues collectives in whatever order its
Python code reaches them.  If two ranks disagree on the order, or on a
tensor's shape or dtype, NCCL hangs with no diagnosis (gloo times out).
The reference answers with rank-0 negotiation (controller.cc:74): every
rank announces readiness, rank 0 validates consistency
(ConstructResponse, controller.cc:496) and publishes the verdict; a
ResponseCache (response_cache.h:45) skips the round-trip for tensors
already negotiated; a StallInspector (stall_inspector.h:30) reports which
ranks are missing when a collective stalls.

The logic (message table, response cache, stall inspector) is the native
core (``csrc/hvd_core.cc``, ``csrc/native.py``).  The transport is the
world's c10d store (``core.init`` makes it; every world of more than one
rank has one) in place of the JAX package's HTTP KV server.  The store
has ``set``, ``get``, ``add``, ``check``, ``wait``, ``multi_get``,
``multi_set`` and ``delete_key``; ``get`` of a missing key blocks until
the store's timeout, so every read here is preceded by a ``check`` or a
``wait`` with its own timeout.

* A request is the key ``rq/<gen>/<epoch>/<name>/<rank>``.  The
  coordinator feeds its own signature to the message table directly,
  waits on the other ranks' keys, feeds each arrival to the table and
  the missing ranks' silence to the stall inspector, and publishes the
  verdict at ``resp/<gen>/<name>/<epoch>``; a worker sets its request
  and waits on the verdict key.
* A cached dispatch costs no synchronous round-trip: its record of the
  replayable dispatch stream is buffered and shipped by a flusher
  thread, in one ``multi_set`` per cycle, over a store client of its
  own (a client serializes its operations, so a blocking ``wait`` of
  the caller's thread must not hold up the flusher).
* Cross-rank cache invalidation is an ``add`` counter, each increment
  naming one tensor and the dispatch of it that renegotiates (in place
  of ``inval_ver``): a rank drops its cached verdict when it reaches
  that dispatch, not when it reads the record.
* Join markers are an ``add`` counter per join round; the order of the
  increments is the order of joining.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from ..exceptions import CollectiveRejectedError, HorovodInternalError
from ..utils.logging import get_logger

# Op-kind id bases; the per-op parameter (ReduceOp value, broadcast root)
# is folded in so joined ranks can reconstruct the exact call from the
# signature alone.  Ranges are disjoint; allgather-family ids are >= 1000
# (the native Validate() relaxes dim0 matching for those).  The JAX
# package's table, unchanged.
KIND_IDS = {
    "allreduce": 0,             # + ReduceOp (0..5)
    "alltoall": 300,
    "reducescatter": 400,       # + ReduceOp
    "barrier": 500,
    "grouped_allreduce": 600,   # + ReduceOp
    "allgather": 1000,          # allgather-family: ids in [1000, 2000)
    "allgather_sizes": 1001,
    "broadcast": 10000,         # + root rank (unbounded above; own range)
}
# The port's kinds more: the explicit two-level allreduce, whose id folds
# in the ReduceOp and the node size (+ ReduceOp + 8 · local_size), and the
# ragged alltoall's two dispatches (its split rows, then its rows, whose
# dim 0 differs by rank: an id in the allgather family's range).
_KINDS = dict(KIND_IDS, hierarchical_allreduce=700, alltoall_splits=301,
              alltoallv=1002)

_POLL_S = 1.0  # the coordinator's stall-check cadence
_FLUSH_S = 3e-3  # the flusher's cycle


def _is_timeout(e: BaseException) -> bool:
    return isinstance(e, RuntimeError) and "timeout" in str(e).lower()


def _store_guarded(fn):
    """Map a failing store (its server gone, a broken connection) to
    HorovodInternalError, so the elastic retry loop owns it."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        try:
            return fn(self, *a, **kw)
        except dist.DistError as e:
            raise HorovodInternalError(
                f"the store is unreachable during negotiation: {e}") from e
    return wrapper


class Negotiator:
    """Per-process negotiation endpoint.  Rank 0 doubles as coordinator.

    ``store`` is the world's store; ``flush_store`` makes the flusher's
    own client of it (None: the flusher shares ``store``, as an
    in-process store allows)."""

    def __init__(self, rank: int, size: int, cfg, store=None,
                 flush_store: Optional[Callable[[], object]] = None,
                 liveness: Optional[Callable[[], Optional[str]]] = None):
        self.rank = rank
        self.size = size
        self.cfg = cfg
        self.enabled = size > 1 and store is not None
        if not self.enabled:
            return
        from ..csrc.native import (CACHE_HIT, CACHE_INVALID,
                                   NativeMessageTable, NativeResponseCache,
                                   NativeStallInspector)
        self._HIT, self._INVALID = CACHE_HIT, CACHE_INVALID
        self.store = store
        self._make_flush_store = flush_store
        self._flush_store = None
        self.cache = NativeResponseCache(cfg.cache_capacity)
        self.msgtable = NativeMessageTable(size) if rank == 0 else None
        self.stall = NativeStallInspector(
            cfg.stall_warning_time_seconds if cfg.stall_check_enabled
            else float("inf"),
            cfg.stall_shutdown_time_seconds, size)
        self.stall_reports: List[tuple] = []  # every stall warning logged
        self._epochs: Dict[str, int] = {}
        # Dispatches of each name so far, cached or negotiated: the same
        # count on every rank at the same point of the program, so an
        # invalidation names the dispatch it applies to.
        self._uses: Dict[str, int] = {}
        self._inval_at: Dict[str, set] = {}  # name -> uses to renegotiate
        self._inval_seen = 0        # last global invalidation absorbed
        self._inval_check_ts = 0.0
        # Negotiation generation "w.c", a part of every key
        # (HVD_TPU_NEGOTIATION_GEN, bumped by elastic resets; each
        # generation also gets a store of its own).
        self._gen = os.environ.get("HVD_TPU_NEGOTIATION_GEN", "0")
        # Elastic runs: a callable giving a reason to abandon a wait (the
        # world moved on: a peer died), checked once a wait has lasted a
        # poll, so a dead peer costs a survivor seconds, not the timeout.
        self._liveness = liveness
        self.join_round = 0
        self._joined: Dict[int, Dict[int, dict]] = {}  # round -> k -> marker
        # Replayable dispatch stream (the join protocol's backbone): every
        # dispatch, cached or negotiated, appends a (seq, signature) record
        # to this rank's ring of store keys.  Ranks advance in lockstep
        # (same collectives, same program order), so seq N names the same
        # collective on every rank.
        self.dispatch_seq = 0
        self._ring = int(os.environ.get("HVD_TPU_DISPATCH_RING", "1024"))
        self._timeout = cfg.gloo_timeout_seconds
        self._buf: list = []
        self._gc: List[str] = []  # keys the flusher deletes
        self._buf_lock = threading.Lock()
        self._flush_lock = threading.Lock()  # serializes batch shipping
        self._flusher = None
        self._flush_error: Optional[BaseException] = None
        self._flush_error_logged = False
        self._buf_event = threading.Event()
        self._closed = False
        # What this endpoint has done: negotiated (slow path) and cached
        # (fast path) dispatches.
        self.negotiated = 0
        self.cached = 0

    # -- keys -----------------------------------------------------------------

    def _req_key(self, name: str, epoch: int, rank: int) -> str:
        return f"hvd/rq/{self._gen}/{epoch}/{name}/{rank}"

    def _resp_key(self, name: str, epoch: int) -> str:
        return f"hvd/resp/{self._gen}/{name}/{epoch}"

    def _inval_key(self, seq=None) -> str:
        return f"hvd/inval/{self._gen}/" + ("ver" if seq is None
                                             else str(seq))

    def _disp_key(self, src: int, seq: int) -> str:
        return f"hvd/disp/{self._gen}/{src}/{seq % self._ring}"

    def _join_key(self, round_: int, k=None) -> str:
        return f"hvd/join/{self._gen}/{round_}/" + ("n" if k is None
                                                     else str(k))

    def _wait(self, store, keys: List[str], seconds: float) -> bool:
        """True once every key exists; False after ``seconds``."""
        try:
            store.wait(keys, datetime.timedelta(seconds=max(seconds, 1e-3)))
            return True
        except RuntimeError as e:
            if _is_timeout(e):
                return False
            raise

    # -- protocol -------------------------------------------------------------

    @_store_guarded
    def negotiate(self, name: str, kind: str, dtype: str,
                  shape: Tuple[int, ...], op: int = 0,
                  prescale: float = 1.0, postscale: float = 1.0,
                  ps_id: int = 0, ps_ranks=None, timeline=None) -> None:
        """Block until every rank has announced this collective and rank 0
        validated consistency; raises CollectiveRejectedError on a
        mismatch.  A response-cache HIT dispatches at once, with no
        round-trip."""
        if not self.enabled:
            return
        kind_id = _KINDS.get(kind, 0) + op
        self._absorb_remote_invalidations()
        use = self._uses.get(name, 0)
        self._uses[name] = use + 1
        marks = self._inval_at.get(name)
        if marks and use in marks:
            # Another rank renegotiates this very dispatch.
            marks.discard(use)
            self.cache.invalidate(name)
        status = self.cache.lookup(name, dtype, shape, kind_id, prescale,
                                   postscale, ps_id)
        sig = {"dtype": dtype, "shape": list(shape), "op": kind_id,
               "prescale": prescale, "postscale": postscale, "ps_id": ps_id}
        if ps_ranks is not None:
            # The membership rides the wire beside the hashed ps_id (see
            # ops._wire_ps): the coordinator exact-checks it and a joined
            # rank resolves the set from it on replay.
            sig["ps_ranks"] = list(ps_ranks)
        if status == self._HIT:
            # Cache fast path: no round-trip, but the dispatch is still
            # published to this rank's replay stream, so a rank that
            # joined a moment ago replays it with zeros.
            self.cached += 1
            self.publish_dispatch(name, self._epochs.get(name, 0), sig, kind)
            return
        if status == self._INVALID:
            # A shape or parameter change: renegotiate under a fresh epoch
            # and tell every other rank, whose cached HIT would otherwise
            # dispatch straight into a mismatched collective.
            self.cache.invalidate(name)
            self._publish_invalidation(name, use)
        self.negotiated += 1
        epoch = self._epochs.get(name, 0)
        self._epochs[name] = epoch + 1
        self.publish_dispatch(name, epoch, sig, kind)
        if timeline is not None:
            timeline.negotiate_start(name, kind.upper())
        try:
            if self.rank == 0:
                if epoch > 1:
                    # A worker may still be between its wait for the
                    # previous epoch's verdict and its read; the epoch
                    # before that one everybody has left (their requests
                    # for the previous epoch all arrived).
                    self._collect(self._resp_key(name, epoch - 2))
                verdict = self._coordinate(name, epoch, sig, timeline, kind)
            else:
                verdict = self._submit_and_wait(name, epoch, sig)
        finally:
            if timeline is not None:
                timeline.negotiate_end(name, kind.upper())
        if verdict:
            raise CollectiveRejectedError(
                f"collective {name!r} rejected by coordinator: {verdict}")
        self.cache.put(name, dtype, shape, kind_id, prescale, postscale,
                       ps_id)

    # -- cross-rank cache invalidation ---------------------------------------

    def _publish_invalidation(self, name: str, use: int) -> None:
        """Tell the other ranks that dispatch number ``use`` of ``name``
        renegotiates.  The counter hands out a globally unique sequence
        number, so however invalidations of several ranks interleave,
        every peer reads each of them once (a plain overwritten marker
        would be ABA-racy)."""
        seq = self.store.add(self._inval_key(), 1)
        self.store.set(self._inval_key(seq), json.dumps(
            {"rank": self.rank, "name": name, "use": use}))

    def _absorb_remote_invalidations(self) -> None:
        """Before trusting a cache HIT, absorb other ranks' invalidations.
        One counter read at most every 50 ms; a stale HIT inside that
        window dispatches into a collective the renegotiating rank never
        joins, and that rank's negotiation times out with a named error:
        degraded diagnosis, never silent corruption."""
        now = time.time()
        if now - self._inval_check_ts < 0.05:
            return
        self._inval_check_ts = now
        ver = self.store.add(self._inval_key(), 0)
        if ver <= self._inval_seen:
            return
        keys = [self._inval_key(s) for s in range(self._inval_seen + 1,
                                                  ver + 1)]
        # The record follows its counter increment at once.
        if not self._wait(self.store, keys, 5.0):
            raise HorovodInternalError(
                "an invalidation record never followed its counter")
        for raw in self.store.multi_get(keys):
            rec = json.loads(raw)
            # The invalidation applies to one dispatch: kept until this
            # rank reaches it, ignored if this rank is past it.  Dropping
            # the cached verdict at once (the JAX package) makes a rank
            # that absorbs a peer's invalidation early or late
            # renegotiate alone while its peers dispatch from the cache:
            # a hang (ROADMAP Queue C).
            name = rec["name"]
            if rec["rank"] != self.rank and \
                    rec["use"] >= self._uses.get(name, 0):
                self._inval_at.setdefault(name, set()).add(rec["use"])
        self._inval_seen = ver

    # -- join protocol (JoinOp, collective_operations.h:308) -----------------
    #
    # A rank with no more data calls join(): it publishes a round-scoped
    # join marker carrying its dispatch_seq, then REPLAYS live ranks'
    # dispatch streams from that position (ops/eager.py EagerEngine.join),
    # zero-filling each record, so the collectives stay total over all
    # processes.  Replays negotiate and publish like any dispatch, which
    # keeps every rank's seq aligned across join rounds.  join() returns
    # the last rank to join, on every rank.

    @_store_guarded
    def publish_dispatch(self, name: str, epoch: int, sig: dict,
                         kind: str) -> None:
        """Append one replayable record to this rank's dispatch stream.
        The append is local; the flusher ships the buffer once per cycle.
        A buffer of ring/4 records forces an inline flush so slot reuse
        can never outrun visibility."""
        if self._flush_error is not None:
            err, self._flush_error = self._flush_error, None
            raise err
        self.dispatch_seq += 1
        rec = {"seq": self.dispatch_seq, "name": name, "epoch": epoch,
               "sig": sig, "kind": kind}
        with self._buf_lock:
            self._buf.append((self._disp_key(self.rank, self.dispatch_seq),
                              json.dumps(rec)))
            pending = len(self._buf)
        if pending >= max(1, self._ring // 4):
            self.flush_dispatches()
        else:
            self._buf_event.set()
            if self._flusher is None:
                self._start_flusher()

    def _collect(self, key: str) -> None:
        """Delete ``key`` later, from the flusher (best effort)."""
        with self._buf_lock:
            self._gc.append(key)
        self._buf_event.set()

    def flush_dispatches(self) -> None:
        """Ship every buffered stream record in one ``multi_set`` (and
        delete the collected keys).  The flush lock serializes inline and
        flusher-thread flushes, so batches land in seq order."""
        with self._flush_lock:
            with self._buf_lock:
                batch, self._buf = self._buf, []
                gc, self._gc = self._gc, []
            if not batch and not gc:
                return
            if self._flush_store is None:
                self._flush_store = (self._make_flush_store()
                                     if self._make_flush_store is not None
                                     else self.store)
            store = self._flush_store
            if batch:
                try:
                    store.multi_set([k for k, _ in batch],
                                    [v for _, v in batch])
                except Exception:
                    # Re-queue: a transient failure must not punch a hole
                    # in the replay stream.
                    with self._buf_lock:
                        self._buf[:0] = batch
                        self._gc[:0] = gc
                    raise
            for key in gc:
                try:
                    store.delete_key(key)
                except Exception as e:  # best effort, never silent
                    get_logger().debug("negotiation GC of %s failed: %s",
                                       key, e)

    def _start_flusher(self) -> None:
        with self._buf_lock:
            if self._flusher is not None or self._closed:
                return
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name=f"hvd-dispatch-flush-{self.rank}")
            self._flusher.start()

    def _flush_loop(self) -> None:
        while not self._closed:
            if not self._buf_event.wait(timeout=1.0):
                continue  # nothing pending: stay parked
            # Batch window: let the cycle's records accumulate.
            time.sleep(_FLUSH_S)
            self._buf_event.clear()
            try:
                self.flush_dispatches()
                self._flush_error_logged = False
            except Exception as e:
                # Surface on the dispatching thread (the next publish
                # rethrows) and log the first failure of a streak; re-arm,
                # since the failed batch was re-queued.
                self._flush_error = e
                self._buf_event.set()
                if not self._flush_error_logged:
                    self._flush_error_logged = True
                    get_logger().warning(
                        "dispatch-stream flush failed (records re-queued; "
                        "rethrown on next publish): %r", e)
                time.sleep(0.05)

    def close(self) -> None:
        """Stop the flusher and ship the pending records, bounded: an
        unreachable store must not hold up the process's exit."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        self._buf_event.set()
        t = threading.Thread(target=lambda: self._swallow(
            self.flush_dispatches), daemon=True,
            name=f"hvd-dispatch-close-{self.rank}")
        t.start()
        t.join(2.0)
        flusher = self._flusher
        if flusher is not None and flusher is not threading.current_thread():
            flusher.join(2.0)

    @staticmethod
    def _swallow(fn) -> None:
        try:
            fn()
        except Exception:
            pass

    @_store_guarded
    def poll_dispatch(self, src: int, seq: int) -> Optional[dict]:
        """Record number ``seq`` of ``src``'s stream, or None if not yet
        published.  A newer record in the slot means the publisher lapped
        the ring before this rank replayed: unrecoverable, so fail
        loudly."""
        key = self._disp_key(src, seq)
        if not self.store.check([key]):
            return None
        rec = json.loads(self.store.get(key))
        if rec["seq"] == seq:
            return rec
        if rec["seq"] > seq:
            raise HorovodInternalError(
                f"join replay stream overrun: rank {src} is "
                f"{rec['seq'] - seq} dispatches ahead of this joined rank "
                f"(ring size {self._ring}; raise HVD_TPU_DISPATCH_RING)")
        return None  # the slot still holds an older lap's record

    @_store_guarded
    def joined_ranks(self, round_: int) -> Dict[int, dict]:
        """rank -> {"order": k, "seq": final dispatch seq} for the round,
        read fresh: k-th to join has order k."""
        got = self._joined.setdefault(round_, {})
        n = self.store.add(self._join_key(round_), 0)
        if n > len(got):
            keys = [self._join_key(round_, k)
                    for k in range(len(got) + 1, n + 1)]
            if not self._wait(self.store, keys, 5.0):
                raise HorovodInternalError(
                    "a join marker never followed its counter")
            for k, raw in zip(range(len(got) + 1, n + 1),
                              self.store.multi_get(keys)):
                got[k] = json.loads(raw)
        return {m["rank"]: {"order": k, "seq": m["seq"]}
                for k, m in got.items()}

    def join_marker(self, round_: int, rank: int) -> Optional[dict]:
        """One rank's join marker for the round (fresh read), or None."""
        return self.joined_ranks(round_).get(rank)

    def join_active(self) -> bool:
        """True while some rank's join round is open (the coordinator's
        broadcast-root check; not on the dispatch hot path)."""
        return bool(self.joined_ranks(self.join_round))

    @_store_guarded
    def announce_join(self, round_: int) -> None:
        # The stream's records go out before the marker that ends them.
        self.flush_dispatches()
        k = self.store.add(self._join_key(round_), 1)
        self.store.set(self._join_key(round_, k),
                       json.dumps({"rank": self.rank,
                                   "seq": self.dispatch_seq}))

    def finish_join_round(self, round_: int, last_rank: int) -> None:
        """Forget the round's markers (every rank has read them)."""
        del last_rank
        self._joined.pop(round_, None)

    def _submit_and_wait(self, name: str, epoch: int, sig: dict) -> str:
        """A worker: announce the request and wait for the verdict."""
        self.store.set(self._req_key(name, epoch, self.rank),
                       json.dumps(sig))
        resp = self._resp_key(name, epoch)
        deadline = time.time() + self._timeout
        chunk = _POLL_S if self._liveness is not None else 5.0
        while not self._wait(self.store, [resp],
                             min(deadline - time.time(), chunk)):
            if time.time() >= deadline:
                raise HorovodInternalError(
                    f"timed out waiting for negotiation verdict on {name!r}")
            why = self._liveness() if self._liveness is not None else None
            if why:
                raise HorovodInternalError(
                    f"negotiation of {name!r} abandoned: {why}")
        return json.loads(self.store.get(resp)).get("error", "")

    def _coordinate(self, name: str, epoch: int, my_sig: dict,
                    timeline, kind: str = "allreduce") -> str:
        """Rank 0: gather every rank's request, run the native message
        table, publish the verdict and return it ("" = approved).

        The table is keyed per (name, epoch) and erased on every exit
        path: an error verdict must not poison the name for a retry.  A
        joined rank's requests arrive like any other rank's (it replays
        the stream); only a broadcast whose root has joined is refused
        (a joined root has no data, and zeros would be silently wrong)."""
        tbl_key = f"{name}#{epoch}"
        started = time.time()
        deadline = started + self._timeout
        arrived = set()
        sigs = {0: my_sig}
        keys = {r: self._req_key(name, epoch, r) for r in range(1, self.size)}
        try:
            res = self.msgtable.increment(
                tbl_key, my_sig["dtype"], my_sig["shape"], my_sig["op"], 0,
                my_sig["prescale"], my_sig["postscale"], my_sig["ps_id"])
            if res == -1:
                return self._publish(name, epoch,
                                     "duplicate request from rank 0 "
                                     "(DUPLICATE_NAME_ERROR)")
            arrived.add(0)
            self.stall.record_request(tbl_key, 0, time.time())
            if timeline is not None:
                timeline.negotiate_rank_ready(name, 0)
            last_stall_check = time.time()
            while len(arrived) < self.size:
                missing = [r for r in keys if r not in arrived]
                if self._wait(self.store, [keys[r] for r in missing],
                              min(_POLL_S, deadline - time.time())):
                    ready = missing
                else:
                    ready = [r for r in missing
                             if self.store.check([keys[r]])]
                raws = self.store.multi_get([keys[r] for r in ready]) \
                    if ready else []
                for r, raw in zip(ready, raws):
                    sig = json.loads(raw)
                    res = self.msgtable.increment(
                        tbl_key, sig["dtype"], sig["shape"], sig["op"], r,
                        sig["prescale"], sig["postscale"], sig["ps_id"])
                    if res == -1:
                        return self._publish(
                            name, epoch,
                            f"duplicate request from rank {r} "
                            f"(DUPLICATE_NAME_ERROR)")
                    sigs[r] = sig
                    arrived.add(r)
                    self.stall.record_request(tbl_key, r, time.time())
                    if timeline is not None:
                        timeline.negotiate_rank_ready(name, r)
                now = time.time()
                if len(arrived) < self.size and \
                        now - last_stall_check >= _POLL_S:
                    last_stall_check = now
                    st, report = self.stall.check(now)
                    if st >= 1:
                        for tname, waited, ready_r, missing_r in report:
                            self.stall_reports.append(
                                (tname.split("#")[0], waited, ready_r,
                                 missing_r))
                            get_logger().warning(
                                "Stalled collective %s: waited %.0fs; ready "
                                "ranks %s; missing ranks %s "
                                "(HOROVOD_STALL_CHECK_TIME_SECONDS)",
                                tname.split("#")[0], waited, ready_r,
                                missing_r)
                    if st == 2:
                        return self._publish(
                            name, epoch, "stall shutdown threshold exceeded")
                if len(arrived) < self.size and now > deadline:
                    return self._publish(
                        name, epoch,
                        f"negotiation timed out; arrived={sorted(arrived)}")
                if len(arrived) < self.size and \
                        self._liveness is not None and \
                        now - started >= _POLL_S:
                    why = self._liveness()
                    if why:
                        return self._publish(
                            name, epoch,
                            f"{why}; arrived={sorted(arrived)}")
            verdict = self._membership_verdict(name, sigs)
            if verdict is not None:
                return self._publish(name, epoch, verdict)
            if kind == "broadcast" and self.join_active():
                root = my_sig["op"] - KIND_IDS["broadcast"]
                if root in self.joined_ranks(self.join_round):
                    return self._publish(
                        name, epoch,
                        f"broadcast root rank {root} has joined "
                        f"(no data to broadcast)")
            # Native validation errors embed the epoch-scoped table key;
            # surface the user-facing name instead.
            return self._publish(
                name, epoch,
                self.msgtable.validate(tbl_key).replace(tbl_key, name))
        finally:
            self.stall.record_done(tbl_key)
            self.msgtable.erase(tbl_key)
            for r in arrived - {0}:
                self._collect(keys[r])

    def _membership_verdict(self, name: str, sigs: Dict[int, dict]
                            ) -> Optional[str]:
        """The process sets the ranks announced.  All alike (the JAX
        package's case): None, and the native table validates the rest.
        Disjoint sets, each announced by every one of its members (ranks
        0-1 reduce over (0, 1) while ranks 2-3 reduce over (2, 3), as
        Horovod's per-set controllers allow): the verdict on the other
        parameters, validated as if the sets were one ("" when they
        agree).  Else the JAX package's membership verdict.  ps_id is a
        membership hash (ops._wire_ps); comparing the rank lists closes
        its collision window."""
        first = sigs[0].get("ps_ranks")
        if all(sigs[r].get("ps_ranks") == first for r in sigs):
            return None
        world = list(range(self.size))
        announced = {r: sigs[r].get("ps_ranks") or world for r in sigs}
        if all(announced[m] == announced[r]
               for r in sigs for m in announced[r]):
            key = f"{name}#sets"
            table = self.msgtable
            try:
                for r, sig in sorted(sigs.items()):
                    table.increment(key, sig["dtype"], sig["shape"],
                                    sig["op"], r, sig["prescale"],
                                    sig["postscale"], 0)
                return table.validate(key).replace(key, name)
            finally:
                table.erase(key)
        r = next(r for r in sorted(sigs)
                 if sigs[r].get("ps_ranks") != first)
        return (f"process-set membership mismatch on {name!r}: rank {r} "
                f"announced {sigs[r].get('ps_ranks')} vs {first}")

    def _publish(self, name: str, epoch: int, err: str) -> str:
        """Publish the verdict for the waiting ranks; return it for the
        coordinator's own caller."""
        self.store.set(self._resp_key(name, epoch),
                       json.dumps({"error": err}))
        return err
