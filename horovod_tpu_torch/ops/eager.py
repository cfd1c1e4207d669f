"""The eager engine: every collective of the port goes through it.

Port of ``horovod_tpu/ops/eager.py``: ``HandleManager`` (``:50-80``) and
``EagerEngine`` (``:82-594``), the enqueue → negotiate → execute pipeline
of the reference's L3-L5 (EnqueueTensorAllreduce, operations.cc:1408),
minus the JAX package's mesh and compiled-program cache, which torch
does not need: the data plane is a ``torch.distributed`` call (NCCL on a
card, gloo on the CPU), handed to ``run`` as a function.

``run`` gives every dispatch Horovod's tensor-name contract (a second
in-flight op under one name raises ``DuplicateNameError``; an unnamed op
is labelled ``<kind>.noname.<dtype>x<shape>``), a profiler range
``hvd::<kind>::<label>``, the timeline's events in the JAX package's
order, and, in a world of more than one rank, coordinator negotiation
over the combined signature of all its tensors (``ops/negotiation.py``)
before anything reaches NCCL.  ``join`` services the other ranks'
collectives with zeros until every rank has joined (uneven data).

An ``*_async`` op has run when its form returns; on a card its kernels
may still be queued, so its handle also holds an event recorded on the
current stream after them, which ``poll`` queries and ``wait`` waits on.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..exceptions import (CollectiveRejectedError, DuplicateNameError,
                          HorovodInternalError)
from .collective_ops import dtype_name
from ..utils.logging import get_logger


def backward_name(name: Optional[str]) -> Optional[str]:
    """The name of a differentiable collective's backward dispatch: the
    forward's name with ``.grad`` appended.  The backward of an unnamed
    forward is unnamed too, and ``run`` labels it by its own kind and
    signature, as any unnamed op."""
    return None if name is None else f"{name}.grad"


def _tensors(result) -> Iterator[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (list, tuple)):
        for r in result:
            yield from _tensors(r)


class HandleManager:
    """int handle → (outputs, event or None)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._results: Dict[int, Tuple[Any, Optional[torch.cuda.Event]]] = {}

    def allocate(self, result) -> int:
        event = None
        if any(t.is_cuda for t in _tensors(result)):
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = (result, event)
            return h

    def _entry(self, handle: int, pop: bool):
        with self._lock:
            if handle not in self._results:
                raise ValueError(
                    f"unknown or already-synchronized handle {handle}")
            return (self._results.pop if pop else self._results.get)(handle)

    def poll(self, handle: int) -> bool:
        """True when the outputs are ready (``hvd.poll``)."""
        _, event = self._entry(handle, pop=False)
        return event is None or event.query()

    def wait(self, handle: int):
        """Wait for the outputs and return them (``hvd.synchronize``)."""
        result, event = self._entry(handle, pop=True)
        if event is not None:
            event.synchronize()
        return result


class EagerEngine:
    """The dispatch pipeline of one process (``core.init`` makes it)."""

    def __init__(self, topology):
        self.topo = topology
        self.n = topology.size
        self._queue = None       # native TensorQueue (duplicate names)
        self._negotiator = None  # coordinator negotiation endpoint
        self._join_gather_sizes = None
        self._join_alltoall_recv = None
        self.dispatches = 0      # every run() since init

    # -- generic dispatch ---------------------------------------------------

    def run(self, kind: str, fn: Callable[[], Any],
            tensors: List[torch.Tensor], name: Optional[str] = None,
            op_id: int = 0, prescale: float = 1.0, postscale: float = 1.0,
            ps_id: int = 0, ps_ranks=None):
        """Dispatch one collective: ``fn()`` runs its data plane and its
        result is returned.  ``tensors`` give the signature (dtype and
        shape; a ``meta`` tensor does for a rank that only negotiates).

        ``name`` is the reference's tensor-name contract: a second
        in-flight collective under the same name raises
        DuplicateNameError (common.h:239)."""
        from .. import core as _core
        tl = _core._state.timeline
        if tl is not None:
            # Each dispatch is one "cycle" (HOROVOD_TIMELINE_MARK_CYCLES).
            tl.mark_cycle()
        # Unnamed ops get a stable signature-derived label: distinct
        # unnamed collectives must not share one negotiation/cache key,
        # and per-call counters would defeat the response cache.
        if name is None:
            label = f"{kind}.noname." + ("-".join(
                f"{dtype_name(t.dtype)}x{'x'.join(map(str, t.shape))}"
                for t in tensors) if tensors else "none")
        else:
            label = name
        self.dispatches += 1
        # The profiler range (the NVTX bracket of nvtx_op_range.h:65,79)
        # spans negotiation and the enqueue; it costs nothing unless a
        # profiler is recording.  Entered before the name claim, so no
        # exception path can leak a claimed name.
        prof = torch.profiler.record_function(f"hvd::{kind}::{label}") \
            if torch.autograd._profiler_enabled() else contextlib.nullcontext()
        with prof:
            self.claim_name(name)
            try:
                if tl is not None:
                    tl.negotiate_start(label, kind.upper())
                    tl.negotiate_rank_ready(label, self.topo.rank)
                    tl.negotiate_end(label, kind.upper())
                    tl.start(label, kind.upper())
                try:
                    if self.n > 1 and tensors:
                        self._negotiate(kind, label, tensors, op_id,
                                        prescale, postscale, ps_id,
                                        ps_ranks, tl)
                    return fn()
                finally:
                    if tl is not None:
                        tl.end(label, kind.upper())
            finally:
                self.release_name(name)

    def _negotiate(self, kind, label, tensors, op_id, prescale, postscale,
                   ps_id, ps_ranks, tl) -> None:
        """Coordinator negotiation (controller.cc:74) before anything is
        enqueued: a mismatched order or shape fails here, on every rank,
        instead of hanging NCCL.  The signature combines all tensors, so
        a mismatch in any member of a grouped collective fails; the
        allgather family's dim 0 may differ."""
        neg = self.negotiator
        if not neg.enabled:
            return
        ragged = kind.startswith("allgather") or kind == "alltoallv"
        shape_sig: List[int] = []
        for t in tensors:
            dims = list(t.shape)
            if ragged and dims:
                dims[0] = -1
            shape_sig.append(len(dims))
            shape_sig.extend(dims)
        neg.negotiate(label, kind, ",".join(dtype_name(t.dtype)
                                            for t in tensors),
                      tuple(shape_sig), op_id, prescale=prescale,
                      postscale=postscale, ps_id=ps_id, ps_ranks=ps_ranks,
                      timeline=tl)

    # -- native core hooks --------------------------------------------------

    @property
    def queue(self):
        """Native TensorQueue (tensor_queue.h:28): duplicate in-flight
        name detection in the C++ core."""
        if self._queue is None:
            from ..csrc.native import NativeTensorQueue
            self._queue = NativeTensorQueue()
        return self._queue

    @property
    def negotiator(self):
        """The negotiation endpoint over the world's store (enabled in
        every world of more than one rank)."""
        if self._negotiator is None:
            from .. import core as _core
            from .negotiation import Negotiator
            st = _core._state
            addr = st.store_address

            def flush_store():
                # The flusher's own client connection (a TCPStore client
                # serializes its operations).
                import datetime
                import torch.distributed as dist
                return dist.TCPStore(addr[0], addr[1], None, False,
                                     timeout=datetime.timedelta(seconds=60))

            self._negotiator = Negotiator(
                self.topo.rank, self.topo.size, st.config, st.store,
                flush_store if addr is not None else None)
        return self._negotiator

    def close(self) -> None:
        """Stop the negotiator's flusher after shipping its records."""
        if self._negotiator is not None:
            self._negotiator.close()

    def claim_name(self, name: Optional[str]):
        if name is None:
            return None
        if not self.queue.add(name, "", []):
            raise DuplicateNameError(
                f"collective named {name!r} already in flight "
                f"(reference: DUPLICATE_NAME_ERROR, common.h:239)")
        return name

    def release_name(self, name: Optional[str]):
        if name is not None:
            self.queue.finish(name)

    # -- join (JoinOp, collective_operations.h:308) --------------------------

    def join(self) -> int:
        """Signal no more data; service peers' collectives with zero
        contributions until every rank has joined; return the last rank
        to join (``hvd.join``, torch/mpi_ops.py:1293).

        Follows a live rank's replayable dispatch stream from this rank's
        own seq, zero-filling every record.  Replays negotiate and publish
        like normal dispatches, so this rank's stream stays seq-aligned
        with its peers' across join rounds.  Each replay enqueues its
        collective and moves on: nothing waits for the card."""
        if self.n == 1:
            return 0
        neg = self.negotiator
        round_ = neg.join_round
        neg.announce_join(round_)
        deadline = time.time() + neg._timeout
        while True:
            joined = neg.joined_ranks(round_)  # rank -> {"order","seq"}
            live = [r for r in range(self.n) if r not in joined]
            if not live:
                # Everyone joined; drain up to the highest seq (a rank may
                # have dispatched and joined before this rank replayed).
                target = max(m["seq"] for m in joined.values())
                if neg.dispatch_seq >= target:
                    break
                src = max(joined, key=lambda r: joined[r]["seq"])
            else:
                src = live[0]
            rec = neg.poll_dispatch(src, neg.dispatch_seq + 1)
            if rec is not None and live:
                # Stale-snapshot guard: ``src`` may have joined since
                # ``joined`` was read, and this record may be its first
                # next-round dispatch.  The marker follows a flush of its
                # stream, so a fresh read is authoritative: past its seq,
                # stop; the all-joined branch caps the replay.
                m = neg.join_marker(round_, src)
                if m is not None and rec["seq"] > m["seq"]:
                    continue
            if rec is not None:
                self._replay_record(rec)
                deadline = time.time() + neg._timeout
                continue
            if time.time() > deadline:
                raise HorovodInternalError(
                    f"join timed out; joined={sorted(joined)} of {self.n}")
            time.sleep(0.002)
        last = max(joined, key=lambda r: (joined[r]["order"], r))
        neg.finish_join_round(round_, last)
        neg.join_round += 1
        return last

    def _replay_record(self, rec: dict) -> None:
        """Contribute zeros to a peer's collective.  The signature holds
        all it takes to rebuild the call (the kind ids of
        ops/negotiation.py).  Every path advances this rank's
        dispatch_seq by exactly one; a record that cannot be replayed is
        fatal, since skipping it would hang the live ranks."""
        from .. import core as _core
        from .. import ops as _pub
        sig, kind, name = rec["sig"], rec["kind"], rec["name"]
        dtypes = sig["dtype"].split(",")
        dims = sig["shape"]
        shapes, i = [], 0
        for _ in dtypes:
            nd = dims[i]
            i += 1
            shapes.append(tuple(dims[i:i + nd]))
            i += nd
        neg = self.negotiator
        if rec["epoch"] < neg._epochs.get(name, 0):
            raise HorovodInternalError(
                f"join: replay record for {name!r} has epoch "
                f"{rec['epoch']} < local {neg._epochs.get(name)}")
        if kind.startswith("allgather"):
            # The ragged gather is two dispatches, each with its own
            # record; replay them one to one.
            self._replay_allgather_record(rec, kind, name, dtypes, shapes)
            return
        if kind in ("alltoall_splits", "alltoallv"):
            self._replay_alltoallv_record(rec, kind, name, dtypes, shapes)
            return
        if any(d < 0 for s in shapes for d in s):
            raise HorovodInternalError(
                f"join: cannot zero-fill collective {name!r} "
                f"(non-concrete shape in replay record)")
        dev = _core._state.device
        zeros = [torch.zeros(s, dtype=getattr(torch, dt), device=dev)
                 for s, dt in zip(shapes, dtypes)]
        neg._epochs[name] = rec["epoch"]  # align the local epoch counter
        op_id = sig["op"]
        pre, post = sig.get("prescale", 1.0), sig.get("postscale", 1.0)
        ps = self._resolve_replay_ps(sig)
        seq_before = neg.dispatch_seq
        try:
            if kind == "allreduce":
                _pub.allreduce(zeros[0], op=_pub.ReduceOp(op_id), name=name,
                               prescale_factor=pre, postscale_factor=post,
                               process_set=ps)
            elif kind == "grouped_allreduce":
                _pub.grouped_allreduce(zeros, op=_pub.ReduceOp(op_id - 600),
                                       name=name, prescale_factor=pre,
                                       postscale_factor=post, process_set=ps)
            elif kind == "hierarchical_allreduce":
                local, rop = divmod(op_id - 700, 8)
                _pub.hierarchical_allreduce(
                    zeros[0], op=_pub.ReduceOp(rop), local_size=local,
                    name=name, prescale_factor=pre, postscale_factor=post)
            elif kind == "broadcast":
                root = op_id - 10000
                if ps.ranks is None and root == self.topo.rank or \
                        ps.ranks is not None and ps.rank() == root:
                    # A joined root has no data; zeros would be silently
                    # wrong.  The next dispatch of the name renegotiates,
                    # on every rank, and errors.
                    get_logger().error(
                        "broadcast %s has joined rank %d as root; receivers "
                        "get zeros this once and an error on the next "
                        "dispatch", name, root)
                    following = neg._uses.get(name, 0) + 1
                    neg._inval_at.setdefault(name, set()).add(following)
                    neg._publish_invalidation(name, following)
                _pub.broadcast(zeros[0], root_rank=root, name=name,
                               process_set=ps)
            elif kind == "reducescatter":
                _pub.reducescatter(zeros[0], op=_pub.ReduceOp(op_id - 400),
                                   name=name, prescale_factor=pre,
                                   postscale_factor=post, process_set=ps)
            elif kind == "alltoall":
                _pub.alltoall(zeros[0], name=name, process_set=ps)
            elif kind == "barrier":
                _pub.barrier(process_set=ps)
            else:
                raise HorovodInternalError(
                    f"join: unsupported kind {kind!r} in replay record "
                    f"for {name!r}")
        except HorovodInternalError as e:
            if neg.dispatch_seq == seq_before or \
                    not isinstance(e, CollectiveRejectedError):
                # Nothing was published, or a local failure that is not
                # symmetric across ranks: live ranks may be inside the
                # collective expecting this rank's zeros.
                raise
            # A coordinator rejection is raised on every rank after the
            # record was published: the streams stay aligned.
            get_logger().warning("join: replayed %s was rejected: %s",
                                 name, e)

    def _resolve_replay_ps(self, sig: dict):
        """The process set of a replayed dispatch, from its wire
        membership (``ops._wire_ps``), never from a local id.  The set
        must be registered here: registration is collective in the port,
        so every rank registered it before the record was issued."""
        from .. import core as _core
        from ..process_sets import global_process_set
        ranks = sig.get("ps_ranks")
        if not ranks:
            return global_process_set
        ps = _core._require_init().process_set_table.find(ranks)
        if ps is None:
            raise HorovodInternalError(
                f"join: replay record names the process set {ranks}, "
                f"which this rank has not registered")
        return ps

    def _replay_allgather_record(self, rec: dict, kind: str, name: str,
                                 dtypes, shapes) -> None:
        """Zero-contribute to the live ranks' ragged allgather: the size
        exchange ("allgather_sizes", a header per rank, over the world)
        announces 0 rows; the gather ("allgather", over the record's set)
        sends [max_rows, ...] zeros, max_rows taken from the size exchange
        this rank just serviced over the set's members (a live rank's two
        records are adjacent)."""
        from .. import core as _core
        from .. import ops as _pub
        neg = self.negotiator
        neg._epochs[name] = rec["epoch"]
        dev = _core._state.device
        if kind == "allgather_sizes":
            # The header's dim 0 went out as the ragged marker: it is 3.
            zero = torch.zeros(3, dtype=torch.int64, device=dev)
            self._join_gather_sizes = _pub._exchange_heads(zero, name=name)
            return
        heads, self._join_gather_sizes = self._join_gather_sizes, None
        if heads is None:
            raise HorovodInternalError(
                f"join: allgather record {name!r} arrived without a "
                f"preceding size exchange (stream order violation)")
        ranks = rec["sig"].get("ps_ranks") or range(self.n)
        max_rows = max(heads[r][0] for r in ranks)
        trailing = tuple(shapes[0][1:])
        zero = torch.zeros((max_rows,) + trailing,
                           dtype=getattr(torch, dtypes[0]), device=dev)
        ps = self._resolve_replay_ps(rec["sig"])
        _pub._gather_rows(zero, heads, ps, name=name)

    def _replay_alltoallv_record(self, rec: dict, kind: str, name: str,
                                 dtypes, shapes) -> None:
        """Zero-contribute to the live ranks' ragged alltoall: the split
        exchange ("alltoall_splits") sends a zero row to every rank, so
        this rank sends no rows and announces ndim 0; the rows exchange
        ("alltoallv") sends none and receives what the live ranks send
        here, sized by the split exchange this rank just serviced (a live
        rank's two records are adjacent)."""
        from .. import core as _core
        from .. import ops as _pub
        self.negotiator._epochs[name] = rec["epoch"]
        dev = _core._state.device
        if kind == "alltoall_splits":
            zero = torch.zeros(shapes[0], dtype=torch.int64, device=dev)
            self._join_alltoall_recv = [
                h[0] for h in _pub._exchange_splits(zero)]
            return
        recv, self._join_alltoall_recv = self._join_alltoall_recv, None
        if recv is None:
            raise HorovodInternalError(
                f"join: alltoallv record {name!r} arrived without a "
                f"preceding split exchange (stream order violation)")
        zero = torch.zeros((0,) + tuple(shapes[0][1:]),
                           dtype=getattr(torch, dtypes[0]), device=dev)
        _pub._alltoall_rows(zero, [0] * self.n, recv, name=name)
