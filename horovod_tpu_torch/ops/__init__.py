"""The collective API of Horovod, through the eager engine.

Port of ``horovod_tpu/ops/__init__.py`` over ``torch.distributed`` (NCCL
for CUDA tensors, gloo for CPU tensors): ``allreduce`` (``:106``),
``grouped_allreduce`` (``:181``), ``_fused_allreduce`` (``:248-297``: one
flat buffer per fusion bucket, compression applied once to the packed
buffer), ``allgather`` (``:304``, ragged dim 0 too) and
``grouped_allgather`` (``:414``), ``broadcast`` (``:429``), ``alltoall``
(``:471``, with or without ``splits``), ``reducescatter`` (``:578``) and
``grouped_reducescatter`` (``:618``), ``barrier`` (``:647``), ``join``
(``:667``), the in-place and ``*_async`` forms, ``poll`` /
``synchronize`` (``:635-644``), and the explicit two-level
``hierarchical_allreduce`` (``collective_ops.py:407``).

Every op dispatches through ``EagerEngine.run`` (``ops/eager.py``): the
tensor-name contract, the timeline, and in a world of more than one rank
coordinator negotiation before the NCCL or gloo call is enqueued.  A
world of one keeps a shortcut: nothing is negotiated, but names are
claimed and timeline events written.  The ragged allgather is two
dispatches, as in the JAX package: ``allgather_sizes`` (each rank's row
count and trailing-dims hash, over the world, synced to the host inside
the dispatch) and then ``allgather``.  The ragged alltoall is two as
well: ``alltoall_splits`` (an equal all-to-all of the split rows) and
then ``alltoallv`` (one ragged ``all_to_all_single``), where the JAX
package, lacking a ragged alltoall in XLA, gathers everything.

Each op takes a ``process_set``.  Every rank of the world calls every op,
as the JAX package's processes do (negotiation runs over the world); a
rank outside the set negotiates but issues no collective, and gets its
input back, unscaled; a broadcast's ``root_rank`` is the root's rank
within the set.  A strict subset must have been registered
(``add_process_set``) before an op uses it.  The out-of-place ops return
new tensors and leave their inputs as they were, as the JAX functions
do; the in-place forms (``allreduce_``, ``grouped_allreduce_``,
``broadcast_``) write the same values into the given tensors and return
them, as Horovod's torch API does.  An ``*_async`` form runs its op and
returns a handle; ``synchronize`` waits for the outputs on the card and
returns them.  As in the JAX package (``:124-133``), ``allreduce`` stays
flat; the two-level form is ``hierarchical_allreduce``.

``allgather``, ``alltoall`` (without ``splits``) and ``reducescatter``
are differentiable, as the JAX package's are (``lax`` collectives
transpose): given a tensor that requires grad, the backward of an
alltoall is the inverse alltoall, an allgather's reduce-scatters
(sums) the cotangent back to each member's rows, and a reducescatter's
allgathers it.  Each backward is an engine dispatch of its own, under
the forward's name with ``.grad`` appended (``eager.backward_name``), so
negotiation, ``join`` and the timeline see it; every rank must run the
backward, as every rank ran the forward.  A rank outside the set gets
the cotangent back, as it got its input.

Inside an ``HVD_ANALYZE`` trace (``analysis/graph_check.py``) each of
``allreduce``, ``grouped_allreduce``, ``_fused_allreduce``,
``allgather``, ``broadcast``, ``alltoall`` and ``reducescatter`` emits
one ``hvd_analyze::collective`` node over its process set's mesh axes
instead of dispatching: no engine, no negotiation, no host read of
sizes, no peer.  On the real path that costs one flag read a call.
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .collective_ops import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product, _apply_scale,
    Members, members_of, reduce_in_place, reducescatter_padded_size)
from . import collective_ops as C
from .eager import backward_name
from .. import core as _core
from .. import timeline as _timeline
from ..analysis import graph_check as _gc
from ..compression import Compression
from ..process_sets import ProcessSet, global_process_set


def _engine():
    return _core._require_init().engine


def _wire_ps(process_set: Optional[ProcessSet]) -> dict:
    """The wire identity of a process set in negotiation signatures
    (``horovod_tpu/ops/__init__.py:67-86``): a membership-derived 31-bit
    id (FNV-1a over the sorted ranks) for the native cache and message
    table, and the member ranks themselves, from which a replaying rank
    resolves its local set.  The local ``process_set_id`` depends on
    registration order, so it never crosses the wire."""
    members = None if process_set is None or process_set.ranks is None \
        else process_set.members()
    if members is None:
        return {"ps_id": 0, "ps_ranks": None}
    h = 0x811C9DC5
    for r in members:
        h = ((h ^ (r + 1)) * 0x01000193) & 0x7FFFFFFF
    return {"ps_id": h or 1, "ps_ranks": list(members)}


def _meta(shape, dtype) -> torch.Tensor:
    """A signature without data: what a rank outside the set negotiates
    with when it cannot know the members' shape from its own tensor."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _normalize_op(op, average):
    """Resolve the deprecated ``average`` flag against ``op``."""
    if average is not None:
        if op is not None:
            raise ValueError("The op parameter supersedes average; "
                             "please provide only one of them")
        warnings.warn("average is deprecated, use op=hvd.Average or "
                      "op=hvd.Sum instead", DeprecationWarning, stacklevel=3)
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    return ReduceOp.AVERAGE if op is None else ReduceOp(op)


def _differentiable(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` must record its backward."""
    return torch.is_grad_enabled() and t.requires_grad


def _reduce(t: torch.Tensor, rop: ReduceOp, prescale: float,
            postscale: float, m: Members, owned: bool = False
            ) -> torch.Tensor:
    """prescale → reduce over the members → postscale (Adasum too, in
    JAX's order).  The reduction runs in place, on ``t`` itself only
    when the caller ``owned`` it.  A rank outside the set gets ``t``
    back, unscaled.  A bool tensor sums (and averages) as int32, as
    ``lax.psum`` counts it."""
    if t.dtype == torch.bool and rop in (ReduceOp.SUM, ReduceOp.AVERAGE):
        t, owned = t.to(torch.int32), True
    if not m.included:
        return t if owned else t.clone()
    x = _apply_scale(t, prescale)
    buf = x.clone(memory_format=torch.contiguous_format) \
        if x is t and not owned else x.contiguous()
    return _apply_scale(reduce_in_place(buf, rop, m), postscale)




# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def allreduce(tensor: torch.Tensor, average=None, name: Optional[str] = None,
              compression=Compression.none, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Reduce ``tensor`` over the set's ranks (``hvd.allreduce``)."""
    rop = _normalize_op(op, average)
    x, ctx = compression.compress(tensor)
    if _gc.active() is not None:
        return compression.decompress(_gc.emit("allreduce", x, process_set),
                                      ctx)
    m = members_of(process_set)
    out = _engine().run(
        "allreduce",
        lambda: _reduce(x, rop, prescale_factor, postscale_factor, m),
        [x], name=name, op_id=int(rop), prescale=prescale_factor,
        postscale=postscale_factor, **_wire_ps(process_set))
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, compression=Compression.none, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    """Reduce a list of tensors, each compressed on its own, as one
    dispatch (``hvd.grouped_allreduce``)."""
    rop = _normalize_op(op, average)
    pairs = [compression.compress(t) for t in tensors]
    xs = [x for x, _ in pairs]
    if _gc.active() is not None:
        outs = _gc.emit("allreduce", xs, process_set)
        return [compression.decompress(o, ctx)
                for o, (_, ctx) in zip(outs, pairs)]
    m = members_of(process_set)
    outs = _engine().run(
        "grouped_allreduce",
        lambda: [_reduce(x, rop, prescale_factor, postscale_factor, m)
                 for x in xs],
        xs, name=name, op_id=int(rop), prescale=prescale_factor,
        postscale=postscale_factor, **_wire_ps(process_set))
    return [compression.decompress(o, ctx)
            for o, (_, ctx) in zip(outs, pairs)]


def _fused_allreduce(tensors: Sequence[torch.Tensor], op,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     compression=Compression.none,
                     process_set: ProcessSet = global_process_set,
                     bucket: int = 0) -> List[torch.Tensor]:
    """One collective for a whole fusion bucket: pack the tensors into
    one flat buffer, compress it once (a cast is elementwise, so this
    equals compressing each tensor), reduce, decompress, and hand back
    views of the result in the tensors' shapes.  The buffer is one
    dispatch named ``fusedbuf.<dtype>.<numel>``, a signature a joined
    rank can replay.  All tensors share one dtype (the planner only
    buckets same-dtype entries).  Adasum is refused: one flat buffer
    would get one coefficient pair for the whole bucket (the JAX package
    fuses only Average and Sum).

    While a timeline records, the pack (``cat`` and compress) and the
    unpack (decompress and the views) are its ``MEMCPY_IN_FUSION_BUFFER``
    and ``MEMCPY_OUT_FUSION_BUFFER`` spans, under the buffer's name,
    with the negotiation and the op state between them; each carries
    ``bucket`` (its index in the caller's plan), the tensors and the
    bytes handed to the collective."""
    rop = ReduceOp(op)
    if rop == ReduceOp.ADASUM:
        raise ValueError("_fused_allreduce reduces with Average or Sum; "
                         "Adasum needs a coefficient pair per tensor "
                         "(grouped_allreduce)")
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("_fused_allreduce needs tensors of one dtype")
    analyzing = _gc.active() is not None
    tl = None if analyzing else _timeline.ACTIVE
    t0 = time.monotonic_ns() if tl is not None else 0
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat, ctx = compression.compress(flat)
    if analyzing:
        out = _gc.emit("allreduce", flat, process_set)
    else:
        m = members_of(process_set)
        name = f"fusedbuf.{C.dtype_name(flat.dtype)}.{flat.numel()}"
        args = None
        if tl is not None:
            args = {"bucket": bucket, "tensors": len(tensors),
                    "bytes": flat.numel() * flat.element_size()}
            tl.span(_timeline.MEMCPY_IN_FUSION_BUFFER, t0, tid=name,
                    args=args)
        out = _engine().run(
            "allreduce",
            lambda: _reduce(flat, rop, prescale_factor, postscale_factor, m,
                            owned=True),
            [flat], name=name, op_id=int(rop), prescale=prescale_factor,
            postscale=postscale_factor, span_args=args,
            **_wire_ps(process_set))
        t0 = time.monotonic_ns() if tl is not None else 0
    out = compression.decompress(out, ctx)
    views, start = [], 0
    for t in tensors:
        views.append(out[start:start + t.numel()].view(t.shape))
        start += t.numel()
    if tl is not None:
        tl.span(_timeline.MEMCPY_OUT_FUSION_BUFFER, t0, tid=name, args=args)
    return views


@torch.no_grad()
def allreduce_(tensor: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``allreduce`` written into ``tensor``, which is returned."""
    return tensor.copy_(allreduce(tensor, *args, **kwargs))


@torch.no_grad()
def grouped_allreduce_(tensors: Sequence[torch.Tensor], *args, **kwargs
                       ) -> List[torch.Tensor]:
    """``grouped_allreduce`` written into ``tensors``, which are
    returned."""
    outs = grouped_allreduce(tensors, *args, **kwargs)
    return [t.copy_(o) for t, o in zip(tensors, outs)]


def hierarchical_allreduce(tensor: torch.Tensor, op=ReduceOp.SUM,
                           local_size: Optional[int] = None,
                           name: Optional[str] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0) -> torch.Tensor:
    """The two-level allreduce over the world (``collective_ops.py:407``):
    a reduce-scatter inside each node of ``local_size`` consecutive
    ranks (``hvd.local_size()`` by default), a reduction across nodes, an
    allgather back inside the node.  SUM and AVERAGE only; a
    ``local_size`` of 1 or a single node takes the flat path."""
    rop = ReduceOp(op)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical_allreduce supports SUM and AVERAGE")
    n = _core.size()
    local = _core.local_size() if local_size is None else int(local_size)
    if local < 1 or n % local != 0:
        raise ValueError(
            f"axis size {n} not divisible by local_size {local} "
            f"(hierarchical allreduce needs a homogeneous layout)")
    if local == 1 or local == n:
        return allreduce(tensor, op=rop, name=name,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor)
    return _engine().run(
        "hierarchical_allreduce",
        lambda: C.hierarchical_allreduce(tensor, rop, local,
                                         prescale_factor, postscale_factor),
        [tensor], name=name, op_id=int(rop) + 8 * local,
        prescale=prescale_factor, postscale=postscale_factor)


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def _exchange_heads(head: torch.Tensor, name: Optional[str] = None
                    ) -> List[List[int]]:
    """The ``allgather_sizes`` dispatch: every rank's [rows, ndim, hash
    of the trailing dims] over the world; a joined rank announces zeros.
    The headers decide the gather's shape: a host sync, inside the
    dispatch."""
    n = _core.size()

    def fn():
        heads = head.new_empty(n * 3)
        C._checked("allgather", head, lambda: dist.all_gather_into_tensor(
            heads, head))
        return heads.view(n, 3).tolist()

    return _engine().run("allgather_sizes", fn, [head], name=name)


def _gather_rows(t: torch.Tensor, heads: List[List[int]],
                 process_set: ProcessSet, name: Optional[str] = None):
    """The ``allgather`` dispatch: pad dim 0 to the members' largest and
    gather once with ``all_gather_into_tensor`` over the set (gloo's
    list-form ``all_gather`` refuses unequal shapes).  Returns the padded
    gather [members · largest, ...] and each member's rows; None on a
    rank outside the set."""
    m = members_of(process_set)
    rows = [heads[r][0] for r in m.ranks]
    top = max(rows)
    trailing = tuple(t.shape[1:])
    if m.included and t.shape[0] < top:
        t = torch.cat([t, t.new_zeros((top - t.shape[0],) + trailing)])
    sig = t if m.included else _meta((top,) + trailing, t.dtype)

    def fn():
        if not m.included:
            return None
        out = t.new_empty((m.size * top,) + trailing)
        if out.numel():  # every member sees the same heads: all skip alike
            C._checked("allgather", t, lambda: dist.all_gather_into_tensor(
                out, t, group=m.group))
        return out, rows

    return _engine().run("allgather", fn, [sig], name=name,
                         **_wire_ps(process_set))


def _gather(t: torch.Tensor, process_set: ProcessSet = global_process_set,
            name: Optional[str] = None):
    """Gather every member's ``t``, whose dim 0 may differ: the padded
    gather and each member's rows (``_gather_rows``), or None on a rank
    outside the set.  Every rank's trailing dims must agree."""
    if t.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dim")
    t = t.contiguous()
    trailing = tuple(t.shape[1:])
    if _core.size() == 1:
        return _gather_rows(t, [[t.shape[0], t.dim(), hash(trailing)]],
                            process_set, name=name)
    heads = _exchange_heads(torch.tensor(
        [t.shape[0], t.dim(), hash(trailing)], dtype=torch.int64,
        device=t.device))
    live = [h for h in heads if h[1]]  # a joined rank announces ndim 0
    if any(h[1:] != live[0][1:] for h in live):
        raise ValueError(
            f"allgather needs every rank's trailing dims to agree; this "
            f"rank's shape is {tuple(t.shape)}")
    return _gather_rows(t, heads, process_set, name=name)


def _blocks(out: torch.Tensor, rows: List[int]) -> List[torch.Tensor]:
    """Each member's rows of a padded gather."""
    top = out.shape[0] // len(rows)
    return [out[i * top:i * top + r] for i, r in enumerate(rows)]


def _allgather(tensor, name, process_set):
    """``allgather``'s value and each member's rows (None outside)."""
    res = _gather(tensor, process_set, name=name)
    if res is None:
        return tensor.clone(), None
    out, rows = res
    return (out if len(set(rows)) == 1 else torch.cat(_blocks(out, rows)),
            rows)


class _AllgatherGrad(torch.autograd.Function):
    """allgather whose backward reduce-scatters (sums) the cotangent of
    the gathered rows back to each member's own rows."""

    @staticmethod
    def forward(ctx, tensor, name, process_set):
        out, ctx.rows = _allgather(tensor, name, process_set)
        ctx.name, ctx.process_set = name, process_set
        return out

    @staticmethod
    def backward(ctx, g):
        rows, ps = ctx.rows, ctx.process_set
        g = g.contiguous()
        if rows is None:  # outside the set: dispatch, get g back
            return reducescatter(g, op=ReduceOp.SUM,
                                 name=backward_name(ctx.name),
                                 process_set=ps), None, None
        top = max(rows)
        if len(set(rows)) > 1:  # each member's rows at i·top
            padded = g.new_zeros((len(rows) * top,) + tuple(g.shape[1:]))
            start = 0
            for i, r in enumerate(rows):
                padded[i * top:i * top + r] = g[start:start + r]
                start += r
            g = padded
        out = reducescatter(g, op=ReduceOp.SUM,
                            name=backward_name(ctx.name), process_set=ps)
        return out[:rows[members_of(ps).set_rank]], None, None


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Every member's tensor concatenated along dim 0, in member order
    (``hvd.allgather``); dim 0 may differ between members.
    Differentiable (module docstring).  Inside an analysis trace every
    member's dim 0 is taken to be this one's, as JAX's ``all_gather``
    has it."""
    if _gc.active() is not None:
        return _gc.emit("allgather", tensor, process_set)
    if _differentiable(tensor):
        return _AllgatherGrad.apply(tensor, name, process_set)
    return _allgather(tensor, name, process_set)[0]


def grouped_allgather(tensors: Sequence[torch.Tensor], name=None,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    return [allgather(t, name=name, process_set=process_set)
            for t in tensors]


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """The root's tensor on every member (``hvd.broadcast``); a new
    tensor.  ``root_rank`` is the root's rank within the set."""
    if _gc.active() is not None:
        return _gc.emit("broadcast", tensor.detach(), process_set)
    m = members_of(process_set)
    if not 0 <= root_rank < m.size:
        raise ValueError(f"root_rank {root_rank} outside the set of "
                         f"{m.size} ranks")
    buf = tensor.detach().clone(memory_format=torch.contiguous_format)

    def fn():
        if not m.included:
            return buf
        wire = buf.to(torch.uint8) if buf.dtype == torch.bool else buf
        # torch's src is a global rank, even with a group.
        C._checked("broadcast", wire, lambda: dist.broadcast(
            wire, src=m.ranks[root_rank], group=m.group))
        return wire.to(torch.bool) if buf.dtype == torch.bool else wire

    return _engine().run("broadcast", fn, [buf], name=name,
                         op_id=int(root_rank), **_wire_ps(process_set))


@torch.no_grad()
def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None,
               process_set: ProcessSet = global_process_set
               ) -> torch.Tensor:
    """``broadcast`` written into ``tensor``, which is returned."""
    return tensor.copy_(broadcast(tensor, root_rank, name, process_set))


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: ProcessSet = global_process_set):
    """Row exchange (``hvd.alltoall``).  Without ``splits``, row block i
    of dim 0 (divisible by the member count) goes to member i.  With
    ``splits`` (one row count per rank, summing to dim 0), returns
    ``(output, received_splits)``: the rows each rank sent here, in rank
    order, and their counts (int32).  The form without ``splits`` is
    differentiable (module docstring).  Inside an analysis trace, a call
    with ``splits`` records the input's bytes and returns a tensor of the
    input's shape (the received splits are the even ones): the real
    sizes are a host read of the peers' splits, which a trace does not
    make."""
    if _gc.active() is not None:
        out = _gc.emit("alltoall", tensor, process_set)
        if splits is None:
            return out
        n = len(torch.as_tensor(splits).reshape(-1))
        return out, torch.full((n,), tensor.shape[0] // max(n, 1),
                               dtype=torch.int32, device=tensor.device)
    m = members_of(process_set)
    if splits is None:
        if tensor.dim() == 0 or tensor.shape[0] % m.size:
            raise ValueError(
                f"alltoall requires dim0 ({tuple(tensor.shape)[:1]}) "
                f"divisible by group size ({m.size}); use alltoall with "
                f"splits for ragged sends")
        if _differentiable(tensor):
            return _AlltoallGrad.apply(tensor, name, process_set)
        return _alltoall(tensor, m, name, process_set)
    if m.group is not None:
        raise NotImplementedError(
            "alltoall with splits over a strict subset of the ranks is not "
            "ported (ROADMAP Queue C: the JAX package runs it over the "
            "world)")
    return _alltoallv(tensor, splits, m, name=name)


def _alltoall(tensor: torch.Tensor, m: Members, name, process_set):
    """The equal exchange: row block i of dim 0 to member i."""
    t = tensor.contiguous()

    def fn():
        if not m.included:
            return tensor.clone()
        out = torch.empty_like(t)
        C._checked("alltoall", t, lambda: dist.all_to_all_single(
            out, t, group=m.group))
        return out

    return _engine().run("alltoall", fn, [t], name=name,
                         **_wire_ps(process_set))


class _AlltoallGrad(torch.autograd.Function):
    """The equal alltoall, whose backward is the inverse alltoall: the
    equal exchange is its own inverse (block j from member j returns to
    member j's block i)."""

    @staticmethod
    def forward(ctx, tensor, name, process_set):
        ctx.name, ctx.process_set = name, process_set
        return _alltoall(tensor, members_of(process_set), name, process_set)

    @staticmethod
    def backward(ctx, g):
        ps = ctx.process_set
        return _alltoall(g, members_of(ps), backward_name(ctx.name),
                         ps), None, None


def _alltoallv(tensor: torch.Tensor, splits, m: Members,
               name: Optional[str] = None):
    """The ragged exchange, as two dispatches over the world: the split
    rows (``alltoall_splits``, an equal all-to-all of each rank's [rows
    sent to rank i, ndim, hash of the trailing dims], synced to the host
    inside the dispatch), then the rows themselves (``alltoallv``, one
    ``all_to_all_single`` sized by both).  A joined rank replays the
    first with a zero row, so it sends nothing, and takes its receive
    sizes from it (``EagerEngine._replay_alltoallv_record``)."""
    send = [int(s) for s in torch.as_tensor(splits).reshape(-1).tolist()]
    if len(send) != m.size or min(send) < 0 or \
            sum(send) != (tensor.shape[0] if tensor.dim() else -1):
        raise ValueError(
            f"alltoall splits {send} must give {m.size} non-negative row "
            f"counts summing to dim0 of the tensor {tuple(tensor.shape)}")
    t = tensor.contiguous()
    sig = [t.dim(), hash(tuple(t.shape[1:]))]
    heads = _exchange_splits(torch.tensor(
        [[s] + sig for s in send], dtype=torch.int64, device=t.device))
    # Every rank sees every rank's (ndim, hash): all raise alike.  A
    # joined rank announces ndim 0.
    if any(h[1:] != sig for h in heads if h[1]):
        raise ValueError(
            f"alltoall needs every rank's trailing dims to agree; this "
            f"rank's shape is {tuple(t.shape)}")
    recv = [h[0] for h in heads]
    return (_alltoall_rows(t, send, recv, name=name),
            torch.tensor(recv, dtype=torch.int32, device=t.device))


def _exchange_splits(head: torch.Tensor) -> List[List[int]]:
    """The ``alltoall_splits`` dispatch: row i of ``head`` [n, 3] goes to
    rank i; returns the row each rank sent here, on the host."""

    def fn():
        heads = torch.empty_like(head)
        C._checked("alltoall", head, lambda: dist.all_to_all_single(
            heads, head))
        return heads.tolist()

    return _engine().run("alltoall_splits", fn, [head])


def _alltoall_rows(t: torch.Tensor, send: List[int], recv: List[int],
                   name: Optional[str] = None) -> torch.Tensor:
    """The ``alltoallv`` dispatch: ``send[i]`` rows of ``t`` to rank i,
    ``recv[i]`` rows from it.  Its dim 0 differs by rank, so negotiation
    relaxes it, as for the allgather family, and an unnamed call's label
    leaves it out."""
    if name is None:
        name = "alltoallv.noname." + "x".join(
            [C.dtype_name(t.dtype), "v"] + [str(d) for d in t.shape[1:]])

    def fn():
        out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
        C._checked("alltoall", t, lambda: dist.all_to_all_single(
            out, t, output_split_sizes=recv, input_split_sizes=send))
        return out

    return _engine().run("alltoallv", fn, [t], name=name)


# ---------------------------------------------------------------------------
# reducescatter
# ---------------------------------------------------------------------------

def reducescatter(tensor: torch.Tensor, op=ReduceOp.SUM,
                  name: Optional[str] = None,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  process_set: ProcessSet = global_process_set
                  ) -> torch.Tensor:
    """Reduce over the members, then member i keeps row block i
    (``hvd.reducescatter``).  A dim 0 that the member count does not
    divide is zero-padded up to a multiple of it
    (``reducescatter_padded_size``), as in the JAX package.
    Differentiable (module docstring)."""
    rop = ReduceOp(op) if op is not None else ReduceOp.SUM
    if _gc.active() is not None:
        return _gc.emit("reducescatter", tensor, process_set)
    if _differentiable(tensor):
        return _ReducescatterGrad.apply(tensor, rop, name, prescale_factor,
                                        postscale_factor, process_set)
    return _reducescatter(tensor, rop, name, prescale_factor,
                          postscale_factor, process_set)


def _reducescatter(tensor, rop, name, prescale_factor, postscale_factor,
                   process_set):
    m = members_of(process_set)

    def fn():
        if not m.included:
            return tensor.clone()
        return C.reducescatter(tensor, rop, m, prescale_factor,
                               postscale_factor)

    return _engine().run("reducescatter", fn, [tensor], name=name,
                         op_id=int(rop), prescale=prescale_factor,
                         postscale=postscale_factor, **_wire_ps(process_set))


class _ReducescatterGrad(torch.autograd.Function):
    """reducescatter whose backward allgathers the cotangent of each
    member's block, scaled as the forward scaled (prescale · postscale,
    and 1/members for Average), and drops dim 0's padding."""

    @staticmethod
    def forward(ctx, tensor, rop, name, prescale, postscale, process_set):
        m = members_of(process_set)
        ctx.name, ctx.process_set, ctx.rows = name, process_set, \
            tensor.shape[0]
        ctx.included = m.included
        ctx.scale = prescale * postscale / (
            m.size if rop == ReduceOp.AVERAGE else 1)
        return _reducescatter(tensor, rop, name, prescale, postscale,
                              process_set)

    @staticmethod
    def backward(ctx, g):
        full = allgather(g.contiguous(), name=backward_name(ctx.name),
                         process_set=ctx.process_set)
        if ctx.included:
            full = _apply_scale(full[:ctx.rows], ctx.scale)
        return full, None, None, None, None, None


def grouped_reducescatter(tensors: Sequence[torch.Tensor], op=ReduceOp.SUM,
                          name=None, prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: ProcessSet = global_process_set
                          ) -> List[torch.Tensor]:
    return [reducescatter(t, op=op, name=name,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set) for t in tensors]


# ---------------------------------------------------------------------------
# async handles / barrier / join
# ---------------------------------------------------------------------------

def _async(fn):
    """``fn``'s async form: runs ``fn`` and returns a handle to its
    outputs (``hvd.*_async``)."""
    @functools.wraps(fn)
    def run(*args, **kwargs) -> int:
        out = fn(*args, **kwargs)
        return _core._require_init().handles.allocate(out)
    run.__name__ = run.__qualname__ = fn.__name__.rstrip("_") + "_async" \
        + ("_" if fn.__name__.endswith("_") else "")
    return run


allreduce_async = _async(allreduce)
allreduce_async_ = _async(allreduce_)
grouped_allreduce_async = _async(grouped_allreduce)
grouped_allreduce_async_ = _async(grouped_allreduce_)
allgather_async = _async(allgather)
grouped_allgather_async = _async(grouped_allgather)
broadcast_async = _async(broadcast)
broadcast_async_ = _async(broadcast_)
alltoall_async = _async(alltoall)
reducescatter_async = _async(reducescatter)
grouped_reducescatter_async = _async(grouped_reducescatter)


def poll(handle: int) -> bool:
    """True when the async op's outputs are ready (``hvd.poll``)."""
    return _core._require_init().handles.poll(handle)


def synchronize(handle: int):
    """Wait for the async op's outputs and return them
    (``hvd.synchronize``)."""
    return _core._require_init().handles.wait(handle)


def barrier(process_set: ProcessSet = global_process_set) -> None:
    """Block until every member reaches the barrier (``hvd.barrier``); a
    world of one returns at once, as in the JAX package."""
    m = members_of(process_set)
    if _core.size() == 1:
        return
    token = _meta((1,), torch.int32)

    def fn():
        if m.included and m.size > 1:
            C._checked("barrier", token,
                       lambda: dist.barrier(group=m.group))

    _engine().run("barrier", fn, [token], **_wire_ps(process_set))


def join(device: int = -1) -> int:
    """This rank has no more data (``hvd.join``, torch/mpi_ops.py:1293):
    block until every rank has joined, contributing zeros to the
    collectives the other ranks keep issuing, and return the last rank
    to join.  ``device`` is accepted for the API (the zeros go to this
    rank's device)."""
    del device
    return _engine().join()
