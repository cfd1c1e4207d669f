"""The synchronous collective API of Horovod.

Port of ``horovod_tpu/ops/__init__.py`` over ``torch.distributed`` (NCCL
for CUDA tensors, gloo for CPU tensors): ``allreduce`` (``:106``),
``grouped_allreduce`` (``:181``), ``_fused_allreduce`` (``:248-297``: one
flat buffer per fusion bucket, compression applied once to the packed
buffer), ``allgather`` (``:304``, ragged dim 0 too) and
``grouped_allgather`` (``:414``), ``broadcast`` (``:429``), ``alltoall``
(``:471``, with or without ``splits``), ``reducescatter`` (``:578``) and
``grouped_reducescatter`` (``:618``), ``barrier`` (``:647``), the
in-place and ``*_async`` forms, and ``poll`` / ``synchronize``
(``:635-644``).

Each op takes a ``process_set``.  A rank outside the set issues no
collective and gets its input back, unscaled; a broadcast's
``root_rank`` is the root's rank within the set.  A strict subset must
have been registered (``add_process_set``) before an op uses it.  The
out-of-place ops return new tensors and leave their inputs as they were,
as the JAX functions do; the in-place forms (``allreduce_``,
``grouped_allreduce_``, ``broadcast_``) write the same values into the
given tensors and return them, as Horovod's torch API does.  An
``*_async`` form runs its op and returns a handle; ``synchronize`` waits
for the outputs on the card and returns them.

Not ported yet (ROADMAP A2): ``join``, the negotiation of the JAX
package's eager engine, and ``hierarchical_allreduce``.  The optimizer
issues its collectives in parameter order, the same on every rank, which
is what negotiation would otherwise guarantee.
"""

from __future__ import annotations

import functools
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .collective_ops import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product, _apply_scale,
    Members, members_of, reduce_in_place, reducescatter_padded_size)
from . import collective_ops as C
from .. import core as _core
from ..compression import Compression
from ..process_sets import ProcessSet, global_process_set


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
    del name
    rop = _normalize_op(op, average)
    m = members_of(process_set)
    x, ctx = compression.compress(tensor)
    out = _reduce(x, rop, prescale_factor, postscale_factor, m)
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, compression=Compression.none, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: ProcessSet = global_process_set
                      ) -> List[torch.Tensor]:
    """Reduce a list of tensors, each compressed on its own
    (``hvd.grouped_allreduce``)."""
    del name
    rop = _normalize_op(op, average)
    m = members_of(process_set)
    outs = []
    for t in tensors:
        x, ctx = compression.compress(t)
        outs.append(compression.decompress(
            _reduce(x, rop, prescale_factor, postscale_factor, m), ctx))
    return outs


def _fused_allreduce(tensors: Sequence[torch.Tensor], op,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     compression=Compression.none,
                     process_set: ProcessSet = global_process_set
                     ) -> List[torch.Tensor]:
    """One collective for a whole fusion bucket: pack the tensors into
    one flat buffer, compress it once (a cast is elementwise, so this
    equals compressing each tensor), reduce, decompress, and hand back
    views of the result in the tensors' shapes.  All tensors share one
    dtype (the planner only buckets same-dtype entries).  Adasum is
    refused: one flat buffer would get one coefficient pair for the
    whole bucket (the JAX package fuses only Average and Sum)."""
    rop = ReduceOp(op)
    if rop == ReduceOp.ADASUM:
        raise ValueError("_fused_allreduce reduces with Average or Sum; "
                         "Adasum needs a coefficient pair per tensor "
                         "(grouped_allreduce)")
    m = members_of(process_set)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("_fused_allreduce needs tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat, ctx = compression.compress(flat)
    out = compression.decompress(
        _reduce(flat, rop, prescale_factor, postscale_factor, m, owned=True),
        ctx)
    views, start = [], 0
    for t in tensors:
        views.append(out[start:start + t.numel()].view(t.shape))
        start += t.numel()
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


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def _gather(t: torch.Tensor, m: Members):
    """Gather every member's ``t``, whose dim 0 may differ: the members
    exchange (rows, ndim, a hash of the trailing dims), pad dim 0 to the
    largest and gather once with ``all_gather_into_tensor`` (gloo's
    list-form ``all_gather`` refuses unequal shapes).  Returns the padded
    gather [members · largest, ...] and each member's rows."""
    if t.dim() == 0:
        raise ValueError("allgather needs a tensor of at least one dim")
    t = t.contiguous()
    trailing = tuple(t.shape[1:])
    head = torch.tensor([t.shape[0], t.dim(), hash(trailing)],
                        dtype=torch.int64, device=t.device)
    heads = head.new_empty(m.size * 3)
    C._checked("allgather", head, lambda: dist.all_gather_into_tensor(
        heads, head, group=m.group))
    # The shapes decide the output's: a host sync.
    heads = heads.view(m.size, 3).tolist()
    if any(h[1:] != heads[0][1:] for h in heads):
        raise ValueError(
            f"allgather needs every member's trailing dims to agree; "
            f"this rank's shape is {tuple(t.shape)}")
    rows = [h[0] for h in heads]
    top = max(rows)
    out = t.new_empty((m.size * top,) + trailing)
    if out.numel():  # every member sees the same heads, so all skip alike
        if t.shape[0] < top:
            t = torch.cat([t, t.new_zeros((top - t.shape[0],) + trailing)])
        C._checked("allgather", t, lambda: dist.all_gather_into_tensor(
            out, t, group=m.group))
    return out, rows


def _blocks(out: torch.Tensor, rows: List[int]) -> List[torch.Tensor]:
    """Each member's rows of a padded gather."""
    top = out.shape[0] // len(rows)
    return [out[i * top:i * top + r] for i, r in enumerate(rows)]


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Every member's tensor concatenated along dim 0, in member order
    (``hvd.allgather``); dim 0 may differ between members."""
    del name
    m = members_of(process_set)
    if not m.included:
        return tensor.clone()
    out, rows = _gather(tensor, m)
    return out if len(set(rows)) == 1 else torch.cat(_blocks(out, rows))


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
    del name
    m = members_of(process_set)
    if not 0 <= root_rank < m.size:
        raise ValueError(f"root_rank {root_rank} outside the set of "
                         f"{m.size} ranks")
    buf = tensor.detach().clone(memory_format=torch.contiguous_format)
    if not m.included:
        return buf
    wire = buf.to(torch.uint8) if buf.dtype == torch.bool else buf
    # torch's src is a global rank, even with a group.
    C._checked("broadcast", wire, lambda: dist.broadcast(
        wire, src=m.ranks[root_rank], group=m.group))
    return wire.to(torch.bool) if buf.dtype == torch.bool else wire


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
    order, and their counts (int32)."""
    del name
    m = members_of(process_set)
    if splits is None:
        if tensor.dim() == 0 or tensor.shape[0] % m.size:
            raise ValueError(
                f"alltoall requires dim0 ({tuple(tensor.shape)[:1]}) "
                f"divisible by group size ({m.size}); use alltoall with "
                f"splits for ragged sends")
        if not m.included:
            return tensor.clone()
        t = tensor.contiguous()
        out = torch.empty_like(t)
        C._checked("alltoall", t,
                   lambda: dist.all_to_all_single(out, t, group=m.group))
        return out
    if m.group is not None:
        raise NotImplementedError(
            "alltoall with splits over a strict subset of the ranks is not "
            "ported (ROADMAP Queue C: the JAX package runs it over the "
            "world)")
    return _alltoallv(tensor, splits, m)


def _alltoallv(tensor: torch.Tensor, splits, m: Members):
    """Exchange the split vectors with an equal all-to-all (each rank
    also sends a hash of its trailing dims), then the rows with one
    ``all_to_all_single`` sized by both."""
    send = [int(s) for s in torch.as_tensor(splits).reshape(-1).tolist()]
    if len(send) != m.size or min(send) < 0 or \
            sum(send) != (tensor.shape[0] if tensor.dim() else -1):
        raise ValueError(
            f"alltoall splits {send} must give {m.size} non-negative row "
            f"counts summing to dim0 of the tensor {tuple(tensor.shape)}")
    t = tensor.contiguous()
    trailing = tuple(t.shape[1:])
    sig = hash((t.dim(), trailing))
    head = torch.tensor([[s, sig] for s in send], dtype=torch.int64,
                        device=t.device)
    heads = torch.empty_like(head)
    C._checked("alltoall", head,
               lambda: dist.all_to_all_single(heads, head, group=m.group))
    heads = heads.tolist()
    if any(h[1] != sig for h in heads):
        raise ValueError(
            f"alltoall needs every rank's trailing dims to agree; this "
            f"rank's shape is {tuple(t.shape)}")
    recv = [h[0] for h in heads]
    out = t.new_empty((sum(recv),) + trailing)
    C._checked("alltoall", t, lambda: dist.all_to_all_single(
        out, t, output_split_sizes=recv, input_split_sizes=send,
        group=m.group))
    return out, torch.tensor(recv, dtype=torch.int32, device=t.device)


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
    (``reducescatter_padded_size``), as in the JAX package."""
    del name
    rop = ReduceOp(op) if op is not None else ReduceOp.SUM
    m = members_of(process_set)
    if not m.included:
        return tensor.clone()
    return C.reducescatter(tensor, rop, m, prescale_factor, postscale_factor)


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
# async handles / barrier
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
    """Block until every member reaches the barrier (``hvd.barrier``)."""
    m = members_of(process_set)
    if m.included and m.size > 1:
        dist.barrier(group=m.group)
