"""The synchronous collectives of the training path.

Port of the part of ``horovod_tpu/ops/__init__.py`` that the
data-parallel path calls: ``allreduce`` (``:106``), ``grouped_allreduce``
(``:181``), ``_fused_allreduce`` (``:248-297``: one flat buffer per
fusion bucket, compression applied once to the packed buffer),
``broadcast`` (``:429``) and ``barrier`` (``:647``), over
``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU tensors).
Each returns new tensors and leaves its inputs as they were, as the JAX
functions do.

Not ported yet (ROADMAP A2): allgather, alltoall, reducescatter, the
async handles, poll / synchronize, join, and the negotiation of the
eager engine.  The optimizer issues its collectives in parameter order,
the same on every rank, which is what negotiation would otherwise
guarantee.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .collective_ops import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product, _apply_scale,
    allreduce_)
from .. import core as _core
from ..compression import Compression
from ..process_sets import ProcessSet, global_process_set, require_global


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
            postscale: float, owned: bool = False) -> torch.Tensor:
    """prescale → reduce over the world → postscale.  The reduction runs
    in place, on ``t`` itself only when the caller ``owned`` it."""
    st = _core._require_init()
    x = _apply_scale(t, prescale)
    buf = x.clone(memory_format=torch.contiguous_format) \
        if x is t and not owned else x.contiguous()
    return _apply_scale(allreduce_(buf, rop, st.topology.size), postscale)


def allreduce(tensor: torch.Tensor, average=None, name: Optional[str] = None,
              compression=Compression.none, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Reduce ``tensor`` over every rank (``hvd.allreduce``)."""
    del name
    rop = _normalize_op(op, average)
    require_global(process_set)
    x, ctx = compression.compress(tensor)
    out = _reduce(x, rop, prescale_factor, postscale_factor)
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
    require_global(process_set)
    outs = []
    for t in tensors:
        x, ctx = compression.compress(t)
        outs.append(compression.decompress(
            _reduce(x, rop, prescale_factor, postscale_factor), ctx))
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
    dtype (the planner only buckets same-dtype entries)."""
    rop = ReduceOp(op)
    require_global(process_set)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("_fused_allreduce needs tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat, ctx = compression.compress(flat)
    out = compression.decompress(
        _reduce(flat, rop, prescale_factor, postscale_factor, owned=True),
        ctx)
    views, start = [], 0
    for t in tensors:
        views.append(out[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return views


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: ProcessSet = global_process_set) -> torch.Tensor:
    """Root's tensor on every rank (``hvd.broadcast``); a new tensor."""
    del name
    require_global(process_set)
    st = _core._require_init()
    if not 0 <= root_rank < st.topology.size:
        raise ValueError(f"root_rank {root_rank} outside the world of "
                         f"{st.topology.size}")
    buf = tensor.detach().clone(memory_format=torch.contiguous_format)
    wire = buf.to(torch.uint8) if buf.dtype == torch.bool else buf
    dist.broadcast(wire, src=root_rank)
    return wire.to(torch.bool) if buf.dtype == torch.bool else wire


def barrier(process_set: ProcessSet = global_process_set) -> None:
    """Block until every rank reaches the barrier (``hvd.barrier``)."""
    require_global(process_set)
    if _core._require_init().topology.size > 1:
        dist.barrier()
