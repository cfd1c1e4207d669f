"""Reduce operators, the pre/post scale, and what the eager collectives
share, in torch.

Port of ``ReduceOp`` and its aliases (``horovod_tpu/ops/collective_ops.py
:53-69``), ``_apply_scale`` (``:72``), ``reducescatter_padded_size``
(``:351``), the reduce-scatter rule (``:360-396``) and
``hierarchical_allreduce`` (``:407-467``), plus:

* ``Members``: who takes part in a collective over a process set: the
  set's group (None for the world), its member ranks, and this rank's
  place among them (None for a rank outside the set, which issues no
  collective and gets its input back);
* ``reduce_in_place``: AVERAGE is a SUM followed by a division by the
  member count (floor division for integers), on gloo and NCCL alike.
  Gloo has no AVG, and one formula keeps the CPU and the card identical.
  ADASUM goes to ``ops/adasum.py`` (``:163-209``: the caller prescales
  before it and postscales after it).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import core as _core
from ..exceptions import HorovodInternalError


class ReduceOp(enum.IntEnum):
    """Reduction operators (the reference's ``message.h:43`` numbering)."""
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {ReduceOp.AVERAGE: dist.ReduceOp.SUM, ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


@dataclasses.dataclass(frozen=True)
class Members:
    """The ranks of a collective over a process set."""
    group: Optional[dist.ProcessGroup]   # None: the world's group
    ranks: Tuple[int, ...]               # global ranks, ascending
    set_rank: Optional[int]              # this rank's place; None: outside

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def included(self) -> bool:
        return self.set_rank is not None


def members_of(process_set) -> Members:
    """Resolve a ``ProcessSet`` (None: the global set) against the
    registered sets; an unregistered strict subset raises ``ValueError``."""
    st = _core._require_init()
    group, ranks = st.process_set_table.resolve(process_set)
    me = st.topology.rank
    return Members(group, tuple(ranks),
                   ranks.index(me) if me in ranks else None)


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a dtype: numpy's, as the JAX package sends it
    (``float32``, ``bfloat16``, ``int64``, ``bool``)."""
    return str(dtype).rpartition(".")[2]


def _apply_scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x * factor``; f16/bf16 scale in f32 and round once, integers
    truncate back to their dtype (the JAX package's rules)."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() * factor).to(x.dtype)
    if not x.is_floating_point() and not x.is_complex():
        return (x * factor).to(x.dtype)
    return x * factor


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.is_floating_point() or x.is_complex():
        return x / n
    return torch.div(x, n, rounding_mode="floor")


def _checked(what: str, t: torch.Tensor, call) -> None:
    """Run one collective on ``t``: a CUDA tensor goes through NCCL or
    raises (gloo would take some CUDA tensors and stage them through the
    host), and a failure of the call is the reference's
    ``HorovodInternalError`` (``exceptions.py:18``, a ``RuntimeError``),
    naming the op, the tensor and the backend."""
    backend = dist.get_backend()
    if t.is_cuda and backend != "nccl":
        raise RuntimeError(
            f"{what} of a CUDA tensor needs the nccl backend; this world "
            f"is {backend} (hvd.init(device='cpu') forms a gloo world for "
            f"CPU tensors)")
    try:
        call()
    except RuntimeError as e:
        raise HorovodInternalError(
            f"{what} of a {t.dtype} tensor on {t.device} failed on the "
            f"{backend} backend: {e}") from e


def reduce_in_place(buf: torch.Tensor, op: ReduceOp, m: Members
                    ) -> torch.Tensor:
    """Reduce ``buf`` in place over the members and return the reduced
    tensor (a new one for AVERAGE and ADASUM; ``ops/adasum.py``)."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        from . import adasum
        return adasum.adasum_allreduce(buf, m)
    _checked("allreduce", buf,
             lambda: dist.all_reduce(buf, op=_DIST_OPS[op], group=m.group))
    return _divide(buf, m.size) if op == ReduceOp.AVERAGE else buf


def reducescatter_padded_size(dim0: int, n: int) -> int:
    """Dim 0 padded up to a multiple of ``n``, so every member's shard is
    equal (the reference gives the first ``dim0 % n`` ranks one extra
    row instead)."""
    return math.ceil(dim0 / n) * n


def reducescatter(x: torch.Tensor, op: ReduceOp, m: Members,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> torch.Tensor:
    """prescale → dim 0 zero-padded to a multiple of the member count →
    reduce-scatter (SUM) over the members → AVERAGE's division →
    postscale.  Member i gets rows [i·b, (i+1)·b) of the padded sum."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports SUM and AVERAGE")
    if x.dtype == torch.bool:
        raise TypeError("reducescatter sums its input, and a bool tensor "
                        "has no sum (as in the JAX package)")
    if x.dim() == 0:
        raise ValueError("reducescatter needs a tensor of at least one dim")
    x = _apply_scale(x, prescale_factor)
    n = m.size
    padded = reducescatter_padded_size(x.shape[0], n)
    xp = x.contiguous()
    if padded != x.shape[0]:
        xp = torch.cat([xp, xp.new_zeros((padded - x.shape[0],)
                                         + tuple(x.shape[1:]))])
    out = xp.new_empty((padded // n,) + tuple(x.shape[1:]))
    if out.numel():  # every member passes this shape, so all skip alike
        _checked("reducescatter", xp, lambda: dist.reduce_scatter_tensor(
            out, xp, op=dist.ReduceOp.SUM, group=m.group))
    if op == ReduceOp.AVERAGE:
        out = _divide(out, n)
    return _apply_scale(out, postscale_factor)


def hierarchical_allreduce(x: torch.Tensor, op: ReduceOp, local_size: int,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0) -> torch.Tensor:
    """Two-level allreduce over the world (the reference's
    NCCLHierarchicalAllreduce, nccl_operations.h:231): the flattened
    tensor, zero-padded to a multiple of ``local_size``, is
    reduce-scattered inside each node's group (ranks [k·L, (k+1)·L)),
    each chunk is reduced across its cross group (the ranks of one local
    rank, L apart), and the chunks are gathered back inside the node.
    The groups are made collectively at first use and kept in the
    process-set table.  SUM and AVERAGE; AVERAGE divides by the world's
    size (floor division for integers)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical_allreduce supports SUM and AVERAGE")
    st = _core._require_init()
    n = st.topology.size
    if n % local_size != 0:
        raise ValueError(
            f"axis size {n} not divisible by local_size {local_size} "
            f"(hierarchical allreduce needs a homogeneous layout)")
    local, cross = st.process_set_table.hierarchy(local_size,
                                                  st.topology.rank)
    x = _apply_scale(x, prescale_factor)
    flat = x.reshape(-1)
    # Phase 1: reduce-scatter inside the node (the port's reducescatter
    # zero-pads to reducescatter_padded_size): each rank owns a chunk.
    chunk = reducescatter(flat, ReduceOp.SUM, local)
    # Phase 2: sum the chunk across nodes.
    chunk = reduce_in_place(chunk, ReduceOp.SUM, cross)
    # Phase 3: gather the chunks back inside the node.
    full = chunk.new_empty(chunk.shape[0] * local_size)
    _checked("hierarchical_allreduce", chunk,
             lambda: dist.all_gather_into_tensor(full, chunk,
                                                 group=local.group))
    r = full[:flat.shape[0]].view(x.shape)
    if op == ReduceOp.AVERAGE:
        r = _divide(r, n)
    return _apply_scale(r, postscale_factor)
