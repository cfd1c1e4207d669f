"""Sparse gradient reduction.

Port of ``horovod_tpu/sparse.py``, with a torch COO tensor in place of
JAX's BCOO: ``sparse_allreduce`` gathers every member's indices and
values (the ragged allgather of ``ops``) and sums the duplicates
(``coalesce``); ``densify_if_sparse`` is the ``sparse_as_dense`` helper.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ops as _ops
from .ops import ReduceOp
from .process_sets import ProcessSet, global_process_set


def sparse_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                     name: Optional[str] = None,
                     process_set: ProcessSet = global_process_set
                     ) -> torch.Tensor:
    """Sum (or average over the member count) a sparse COO tensor over
    the set's ranks; returns a coalesced COO tensor.  A rank outside the
    set gets ``x`` back."""
    del name
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("sparse_allreduce supports SUM and AVERAGE "
                         "(the reference's IndexedSlices path likewise "
                         "gathers and sums)")
    if not (isinstance(x, torch.Tensor) and x.layout == torch.sparse_coo):
        raise TypeError("sparse_allreduce takes a sparse COO tensor")
    m = _ops.members_of(process_set)
    # One row per nonzero: indices [nnz, ndim] and values [nnz, ...].
    res = _ops._gather(x._indices().t(), process_set)
    vres = _ops._gather(x._values(), process_set)
    if res is None:
        return x
    (idx, rows), (vals, _) = res, vres
    if len(set(rows)) > 1:
        idx = torch.cat(_ops._blocks(idx, rows))
        vals = torch.cat(_ops._blocks(vals, rows))
    if op == ReduceOp.AVERAGE:
        vals = vals / m.size
    # The indices came from other ranks: check them before coalescing.
    return torch.sparse_coo_tensor(idx.t(), vals, x.shape,
                                   check_invariants=True).coalesce()


def densify_if_sparse(g):
    """A sparse COO tensor made dense; anything else as it is."""
    if isinstance(g, torch.Tensor) and g.layout == torch.sparse_coo:
        return g.to_dense()
    return g
