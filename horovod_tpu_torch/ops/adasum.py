"""Adasum, the adaptive-summation allreduce, in torch.

Port of ``horovod_tpu/ops/adasum.py``.  Two ranks' tensors ``a`` and
``b`` combine as ``acoeff·a + bcoeff·b`` with

    acoeff = 1 - dot / (2·||a||²)
    bcoeff = 1 - dot / (2·||b||²)

(the reference's ``adasum.h:396-409``; a coefficient is 1 where its
norm is 0): a sum for orthogonal tensors, an average for parallel ones.
The dot product and the norms are taken in float32 islands whatever the
input's dtype, or in float64 with ``HVD_ADASUM_ACC_DTYPE=f64`` (the
reference's own precision); the result is cast back to the input's
dtype.

A reduction over the whole world at a power-of-two size runs the
butterfly: log2(n) rounds, in each of which rank i swaps its whole
tensor with rank ``i ^ 2^level`` (``dist.batch_isend_irecv``) and both
combine the pair with the lower rank as ``a``, so every rank computes
the same bits and holds the tree's result at the end.  A strict subset
of the ranks, or a size that is not a power of two, gathers the
members' tensors over the set's group and reduces the stack locally
with a binary tree, zero-padded to a power of two (``adasum(a, 0) =
a``), pairing members in set order.

Like JAX's, it is plain tensor code: the JAX package has no Pallas
kernel for it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .collective_ops import Members, _checked


def _acc_dtype() -> torch.dtype:
    """The dot/norm island dtype: ``HVD_ADASUM_ACC_DTYPE`` f32 (the
    default) or f64.  torch has no x64 switch to consult, so f64 always
    gives float64 islands."""
    name = os.environ.get("HVD_ADASUM_ACC_DTYPE", "f32")
    if name in ("f32", "float32"):
        return torch.float32
    if name in ("f64", "float64"):
        return torch.float64
    raise ValueError(
        f"HVD_ADASUM_ACC_DTYPE={name!r}: expected 'f32' or 'f64'")


def _combine(a: torch.Tensor, b: torch.Tensor, lead: int) -> torch.Tensor:
    """Adasum of ``a`` and ``b`` with one coefficient pair for each index
    of their first ``lead`` dims (0: one pair for the whole tensor)."""
    acc = _acc_dtype()
    shape = a.shape
    slices = 1
    for d in shape[:lead]:
        slices *= d
    per = a.numel() // max(slices, 1)
    a2 = a.to(acc).reshape(slices, per)
    b2 = b.to(acc).reshape(slices, per)
    dot = (a2 * b2).sum(dim=1, keepdim=True)
    na = (a2 * a2).sum(dim=1, keepdim=True)
    nb = (b2 * b2).sum(dim=1, keepdim=True)
    one = torch.ones_like(na)
    acoeff = torch.where(na > 0, 1.0 - dot / torch.where(na > 0, 2.0 * na,
                                                         one), one)
    bcoeff = torch.where(nb > 0, 1.0 - dot / torch.where(nb > 0, 2.0 * nb,
                                                         one), one)
    return (acoeff * a2 + bcoeff * b2).reshape(shape).to(a.dtype)


def pair_combine(a: torch.Tensor, b: torch.Tensor,
                 per_slice_axis0: bool = False) -> torch.Tensor:
    """Adasum of one pair.  ``per_slice_axis0``: one coefficient pair per
    slice of dim 0 (a stacked [L, ...] per-layer leaf keeps the
    reference's per-tensor granularity)."""
    return _combine(a, b, 1 if per_slice_axis0 else 0)


def _tree_reduce_gathered(stacked: torch.Tensor,
                          per_slice_axis0: bool = False) -> torch.Tensor:
    """Binary-tree Adasum over a [n, ...] stack, zero-padded to a power
    of two; each level combines rows ``[0::2]`` with ``[1::2]``, every
    pair with coefficients of its own."""
    n = stacked.shape[0]
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    if pow2 != n:
        stacked = torch.cat([stacked, stacked.new_zeros(
            (pow2 - n,) + tuple(stacked.shape[1:]))])
    while stacked.shape[0] > 1:
        stacked = _combine(stacked[0::2], stacked[1::2],
                           2 if per_slice_axis0 else 1)
    return stacked[0]


def adasum_allreduce(x: torch.Tensor, m: Members,
                     per_slice_axis0: bool = False) -> torch.Tensor:
    """Adasum of every member's ``x`` (``ReduceOp.ADASUM``'s target).  A
    set of one and a rank outside the set get ``x`` back."""
    n = m.size
    if n == 1 or not m.included:
        return x
    x = x.contiguous()
    if m.group is None and n & (n - 1) == 0:
        me = m.set_rank
        for level in range(n.bit_length() - 1):
            bit = 1 << level
            peer = m.ranks[me ^ bit]
            other = torch.empty_like(x)

            def swap():
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, other, peer)])
                for req in reqs:
                    req.wait()

            _checked("adasum", x, swap)
            a, b = (x, other) if me & bit == 0 else (other, x)
            x = pair_combine(a, b, per_slice_axis0)
        return x
    flat = x.reshape(-1)
    out = flat.new_empty(n * flat.numel())
    _checked("adasum", x, lambda: dist.all_gather_into_tensor(
        out, flat, group=m.group))
    return _tree_reduce_gathered(out.view((n,) + tuple(x.shape)),
                                 per_slice_axis0)
