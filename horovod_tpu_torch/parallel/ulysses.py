"""Ulysses sequence parallelism: an all-to-all turns sequence shards into
head shards and back.

Port of ``horovod_tpu/parallel/ulysses.py``.  ``seq_to_heads`` re-shards
[B, S/n, H, D] (the sequence split over the axis) into [B, S, H/n, D]
(the heads split), each rank runs full-sequence attention over its
heads with any local function (the model passes the flash kernels), and
``heads_to_seq`` restores the sequence split.  Each exchange is one
equal ``hvd.alltoall`` over the axis's process set, which is
differentiable (its backward is the inverse alltoall, an engine dispatch
of its own), where JAX uses ``lax.all_to_all``.  The heads must divide
by the axis size (the DeepSpeed-Ulysses condition).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import axis as _axis
from .. import ops as _ops


def _exchange(x: torch.Tensor, ax) -> torch.Tensor:
    """Row block i of dim 0 (of size 1) to the axis's member i."""
    if ax.size == 1:
        return x
    return _ops.alltoall(x.contiguous(), process_set=ax.process_set)


def seq_to_heads(x: torch.Tensor, *, axis_name: str = "hvd",
                 mesh=None) -> torch.Tensor:
    """[B, S_local, H, D] → [B, S_global, H/n, D]: head group i to member
    i, the sequence shards concatenated in member order."""
    ax = _axis(axis_name, mesh)
    n = ax.size
    B, S, H, D = x.shape
    if H % n != 0:
        raise ValueError(
            f"Ulysses requires heads ({H}) divisible by axis size ({n})")
    y = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)
    y = _exchange(y, ax)                      # [n (source), B, S, H/n, D]
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def heads_to_seq(x: torch.Tensor, *, axis_name: str = "hvd",
                 mesh=None) -> torch.Tensor:
    """[B, S_global, H/n, D] → [B, S_local, H, D] (the inverse
    exchange)."""
    ax = _axis(axis_name, mesh)
    n = ax.size
    B, Sg, Hn, D = x.shape
    y = x.reshape(B, n, Sg // n, Hn, D).permute(1, 0, 2, 3, 4)
    y = _exchange(y, ax)                      # [n (source), B, S, H/n, D]
    return y.permute(1, 2, 0, 3, 4).reshape(B, Sg // n, n * Hn, D)


def _default_attention(q, k, v, *, causal: bool, scale: Optional[float]):
    from .ring import ring_attention_reference
    return ring_attention_reference(q, k, v, causal=causal, scale=scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str = "hvd", causal: bool = False,
                      scale: Optional[float] = None,
                      attention_fn: Optional[Callable] = None,
                      mesh=None) -> torch.Tensor:
    """Exact attention for sequence-sharded q/k/v [B, S/n, H, D]:
    ``attention_fn(q, k, v, causal=..., scale=...)`` runs the local
    full-sequence attention over H/n heads (default: the dense
    reference)."""
    attention_fn = attention_fn or _default_attention
    kw = dict(axis_name=axis_name, mesh=mesh)
    qh, kh, vh = (seq_to_heads(t, **kw) for t in (q, k, v))
    oh = attention_fn(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(oh.to(q.dtype), **kw)
