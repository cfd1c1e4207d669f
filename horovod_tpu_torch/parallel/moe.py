"""Expert parallelism: a GShard / Switch mixture-of-experts FFN whose
experts are sharded over a mesh axis, tokens routed by two alltoalls.

Port of ``horovod_tpu/parallel/moe.py``: ``MoEOutput``,
``_top_k_gating`` (``:43``), ``_dispatch_combine`` (``:55``),
``switch_aux_loss`` (``:84``) and ``expert_parallel_ffn`` (``:92``).
Each rank holds its tokens [T, d] and its E_local = E / n experts
(``w_in`` [E_local, d, d_ff], ``w_out`` [E_local, d_ff, d]) and a
replicated router ``gate`` [d, E]; expert ``e`` lives on the axis's
member ``e // E_local``.

Routing is local to a rank, as in JAX: f32 router logits, softmax, the
top k experts with their probabilities renormalised over the k choices
(the sum floored at 1e-9).  Every expert takes at most
``C = max(1, int(capacity_factor · k · T / E))`` tokens of this rank (T
the local token count); claims are counted choice-major, every primary
choice before any secondary one, and a claim past the capacity is
dropped.  The buckets [E, C, d] go out by one equal ``hvd.alltoall``
over the axis's process set ([n, E_local, C, d], block i to member i),
each member runs its experts on the [E_local, n, C, d] it received (gelu,
tanh form), one product per member's block of C rows, as the replicated
model's products, and a second alltoall brings the results back.  Both
alltoalls are the differentiable one of ``ops``, each direction's
backward the other.

JAX builds the [T, E, C] one-hot ``dispatch`` and the weighted
``combine`` and contracts them with einsums; at T = 4096, E = 8, C =
1280 each is 168 MB of f32 a layer.  The port builds each claim's slot
(expert, position) instead and moves rows by index: the bucket of slot
(e, c) is the one token that claimed it (a sum of one term, exact in
any dtype), and a token's output is the sum over its kept claims of the
combine weight, rounded to the experts' output dtype as JAX rounds
``combine``, times that slot's row.  :func:`_dispatch_combine` keeps
JAX's materialised form, against which the tests hold the index form.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.nn import functional as F

from . import axis as _axis
from .. import ops as _ops


class MoEOutput(NamedTuple):
    out: torch.Tensor           # [T_local, d] combined expert outputs
    aux_loss: torch.Tensor      # scalar load-balancing loss (Switch)
    dropped_frac: torch.Tensor  # scalar: share of (token, choice) claims
    # dropped by capacity


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _top_k_gating(logits: torch.Tensor, top_k: int):
    """Top-k router: ``(indices [T, k], weights [T, k], probs [T, E])``,
    the weights the chosen probabilities renormalised over the k
    choices (GShard)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, indices = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return indices, weights, probs


def _dispatch_combine(indices, weights, probs, num_experts: int,
                      capacity: int):
    """JAX's materialised [T, E, C] dispatch (0/1) and combine (weighted)
    tensors and the dropped share (``moe.py:55``), for the tests."""
    T, k = indices.shape
    onehot = F.one_hot(indices.T, num_experts).float()       # [k, T, E]
    flat = onehot.reshape(k * T, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat                   # earlier claims
    kept = ((pos < capacity).float() * flat).reshape(k, T, num_experts)
    pos = pos.reshape(k, T, num_experts)
    # jax.nn.one_hot gives a zero row for a position past the capacity;
    # those claims are not kept, so clamping first changes nothing.
    cap_onehot = F.one_hot(pos.long().clamp_max(capacity - 1),
                           capacity).float() * kept[..., None]
    dispatch = cap_onehot.sum(dim=0)
    combine = torch.einsum("tk,ktec->tec", weights.float(), cap_onehot)
    dropped = 1.0 - kept.sum() / (T * k)
    return dispatch, combine, dropped


def _routes(indices: torch.Tensor, num_experts: int, capacity: int):
    """Each claim's slot, in ``_dispatch_combine``'s order: ``(slot [k,
    T], kept [k, T] bool)``, slot = expert · C + position; the position
    counts the earlier claims on the same expert, choice-major."""
    k, T = indices.shape[1], indices.shape[0]
    flat = indices.T.reshape(-1)                             # [k·T]
    onehot = F.one_hot(flat, num_experts)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0]
    return (flat * capacity + pos).view(k, T), (pos < capacity).view(k, T)


def switch_aux_loss(probs: torch.Tensor, dispatch: torch.Tensor
                    ) -> torch.Tensor:
    """Switch Transformer load-balancing loss: E · Σ_e f_e · P_e."""
    num_experts = probs.shape[-1]
    f = dispatch.sum(dim=2).mean(dim=0)      # share routed per expert
    p = probs.mean(dim=0)                    # mean router prob per expert
    return num_experts * torch.sum(f * p)


def expert_parallel_ffn(x: torch.Tensor, gate_kernel: torch.Tensor,
                        w_in: torch.Tensor, w_out: torch.Tensor, *,
                        axis_name: Optional[str] = "hvd", top_k: int = 2,
                        capacity_factor: float = 1.25,
                        activation: Callable = gelu,
                        mesh=None) -> MoEOutput:
    """Mixture-of-experts FFN with the experts sharded over
    ``axis_name`` (shapes per rank: x [T, d], gate [d, E], w_in
    [E_local, d, d_ff], w_out [E_local, d_ff, d]).  ``axis_name=None``
    runs the same math on one rank with E_local = E."""
    ax = _axis(axis_name, mesh) if axis_name else None
    n = ax.size if ax is not None else 1
    T, d = x.shape
    e_local = w_in.shape[0]
    num_experts = e_local * n
    if gate_kernel.shape[-1] != num_experts:
        raise ValueError(
            f"gate maps to {gate_kernel.shape[-1]} experts but weights "
            f"provide {e_local} local x {n} shards = {num_experts}")
    capacity = max(1, int(capacity_factor * top_k * T / num_experts))

    logits = x.float() @ gate_kernel.float()
    indices, weights, probs = _top_k_gating(logits, top_k)
    slot, kept = _routes(indices, num_experts, capacity)
    # f_e of the aux loss: the kept claims on each expert over T.  No
    # boolean indexing: the sizes stay on the device.
    counts = torch.zeros(num_experts, device=x.device).index_add_(
        0, indices.T.reshape(-1), kept.reshape(-1).float())
    aux = num_experts * torch.sum(counts / T * probs.mean(dim=0))
    dropped = 1.0 - kept.sum() / (T * top_k)

    # [E·C, d]: each kept claim's token row in its slot, zero elsewhere;
    # the dropped claims land in one spare row, cut off after.
    slots = num_experts * capacity
    dest = torch.where(kept, slot, slots).reshape(-1)
    buckets = x.new_zeros(slots + 1, d).index_copy(
        0, dest, x.repeat(top_k, 1))[:slots]
    # Block i of [n, E_local, C, d] to member i: each member gets its
    # experts' buckets from every member, [E_local, n, C, d] (JAX's
    # [E_local, n·C, d]).
    buckets = buckets.view(n, e_local, capacity, d)
    if n > 1:
        buckets = _ops.alltoall(buckets, process_set=ax.process_set)
    # Each member's C rows are a product of their own, [C, d] @ [d, f]
    # batched E_local · n times: the products the replicated model makes
    # ([E, C, d] @ [E, d, f]), so sharding changes no bit of them.
    h = activation(torch.matmul(buckets.transpose(0, 1), w_in[:, None]))
    h = torch.matmul(h, w_out[:, None]).transpose(0, 1).contiguous()
    if n > 1:
        h = _ops.alltoall(h, process_set=ax.process_set)
    h = h.reshape(slots, d)
    # Each token's kept claims: the combine weight, rounded to h's dtype
    # as JAX casts ``combine``, times its slot's row, summed in f32.
    w = (weights.T * kept).to(h.dtype)                        # [k, T]
    rows = h[torch.where(kept, slot, 0)]                      # [k, T, d]
    out = (w.float()[..., None] * rows.float()).sum(dim=0).to(h.dtype)
    return MoEOutput(out.to(x.dtype), aux, dropped.float())
