"""Ring attention: exact attention over a sequence sharded on a mesh
axis, K/V rotated around the axis's ring from rank to rank.

Port of ``horovod_tpu/parallel/ring.py``.  q, k, v are each rank's
local sequence shard ``[B, S_local, H, D]``; each hop folds the K/V
block it holds into an online softmax (``ring_attention``, einsums) or
runs the flash kernels on it and merges ``(out, lse)`` pairs by
logsumexp (``ring_flash_attention``), and the blocks rotate one step to
the left (rank i sends to rank i - 1 and receives from i + 1, JAX's
``lax.ppermute`` with ``perm = [(i, (i - 1) % n)]``, ``:323``), so hop t
holds the block of rank ``(my + t) % n``.

The rotation is ``torch.distributed.batch_isend_irecv`` over the axis's
group (NCCL on cards, gloo on the CPU), not an engine dispatch: JAX's
ring calls ``lax.ppermute``, not an hvd op.  It is differentiable, its
backward the inverse rotation, and split into a start (post the P2P ops)
and a finish (wait on them), so the ``"overlap"`` schedule puts hop
t + 1's transfer under hop t's compute and runs n - 1 rotations, against
``"serial"``'s compute-then-rotate n (its last rotation is dead).
``ROTATIONS`` counts both directions.  Inside an analysis trace
(``analysis/graph_check.py``) each rotated tensor is one ``ppermute``
node of the graph, and nothing is sent.

JAX's program is one SPMD trace, the same on every rank; the port's
per-hop decisions are plain Python on each rank (``_hop_plan``: NONE
below the diagonal, CAUSAL on it, a true skip above it under
``"overlap"``, a kernel whose lse is forced to -1e30 under
``"serial"``; striped CAUSAL / STRICT).  A rank that skips its last
hops never uses the K/V it received, so autograd would not run those
rotations' backward on that rank while its neighbours wait for it: the
last rotated pair is tied to the output with zero gradient (``_Tie``),
so every rank runs every inverse rotation, in one order.  ``remat_hops``
checkpoints the fold alone, so a hop's recompute sends nothing; the
transformer's ``remat`` recomputes a whole block, its rotations
included, at a point of the backward that every rank reaches in the
same order.

``ring_flash_attention`` rotates K/V in f32 and asks each hop for an f32
partial (``flash_attention_lse(out_dtype=float32)``, which casts q), so
by ``parallel/flash.py``'s routes every hop runs the 3xTF32 f32 kernels,
forward and backward, even in a bf16 model, as JAX runs f32 hops.  The
partials merge in f32 and are cast to q's dtype once at the end.

Observability: ``set_ring_timeline`` makes each ring call write its hop
schedule as ``ring_hop`` events (once per configuration per
registration); ``set_ring_kernel_callback`` registers ``cb(mask_mode)``,
called once for each hop whose flash attention runs (the kernel on a
card, its plain version on the CPU) and never for a skipped hop.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import axis as _axis
from ..analysis import graph_check as _gc
from .flash import MASK_CAUSAL, MASK_NONE, MASK_STRICT, flash_attention_lse

SCHEDULES = ("overlap", "serial")
NEG_INF = -1e30

#: Rotations since the last reset: ``"forward"`` counts the K/V
#: rotations of the ring functions' forward passes (one per K/V pair
#: sent, the identity of a ring of one included), ``"backward"`` the
#: inverse rotations their backward passes run.
ROTATIONS = {"forward": 0, "backward": 0}

# -- observability hooks ------------------------------------------------------

_ring_timeline = None
_ring_timeline_seen: set = set()
_ring_kernel_callback: Optional[Callable[[int], None]] = None


def set_ring_timeline(timeline, tensor_name: str = "ring") -> None:
    """Register a ``timeline.Timeline`` (or None to clear) to receive
    each ring call's hop schedule: hop index, bytes rotated, mask rule,
    schedule and how many shards skip the hop's kernel.  Each distinct
    configuration is written once per registration, so the layers and
    steps of a model do not repeat it."""
    global _ring_timeline
    _ring_timeline = None if timeline is None else (timeline, tensor_name)
    _ring_timeline_seen.clear()


def set_ring_kernel_callback(cb: Optional[Callable[[int], None]]) -> None:
    """Register ``cb(mask_mode)`` (or None), called once for every hop
    of ``ring_flash_attention`` whose flash attention runs; a skipped hop
    never calls it."""
    global _ring_kernel_callback
    _ring_kernel_callback = cb


def _emit_hop_schedule(kind: str, n: int, bytes_per_hop: int, causal: bool,
                       striped: bool, schedule: str) -> None:
    if _ring_timeline is None:
        return
    key = (kind, n, bytes_per_hop, causal, striped, schedule)
    if key in _ring_timeline_seen:
        return
    _ring_timeline_seen.add(key)
    tl, name = _ring_timeline
    mask = ("causal-striped" if causal and striped else
            "causal-contiguous" if causal else "none")
    for hop in range(n):
        # Contiguous causal under "overlap": hop t (t >= 1) carries the
        # block of owner my + t, above the diagonal on the n - t shards
        # with my < n - t, which skip it.
        skipped = 0
        if causal and not striped and schedule == "overlap" and hop > 0:
            skipped = n - hop
        tl.ring_hop(f"{name}/{kind}", hop, bytes_rotated=bytes_per_hop,
                    mask=mask, schedule=schedule, skipped_shards=skipped)


def emit_hop_schedule(kind: str, n: int, bytes_per_hop: int, *,
                      causal: bool = True, striped: bool = False,
                      schedule: str = "overlap") -> None:
    """The hop schedule for callers that run the ring fold without a
    live ring (a sequence-parallel prefill emulated in one process):
    the same events, dedup and skip accounting as the ring functions."""
    _emit_hop_schedule(kind, n, bytes_per_hop, causal, striped, schedule)


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")


# -- the fold -----------------------------------------------------------------

def _block_scores(q32, k32, scale):
    # [B, Sq, H, D] x [B, Sk, H, D] -> [B, H, Sq, Sk]
    return torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale


def online_fold(s, v32, acc, m, l):
    """One online-softmax fold of a masked score block into the running
    ``(acc, m, l)``: ``s`` [B, H, Sq, Sk] with masked entries at -1e30,
    ``v32`` [B, Sk, H, D], ``acc`` [B, H, Sq, D], ``m`` and ``l``
    [B, H, Sq, 1].  The running max is floored at half the mask value,
    so a fully masked block is an exact no-op even on an empty state."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_new = torch.clamp_min(m_new, NEG_INF * 0.5)
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p, v32)
    return acc_new, m_new, l_new


def ragged_fold_init(q32):
    """The empty state ``(acc, m, l)`` for folding K/V extents into
    queries ``q32`` [B, Sq, H, D] with ``ragged_fold``."""
    B, Sq, H, D = q32.shape
    acc = q32.new_zeros((B, H, Sq, D))
    m = q32.new_full((B, H, Sq, 1), NEG_INF)
    return acc, m, torch.zeros_like(m)


def ragged_fold(q32, k32, v32, *, q_start, k_start, k_len, acc, m, l,
                scale, mask_mode: int = MASK_CAUSAL):
    """Fold one K/V extent whose global positions are known only at run
    time: query row i sits at ``q_start + i``, key column j at
    ``k_start + j``, and only the first ``k_len`` columns are real.
    ``mask_mode``: 0 none, 1 causal (q >= k), 2 strict (q > k)."""
    s = _block_scores(q32, k32, scale)
    Sq, Sk = s.shape[-2], s.shape[-1]
    iq = torch.arange(Sq, device=s.device)[:, None]
    ik = torch.arange(Sk, device=s.device)[None, :]
    qg, kg = q_start + iq, k_start + ik
    if mask_mode == MASK_CAUSAL:
        keep = qg >= kg
    elif mask_mode == MASK_STRICT:
        keep = qg > kg
    else:
        keep = torch.ones((Sq, Sk), dtype=torch.bool, device=s.device)
    keep = keep & (ik < k_len)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return online_fold(s, v32, acc, m, l)


def ragged_fold_finish(acc, m, l, dtype=torch.float32):
    """Normalize: [B, H, Sq, D] accumulator to the [B, Sq, H, D] output
    (a row that attended nothing comes out 0)."""
    del m
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(dtype)


# -- layouts ------------------------------------------------------------------

def stripe_sequence(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Re-order a global sequence into the striped layout: shard i gets
    tokens [i, i + n, i + 2n, ...] instead of a contiguous block (under
    causal ring attention this balances the mask across hops).  Apply
    before sharding; invert with ``unstripe_sequence``."""
    x = torch.movedim(x, axis, 0)
    S = x.shape[0]
    if S % n:
        raise ValueError(f"sequence length {S} not divisible by {n}")
    x = x.reshape(S // n, n, *x.shape[1:])
    x = torch.movedim(x, 1, 0).reshape(S, *x.shape[2:])
    return torch.movedim(x, 0, axis)


def unstripe_sequence(x: torch.Tensor, n: int, axis: int = 1
                      ) -> torch.Tensor:
    """Inverse of ``stripe_sequence``."""
    x = torch.movedim(x, axis, 0)
    S = x.shape[0]
    x = x.reshape(n, S // n, *x.shape[1:])
    x = torch.movedim(x, 1, 0).reshape(S, *x.shape[2:])
    return torch.movedim(x, 0, axis)


def striped_positions(s_local: int, *, axis_name: str = "hvd", mesh=None,
                      device=None) -> torch.Tensor:
    """Global positions of this shard's striped tokens ([i, i + n, ...]),
    for the position embedding in the striped layout."""
    ax = _axis(axis_name, mesh)
    return torch.arange(s_local, device=device) * ax.size + ax.index


# -- the rotation -------------------------------------------------------------

def _post(ax, tensors: List[torch.Tensor], shift: int):
    """Send each tensor to the rank ``shift`` places along the axis and
    receive as many from the rank ``shift`` places the other way;
    returns the receive buffers and the works."""
    if _gc.active() is not None:   # an analysis trace: one hop each
        return [_gc.emit("ppermute", t.contiguous(), ax.process_set)
                for t in tensors], []
    n, i = ax.size, ax.index
    dst, src = ax.ranks[(i + shift) % n], ax.ranks[(i - shift) % n]
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        o = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group=ax.group))
        ops.append(dist.P2POp(dist.irecv, o, src, group=ax.group))
        outs.append(o)
    return outs, dist.batch_isend_irecv(ops)


def _finish(works) -> None:
    for w in works:
        w.wait()


class _Rotate(torch.autograd.Function):
    """One left rotation of a K/V pair; its backward is the inverse
    rotation.  The forward only posts the transfer (its outputs are
    valid after ``_finish`` of the works it appends to ``pending``); the
    backward waits for its own."""

    @staticmethod
    def forward(ctx, ax, pending, k, v):
        ctx.ax = ax
        outs, works = _post(ax, [k, v], -1)
        pending.append(works)
        return tuple(outs)

    @staticmethod
    def backward(ctx, gk, gv):
        (dk, dv), works = _post(ctx.ax, [gk, gv], +1)
        _finish(works)
        ROTATIONS["backward"] += 1
        return None, None, dk, dv


def _rotate_start(ax, k, v):
    """Start rotating ``(k, v)`` one step left: ``((k', v'), works)``;
    the pair is valid after ``_finish(works)``.  A ring of one returns
    its own pair."""
    ROTATIONS["forward"] += 1
    if ax.size == 1:
        return (k, v), []
    pending: list = []
    kv = _Rotate.apply(ax, pending, k, v)
    return kv, pending[0]


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``others`` as inputs whose gradient is
    zero: puts the last rotated K/V on the path from the output, so
    autograd runs every inverse rotation on every rank."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.metas = [(o.shape, o.dtype, o.device) for o in others]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dev)
                            for s, d, dev in ctx.metas)


def _tie(out, last):
    if last is None or not torch.is_grad_enabled() or \
            not any(t.requires_grad for t in last):
        return out
    return _Tie.apply(out, *last)


class _RingBlocks:
    """The K/V block each hop of one rank holds: ``blocks(t)`` is the
    pair of owner ``(my + t) % n``, called for t = 0, 1, ..., n - 1 in
    order with the hop's compute between calls.  ``"serial"``: each call
    after the first rotates (start and finish) before it returns, and
    ``last()`` runs the n-th rotation.  ``"overlap"``: each call finishes
    the rotation the previous call started and starts the one that
    brings the next hop's pair, so it moves under the hop's compute,
    n - 1 rotations.  ``last()`` is the last rotated pair (None when
    nothing rotated), for ``_tie``."""

    def __init__(self, ax, k32, v32, schedule: str):
        self.ax, self.schedule = ax, schedule
        self.cur, self.nxt, self.works = (k32, v32), None, None

    def __call__(self, step: int):
        ax = self.ax
        if step > 0:
            if self.schedule == "serial":
                self.cur, works = _rotate_start(ax, *self.cur)
                _finish(works)
            else:
                _finish(self.works)
                self.cur = self.nxt
        if self.schedule == "overlap" and step + 1 < ax.size:
            self.nxt, self.works = _rotate_start(ax, *self.cur)
        return self.cur

    def last(self):
        if self.schedule == "serial":
            self.cur, works = _rotate_start(self.ax, *self.cur)
            _finish(works)
            return self.cur
        return self.cur if self.ax.size > 1 else None


# -- per-hop decisions --------------------------------------------------------

def _hop_plan(my: int, owner: int, *, causal: bool, striped: bool,
              schedule: str, s_local: int) -> Tuple[Optional[int], bool]:
    """``(mask_mode, forced)`` of the hop whose K/V block ``owner`` holds
    on the rank at ring position ``my`` (``ring.py:508-535``):
    ``mask_mode`` None is a true skip (no kernel); ``forced`` runs the
    kernel and forces its lse to -1e30 (``"serial"``'s discarded hops
    above the diagonal).  Contiguous causal: NONE below the diagonal,
    CAUSAL on it, above it a skip under ``"overlap"``.  Striped causal:
    CAUSAL for ``owner <= my``, else STRICT, skipped only when each
    shard holds one row under ``"overlap"``.  Not causal: NONE."""
    if causal and striped:
        if owner <= my:
            return MASK_CAUSAL, False
        if schedule == "overlap" and s_local == 1:
            return None, False
        return MASK_STRICT, False
    if causal:
        if owner == my:
            return MASK_CAUSAL, False
        if owner < my:
            return MASK_NONE, False
        if schedule == "overlap":
            return None, False
        return MASK_NONE, True
    return MASK_NONE, False


def _hop_flash(q, k, v, mode: int, scale: float, block_q: int = 128,
               block_k: int = 128):
    """One hop's flash attention with an f32 partial: ``(out [B, S, H, D]
    f32, lse [B, H, S])``, differentiable in both."""
    if _ring_kernel_callback is not None:
        _ring_kernel_callback(mode)
    return flash_attention_lse(q, k, v, mask_mode=mode, scale=scale,
                               block_q=block_q, block_k=block_k,
                               out_dtype=torch.float32)


def _merge(out_acc, lse_acc, o_h, lse_h):
    """The (out, lse) logsumexp merge with masked-row guards
    (``ring.py:536-549``): a fully masked row (lse at most -1e30 / 2)
    gets weight exactly 0, where a plain logaddexp of two such rows
    would weigh each 0.5."""
    masked_a = lse_acc <= NEG_INF * 0.5
    masked_h = lse_h <= NEG_INF * 0.5
    lse_new = torch.where(
        masked_h, lse_acc,
        torch.where(masked_a, lse_h, torch.logaddexp(lse_acc, lse_h)))
    w_a = torch.where(masked_a, 0.0, torch.exp(lse_acc - lse_new))
    w_h = torch.where(masked_h, 0.0, torch.exp(lse_h - lse_new))
    out_new = out_acc * w_a.transpose(1, 2)[..., None] \
        + o_h.float() * w_h.transpose(1, 2)[..., None]
    return out_new, lse_new


def _rank_hops(q, block_of: Callable[[int], tuple], my: int, n: int, *,
               causal: bool, striped: bool, schedule: str, scale: float,
               block_q: int = 128, block_k: int = 128):
    """One rank's hops of ``ring_flash_attention``: for t = 0 .. n - 1,
    the K/V pair of owner ``(my + t) % n`` from ``block_of(t)`` (called
    for every hop, a skipped one included), the mode ``_hop_plan`` picks,
    the hop's flash attention (``_hop_flash``) and the merge.  Returns
    the merged ``(out f32 [B, S, H, D], lse [B, H, S])``."""
    B, Sq, H, D = q.shape
    out = q.new_zeros(q.shape, dtype=torch.float32)
    lse = q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32)
    for step in range(n):
        kc, vc = block_of(step)
        mode, forced = _hop_plan(my, (my + step) % n, causal=causal,
                                 striped=striped, schedule=schedule,
                                 s_local=Sq)
        if mode is None:
            continue  # true skip: merging (0, -1e30) is the identity
        o_h, lse_h = _hop_flash(q, kc, vc, mode, scale, block_q, block_k)
        if forced:
            lse_h = torch.full_like(lse_h, NEG_INF)
        out, lse = _merge(out, lse, o_h, lse_h)
    return out, lse


# -- the ring functions -------------------------------------------------------

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "hvd", causal: bool = False,
                   scale: Optional[float] = None, striped: bool = False,
                   remat_hops: bool = True, schedule: str = "overlap",
                   mesh=None) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``axis_name``
    (``ring.py:264``): q, k, v are the local shards [B, S_local, H, D];
    returns the local output in q's dtype.

    ``causal`` masks by global position; ``striped`` says shard i holds
    tokens i, i + n, ... (``stripe_sequence``), else the contiguous
    block [i·S_local, (i + 1)·S_local).  ``remat_hops`` recomputes each
    hop's fold in the backward (``torch.utils.checkpoint`` around the
    fold alone) instead of saving its [Sq, Sk] probability block.
    ``schedule``: ``"overlap"`` (hop t + 1's rotation under hop t's fold,
    n - 1 rotations, contiguous-causal hops above the diagonal skipped)
    or ``"serial"`` (fold, then rotate, n rotations, masked hops
    folded); both give the same values and gradients."""
    _check_schedule(schedule)
    ax = _axis(axis_name, mesh)
    n, my = ax.size, ax.index
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q32 = q.float()
    state = list(ragged_fold_init(q32))
    if causal:
        i = torch.arange(Sq, device=q.device)
        tri, tri_strict = i[:, None] >= i[None, :], i[:, None] > i[None, :]
    _emit_hop_schedule("ring_attention", n, 2 * B * Sq * H * D * 4,
                       causal, striped, schedule)

    def fold(kc, vc, acc, m, l, owner: int):
        s = _block_scores(q32, kc, scale)
        keep = None
        if causal and striped:
            keep = tri if owner <= my else tri_strict
        elif causal and owner >= my:
            keep = tri if owner == my else torch.zeros_like(tri)
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        return online_fold(s, vc, acc, m, l)

    def hop(step, kc, vc):
        owner = (my + step) % n
        if schedule == "overlap" and causal and not striped and owner > my:
            return  # true skip: the state is untouched
        if remat_hops and torch.is_grad_enabled():
            state[:] = checkpoint(fold, kc, vc, *state, owner,
                                  use_reentrant=False)
        else:
            state[:] = fold(kc, vc, *state, owner)

    blocks = _RingBlocks(ax, k.float(), v.float(), schedule)
    for step in range(n):
        hop(step, *blocks(step))
    acc, m, l = state
    return _tie(ragged_fold_finish(acc, m, l, q.dtype), blocks.last())


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, axis_name: str = "hvd", causal: bool = False,
                         scale: Optional[float] = None, striped: bool = False,
                         block_q: int = 128, block_k: int = 128,
                         schedule: str = "overlap", mesh=None
                         ) -> torch.Tensor:
    """``ring_attention`` with each hop in the flash kernels
    (``ring.py:423``): per hop ``flash_attention_lse`` in the mode
    ``_hop_plan`` picks, an f32 partial merged by ``_merge``, no [Sq, Sk]
    block in memory.  K/V rotate in f32, so every hop runs the f32
    (3xTF32) kernels; the merged output is cast to q's dtype once.  The
    backward runs each hop's flash backward and the inverse rotations;
    each hop keeps its K/V block, partial and lse for it (O(S_global)
    per rank, no recompute)."""
    _check_schedule(schedule)
    ax = _axis(axis_name, mesh)
    n, my = ax.size, ax.index
    B, Sq, H, D = q.shape
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    _emit_hop_schedule("ring_flash_attention", n, 2 * B * Sq * H * D * 4,
                       causal, striped, schedule)
    blocks = _RingBlocks(ax, k.float(), v.float(), schedule)
    out, _ = _rank_hops(q, blocks, my, n, causal=causal, striped=striped,
                        schedule=schedule, scale=scale, block_q=block_q,
                        block_k=block_k)
    return _tie(out.to(q.dtype), blocks.last())


def virtual_ring_flash_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n: int, *,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 striped: bool = False,
                                 schedule: str = "overlap", block_q: int = 128,
                                 block_k: int = 128) -> torch.Tensor:
    """What n ranks of ``ring_flash_attention`` compute, on one device:
    the global [B, S, H, D] sequence cut into n virtual shards (striped
    first when ``striped``), each shard's hops run by ``_rank_hops``, the
    ring's own per-hop code, with the owners' K/V blocks in place of
    rotated ones; the output in global order and q's dtype,
    differentiable.  For driving the hop kernels at a ring's shapes on
    one card."""
    _check_schedule(schedule)
    D = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    if striped:
        q, k, v = (stripe_sequence(t, n) for t in (q, k, v))
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"{n}")
    sl = q.shape[1] // n
    part = lambda t, i: t[:, i * sl:(i + 1) * sl]  # noqa: E731
    kv = [(part(k, i).float(), part(v, i).float()) for i in range(n)]
    outs = [_rank_hops(part(q, my), lambda t, my=my: kv[(my + t) % n], my,
                       n, causal=causal, striped=striped, schedule=schedule,
                       scale=scale, block_q=block_q, block_k=block_k)[0]
            for my in range(n)]
    out = torch.cat(outs, dim=1).to(q.dtype)
    return unstripe_sequence(out, n) if striped else out


def ring_attention_reference(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded dense attention (``ring.py:598``): [B, S, H, D] in f32,
    the output in q's dtype."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        i = torch.arange(S, device=q.device)
        s = torch.where(i[:, None] >= i[None, :], s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
