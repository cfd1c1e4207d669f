"""Pipeline parallelism: the GPipe microbatch schedule over P2P hops.

Port of ``horovod_tpu/parallel/pipeline.py``: ``gpipe_spmd`` (``:37``)
and ``stack_stage_params`` (``:89``).  Rank i of the ``pp`` line is
stage i; ``xs`` [M, mb, ...] holds the microbatches, the same on every
rank.  The schedule is JAX's: M + S − 1 ticks; at tick t stage 0 runs
microbatch t, stage i the activation stage i − 1 sent it the tick
before, and the last stage finishes microbatch t − (S − 1); after each
tick but the last, one hop sends every stage's output to stage
(i + 1) mod S (``ring._post`` / ``_finish``, paired
``batch_isend_irecv`` over the axis's group, as JAX's ``lax.ppermute``).
The result is the last stage's outputs, summed over the line with the
other stages' masked, so every rank holds it.

A stage is idle outside ticks [i, i + M): JAX computes and masks there,
the port skips ``stage_fn`` and sends zeros, since no rank reads what an
idle stage sends.  Every rank still posts every hop (a hop pairs each
rank's send with its neighbour's receive), and the last tick's hop,
which no rank reads, is skipped by all.

JAX differentiates the scan and its ppermutes into the reverse
schedule.  The port writes that schedule out: the forward is one
``torch.autograd.Function`` that keeps each active tick's graph, and its
backward walks the ticks in reverse, posting the inverse hop of every
tick on every rank in one order (each stage sends the cotangent of what
it received back to stage i − 1) before running its own tick's
backward.  So stage 0, which never reads the wrap-around hop S − 1 → 0,
still returns its zero cotangent, and stage S − 1 does not wait for it
in vain: plain autograd would skip that hop on stage 0, as it would the
ring's last rotation without ``ring._Tie``.  The output's sum passes its
cotangent through unchanged (the loss is replicated: JAX's psum
transposes so under its varying-axes types), and ``xs``'s gradient is
summed over the line, which gives stage 0's.  ``stage_fn`` must not run
collectives: a stage's backward runs inside the schedule's.

``HOPS`` counts the hops of the forwards and the inverse hops of the
backwards.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils import _pytree

from . import axis as _axis
from .ring import _finish, _post
from .tensor import _sum

#: Hops since the last reset: ``"forward"`` one per tick but the last of
#: each ``gpipe_spmd`` forward (S > 1), ``"backward"`` the inverse hops.
HOPS = {"forward": 0, "backward": 0}


def _hop(ax, t: torch.Tensor, shift: int) -> torch.Tensor:
    (out,), works = _post(ax, [t], shift)
    _finish(works)
    return out


def _leaves(stage_params):
    leaves = stage_params.parameters() \
        if isinstance(stage_params, nn.Module) \
        else _pytree.tree_leaves(stage_params)
    return [p for p in leaves
            if isinstance(p, torch.Tensor) and p.requires_grad]


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, run, xs, *leaves):
        stage_fn, stage_params, ax, record = run
        S, i, M = ax.size, ax.index, xs.shape[0]
        zero = torch.zeros_like(xs[0])
        ys = torch.zeros_like(xs)
        ticks, buf = {}, None
        with torch.set_grad_enabled(record):
            for t in range(M + S - 1):
                y = zero
                if i <= t < i + M:
                    x_in = (xs[t] if i == 0 else buf).detach()
                    if i > 0 or xs.requires_grad:
                        x_in.requires_grad_(record)
                    y = stage_fn(stage_params, x_in)
                    if y.shape != x_in.shape or y.dtype != x_in.dtype:
                        raise ValueError(
                            f"stage_fn must keep the activation's shape "
                            f"and dtype: {tuple(x_in.shape)} "
                            f"{x_in.dtype} became {tuple(y.shape)} "
                            f"{y.dtype}")
                    ticks[t] = (x_in, y)
                    if i == S - 1:
                        ys[t - (S - 1)] = y.detach()
                    y = y.detach()
                if t < M + S - 2 and S > 1:
                    HOPS["forward"] += 1
                    buf = _hop(ax, y, +1)
        ctx.run, ctx.ticks, ctx.leaves = run, ticks, leaves
        ctx.xs_meta = (xs.shape, xs.dtype, xs.device)
        return _sum(ys, ax)

    @staticmethod
    def backward(ctx, g_out):
        _, _, ax, _ = ctx.run
        S, i = ax.size, ax.index
        shape, dtype, device = ctx.xs_meta
        M = shape[0]
        zero = torch.zeros(shape[1:], dtype=dtype, device=device)
        g_leaves = [None] * len(ctx.leaves)
        need_xs = ctx.needs_input_grad[1]
        g_xs = torch.zeros(shape, dtype=dtype, device=device) \
            if need_xs else None
        g_next = zero        # cotangent of what this stage got at tick t
        for t in reversed(range(M + S - 1)):
            g_y = None
            if t < M + S - 2 and S > 1:
                HOPS["backward"] += 1
                g_y = _hop(ax, g_next, -1)
            g_next = zero
            if t not in ctx.ticks:
                continue
            x_in, y = ctx.ticks.pop(t)
            if i == S - 1:
                # What came back from stage 0 is its zero cotangent.
                g_y = g_out[t - (S - 1)]
            inputs = ([x_in] if x_in.requires_grad else []) + \
                list(ctx.leaves)
            grads = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            if x_in.requires_grad:
                g_x, grads = grads[0], grads[1:]
                if i > 0:
                    g_next = g_x
                elif need_xs:
                    g_xs[t] = g_x
            for j, g in enumerate(grads):
                if g is not None:
                    g_leaves[j] = g if g_leaves[j] is None \
                        else g_leaves[j] + g
        if need_xs:
            g_xs = _sum(g_xs, ax)
        return (None, g_xs) + tuple(g_leaves)


def gpipe_spmd(stage_fn: Callable, stage_params, xs: torch.Tensor, *,
               axis_name: str = "pp", mesh=None) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x) -> y`` (``y`` of ``x``'s shape
    and dtype) as a pipeline of the axis's size over the M microbatches
    of ``xs`` [M, mb, ...] (the same on every rank); ``stage_params``
    is this rank's stage (a tensor, a tree of them, or a module).
    Returns the last stage's [M, mb, ...] outputs on every rank."""
    ax = _axis(axis_name, mesh)
    leaves = _leaves(stage_params)
    record = torch.is_grad_enabled() and (xs.requires_grad or bool(leaves))
    return _GPipe.apply((stage_fn, stage_params, ax, record), xs, *leaves)


def stack_stage_params(params_per_stage):
    """Stack per-stage trees (tensors, or dicts / lists of them) along a
    new leading stage dim: the layout each rank takes its row of."""
    leaves = [_pytree.tree_flatten(p) for p in params_per_stage]
    spec = leaves[0][1]
    return _pytree.tree_unflatten(
        [torch.stack(ls) for ls in zip(*(lv for lv, _ in leaves))], spec)
