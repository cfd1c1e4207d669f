"""The reference's training steps: what one optimizer step of the port
should give, worked out again from the inputs alone.

Per step, each rank's micro-batches (``backward_passes_per_step`` of
them) give the gradient of the mean of their mean token losses, summed
block by block of rows so that a full-size step fits; the ranks'
gradients are averaged (``Average``); AdamW (torch's form: decoupled
decay, bias-corrected moments) updates the f32 parameters.

A process computes the ranks in ``ranks_here``; ``allreduce_sum`` adds
a flat f32 tensor over the processes of the world (the identity when
one process computes every rank), and ``world`` ranks in all divide it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import transformer
from .products import Products, exact_f32

TOKENS_PER_BLOCK = 2048


def _adamw(P, state, step: int, opt: dict) -> None:
    lr, wd, eps = opt["lr"], opt["weight_decay"], opt["eps"]
    b1, b2 = opt["betas"]
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for name, p in P.items():
        g = p.grad
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        p.data.mul_(1.0 - lr * wd)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = v.sqrt() / (bc2 ** 0.5) + eps
        p.data.addcdiv_(m, denom, value=-lr / bc1)


def _rows(batch: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def _rank_pass(P, model, traffic, micros: Sequence[Dict[str, torch.Tensor]],
               prod: Products, half_batch: bool) -> float:
    """Backward of one rank's step loss into ``P``'s grads (added to
    what is there); returns that loss."""
    task, passes = traffic["task"], len(micros)
    total = 0.0
    for batch in micros:
        B = next(iter(batch.values())).shape[0]
        if half_batch:
            B //= 2
            batch = _rows(batch, 0, B)
        per = max(1, TOKENS_PER_BLOCK // int(traffic["seq_len"]))
        for lo in range(0, B, per):
            hi = min(B, lo + per)
            ce, n = transformer.loss_sum(P, model, task, _rows(batch, lo, hi),
                                         prod)
            # the mean over the micro-batch's predicted tokens, and over
            # the step's passes
            denom = n // (hi - lo) * B * passes
            (ce / denom).backward()
            total += float(ce.detach()) / denom
    return total


def run(config: dict, traffic: dict, params: Dict[str, torch.Tensor],
        micros_by_rank: Dict[int, List[List[Dict[str, torch.Tensor]]]],
        world: int, allreduce_sum: Optional[Callable] = None,
        mode: str = "f32", half_batch: bool = False) -> dict:
    """Run ``len(next(iter(micros_by_rank.values())))`` steps from
    ``params`` (each rank's list holds, per step, that step's
    micro-batches).  Returns the readings the check compares:
    ``losses`` ({rank: [loss per step]}), ``grad`` (the first step's
    reduced gradient) and ``delta`` (every parameter's change over the
    steps), both flat in ``params``' order."""
    model, opt = config["model"], traffic["optimizer"]
    prod = Products(mode)
    names = list(params)
    P = {n: params[n].detach().clone().float().requires_grad_()
         for n in names}
    start = [params[n].detach().float() for n in names]
    steps = len(next(iter(micros_by_rank.values())))
    losses = {r: [] for r in micros_by_rank}
    state: dict = {}
    grad = None
    with exact_f32():
        for t in range(steps):
            for p in P.values():
                p.grad = None
            for r, per_step in micros_by_rank.items():
                losses[r].append(_rank_pass(P, model, traffic, per_step[t],
                                            prod, half_batch))
            grads = [P[n].grad if P[n].grad is not None
                     else torch.zeros_like(P[n]) for n in names]
            flat = torch.cat([g.reshape(-1) for g in grads])
            if allreduce_sum is not None:
                flat = allreduce_sum(flat)
            flat /= world
            at = 0
            for n in names:
                k = P[n].numel()
                P[n].grad = flat[at:at + k].view_as(P[n])
                at += k
            if t == 0:
                grad = flat.clone()
            with torch.no_grad():
                _adamw(P, state, t + 1, opt)
        delta = torch.cat([(P[n].detach() - s).reshape(-1)
                           for n, s in zip(names, start)])
    return {"losses": losses, "grad": grad, "delta": delta, "names": names}
