"""The numbers that decide ``correct``, and the verdict.

Both sides give readings of the same checked steps: each step's loss on
each rank, each leaf's norm of the first step's reduced gradient (the
reference also gives that gradient whole), and the change of every
parameter over the steps, as one flat tensor in the layout's order.
Three gaps:

* ``loss_gap``: the largest ``|L_prog - L_ref| / L_ref`` over steps and
  ranks;
* ``grad_gap``: the worst leaf's ``| |g_prog| - |g_ref| |`` over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``delta_gap``: the same for each leaf's change.  Elements whose first
  reference gradient is under a thousandth of the median leaf's (its
  root mean square) are left out on both sides: they move under Adam by
  round-off alone, as the key's bias does under softmax, which shares
  the ``attn.qkv.bias`` leaf with the query's and value's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

CHECKS = ("loss_gap", "grad_gap", "delta_gap")
NEGLIGIBLE_GRAD = 1e-3


def leaf_norms(flat: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.double())
                        for t in torch.split(flat, list(sizes))]).cpu()


def _worst(prog: torch.Tensor, ref: torch.Tensor,
           keep: torch.Tensor) -> float:
    prog, ref = prog[keep].double(), ref[keep].double()
    floor = torch.maximum(ref, ref.median())
    return float(((prog - ref).abs() / floor).max())


def gaps(prog: dict, ref: dict, sizes: Sequence[int]) -> Dict[str, float]:
    """The three gaps between the program's readings (``prog``: ``losses``
    {rank: [per step]}, ``grad_norms`` [leaves], ``delta`` flat) and the
    reference's (the same, with ``grad`` flat); ``prog`` may hold fewer
    ranks' losses than ``ref``."""
    loss = 0.0
    for r, lp in prog["losses"].items():
        for a, b in zip(lp, ref["losses"][r]):
            loss = max(loss, abs(a - b) / abs(b))
    g = ref["grad"]
    g_norms = leaf_norms(g, sizes)
    every = torch.ones_like(g_norms, dtype=torch.bool)
    counts = torch.tensor([float(n) for n in sizes], dtype=torch.float64)
    threshold = NEGLIGIBLE_GRAD * float((g_norms / counts.sqrt()).median())
    moving = (g.abs() >= threshold).to(prog["delta"].dtype)
    dp = leaf_norms(prog["delta"] * moving, sizes)
    dr = leaf_norms(ref["delta"] * moving, sizes)
    kept = leaf_norms(moving, sizes) > 0
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad_norms"].cpu(), g_norms, every),
            "delta_gap": _worst(dp, dr, kept)}


def verdict(measured: Dict[str, float], limits: dict
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {check: {"value", "limit"}}): correct when every gap is
    a number within its limit.  A check without a limit fails."""
    checks, ok = {}, True
    for name in CHECKS:
        value = measured.get(name)
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, checks
