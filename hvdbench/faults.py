"""Faults planted under the harness, for the checks that ``correct``
comes out false when the timed path is broken.  Used by the tests and
by ``calibrate.py``; a benchmark run plants none.

* ``frozen_step``: the wrapped optimizer's step returns with the
  parameters and its state unchanged;
* ``half_batch``: the loss is the mean over the first half of the
  batch's rows, the rest left out;
* ``no_exchange``: each fusion bucket comes back from the reduction as
  this rank's own gradients, not the world's average.
"""

from __future__ import annotations

FAULTS = ("frozen_step", "half_batch", "no_exchange")


def plant(name: str, program) -> None:
    if name == "frozen_step":
        program.opt.optimizer.step = lambda *a, **k: None
    elif name == "half_batch":
        T = program.T
        whole = T.lm_loss

        def half(logits, targets, mask=None):
            n = logits.shape[0] // 2
            return whole(logits[:n], targets[:n],
                         None if mask is None else mask[:n])
        program.lm_loss = half
    elif name == "no_exchange":
        import horovod_tpu_torch.ops as ops
        ops._fused_allreduce = lambda tensors, *a, **k: [
            t.clone() for t in tensors]
    else:
        raise ValueError(f"unknown fault {name!r}; {FAULTS}")
