"""GPT-2 language modeling with Adasum reduction.

Port of ``examples/gpt2_adasum.py`` (BASELINE config 4, "GPT-2 medium
with Adasum"): each rank takes its ``--batch-per-slot`` rows of one
fixed token batch made with numpy from ``RandomState(0)``, computes its
own gradients (``local_value_and_grad``), and ``adasum_delta_step``
steps ``SGD(0.05)`` on them and Adasum-reduces each parameter's delta
(the reference's ``_DistributedAdasumOptimizer`` contract).  Adasum
adapts between summing and averaging per tensor, so the learning rate
stays fixed as the world grows.  The loss reported is averaged over the
world.  The JAX example's ``per_layer_stacked`` serves its scanned
layout; the port's layers are unrolled, so every tensor gets its own
coefficients without it.

Run small on the CPU (a gloo world of one, or several under a launcher):
    python -m horovod_tpu_torch.examples.gpt2_adasum --device cpu --size tiny --steps 6
GPT-2 medium on a card (remat, flash attention, bf16 products):
    python -m horovod_tpu_torch.examples.gpt2_adasum --size medium --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
from torch.func import functional_call

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                      create_gpt2, lm_loss)
from horovod_tpu_torch.models.transformer import init_gpt2_

TINY = TransformerConfig(vocab_size=512, num_layers=2, num_heads=8,
                         d_model=128, d_ff=256, max_len=128, causal=True,
                         dtype=torch.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny",
                    choices=["tiny", "small", "medium", "large"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-per-slot", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--attention", default="auto",
                    choices=["auto", "dense", "flash"],
                    help="'flash' = the CUDA kernels (fwd+bwd); 'auto' "
                         "picks flash on cuda, dense elsewhere")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (a gloo world)")
    return ap.parse_args(argv)


def build(args):
    """Join the world and build what one rank trains: returns the model,
    the attention it runs ("flash" or "dense"), and ``step()``, which
    runs one forward and backward pass and ``adasum_delta_step`` and
    returns the loss averaged over the world, on the device."""
    hvd.init(device=args.device)
    dev = hvd.device()
    attn = args.attention
    if attn == "auto":
        attn = "flash" if dev.type == "cuda" else "dense"
    attn_impl = "flash" if attn == "flash" else None
    if args.size == "tiny":
        model = init_gpt2_(
            Transformer(dataclasses.replace(TINY, attention_impl=attn_impl),
                        device=dev),
            torch.Generator(device=dev).manual_seed(0))
    else:
        model = create_gpt2(args.size, device=dev, seed=0, remat=True,
                            attention_impl=attn_impl)
    cfg = model.cfg
    seq_len = min(args.seq_len, cfg.max_len)
    rows = args.batch_per_slot
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(rows * hvd.num_slots(), seq_len))
    mine = torch.as_tensor(tokens[hvd.rank() * rows:(hvd.rank() + 1) * rows],
                           device=dev)
    hvd.broadcast_parameters(model, root_rank=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    params = dict(model.named_parameters())

    def loss_fn(p):
        logits = functional_call(model, p, (mine,))
        return lm_loss(logits[:, :-1], mine[:, 1:])

    # LOCAL gradients: Adasum adapts from the ranks' gradient divergence.
    value_and_grad = hvd.local_value_and_grad(loss_fn)

    def step():
        loss, grads = value_and_grad(params)
        for name, p in params.items():
            p.grad = grads[name]
        hvd.adasum_delta_step(opt)
        return hvd.allreduce(loss, op=hvd.Average)

    return model, attn, step


def main(argv=None):
    args = parse_args(argv)
    _, attn, step = build(args)
    dev = hvd.device()
    losses_dev = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses_dev.append(step())
        if i == 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    losses = torch.stack(losses_dev).float().cpu().tolist() \
        if losses_dev else []
    batch = args.batch_per_slot * hvd.size()
    samples_s = batch * (args.steps - 2) / dt if args.steps > 2 else 0.0
    if hvd.rank() == 0:
        print(f"lm loss: {losses[0]:.4f} -> {losses[-1]:.4f}  "
              f"({samples_s:.1f} samples/sec, Adasum, attention={attn})")
    if args.steps > 3:
        assert losses[-1] < losses[0], "loss did not decrease"
    return losses, samples_s


if __name__ == "__main__":
    main(sys.argv[1:])
