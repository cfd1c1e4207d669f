"""BERT pretraining with DistributedOptimizer + gradient accumulation.

Port of ``examples/bert_pretraining.py`` (BASELINE config 3, "BERT-large
pretraining, DistributedOptimizer + grad accumulation"): a masked-LM
objective on synthetic data made with numpy from ``RandomState(rank)``,
bf16 products (BERT's compute dtype) over f32 weights, AdamW with
optax's ``adamw`` defaults, and ``backward_passes_per_step``
accumulation.  Each rank runs ``--batch-per-slot`` sequences per
micro-batch; ``--steps`` counts micro-batches, as in the JAX example.

Run small on the CPU (a gloo world of one, or several under a launcher):
    python -m horovod_tpu_torch.examples.bert_pretraining --device cpu --size tiny
Run BERT-large on a card:
    python -m horovod_tpu_torch.examples.bert_pretraining --size large --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (BERT_BASE, BERT_LARGE, Transformer,
                                      TransformerConfig, lm_loss)
from horovod_tpu_torch.models.transformer import init_gpt2_

TINY = TransformerConfig(vocab_size=1024, num_layers=2, num_heads=8,
                         d_model=128, d_ff=256, max_len=128, causal=False,
                         dtype=torch.float32)

MASK_ID = 103  # [MASK] in the BERT vocab

def mlm_batch(rng, batch, seq_len, vocab, mask_rate=0.15):
    tokens = rng.randint(5, vocab, size=(batch, seq_len)).astype(np.int32)
    mask = rng.rand(batch, seq_len) < mask_rate
    inputs = tokens.copy()
    inputs[mask] = MASK_ID
    return inputs, tokens, mask.astype(np.float32)


def mlm_batch_fixed_positions(rng, batch, seq_len, vocab, num_positions):
    """Exactly ``num_positions`` masked slots per sequence (standard BERT
    max_predictions_per_seq).  Returns (inputs, positions [B,K], labels
    [B,K]); the LM head runs only at the gathered positions."""
    tokens = rng.randint(5, vocab, size=(batch, seq_len)).astype(np.int32)
    positions = np.stack([
        np.sort(rng.choice(seq_len, size=num_positions, replace=False))
        for _ in range(batch)]).astype(np.int32)
    labels = np.take_along_axis(tokens, positions, axis=1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, MASK_ID, axis=1)
    return inputs, positions, labels


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=["tiny", "base", "large"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-per-slot", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=2,
                    help="backward_passes_per_step (grad accumulation)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward pass "
                         "(torch.utils.checkpoint)")
    ap.add_argument("--attention", default="auto",
                    choices=["auto", "dense", "flash"],
                    help="'flash' = the CUDA kernels (fwd+bwd); 'auto' "
                         "picks flash on cuda, dense elsewhere")
    ap.add_argument("--mlm-positions", type=int, default=0,
                    help="if >0, generate exactly this many masked "
                         "positions per sequence and apply the LM head "
                         "only at them (standard BERT "
                         "max_predictions_per_seq)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (a gloo world)")
    return ap.parse_args(argv)


def build(args):
    """Join the world and build what one rank trains: returns the model,
    the attention it runs ("flash" or "dense"), and ``micro_batch()``,
    which runs one forward and backward pass and
    ``DistributedOptimizer.step()`` and returns the loss averaged over
    the world, on the device."""
    hvd.init(device=args.device)
    dev = hvd.device()
    attn = args.attention
    if attn == "auto":
        attn = "flash" if dev.type == "cuda" else "dense"
    attn_impl = "flash" if attn == "flash" else None
    if args.size == "tiny":
        cfg = dataclasses.replace(TINY, attention_impl=attn_impl)
    else:
        cfg = {"base": BERT_BASE, "large": BERT_LARGE}[args.size]
        cfg = dataclasses.replace(cfg, max_len=args.seq_len,
                                  remat=args.remat, attention_impl=attn_impl)
    model = init_gpt2_(Transformer(cfg, device=dev),
                       torch.Generator(device=dev).manual_seed(0))
    batch = args.batch_per_slot
    seq_len = min(args.seq_len, cfg.max_len)

    rng = np.random.RandomState(hvd.rank())
    if args.mlm_positions:
        inputs, targets, mask = mlm_batch_fixed_positions(
            rng, batch, seq_len, cfg.vocab_size, args.mlm_positions)
    else:
        inputs, targets, mask = mlm_batch(rng, batch, seq_len,
                                          cfg.vocab_size)
    inputs, targets, mask = (torch.as_tensor(a, device=dev)
                             for a in (inputs, targets, mask))
    hvd.broadcast_parameters(model, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        backward_passes_per_step=args.accum,
        compression=hvd.Compression.none)

    def micro_batch():
        opt.zero_grad()
        if args.mlm_positions:
            # targets = positions [B,K], mask = labels [B,K]
            logits = model(inputs, predict_positions=targets)
            loss = lm_loss(logits, mask)
        else:
            loss = lm_loss(model(inputs), targets, mask)
        loss.backward()
        opt.step()
        return hvd.allreduce(loss.detach(), op=hvd.Average)

    return model, attn, micro_batch


def main(argv=None):
    args = parse_args(argv)
    _, attn, micro_batch = build(args)
    dev = hvd.device()
    # Keep the losses on the device: one transfer at the end.
    losses_dev = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses_dev.append(micro_batch())
        if i == 1:
            _sync(dev)  # barrier after the first steps' warm-up
            t0 = time.perf_counter()
    _sync(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    losses = torch.stack(losses_dev).float().cpu().tolist() \
        if losses_dev else []
    samples_s = (args.batch_per_slot * hvd.size() * (args.steps - 2) / dt
                 if args.steps > 2 else 0.0)
    if hvd.rank() == 0:
        print(f"mlm loss: {losses[0]:.4f} -> {losses[-1]:.4f}  "
              f"({samples_s:.1f} samples/sec, accum={args.accum}, "
              f"attention={attn})")
    if args.steps > 3:
        assert losses[-1] < losses[0], "loss did not decrease"
    return losses, samples_s


if __name__ == "__main__":
    main(sys.argv[1:])
