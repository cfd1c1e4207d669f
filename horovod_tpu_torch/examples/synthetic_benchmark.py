"""Synthetic training benchmark: images/s of full training steps.

Port of ``examples/synthetic_benchmark.py`` (Horovod's headline harness,
``examples/pytorch/pytorch_synthetic_benchmark.py`` in the reference): a
standard model on synthetic data, every step through
``DistributedOptimizer``.  Each step runs the forward in train mode
(bf16 products, f32 batch-norm statistics synchronized over the world
unless ``--no-sync-bn``), an f32 softmax cross-entropy, the loss averaged
with ``hvd.allreduce`` as a metric, and SGD with momentum 0.9 (optax's
``sgd`` trace is torch's momentum buffer: no dampening, no Nesterov).
The global batch is made with numpy from seeds 0 (images) and 1 (labels),
and each rank trains on its ``--batch-size`` share; parameters and
batch-norm statistics are broadcast from rank 0 at start.

Run on a card:
    python -m horovod_tpu_torch.examples.synthetic_benchmark --model resnet50 --batch-size 128
Run small on the CPU (a gloo world of one, or several under a launcher):
    python -m horovod_tpu_torch.examples.synthetic_benchmark --device cpu --image-size 32 --batch-size 2 --num-warmup-batches 1 --num-iters 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.nn import functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet50, ResNet101, create_mlp
from horovod_tpu_torch.models.resnet import init_kernels_


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet101", "mlp"])
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-slot batch size")
    p.add_argument("--num-warmup-batches", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=30)
    p.add_argument("--no-sync-bn", action="store_true")
    p.add_argument("--fast-stem", action="store_true",
                   help="SpaceToDepthStem + max_pool_eq_grad (bench.py's "
                        "ResNet-50)")
    p.add_argument("--image-size", type=int, default=224,
                   help="ResNet input height and width")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (a gloo world)")
    return p.parse_args(argv)


def build(args):
    """Join the world and build what one rank trains: returns the model
    and ``step()``, which runs one training step and returns the loss
    averaged over the world, on the device."""
    hvd.init(device=args.device)
    dev = hvd.device()
    n, r, bs = hvd.size(), hvd.rank(), args.batch_size
    if args.model == "mlp":
        model = create_mlp((1024, 1024, 1000), device=dev, seed=0)
        images = np.random.RandomState(0).rand(bs * n, 784)
    else:
        cls = ResNet50 if args.model == "resnet50" else ResNet101
        model = init_kernels_(cls(
            num_classes=1000, dtype=torch.bfloat16,
            sync_bn=not args.no_sync_bn, s2d_stem=args.fast_stem,
            eq_pool_grad=args.fast_stem, device=dev),
            torch.Generator(device=dev).manual_seed(0))
        hw = args.image_size
        images = np.random.RandomState(0).rand(bs * n, hw, hw, 3)
    labels = np.random.RandomState(1).randint(0, 1000, size=(bs * n,))
    images = torch.as_tensor(images[r * bs:(r + 1) * bs].astype(np.float32),
                             device=dev)
    labels = torch.as_tensor(labels[r * bs:(r + 1) * bs], device=dev)
    has_bn = args.model != "mlp"
    hvd.broadcast_parameters(model, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))

    def step():
        opt.zero_grad()
        logits = model(images, train=True) if has_bn else model(images)
        loss = F.cross_entropy(logits.float(), labels)
        loss.backward()
        opt.step()
        return hvd.allreduce(loss.detach(), op=hvd.Average)

    return model, step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train and print images/s; returns the per-step losses and the
    images/s of the timed steps (0 when there are none)."""
    args = parse_args(argv)
    _, step = build(args)
    dev = hvd.device()
    losses_dev = [step() for _ in range(args.num_warmup_batches)]
    _sync(dev)
    t0 = time.perf_counter()
    losses_dev += [step() for _ in range(args.num_iters)]
    _sync(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    losses = torch.stack(losses_dev).float().cpu().tolist() \
        if losses_dev else []
    n = hvd.size()
    img_s = args.batch_size * n * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"Model: {args.model}, batch {args.batch_size}/slot, "
              f"{n} slot(s)")
        print(f"Img/sec total: {img_s:.1f}  (per slot: {img_s / n:.1f})")
    return losses, img_s


if __name__ == "__main__":
    main(sys.argv[1:])
