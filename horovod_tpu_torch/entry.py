"""Entry points of the port's flagship model (ResNet-50).

Counterpart of ``__graft_entry__.py``: ``entry()`` gives the ResNet-50
forward step and example arguments, and ``dryrun_step()`` runs phase 1
of ``dryrun_multichip`` (one data-parallel training step with
synchronized batch norm and the metric allreduce) in whatever world
``hvd.init()`` formed.  Phases 2-5 there (ring attention, MoE, pipeline,
tensor parallel) are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import create_resnet50
from horovod_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """``(forward, (model, x))``: ResNet-50 in bf16 with random weights
    from seed 0, in eval mode, and 8 NHWC 224x224x3 images from
    ``RandomState(0)``; ``forward(model, x)`` gives the f32 logits."""
    dev = resolve_device(device)
    model = create_resnet50(num_classes=1000, dtype=torch.bfloat16,
                            sync_bn=False, device=dev).eval()
    x = torch.as_tensor(np.random.RandomState(0).rand(8, 224, 224, 3)
                        .astype(np.float32), device=dev)

    def forward(model, x):
        return model(x, train=False)

    return forward, (model, x)


def dryrun_step(device=None) -> float:
    """One training step of ResNet-50 (10 classes, f32, synchronized batch
    norm) on 2 images of 32x32 per rank, SGD with momentum through
    ``DistributedOptimizer``, in the world ``hvd.init(device=device)``
    forms; returns the loss averaged over the world."""
    hvd.init(device=device)
    dev, n, r = hvd.device(), hvd.size(), hvd.rank()
    model = create_resnet50(num_classes=10, dtype=torch.float32,
                            sync_bn=True, device=dev)
    images = np.random.RandomState(0).rand(2 * n, 32, 32, 3)
    labels = np.random.RandomState(1).randint(0, 10, (2 * n,))
    xb = torch.as_tensor(images[2 * r:2 * r + 2].astype(np.float32),
                         device=dev)
    yb = torch.as_tensor(labels[2 * r:2 * r + 2], device=dev)
    hvd.broadcast_parameters(model, root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    opt.zero_grad()
    loss = F.cross_entropy(model(xb, train=True), yb)
    loss.backward()
    opt.step()
    loss = float(hvd.allreduce(loss.detach(), op=hvd.Average))
    if r == 0:
        print(f"dryrun_step({n}): ResNet dp step OK, loss={loss:.4f}")
    return loss
