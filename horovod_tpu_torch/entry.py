"""Entry points of the port's flagship model (ResNet-50).

Counterpart of ``__graft_entry__.py``: ``entry()`` gives the ResNet-50
forward step and example arguments, and ``dryrun_step()`` runs phase 1
of ``dryrun_multichip`` (one data-parallel training step with
synchronized batch norm and the metric allreduce) and
``dryrun_seqpar_step()`` its phase 2 (one Adam step of a tiny
transformer with ring attention on a dp × sp mesh) in whatever world
``hvd.init()`` formed.  Phases 3-5 there (MoE, pipeline, tensor
parallel) are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import create_resnet50
from horovod_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, init_gpt2_, lm_loss)
from horovod_tpu_torch.parallel import make_mesh
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


def dryrun_seqpar_step(device=None, state_dict=None):
    """Phase 2 of ``dryrun_multichip`` (``__graft_entry__.py:118-168``):
    one Adam(1e-3) step of a tiny causal transformer (vocab 128, 2
    layers, d_model 64, heads = sp, f32, ``seq_parallel='ring'`` over
    axis ``'sp'``) on a ``{"dp": dp, "sp": sp}`` mesh of the world (dp 2
    when the world's size is even, else 1), through
    ``DistributedOptimizer(reduce_axes=("dp", "sp"))``.  The batch is
    ``RandomState(2)``'s [2·dp, 8·sp] tokens: rank (i, j) takes rows
    [2i, 2i + 2) and the sequence shard [8j, 8j + 8), with its global
    positions, and its loss is the next-token loss within its shard.
    The weights are ``state_dict`` or random from seed 1, broadcast from
    rank 0.  Returns ``(loss averaged over the world, model)``."""
    hvd.init(device=device)
    dev, n, r = hvd.device(), hvd.size(), hvd.rank()
    dp = 2 if n % 2 == 0 else 1
    sp = n // dp
    mesh = make_mesh({"dp": dp, "sp": sp})
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=sp,
                            d_model=64, d_ff=128, max_len=64, causal=True,
                            dtype=torch.float32, seq_parallel="ring",
                            axis_name="sp")
    model = Transformer(cfg, device=dev)
    if state_dict is None:
        init_gpt2_(model, torch.Generator(device=dev).manual_seed(1))
    else:
        model.load_state_dict(state_dict)
    hvd.broadcast_parameters(model, root_rank=0)
    i, j = mesh.coords(r)
    toks = np.random.RandomState(2).randint(0, 128, (2 * dp, 8 * sp))
    tb = torch.as_tensor(toks[2 * i:2 * i + 2, 8 * j:8 * j + 8], device=dev)
    pos = torch.arange(8 * j, 8 * j + 8, device=dev)[None].repeat(2, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        reduce_axes=("dp", "sp"))
    opt.zero_grad()
    loss = lm_loss(model(tb, positions=pos)[:, :-1], tb[:, 1:])
    loss.backward()
    opt.step()
    loss = float(hvd.allreduce(loss.detach(), op=hvd.Average))
    if r == 0:
        print(f"dryrun_seqpar_step({n}): transformer dp={dp} x sp={sp} "
              f"ring-attention step OK, loss={loss:.4f}")
    return loss, model
