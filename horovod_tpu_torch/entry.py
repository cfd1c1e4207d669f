"""Entry points of the port's flagship model (ResNet-50).

Counterpart of ``__graft_entry__.py``: ``entry()`` gives the ResNet-50
forward step and example arguments, and ``dryrun_step()`` runs phase 1
of ``dryrun_multichip`` (one data-parallel training step with
synchronized batch norm and the metric allreduce) and
``dryrun_seqpar_step()`` its phase 2 (one Adam step of a tiny
transformer with ring attention on a dp × sp mesh), and
``dryrun_moe_step()``, ``dryrun_pp_step()`` and ``dryrun_tp_step()``
its phases 3-5 (an expert-parallel MoE transformer on dp × ep, a GPipe
pipeline on dp × pp, a Megatron MLP on dp × tp), each in whatever world
``hvd.init()`` formed, with the JAX phases' sizes, seeds, optimizers and
``reduce_axes``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn import functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import create_resnet50
from horovod_tpu_torch.models.convert import shard_experts
from horovod_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, init_gpt2_, lm_loss)
from horovod_tpu_torch.parallel import make_mesh, sharded_axes
from horovod_tpu_torch.parallel.pipeline import (gpipe_spmd,
                                                 stack_stage_params)
from horovod_tpu_torch.parallel.tensor import (column_row_parallel_mlp,
                                               shard_columns, shard_rows)
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


def _factors():
    """(dp, n // dp) of the world, dp 2 when its size is even, as
    ``dryrun_multichip`` factors it."""
    n = hvd.size()
    dp = 2 if n % 2 == 0 else 1
    return dp, n // dp


def _report(what, loss):
    loss = float(hvd.allreduce(loss.detach(), op=hvd.Average))
    if hvd.rank() == 0:
        print(f"{what} OK, loss={loss:.4f}")
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
    dev, r = hvd.device(), hvd.rank()
    dp, sp = _factors()
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
    return _report(f"dryrun_seqpar_step({hvd.size()}): transformer dp={dp} "
                   f"x sp={sp} ring-attention step", loss), model


def dryrun_moe_step(device=None, state_dict=None):
    """Phase 3 of ``dryrun_multichip`` (``__graft_entry__.py:195``): one
    Adam(1e-3) step of a tiny causal MoE transformer (vocab 128, 2
    layers, 4 heads, d_model 64, d_ff 128, max_len 16, f32, 2·ep experts
    every 2nd block, capacity factor 4, ``expert_axis='ep'``) on a
    ``{"dp": dp, "ep": ep}`` mesh, through
    ``DistributedOptimizer(reduce_axes=("dp", "ep"))``: the expert
    weights' gradients summed over dp, the others over dp × ep, both
    divided by dp·ep.  The batch is ``RandomState(3)``'s [2·dp·ep, 16]
    tokens, rank (i, j) taking rows [2(i·ep + j), 2(i·ep + j) + 2); the
    loss is the next-token loss plus 0.01 × the aux loss.  The weights
    are ``state_dict`` (global, [E, ...] experts) or random from seed 2
    with the experts of the replicated model, rank 0's dense weights
    broadcast; each rank keeps its experts (``shard_experts``).
    Returns ``(loss averaged over the world, model)``."""
    hvd.init(device=device)
    dev, r = hvd.device(), hvd.rank()
    dp, ep = _factors()
    mesh = make_mesh({"dp": dp, "ep": ep})
    cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, max_len=16, causal=True,
                            dtype=torch.float32, moe_experts=2 * ep,
                            moe_capacity_factor=4.0)
    if state_dict is None:
        full = Transformer(cfg, device=dev)
        init_gpt2_(full, torch.Generator(device=dev).manual_seed(2))
        state_dict = full.state_dict()
        del full
    model = Transformer(dataclasses.replace(cfg, expert_axis="ep"),
                        device=dev)
    model.load_state_dict(shard_experts(state_dict, "ep", mesh=mesh))
    # The dense weights are one model's; each rank keeps its experts.
    dense = [p for p in model.parameters() if not sharded_axes(p)]
    for p in dense:
        hvd.broadcast_(p.data, root_rank=0)
    i, j = mesh.coords(r)
    row = 2 * (i * ep + j)
    toks = np.random.RandomState(3).randint(0, 128, (2 * dp * ep, 16))
    tb = torch.as_tensor(toks[row:row + 2], device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        reduce_axes=("dp", "ep"))
    opt.zero_grad()
    logits = model(tb)
    loss = lm_loss(logits[:, :-1], tb[:, 1:]) + 0.01 * sum(model.aux_losses)
    loss.backward()
    opt.step()
    return _report(f"dryrun_moe_step({hvd.size()}): MoE transformer "
                   f"dp={dp} x ep={ep} expert-parallel step", loss), model


def dryrun_pp_step(device=None):
    """Phase 4 of ``dryrun_multichip`` (``:242``): one SGD(0.05) step of
    a pp-stage pipeline (stage s: tanh(x @ W_s), W_s [8, 8] from
    ``RandomState(4)`` · 0.3) over M = 4 microbatches of [2, 8] on a
    ``{"dp": dp, "pp": pp}`` mesh, ``gpipe_spmd`` over ``pp``, the loss
    the mean squared error to the targets, through
    ``DistributedOptimizer(reduce_axes=("dp",))`` (each pp rank owns its
    stage).  Rank (i, j) holds stage j ([1, 8, 8]) and microbatches
    [4i, 4i + 4).  Returns ``(loss averaged over the world, this rank's
    stage after the step)``."""
    hvd.init(device=device)
    dev, r = hvd.device(), hvd.rank()
    dp, pp = _factors()
    mesh = make_mesh({"dp": dp, "pp": pp})
    d, M, mb = 8, 4, 2
    rng = np.random.RandomState(4)
    stages = stack_stage_params([torch.as_tensor(
        (rng.randn(d, d) * 0.3).astype(np.float32)) for _ in range(pp)])
    xs = (rng.randn(dp * M, mb, d)).astype(np.float32)
    tgt = (rng.randn(dp * M, mb, d)).astype(np.float32)
    i, j = mesh.coords(r)
    w = stages[j:j + 1].to(dev).requires_grad_()
    xb = torch.as_tensor(xs[M * i:M * i + M], device=dev)
    tb = torch.as_tensor(tgt[M * i:M * i + M], device=dev)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.05),
                                   reduce_axes=("dp",))
    opt.zero_grad()
    ys = gpipe_spmd(lambda p, x: torch.tanh(x @ p[0]), w, xb,
                    axis_name="pp")
    loss = torch.mean((ys - tb) ** 2)
    loss.backward()
    opt.step()
    return _report(f"dryrun_pp_step({hvd.size()}): pipeline dp={dp} x "
                   f"pp={pp} GPipe step", loss), w.detach()


def dryrun_tp_step(device=None):
    """Phase 5 of ``dryrun_multichip`` (``:279``): one SGD(0.05) step of
    ``column_row_parallel_mlp`` (d 8, f 8·tp; W1 [8, f], W2 [f, 8] from
    ``RandomState(5)`` · 0.3, split by ``shard_columns`` /
    ``shard_rows``) on a ``{"dp": dp, "tp": tp}`` mesh, the loss the mean
    squared error to the targets, through
    ``DistributedOptimizer(reduce_axes=("dp",))``.  Rank (i, j) holds
    shard j of each weight and rows [4i, 4i + 4) of the [4·dp, 8]
    batch.  Returns ``(loss averaged over the world, {"c": column
    shard [1, 8, 8], "r": row shard [1, 8, 8]} after the step)``."""
    hvd.init(device=device)
    dev, r = hvd.device(), hvd.rank()
    dp, tp = _factors()
    mesh = make_mesh({"dp": dp, "tp": tp})
    d, f = 8, 8 * tp
    rng = np.random.RandomState(5)
    w1 = torch.as_tensor((rng.randn(d, f) * 0.3).astype(np.float32))
    w2 = torch.as_tensor((rng.randn(f, d) * 0.3).astype(np.float32))
    xs = (rng.randn(4 * dp, d)).astype(np.float32)
    tgt = (rng.randn(4 * dp, d)).astype(np.float32)
    i, j = mesh.coords(r)
    params = {"c": shard_columns(w1, tp)[j][None].to(dev).requires_grad_(),
              "r": shard_rows(w2, tp)[j][None].to(dev).requires_grad_()}
    xb = torch.as_tensor(xs[4 * i:4 * i + 4], device=dev)
    tb = torch.as_tensor(tgt[4 * i:4 * i + 4], device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(params.values()), lr=0.05), reduce_axes=("dp",))
    opt.zero_grad()
    y = column_row_parallel_mlp(xb, params["c"][0], params["r"][0],
                                axis_name="tp")
    loss = torch.mean((y - tb) ** 2)
    loss.backward()
    opt.step()
    return _report(f"dryrun_tp_step({hvd.size()}): tensor-parallel dp={dp} "
                   f"x tp={tp} Megatron MLP step", loss), \
        {k: v.detach() for k, v in params.items()}
