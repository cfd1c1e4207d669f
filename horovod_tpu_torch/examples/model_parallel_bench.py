"""Model parallelism over several cards, checked and timed: an
expert-parallel MoE GPT-2 small, a GPipe pipeline of GPT-2 small's
blocks, and a Megatron tensor-parallel MLP at GPT-2 small's widths.

Starts one process per card (``--nproc``, NCCL; ``--device cpu`` forms
a gloo world instead).  Weights are random from ``--seed``, the same on
every rank; tokens and activations come from ``RandomState(seed)``.

1. MoE: GPT-2 small (12 layers, 12 heads, d_model 768, d_ff 3072, vocab
   50257) with 8 experts, top 2, capacity factor 1.25, every 2nd block,
   flash attention, on a ``{"dp": n / 2, "ep": 2}`` mesh (dp 1 × ep 2 on
   2 cards, dp 2 × ep 2 on 4), each rank 4 × 1024 tokens of its own.
   First the check, in f32: each rank's logits from the expert-sharded
   model (4 experts a rank, ``shard_experts``) against the replicated
   model (all 8) on the rank's own tokens, at rtol = atol = 2e-3 (routing
   is local to a rank, so the two route alike).  Then bf16 training,
   ``AdamW`` through ``DistributedOptimizer(reduce_axes=("dp", "ep"))``,
   2 warm-up and 5 timed steps: tokens/s and step time (the slowest
   rank's), peak memory a rank, the flash kernels' launches, the
   dropped share and the aux loss, one traced step's NCCL time (the
   alltoalls' ``SendRecv`` kernels, the gradient allreduce's
   ``AllReduce``) beside its busy time, and one bucket alltoall alone.
2. Pipeline: GPT-2 small's 12 blocks as S = n stages (12 / n blocks a
   rank), M = 8 microbatches of [1, 1024, 768], flash attention,
   ``gpipe_spmd`` over the world.  The check, in f32: the outputs and
   each rank's stage gradients (of the mean square of the outputs)
   against the 12 blocks run in sequence on one rank, at 1e-4 / 1e-6
   (``tests/test_pipeline.py``).  Then bf16 training (local AdamW) with
   2 warm-up and 5 timed steps: step time, and the bubble's share,
   1 − (this rank's stage run alone: the same schedule and optimizer
   step on an axis of one, no hops) / (the pipelined step), beside the
   schedule's (S − 1) / (M + S − 1).
3. Tensor parallelism: ``column_row_parallel_mlp`` at x [4096, 768], f =
   3072 split over tp = n.  The check, in f32: the output and the
   gradients of sum(y) (this rank's column and row shards, x) against
   the dense MLP on one rank, at rtol 1e-4 / atol 1e-5
   (``tests/test_pipeline.py``) for y and x's gradient.  The weight
   gradients are sums over the T = 4096 tokens, which a shard's product
   adds in another order than the whole one's; their atol is that
   reordering's rounding, sqrt(T) · eps_f32 · max |g|.  Each tensor's
   error over tolerance is reported at both.  Then bf16, forward and
   backward, 10 runs: the time (the slowest rank's) and one traced
   run's ``AllReduce`` share of its wall time.

A failed check makes the script exit non-zero.  Rank 0 prints one
``{"model_parallel": ...}`` line with the card's name and power limit.
Run on n cards (n even):
    python -m horovod_tpu_torch.examples.model_parallel_bench --nproc 4
On the CPU (a gloo world, a tiny model, 32 tokens):
    python -m horovod_tpu_torch.examples.model_parallel_bench --nproc 4 --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples.seqpar_bench import (_length, _union,
                                                     card_tag, launch)
from horovod_tpu_torch.models import create_gpt2, lm_loss, shard_experts
from horovod_tpu_torch.parallel import flash as fl
from horovod_tpu_torch.parallel import make_mesh, pipeline, tensor

MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
           moe_every=2)
SMALL = dict(num_layers=4, num_heads=4, d_model=64, d_ff=128,
             vocab_size=97)
MOE_TOL = 2e-3             # sharded against replicated logits, f32
PIPE_TOL = (1e-4, 1e-6)    # rtol, atol
TP_TOL = (1e-4, 1e-5)
MICROBATCHES = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one card per rank) or cpu (gloo)")
    ap.add_argument("--small", action="store_true",
                    help="a tiny model and 32 tokens a sequence (a quick "
                         "rehearsal on the CPU)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    args.seq_len = 32 if args.small else 1024
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _gpt2(args, device, dtype, **kw):
    if args.small:
        kw = dict(SMALL, **kw)
    return create_gpt2("small", device=device, dtype=dtype,
                       attention_impl="flash", max_len=args.seq_len, **kw)


def _err_over_tol(got, want, rtol, atol) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _traced(device, fn, pattern: str):
    """Run ``fn`` under the profiler: (the union of the device spans of
    kernels whose name matches ``pattern``, of every kernel) in ms; None
    off the card."""
    if device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dist.barrier()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        _sync(device)
    cpu = torch.autograd.DeviceType.CPU
    hit, every = [], []
    for e in prof.events():
        if e.device_type == cpu:
            continue
        iv = (e.time_range.start, e.time_range.end)
        every.append(iv)
        if re.search(pattern, e.name):
            hit.append(iv)
    if not every:
        return None
    return {"matched_ms": _length(_union(hit)) / 1e3,
            "busy_ms": _length(_union(every)) / 1e3}


def _timed(device, fn, warmup: int, iters: int) -> float:
    """Mean wall ms of ``fn`` over ``iters`` runs after ``warmup``, the
    ranks started together."""
    for _ in range(warmup):
        fn()
    _sync(device)
    dist.barrier()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t) * 1e3 / iters


# -- 1. the MoE ---------------------------------------------------------------

def moe_part(args, device) -> dict:
    n, r = hvd.size(), hvd.rank()
    ep = 2 if n % 2 == 0 else 1
    dp = n // ep
    mesh = make_mesh({"dp": dp, "ep": ep})
    vocab = SMALL["vocab_size"] if args.small else 50257
    toks = np.random.RandomState(args.seed).randint(
        0, vocab, (4 * n, args.seq_len + 1))
    x = torch.as_tensor(toks[4 * r:4 * r + 4, :-1], device=device)
    y = torch.as_tensor(toks[4 * r:4 * r + 4, 1:], device=device)

    # The f32 check: expert-sharded against replicated, same weights.
    full = _gpt2(args, device, torch.float32, seed=args.seed, **MOE)
    state = full.state_dict()
    with torch.no_grad():
        want = full(x)
    del full
    sharded = _gpt2(args, device, torch.float32, seed=None,
                    expert_axis="ep", **MOE)
    sharded.load_state_dict(shard_experts(state, "ep"))
    with torch.no_grad():
        got = sharded(x)
    out = {"dp": dp, "ep": ep,
           "check_err_over_tol": _err_over_tol(got, want, MOE_TOL, MOE_TOL),
           "check_max_abs_err": float((got - want).abs().max())}
    del sharded, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()

    model = _gpt2(args, device, torch.bfloat16, seed=None,
                  expert_axis="ep", **MOE)
    model.load_state_dict(shard_experts(state, "ep"))
    del state
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4),
        reduce_axes=("dp", "ep"))

    def step():
        opt.zero_grad()
        loss = lm_loss(model(x), y) + 0.01 * sum(model.aux_losses)
        loss.backward()
        opt.step()
        return loss

    for _ in range(args.warmup):
        step()
    _sync(device)
    for counts in (fl.LAUNCHES, fl.LAUNCHES_BY_MODE):
        for name in counts:
            counts[name] = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    t = time.perf_counter()
    losses = [float(step().detach()) for _ in range(args.steps)]
    _sync(device)
    out["step_ms"] = (time.perf_counter() - t) * 1e3 / args.steps
    out["losses"] = losses
    out["flash_launches"] = {k: v for k, v in fl.LAUNCHES.items() if v}
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else None)
    out["dropped_frac"] = [float(f) for f in model.dropped_fracs]
    out["aux_loss"] = float(sum(model.aux_losses).detach())
    out["alltoalls_per_step"] = 4 * len(model.aux_losses) if ep > 1 else 0
    out["trace_sendrecv"] = _traced(device, step, r"SendRecv|AllToAll")
    out["trace_allreduce"] = _traced(device, step, r"AllReduce")
    # One bucket exchange alone: [n_ep, E_local, C, d] of bf16.
    cfg = model.cfg
    C = max(1, int(cfg.moe_capacity_factor * cfg.moe_top_k * x.numel()
                   / cfg.moe_experts))
    bucket = torch.randn(ep, cfg.moe_experts // ep, C, cfg.d_model,
                         device=device).to(torch.bfloat16)
    ps = mesh.axis("ep").process_set
    out["alltoall_bytes"] = bucket.numel() * bucket.element_size()
    out["alltoall_alone_ms"] = _timed(
        device, lambda: hvd.alltoall(bucket, process_set=ps), 3, 10) \
        if ep > 1 else 0.0
    del model, opt, bucket
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- 2. the pipeline ----------------------------------------------------------

def _stage_fn(blocks, v):
    for blk in blocks:
        v, _ = blk(v)
    return v


def pipeline_part(args, device) -> dict:
    n, r = hvd.size(), hvd.rank()
    make_mesh({"pp": n})
    make_mesh({"rank": n, "solo": 1})
    M = MICROBATCHES
    layers = SMALL["num_layers"] if args.small else 12
    if layers % n:
        raise SystemExit(f"{layers} blocks do not split over {n} stages")
    per = layers // n
    d = SMALL["d_model"] if args.small else 768
    rng = np.random.RandomState(args.seed + 1)
    xs = rng.randn(M, 1, args.seq_len, d).astype(np.float32)

    def stage(dtype):
        model = _gpt2(args, device, dtype, seed=args.seed)
        return model.blocks[r * per:(r + 1) * per], model.blocks

    # The f32 check: the pipeline against the blocks in sequence.
    mine, every = stage(torch.float32)
    xs32 = torch.as_tensor(xs, device=device)
    ys = pipeline.gpipe_spmd(_stage_fn, mine, xs32, axis_name="pp")
    ys.square().mean().backward()
    want = torch.stack([_stage_fn(every, xs32[m]) for m in range(M)])
    # The reference's own copies of this rank's blocks take its grads.
    ref = every[r * per:(r + 1) * per]
    ref_params = [p for p in ref.parameters()]
    want_g = torch.autograd.grad(want.square().mean(), ref_params)
    rt, at = PIPE_TOL
    out = {"stages": n, "microbatches": M, "blocks_per_stage": per,
           "schedule_bubble_share": (n - 1) / (M + n - 1),
           "check_err_over_tol": max(
               _err_over_tol(ys, want, rt, at),
               max(_err_over_tol(p.grad, g, rt, at)
                   for p, g in zip(mine.parameters(), want_g)))}
    del mine, every, ref, ref_params, want_g, ys, want
    if device.type == "cuda":
        torch.cuda.empty_cache()

    mine, _ = stage(torch.bfloat16)
    opt = torch.optim.AdamW(mine.parameters(), lr=1e-4, weight_decay=1e-4)
    xs16 = torch.as_tensor(xs, device=device).to(torch.bfloat16)

    def step():
        opt.zero_grad()
        ys = pipeline.gpipe_spmd(_stage_fn, mine, xs16, axis_name="pp")
        loss = ys.float().square().mean()
        loss.backward()
        opt.step()
        return loss

    def alone():
        # This stage's M microbatches through the same schedule on an
        # axis of one: its compute and the optimizer, no hops, no wait.
        opt.zero_grad()
        ys = pipeline.gpipe_spmd(_stage_fn, mine, xs16, axis_name="solo")
        ys.float().square().mean().backward()
        opt.step()

    out["step_ms"] = _timed(device, step, args.warmup, args.steps)
    out["stage_alone_ms"] = _timed(device, alone, 1, args.steps)
    out["bubble_share"] = 1.0 - out["stage_alone_ms"] / out["step_ms"]
    out["loss"] = float(step().detach())
    del mine, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- 3. the tensor-parallel MLP ----------------------------------------------------

def tensor_part(args, device) -> dict:
    n, r = hvd.size(), hvd.rank()
    make_mesh({"tp": n})
    T, d, f = (64, 64, 128) if args.small else (4096, 768, 3072)
    rng = np.random.RandomState(args.seed + 2)
    x = torch.as_tensor(rng.randn(T, d).astype(np.float32), device=device)
    w1 = torch.as_tensor((rng.randn(d, f) * 0.02).astype(np.float32),
                         device=device)
    w2 = torch.as_tensor((rng.randn(f, d) * 0.02).astype(np.float32),
                         device=device)

    def shards(dtype):
        return [t.to(dtype).requires_grad_() for t in
                (x, tensor.shard_columns(w1, n)[r].contiguous(),
                 tensor.shard_rows(w2, n)[r].contiguous())]

    # The f32 check against the dense MLP.
    xx, c, rw = shards(torch.float32)
    y = tensor.column_row_parallel_mlp(xx, c, rw, axis_name="tp")
    y.sum().backward()
    dx, dw1, dw2 = (t.detach().clone().requires_grad_() for t in (x, w1, w2))
    want = tensor.gelu(dx @ dw1) @ dw2
    want.sum().backward()
    rt, at = TP_TOL
    # The weight gradients sum T rows (|g| up to ~500 at full width) and
    # cuBLAS adds a shard's T-deep product in another order than the
    # whole one's: their atol is that reordering's rounding.
    eps = torch.finfo(torch.float32).eps
    check, gated = {}, []
    for k, got, ref, reordered in (
            ("y", y, want, False), ("x_grad", xx.grad, dx.grad, False),
            ("w_col_grad", c.grad, tensor.shard_columns(dw1.grad, n)[r],
             True),
            ("w_row_grad", rw.grad, tensor.shard_rows(dw2.grad, n)[r],
             True)):
        e = {"at_1e-5": _err_over_tol(got, ref, rt, at)}
        if reordered:
            e["atol"] = T ** 0.5 * eps * float(ref.abs().max())
            e["at_reorder_atol"] = _err_over_tol(got, ref, rt, e["atol"])
        check[k] = e
        gated.append(e["at_reorder_atol"] if reordered else e["at_1e-5"])
    out = {"tp": n, "check": check, "check_err_over_tol": max(gated)}

    xx, c, rw = shards(torch.bfloat16)

    def layer():
        y = tensor.column_row_parallel_mlp(xx, c, rw, axis_name="tp")
        torch.autograd.grad(y.float().sum(), (xx, c, rw))

    out["layer_ms"] = _timed(device, layer, 3, 10)
    out["trace_allreduce"] = _traced(device, layer, r"AllReduce")
    if out["trace_allreduce"] is not None:
        out["allreduce_share"] = out["trace_allreduce"]["matched_ms"] \
            / out["layer_ms"]
    return out


def rank_main(args) -> dict:
    hvd.init(device=args.device)
    try:
        device = (torch.device("cpu") if args.device == "cpu"
                  else torch.device("cuda", torch.cuda.current_device()))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"ranks": hvd.size(), "backend": dist.get_backend(),
               "moe": moe_part(args, device),
               "pipeline": pipeline_part(args, device),
               "tensor": tensor_part(args, device)}
        per_rank = [None] * hvd.size()
        dist.all_gather_object(per_rank, out)
        return per_rank
    finally:
        hvd.shutdown()


def summary(per_rank, args) -> dict:
    n = per_rank[0]["ranks"]
    moe = [p["moe"] for p in per_rank]
    step = max(m["step_ms"] for m in moe)
    pipe = [p["pipeline"] for p in per_rank]
    tp = [p["tensor"] for p in per_rank]
    return {
        "moe": {"dp": moe[0]["dp"], "ep": moe[0]["ep"],
                "tokens_per_step": 4 * args.seq_len * n,
                "step_ms": step,
                "tokens_per_s": 4 * args.seq_len * n / step * 1e3,
                "peak_mem_gib": [m["peak_mem_gib"] for m in moe],
                "alltoalls_per_step": moe[0]["alltoalls_per_step"],
                "sendrecv_ms": [m["trace_sendrecv"] and
                                m["trace_sendrecv"]["matched_ms"]
                                for m in moe],
                "allreduce_ms": [m["trace_allreduce"] and
                                 m["trace_allreduce"]["matched_ms"]
                                 for m in moe],
                "busy_ms": [m["trace_sendrecv"] and
                            m["trace_sendrecv"]["busy_ms"] for m in moe],
                "alltoall_alone_ms": max(m["alltoall_alone_ms"]
                                         for m in moe),
                "alltoall_bytes": moe[0]["alltoall_bytes"],
                "dropped_frac": [m["dropped_frac"] for m in moe],
                "aux_loss": [m["aux_loss"] for m in moe],
                "flash_launches": moe[0]["flash_launches"],
                "check_err_over_tol": max(m["check_err_over_tol"]
                                          for m in moe)},
        "pipeline": {"stages": n, "step_ms": max(p["step_ms"] for p in pipe),
                     "stage_alone_ms": [p["stage_alone_ms"] for p in pipe],
                     "bubble_share": [p["bubble_share"] for p in pipe],
                     "schedule_bubble_share":
                         pipe[0]["schedule_bubble_share"],
                     "check_err_over_tol": max(p["check_err_over_tol"]
                                               for p in pipe)},
        "tensor": {"tp": n, "layer_ms": max(t["layer_ms"] for t in tp),
                   "allreduce_share": [t.get("allreduce_share")
                                       for t in tp],
                   "check": [t["check"] for t in tp],
                   "check_err_over_tol": max(t["check_err_over_tol"]
                                             for t in tp)}}


def checks(per_rank) -> list:
    bad = []
    for r, p in enumerate(per_rank):
        for part in ("moe", "pipeline", "tensor"):
            e = p[part]["check_err_over_tol"]
            if not e <= 1.0:
                bad.append(f"{part} rank {r}: err/tol {e}")
        if not all(np.isfinite(p["moe"]["losses"])):
            bad.append(f"moe rank {r}: losses {p['moe']['losses']}")
        if not np.isfinite(p["pipeline"]["loss"]):
            bad.append(f"pipeline rank {r}: loss {p['pipeline']['loss']}")
    return bad


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if "HOROVOD_RANK" not in os.environ:
        return launch(args, argv,
                      "horovod_tpu_torch.examples.model_parallel_bench")
    per_rank = rank_main(args)
    bad = checks(per_rank)
    if os.environ["HOROVOD_RANK"] == "0":
        for b in bad:
            print(f"FAIL: {b}", file=sys.stderr, flush=True)
        print(json.dumps({"model_parallel": {
            "ok": not bad, "card": card_tag() if args.device != "cpu"
            else "cpu", "ranks": per_rank[0]["ranks"],
            "summary": summary(per_rank, args), "per_rank": per_rank}}),
            flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
