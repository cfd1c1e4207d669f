"""Adasum's two exchange paths over several ranks, checked and timed.

``ops/adasum.py`` reduces the whole world at a power-of-two size with a
butterfly (log2(n) rounds, each swapping the whole tensor with one
partner and combining the pair) and any other set with a gather of
every member's tensor and a local zero-padded tree.  Both build the
same tree in the same order.  This script runs both over the whole
world on one tensor per rank, checks them against a float64 model of
the tree, checks that every rank holds the same bits after the
butterfly, and times each path and a plain Sum allreduce of the same
tensor with CUDA events (the host clock on the CPU).

Rank r's tensor is an AR(1) chain, x_0 = n_0, x_r = 0.6·x_{r-1} +
0.8·n_r, made on the device from ``--seed``: neighbours are correlated,
so every coefficient of the tree lies far from 1 and a plain Sum fails
the check.  The default shape is GPT-2-medium's token embedding
[50257, 1024] in f32.

Run on n cards (this script starts one process per card):
    python -m horovod_tpu_torch.examples.adasum_bench --nproc 4
On the CPU (a gloo world):
    python -m horovod_tpu_torch.examples.adasum_bench --nproc 4 --device cpu --rows 97 --cols 32
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.adasum import _tree_reduce_gathered

RTOL = 1e-4          # JAX's tests/test_adasum.py:73
ATOL_OF_TOP = 1e-6   # atol: this times the model's largest magnitude
ITERS = 10           # timed calls of each path
TIMEOUT_S = 600      # for the whole world


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one card per rank) or cpu (gloo)")
    ap.add_argument("--rows", type=int, default=50257)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def float64_tree(stack):
    """The reference's pair combine (adasum.h:396-409) over a [n, ...]
    stack in float64, zero-padded to a power of two, pairs in rank
    order."""
    level = [t.double() for t in stack]
    while len(level) & (len(level) - 1):
        level.append(torch.zeros_like(level[0]))
    while len(level) > 1:
        nxt = []
        for a, b in zip(level[0::2], level[1::2]):
            dot, na, nb = (a * b).sum(), (a * a).sum(), (b * b).sum()
            nxt.append((1 - dot / (2 * na) if na > 0 else 1.0) * a
                       + (1 - dot / (2 * nb) if nb > 0 else 1.0) * b)
        level = nxt
    return level[0]


def _timed(fn, iters, device):
    """Mean milliseconds of ``fn()`` over ``iters`` calls after one
    warm-up, the world in step before the first."""
    fn()
    dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def rank_main(args) -> dict:
    hvd.init(device=args.device)
    try:
        r, n = hvd.rank(), hvd.size()
        device = (torch.device("cpu") if args.device == "cpu"
                  else torch.device("cuda", torch.cuda.current_device()))
        gen = torch.Generator(device=device).manual_seed(args.seed)
        shape = (args.rows, args.cols)
        x = torch.randn(shape, generator=gen, device=device)
        for _ in range(r):
            x.mul_(0.6).add_(torch.randn(shape, generator=gen,
                                         device=device), alpha=0.8)

        def gather(t):
            """Every rank's ``t``, stacked [n, ...] in rank order."""
            stack = t.new_empty(n * t.numel())
            dist.all_gather_into_tensor(stack, t.reshape(-1))
            return stack.view((n,) + shape)

        def gather_tree():
            return _tree_reduce_gathered(gather(x))

        butterfly = hvd.allreduce(x, op=hvd.Adasum)
        gathered = gather_tree()
        every = gather(butterfly)
        same_bits = all(torch.equal(every[i], butterfly) for i in range(n))
        stack = gather(x)
        want = float64_tree(stack)
        del stack, every
        atol = ATOL_OF_TOP * float(want.abs().max())

        def over_tol(got):
            return float(((got.double() - want).abs()
                          / (atol + RTOL * want.abs())).max())

        out = {"butterfly_err_over_tol": over_tol(butterfly),
               "gather_err_over_tol": over_tol(gathered),
               "sum_err_over_tol": over_tol(hvd.allreduce(x, op=hvd.Sum)),
               "butterfly_vs_gather_max_abs": float(
                   (butterfly - gathered).abs().max()),
               "same_bits_on_every_rank": same_bits}
        del want, butterfly, gathered
        times = {
            "butterfly_ms": _timed(lambda: hvd.allreduce(x, op=hvd.Adasum),
                                   ITERS, device),
            "gather_tree_ms": _timed(gather_tree, ITERS, device),
            "sum_allreduce_ms": _timed(lambda: hvd.allreduce(x, op=hvd.Sum),
                                       ITERS, device)}
        slowest = [None] * n
        dist.all_gather_object(slowest, times)
        out.update({k: max(t[k] for t in slowest) for k in times})
        out.update(ranks=n, shape=list(shape), dtype=str(x.dtype),
                   bytes_per_rank=x.numel() * x.element_size(),
                   backend=dist.get_backend())
        return out
    finally:
        hvd.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv) -> int:
    """Start ``--nproc`` ranks of this script and wait for them; rank 0
    prints the result."""
    port = _free_port()
    procs = []
    for r in range(args.nproc):
        env = dict(os.environ, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE=str(args.nproc), HOROVOD_LOCAL_RANK=str(r),
                   HOROVOD_LOCAL_SIZE=str(args.nproc),
                   HVD_TPU_COORDINATOR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.examples.adasum_bench"]
            + list(argv), env=env))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if all(c == 0 for c in codes) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if "HOROVOD_RANK" not in os.environ:
        return launch(args, argv)
    out = rank_main(args)
    ok = (out["butterfly_err_over_tol"] <= 1.0
          and out["gather_err_over_tol"] <= 1.0
          and out["sum_err_over_tol"] > 1.0
          and out["same_bits_on_every_rank"])
    if os.environ["HOROVOD_RANK"] == "0":
        print(json.dumps({"adasum_exchange": dict(out, ok=ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
