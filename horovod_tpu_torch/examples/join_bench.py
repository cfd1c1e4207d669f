"""The negotiated eager engine over several ranks, checked and timed.

Starts one process per card (``--nproc``, NCCL; ``--device cpu`` forms a
gloo world instead) and runs four things through ``hvd``:

1. dispatch cost: a cached 4 KiB ``hvd.allreduce`` taken apart, per
   call on the host clock and on CUDA events (1000 calls of each part,
   in 5 rounds): the engine with a data plane that does nothing, the
   cached negotiation alone, the data plane alone, the engine around
   the data plane, the whole call and ``dist.all_reduce``; and the first, negotiated dispatch of a new
   signature (the mean over 20 new names);
2. a mismatch: one name with a rank-dependent shape, and one with a
   rank-dependent dtype; every rank must raise
   ``CollectiveRejectedError`` with the coordinator's verdict, within a
   few seconds and with no NCCL hang, and a matched allreduce under the
   same name must then succeed; then ``alltoall`` with rank-dependent
   splits, checked, timed beside the equal form, and run again while
   rank 0 has joined and replays it;
3. uneven data with ``join``: GPT-2 small at full width (12 layers,
   d 768, 12 heads, vocab 50257), bf16 products, causal flash
   attention, 4 × 1024 tokens, ``DistributedOptimizer(AdamW)`` with
   Average; rank r trains 3 + r steps, calls ``hvd.join()`` and then
   takes the last rank's parameters.  ``join()`` must return nproc - 1
   on every rank, the parameters bit-identical everywhere after that
   broadcast (which the broadcast alone ensures), the losses finite,
   and each rank's flash launches its own steps × 12 (each of the three
   kernels, on its wgmma route).  Then the same schedule on a small f32
   MLP (SGD), held to a float64 numpy model in which joined ranks add
   zeros and Average divides by the world's size: the check of the
   joined ranks' replay;
4. at 4 ranks: ``hierarchical_allreduce(local_size=2)`` at wte's shape
   [50257, 1024] f32 against a flat Sum allreduce, within the f32 bound
   of two summation orders, both timed.

Rank 0 prints one ``{"eager_multi": ...}`` line with the card's name and
power limit.  Run on n cards:
    python -m horovod_tpu_torch.examples.join_bench --nproc 4
On the CPU (a gloo world, small shapes):
    python -m horovod_tpu_torch.examples.join_bench --nproc 4 --device cpu --small
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.exceptions import CollectiveRejectedError

TIMEOUT_S = 900      # for the whole world
CACHED_CALLS = 1000  # timed cached dispatches
NEW_NAMES = 20       # timed negotiated dispatches
MLP_LR = 0.1


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one card per rank) or cpu (gloo)")
    ap.add_argument("--small", action="store_true",
                    help="small shapes (a quick rehearsal on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def card_tag() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else smi.stderr.strip()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed_rounds(device, parts, calls, rounds=5) -> dict:
    """Per-call host µs (and device ms on a card, CUDA events) of each
    part, the parts timed in turn in each of ``rounds`` rounds after 10
    warm-up calls each; the median round of each part."""
    for fn in parts.values():
        for _ in range(10):
            fn()
    _sync(device)
    per = calls // rounds
    got = {k: [] for k in parts}
    for _ in range(rounds):
        for label, fn in parts.items():
            dist.barrier()
            _sync(device)
            ev = None
            if device.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
            t = time.perf_counter()
            for _ in range(per):
                fn()
            host = time.perf_counter() - t
            if ev is not None:
                ev[1].record()
                ev[1].synchronize()
            got[label].append((host * 1e6 / per, ev[0].elapsed_time(ev[1])
                               / per if ev is not None else None))
    out = {}
    for label, rows in got.items():
        host = sorted(h for h, _ in rows)
        dev = sorted(d for _, d in rows if d is not None)
        out[label] = {"host_us_per_call": host[len(host) // 2],
                      "device_ms_per_call": dev[len(dev) // 2] if dev
                      else None}
    return out


def engine_cost(device, calls) -> dict:
    """A cached 4 KiB ``hvd.allreduce`` taken apart, each part per call
    (``_timed_rounds``):
    - ``engine_noop``: ``EagerEngine.run`` with a data plane that does
      nothing: the label, the name claim, the timeline test, and in a
      world of more than one rank the cached negotiation;
    - ``negotiate`` (world > 1): the cached negotiation alone: the
      response cache's lookup and the dispatch record (JSON, buffered,
      shipped by the flusher, inline every 256 records);
    - ``reduce``: the data plane alone (``ops._reduce``: the copy and the
      NCCL or gloo call);
    - ``engine_reduce``: ``EagerEngine.run`` around that data plane, the
      public op's own wrapper left out;
    - ``hvd_allreduce``: the whole call;
    - ``dist_all_reduce``: torch's in-place call on a tensor of zeros
      of the same size, the floor."""
    from horovod_tpu_torch import ops
    eng = hvd.core._state.engine
    x = torch.ones(1024, device=device)  # 4 KiB of f32
    z = torch.zeros(1024, device=device)
    m = ops.members_of(hvd.global_process_set)
    parts = {
        "engine_noop": lambda: eng.run("allreduce", lambda: None, [x],
                                       name="cost.noop",
                                       op_id=int(hvd.Sum)),
        "reduce": lambda: ops._reduce(x, ops.ReduceOp.SUM, 1.0, 1.0, m),
        "engine_reduce": lambda: eng.run(
            "allreduce", lambda: ops._reduce(x, ops.ReduceOp.SUM, 1.0, 1.0,
                                             m),
            [x], name="cost.engine_reduce", op_id=int(hvd.Sum)),
        "hvd_allreduce": lambda: hvd.allreduce(x, op=hvd.Sum,
                                               name="cost.4k"),
        "dist_all_reduce": lambda: dist.all_reduce(z)}
    if hvd.size() > 1:
        parts["negotiate"] = lambda: eng._negotiate(
            "allreduce", "cost.neg", [x], int(hvd.Sum), 1.0, 1.0, 0, None,
            None)
    return _timed_rounds(device, parts, calls)


def dispatch_cost(device, calls) -> dict:
    """The cached dispatch taken apart (``engine_cost``) and the host ms
    of a negotiated first dispatch of a new name."""
    x = torch.ones(1024, device=device)  # 4 KiB of f32
    out = {"per_call_4KiB": engine_cost(device, calls)}
    dist.barrier()
    times = []
    for i in range(NEW_NAMES):
        t = time.perf_counter()
        hvd.allreduce(x, op=hvd.Sum, name=f"bench.new.{i}")
        times.append(time.perf_counter() - t)
    _sync(device)
    out["negotiated_first_dispatch_ms"] = {
        "mean": float(np.mean(times) * 1e3),
        "median": float(np.median(times) * 1e3)}
    neg = hvd.core._state.engine.negotiator
    out["negotiated"], out["cached"] = neg.negotiated, neg.cached
    return out


def ragged_alltoall(device, calls) -> dict:
    """``alltoall`` with splits: rank r sends (r + i) % 3 + 1 rows of 256
    f32 to rank i, each row 1000·r + i.  Checked, timed per call beside
    the equal ``alltoall`` of as many rows, then run once more while
    rank 0 has joined: it replays both dispatches, sending no rows and
    taking the live ranks' rows."""
    r, n = hvd.rank(), hvd.size()
    cols = 256
    send = [(r + i) % 3 + 1 for i in range(n)]
    x = torch.cat([torch.full((k, cols), float(1000 * r + i), device=device)
                   for i, k in enumerate(send)])
    even = torch.ones(n * 2, cols, device=device)

    def want(live):
        rows = [(src + r) % 3 + 1 if src in live else 0 for src in range(n)]
        return torch.cat([torch.full((k, cols), float(1000 * src + r),
                                     device=device)
                          for src, k in enumerate(rows)]), rows

    out, recv = hvd.alltoall(x, splits=send)
    w, rows = want(range(n))
    bad = [] if torch.equal(out, w) and recv.tolist() == rows else \
        ["ragged alltoall over the world"]
    res = _timed_rounds(device, {
        "alltoall_splits": lambda: hvd.alltoall(x, splits=send),
        "alltoall_equal": lambda: hvd.alltoall(even)}, calls)
    if r == 0:
        last = hvd.join()
    else:
        out, recv = hvd.alltoall(x, splits=send)
        w, rows = want(range(1, n))
        if not (torch.equal(out, w) and recv.tolist() == rows):
            bad.append("ragged alltoall with rank 0 joined")
        last = hvd.join()
    if last == 0:
        bad.append(f"join() returned {last}")
    res["failures"] = bad
    return res


def mismatch(device) -> dict:
    """A rank-dependent shape and a rank-dependent dtype under one name:
    every rank gets the verdict, then a matched call succeeds."""
    r = hvd.rank()
    out = {}
    for case, t in (("shape", torch.ones(4 + r, device=device)),
                    ("dtype", torch.ones(4, device=device, dtype=(
                        torch.float32 if r == 0 else torch.float16)))):
        t0 = time.perf_counter()
        try:
            hvd.allreduce(t, name=f"mismatch.{case}")
            verdict = None
        except CollectiveRejectedError as e:
            verdict = str(e)
        sec = time.perf_counter() - t0
        ok = hvd.allreduce(torch.full((4,), 1.0, device=device), op=hvd.Sum,
                           name=f"mismatch.{case}")
        _sync(device)
        out[case] = {"verdict": verdict, "seconds": sec,
                     "matched_after": float(ok[0].cpu())}
    return out


def _param_digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def gpt2_uneven(args, device) -> dict:
    """Rank r takes 3 + r steps of GPT-2 small, then joins."""
    from horovod_tpu_torch.models import create_gpt2, lm_loss
    from horovod_tpu_torch.parallel import flash as fl
    r = hvd.rank()
    kw = dict(attention_impl="flash", dtype=torch.bfloat16)
    B, S = 4, 1024
    if args.small or device.type == "cpu":
        kw.update(num_layers=2, num_heads=2, d_model=32, d_ff=64,
                  vocab_size=97, max_len=64, dtype=torch.float32)
        B, S = 2, 64
    model = create_gpt2("small", device=device, seed=9, **kw)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4), op=hvd.Average)
    g = np.random.RandomState(args.seed + 4 + 100 * r)
    for name in fl.LAUNCHES:
        fl.LAUNCHES[name] = 0
    eng = hvd.core._state.engine
    d0 = eng.dispatches
    losses = []
    t = time.perf_counter()
    for _ in range(3 + r):
        tokens = torch.as_tensor(g.randint(0, model.cfg.vocab_size, (B, S)),
                                 device=device)
        opt.zero_grad()
        loss = lm_loss(model(tokens)[:, :-1], tokens[:, 1:])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    _sync(device)
    train_s = time.perf_counter() - t
    dispatches = eng.dispatches - d0
    launches = dict(fl.LAUNCHES)
    t = time.perf_counter()
    last = hvd.join()
    _sync(device)
    join_s = time.perf_counter() - t
    hvd.broadcast_parameters(model, root_rank=last)
    _sync(device)
    digests = hvd.allgather_object(_param_digest(model))
    steps = 3 + r
    # Each kernel once per layer and step, on the route of the model's
    # compute type; the plain versions on the CPU launch nothing.
    route = "_tf32x3" if model.cfg.dtype == torch.float32 else "_wgmma"
    n = steps * model.cfg.num_layers if device.type == "cuda" else 0
    want = {k: (n if k.endswith(route)
                or not k.endswith(("_wgmma", "_tf32x3")) else 0)
            for k in launches}
    return {"steps": steps, "losses": losses, "last": last,
            "params_bit_identical": len(set(digests)) == 1,
            "flash_launches": launches, "flash_launches_want": want,
            "dispatches_per_step": dispatches / steps,
            "train_ms_per_step": train_s * 1e3 / steps,
            "join_ms": join_s * 1e3}


def _mlp_init(seed):
    g = np.random.RandomState(seed + 11)
    return {"0.weight": (0.5 * g.randn(16, 8)).astype(np.float32),
            "0.bias": (0.1 * g.randn(16)).astype(np.float32),
            "2.weight": (0.5 * g.randn(4, 16)).astype(np.float32),
            "2.bias": (0.1 * g.randn(4)).astype(np.float32)}


def _mlp_batch(seed, r, s):
    g = np.random.RandomState(seed + 1000 * r + s)
    return g.randn(8, 8).astype(np.float32), g.randn(8, 4).astype(np.float32)


def _mlp_model(seed, n) -> dict:
    """Float64 SGD on the uneven schedule: rank r's gradients count in
    steps s < 3 + r; the others add zeros; Average divides by n."""
    p = {k: v.astype(np.float64) for k, v in _mlp_init(seed).items()}
    for s in range(3 + n - 1):
        total = {k: np.zeros_like(v) for k, v in p.items()}
        for r in range(n):
            if s >= 3 + r:
                continue
            x, y = (a.astype(np.float64) for a in _mlp_batch(seed, r, s))
            h = np.tanh(x @ p["0.weight"].T + p["0.bias"])
            o = h @ p["2.weight"].T + p["2.bias"]
            d_o = 2.0 * (o - y) / o.size
            d_h = (d_o @ p["2.weight"]) * (1.0 - h ** 2)
            for k, gk in (("2.weight", d_o.T @ h), ("2.bias", d_o.sum(0)),
                          ("0.weight", d_h.T @ x), ("0.bias", d_h.sum(0))):
                total[k] += gk
        p = {k: v - MLP_LR * total[k] / n for k, v in p.items()}
    return p


def mlp_uneven(args, device) -> dict:
    r, n = hvd.rank(), hvd.size()
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4)).to(device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _mlp_init(args.seed).items()})
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=MLP_LR),
                                   op=hvd.Average)
    for s in range(3 + r):
        x, y = (torch.from_numpy(a).to(device)
                for a in _mlp_batch(args.seed, r, s))
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
    last = hvd.join()
    hvd.broadcast_parameters(model, root_rank=last)
    want = _mlp_model(args.seed, n)
    got = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    err = max(float(np.max(np.abs(got[k] - want[k])
                           / (1e-6 + 1e-5 * np.abs(want[k]))))
              for k in want)
    digests = hvd.allgather_object(_param_digest(model))
    return {"last": last, "err_over_tol": err,
            "params_bit_identical": len(set(digests)) == 1}


def hierarchical(args, device) -> dict:
    """hierarchical_allreduce(local_size=2) against the flat Sum."""
    r = hvd.rank()
    shape = (97, 32) if args.small else (50257, 1024)
    gen = torch.Generator(device=device).manual_seed(args.seed + r)
    x = torch.randn(shape, generator=gen, device=device)
    two = hvd.hierarchical_allreduce(x, op=hvd.Sum, local_size=2)
    flat = hvd.allreduce(x, op=hvd.Sum)
    absum = hvd.allreduce(x.abs(), op=hvd.Sum)
    # Two summation orders of n terms each differ by at most
    # 2·(n-1)·u·Σ|x| (u = 2^-24), elementwise.
    bound = 2 * (hvd.size() - 1) * 2.0 ** -24 * absum
    err = float(((two - flat).abs() / (bound + 1e-30)).max())

    def timed(fn, iters=10):
        fn()
        _sync(device)
        dist.barrier()
        if device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
            ev[0].record()
            for _ in range(iters):
                fn()
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / iters
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters

    ms = {"hierarchical_ms": timed(lambda: hvd.hierarchical_allreduce(
              x, op=hvd.Sum, local_size=2)),
          "flat_sum_ms": timed(lambda: hvd.allreduce(x, op=hvd.Sum))}
    slowest = [None] * hvd.size()
    dist.all_gather_object(slowest, ms)
    out = {k: max(t[k] for t in slowest) for k in ms}
    out.update(shape=list(shape), err_over_bound=err,
               max_abs_diff=float((two - flat).abs().max()))
    return out


def rank_main(args) -> dict:
    hvd.init(device=args.device)
    try:
        device = (torch.device("cpu") if args.device == "cpu"
                  else torch.device("cuda", torch.cuda.current_device()))
        calls = 100 if args.small else CACHED_CALLS
        out = {"ranks": hvd.size(), "backend": dist.get_backend(),
               "dispatch": dispatch_cost(device, calls),
               "mismatch": mismatch(device),
               "ragged_alltoall": ragged_alltoall(device, calls // 10)}
        gpt2 = gpt2_uneven(args, device)
        per_rank = [None] * hvd.size()
        dist.all_gather_object(per_rank, gpt2)
        out["gpt2_uneven"] = per_rank
        out["mlp_uneven"] = mlp_uneven(args, device)
        out["hierarchical"] = hierarchical(args, device) \
            if hvd.size() == 4 else None
        return out
    finally:
        hvd.shutdown()


def checks(out) -> list:
    """The failures of one rank's result (empty when every check holds)."""
    n = out["ranks"]
    bad = []
    for case, m in out["mismatch"].items():
        if not (m["verdict"] and "Mismatched" in m["verdict"]
                and m["seconds"] < 10 and m["matched_after"] == n):
            bad.append(f"mismatch {case}: {m}")
    for g in out["gpt2_uneven"]:
        if g["last"] != n - 1 or not g["params_bit_identical"] or \
                not all(np.isfinite(g["losses"])) or \
                g["flash_launches"] != g["flash_launches_want"]:
            bad.append(f"gpt2 uneven rank with {g['steps']} steps: last "
                       f"{g['last']}, identical "
                       f"{g['params_bit_identical']}, losses "
                       f"{g['losses']}, launches {g['flash_launches']} "
                       f"(want {g['flash_launches_want']})")
    bad += [f"{f}: {out['ragged_alltoall']}"
            for f in out["ragged_alltoall"]["failures"]]
    mlp = out["mlp_uneven"]
    if mlp["last"] != n - 1 or mlp["err_over_tol"] > 1 or \
            not mlp["params_bit_identical"]:
        bad.append(f"mlp uneven: {mlp}")
    hier = out["hierarchical"]
    if hier is not None and hier["err_over_bound"] > 1:
        bad.append(f"hierarchical: {hier}")
    return bad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv) -> int:
    """Build the kernels once, start ``--nproc`` ranks of this script and
    wait for them; rank 0 prints the result."""
    if args.device != "cpu":
        from horovod_tpu_torch.csrc import build
        build.build()
    # A SIGTERM (a time limit) still stops the ranks below.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    port = _free_port()
    procs = []
    for r in range(args.nproc):
        env = dict(os.environ, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE=str(args.nproc), HOROVOD_LOCAL_RANK=str(r),
                   HOROVOD_LOCAL_SIZE=str(args.nproc),
                   HVD_TPU_COORDINATOR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.examples.join_bench"]
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
    bad = checks(out)
    if os.environ["HOROVOD_RANK"] == "0":
        for b in bad:
            print(f"FAIL: {b}", file=sys.stderr, flush=True)
        out.update(ok=not bad, card=card_tag() if args.device != "cpu"
                   else "cpu")
        print(json.dumps({"eager_multi": out}), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
