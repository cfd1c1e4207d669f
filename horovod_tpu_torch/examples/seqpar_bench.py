"""Sequence parallelism over several cards, checked and timed: GPT-2
small at full width with a long context.

Starts one process per card (``--nproc``, NCCL; ``--device cpu`` forms
a gloo world instead) and trains GPT-2 small (12 layers, 12 heads,
d_model 768, d_ff 3072, vocab 50257, ``max_len`` 8192) on one global
sequence of 8192 tokens a step, each rank holding its S/n tokens, in
four modes: ``ring`` (ring attention, the overlap schedule),
``ring_serial`` (the serial schedule), ``ring_striped`` (the striped
layout) and ``ulysses``; flash attention throughout.  The weights are
random from ``--seed``, the same on every rank; the tokens come from
``RandomState(seed)``.

For each mode (every mode's check runs first, and the unsharded
references are freed before any training, so the peak memory printed is
the training's own):

1. the check, in f32: each rank's logits of its shard, the loss
   (the mean over the ranks of each shard's mean next-token loss) and
   every parameter's gradient (averaged over the ranks) are held
   against the same model unsharded on the same card, with
   ``flash_attention`` over all 8192 tokens, at rtol = atol = 2e-3 (the
   JAX package's ring flash transformer tolerance,
   ``tests/test_sequence_parallel.py:253``); then the same in bf16
   against the unsharded bf16 model (the wgmma kernels over all 8192
   tokens): the logits and the loss held at the flash kernels' bf16
   rtol 2^-6 with an atol of 2^-6 of the largest |logit| (a head
   exchange that puts heads in the wrong place misses it by ~50×); the
   gradients reported at that tolerance, not held: each rank rounds its
   bf16 weight gradients before the f32 average, where the unsharded
   model rounds the whole sum once, so they differ by more than the
   kernels do;
2. training in bf16 (``AdamW`` through ``DistributedOptimizer``): 2
   warm-up and 5 timed steps; the first step's loss is held to the f32
   loss at the flash bf16 tolerance (rtol 0.1, atol 0.05).  Printed:
   tokens/s and step time (the slowest rank's), peak memory per rank,
   the ring's hop-kernel launches a layer by mask mode and rank (a
   layer's forward: contiguous causal must give n(n+1)/2 over the ranks
   under the overlap schedule, n² under the serial one), the flash
   kernels' launches by route, K/V rotations a layer (n - 1 against n),
   and one traced step's device time split into the flash kernels,
   NCCL ``SendRecv`` (the rotations, Ulysses' all-to-alls) and the time
   the two overlap, beside the busy time;
3. one attention layer alone (bf16 q/k/v of the model's shapes, forward
   and backward, 10 runs): its wall time (the slowest rank's) and a
   traced run's split as above, the schedule's effect without the rest
   of the step.

Before the modes, every rank times the unsharded bf16 step at the same
8192 tokens on its own card (local ``AdamW``), the single-card yardstick.

Rank 0 prints one ``{"seqpar": ...}`` line with the card's name and
power limit.  Run on n cards:
    python -m horovod_tpu_torch.examples.seqpar_bench --nproc 4
On the CPU (a gloo world, a tiny model, 128 tokens):
    python -m horovod_tpu_torch.examples.seqpar_bench --nproc 4 --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import create_gpt2, lm_loss
from horovod_tpu_torch.parallel import flash as fl
from horovod_tpu_torch.parallel import ring

TIMEOUT_S = 1500     # for the whole world
MODES = {"ring": ("ring", "overlap"), "ring_serial": ("ring", "serial"),
         "ring_striped": ("ring_striped", "overlap"),
         "ulysses": ("ulysses", "overlap")}
TOL = 2e-3           # f32: the sharded model against the unsharded one
BF16_CHECK_TOL = 2**-6   # bf16: rtol, and atol as a share of max |want|
BF16_TOL = (0.1, 0.05)   # the first bf16 training loss against the f32 one
FLASH_KERNEL = re.compile(r"tf32x3_kernel|flash_fwd_kernel|\bdq_kernel|"
                          r"\bdkv_kernel")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one card per rank) or cpu (gloo)")
    ap.add_argument("--small", action="store_true",
                    help="a tiny model and 128 tokens (a quick rehearsal "
                         "on the CPU)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="tokens a step (default 8192; 128 with --small)")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.seq_len is None:
        args.seq_len = 128 if args.small else 8192
    return args


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


def make_model(args, device, dtype, mode=None):
    """GPT-2 small (or the tiny model of ``--small``) with flash
    attention, random from ``--seed`` and broadcast from rank 0."""
    sp, sched = MODES[mode] if mode else (None, "overlap")
    kw = dict(max_len=args.seq_len)
    if args.small:
        kw.update(num_layers=2, num_heads=4, d_model=64, d_ff=128,
                  vocab_size=97)
    model = create_gpt2("small", device=device, seed=args.seed,
                        attention_impl="flash", dtype=dtype,
                        seq_parallel=sp, ring_schedule=sched, **kw)
    hvd.broadcast_parameters(model, root_rank=0)
    return model


def shard(x, mode):
    """This rank's part of a [B, S, ...] sequence in ``mode``'s
    layout."""
    n, r = hvd.size(), hvd.rank()
    if MODES[mode][0] == "ring_striped":
        x = ring.stripe_sequence(x, n)
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def err_over_tol(got, want, dtype=torch.float32) -> float:
    """max |got - want| / tol: f32 rtol = atol = ``TOL``; bf16 rtol
    ``BF16_CHECK_TOL``, atol that share of max |want|."""
    got, want = got.detach().float(), want.detach().float()
    if dtype == torch.bfloat16:
        rtol = BF16_CHECK_TOL
        atol = BF16_CHECK_TOL * float(want.abs().max())
    else:
        rtol = atol = TOL
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def reference(args, device, inputs, targets, dtype) -> dict:
    """The unsharded model in ``dtype`` over the whole sequence: logits,
    loss, gradients."""
    model = make_model(args, device, dtype)
    logits = model(inputs)
    loss = lm_loss(logits, targets)
    loss.backward()
    out = {"logits": logits.detach(), "loss": loss.detach(),
           "grads": [p.grad.detach().clone() for p in model.parameters()]}
    del model
    return out


def check(args, device, mode, inputs, targets, ref, dtype) -> dict:
    """The sharded model in ``dtype`` against the unsharded one (module
    docstring, 1); the bf16 keys start with ``bf16_``."""
    model = make_model(args, device, dtype, mode)
    logits = model(shard(inputs, mode))
    loss = lm_loss(logits, shard(targets, mode))
    loss.backward()
    grads = hvd.grouped_allreduce([p.grad for p in model.parameters()],
                                  op=hvd.Average)
    loss = hvd.allreduce(loss.detach(), op=hvd.Average)
    want = shard(ref["logits"], mode)
    logits = logits.detach()
    out = {"logits_err_over_tol": err_over_tol(logits, want, dtype),
           "logits_max_abs_err": float((logits - want).abs().max()),
           "loss": float(loss), "loss_unsharded": float(ref["loss"]),
           "loss_err_over_tol": err_over_tol(loss, ref["loss"], dtype),
           "grads_err_over_tol": max(err_over_tol(g, w, dtype) for g, w in
                                     zip(grads, ref["grads"])),
           "grads_max_abs_err": max(float((g - w).abs().max())
                                    for g, w in zip(grads, ref["grads"]))}
    del model, logits, grads
    if dtype == torch.bfloat16:
        out = {"bf16_" + k: v for k, v in out.items()}
    return out


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(ivs) -> float:
    return sum(e - s for s, e in ivs)


def _intersection(a, b) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_split(prof) -> dict:
    """A traced step's device time (ms): the union of the flash kernels'
    spans, of NCCL ``SendRecv``'s, the time both run at once, and the
    union of every kernel (busy).  None when the trace has no device
    event."""
    cpu = torch.autograd.DeviceType.CPU
    flash, nccl, every = [], [], []
    for e in prof.events():
        if e.device_type == cpu:
            continue
        iv = (e.time_range.start, e.time_range.end)
        every.append(iv)
        if FLASH_KERNEL.search(e.name):
            flash.append(iv)
        elif "SendRecv" in e.name:
            nccl.append(iv)
    if not every:
        return None
    f, c = _union(flash), _union(nccl)
    both = _intersection(f, c)
    return {"flash_ms": _length(f) / 1e3, "sendrecv_ms": _length(c) / 1e3,
            "overlap_ms": both / 1e3,
            "sendrecv_hidden_share": both / _length(c) if c else None,
            "busy_ms": _length(_union(every)) / 1e3}


def single_card_step(args, device, inputs, targets) -> dict:
    """The unsharded bf16 step over the whole sequence on this rank's
    card, local AdamW, no communication."""
    model = make_model(args, device, torch.bfloat16)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def step():
        opt.zero_grad()
        loss = lm_loss(model(inputs), targets)
        loss.backward()
        opt.step()
        return loss

    for _ in range(args.warmup):
        step()
    _sync(device)
    t = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    _sync(device)
    ms = (time.perf_counter() - t) * 1e3 / args.steps
    del model, opt
    return {"step_ms": ms, "tokens_per_s": args.seq_len / ms * 1e3,
            "loss": float(loss.detach())}


def layer_timing(args, device, mode, heads, head_dim, iters=10) -> dict:
    """One attention layer alone, forward and backward, in ``mode`` on
    bf16 q/k/v [1, S/n, heads, head_dim] (the model's shapes): the
    wall time a layer (the slowest rank's is what the model pays) and a
    traced run's device split, so the ring's schedule is seen without
    the rest of the step."""
    from horovod_tpu_torch.parallel.flash import flash_attention
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention
    sp, sched = MODES[mode]
    shape = (1, args.seq_len // hvd.size(), heads, head_dim)
    gen = torch.Generator(device=device).manual_seed(args.seed + hvd.rank())
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def layer():
        if sp == "ulysses":
            out = ulysses_attention(
                q, k, v, causal=True,
                attention_fn=lambda a, b, c, causal, scale: flash_attention(
                    a, b, c, causal=causal, scale=scale))
        else:
            out = ring.ring_flash_attention(
                q, k, v, causal=True, striped=sp == "ring_striped",
                schedule=sched)
        torch.autograd.grad(out, (q, k, v), do)

    for _ in range(3):
        layer()
    _sync(device)
    dist.barrier()
    t = time.perf_counter()
    for _ in range(iters):
        layer()
    _sync(device)
    out = {"ms": (time.perf_counter() - t) * 1e3 / iters, "trace": None}
    if device.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        dist.barrier()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                layer()
            _sync(device)
        out["trace"] = device_split(prof)
    return out


def train(args, device, mode, inputs, targets, loss_f32) -> dict:
    """bf16 training of the sharded model (module docstring, 2)."""
    model = make_model(args, device, torch.bfloat16, mode)
    layers = model.cfg.num_layers
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    x, y = shard(inputs, mode), shard(targets, mode)
    calls = []

    def step():
        opt.zero_grad()
        loss = lm_loss(model(x), y)
        loss.backward()
        opt.step()
        return loss

    first = float(hvd.allreduce(step().detach(), op=hvd.Average))
    for _ in range(args.warmup - 1):
        step()
    _sync(device)
    for counts in (fl.LAUNCHES, fl.LAUNCHES_BY_MODE):
        for name in counts:
            counts[name] = 0
    ring.ROTATIONS.update(forward=0, backward=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ring.set_ring_kernel_callback(calls.append)
    dist.barrier()
    t = time.perf_counter()
    losses = [float(step().detach()) for _ in range(args.steps)]
    _sync(device)
    ms = (time.perf_counter() - t) * 1e3 / args.steps
    ring.set_ring_kernel_callback(None)
    per_layer = layers * args.steps
    out = {"step_ms": ms, "losses": losses, "first_loss": first,
           "first_loss_f32": loss_f32,
           "hop_launches_per_layer": {
               str(m): calls.count(m) / per_layer for m in sorted(set(calls))},
           "hop_launches_per_layer_total": len(calls) / per_layer,
           "rotations_per_layer": ring.ROTATIONS["forward"] / per_layer,
           "inverse_rotations_per_layer":
               ring.ROTATIONS["backward"] / per_layer,
           "flash_launches": {k: v for k, v in fl.LAUNCHES.items() if v},
           # The wrappers' own counts of the hop kernels (the f32 route),
           # a layer by mask mode; 0 on the CPU, where nothing launches.
           "hop_kernel_launches_per_layer": {
               m: fl.LAUNCHES_BY_MODE[f"flash_fwd_tf32x3_{m}"] / per_layer
               for m in fl.MODE_NAMES},
           "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
           "trace": None}
    if device.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        dist.barrier()
        with torch.profiler.profile(activities=acts) as prof:
            step()
            _sync(device)
        out["trace"] = device_split(prof)
    del model, opt
    return out


def rank_main(args) -> dict:
    hvd.init(device=args.device)
    try:
        device = (torch.device("cpu") if args.device == "cpu"
                  else torch.device("cuda", torch.cuda.current_device()))
        torch.backends.cuda.matmul.allow_tf32 = False
        n = hvd.size()
        probe = make_model(args, device, torch.float32)
        vocab, layers = probe.cfg.vocab_size, probe.cfg.num_layers
        heads, head_dim = probe.cfg.num_heads, probe.cfg.head_dim
        del probe
        toks = np.random.RandomState(args.seed).randint(
            0, vocab, (1, args.seq_len + 1))
        inputs = torch.as_tensor(toks[:, :-1], device=device)
        targets = torch.as_tensor(toks[:, 1:], device=device)
        out = {"ranks": n, "backend": dist.get_backend(),
               "tokens_per_step": args.seq_len, "layers": layers,
               "single_card": single_card_step(args, device, inputs,
                                               targets),
               "modes": {}}
        modes = args.modes.split(",")
        ref = reference(args, device, inputs, targets, torch.float32)
        ref16 = reference(args, device, inputs, targets, torch.bfloat16)
        checked = {mode: dict(
            check(args, device, mode, inputs, targets, ref, torch.float32),
            **check(args, device, mode, inputs, targets, ref16,
                    torch.bfloat16)) for mode in modes}
        # The references are gone before training, so a mode's peak
        # memory is its own.
        del ref, ref16
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for mode in modes:
            got = checked[mode]
            got.update(train(args, device, mode, inputs, targets,
                             got["loss"]))
            got["layer"] = layer_timing(args, device, mode, heads, head_dim)
            out["modes"][mode] = got
            if device.type == "cuda":
                torch.cuda.empty_cache()
        per_rank = [None] * n
        dist.all_gather_object(per_rank, out)
        return per_rank
    finally:
        hvd.shutdown()


def summary(per_rank) -> dict:
    """Per mode: the slowest rank's step time and the tokens/s it gives,
    peak memory and hop launches a layer by rank, rotations a layer, and
    the traced step's split (ms, by rank)."""
    out = {}
    single = max(p["single_card"]["step_ms"] for p in per_rank)
    out["single_card"] = {"step_ms": single,
                          "tokens_per_s": per_rank[0]["tokens_per_step"]
                          / single * 1e3}
    for mode in per_rank[0]["modes"]:
        ms = [p["modes"][mode] for p in per_rank]
        step = max(m["step_ms"] for m in ms)
        out[mode] = {
            "step_ms": step,
            "tokens_per_s": per_rank[0]["tokens_per_step"] / step * 1e3,
            "peak_mem_gib": [m["peak_mem_gib"] for m in ms],
            "hop_launches_per_layer": [m["hop_launches_per_layer"]
                                       for m in ms],
            "hop_launches_per_layer_total": sum(
                m["hop_launches_per_layer_total"] for m in ms),
            "hop_kernel_launches_per_layer": [
                m["hop_kernel_launches_per_layer"] for m in ms],
            "rotations_per_layer": ms[0]["rotations_per_layer"],
            "trace": [m["trace"] for m in ms],
            "layer_ms": max(m["layer"]["ms"] for m in ms),
            "layer_trace": [m["layer"]["trace"] for m in ms],
            "check_err_over_tol": max(
                max(m["logits_err_over_tol"], m["loss_err_over_tol"],
                    m["grads_err_over_tol"]) for m in ms),
            "bf16_check_err_over_tol": {
                k: max(m["bf16_" + k] for m in ms)
                for k in ("logits_err_over_tol", "loss_err_over_tol",
                          "grads_err_over_tol")},
            "first_loss_bf16": ms[0]["first_loss"],
            "loss_f32": ms[0]["loss"]}
    return out


def checks(per_rank) -> list:
    """The failures over every rank's result (empty when all hold)."""
    n = per_rank[0]["ranks"]
    bad = []
    for mode in per_rank[0]["modes"]:
        ms = [p["modes"][mode] for p in per_rank]
        for r, m in enumerate(ms):
            for key in ("logits_err_over_tol", "loss_err_over_tol",
                        "grads_err_over_tol", "bf16_logits_err_over_tol",
                        "bf16_loss_err_over_tol"):
                if not m[key] <= 1.0:
                    bad.append(f"{mode} rank {r}: {key} {m[key]}")
            rt, at = BF16_TOL
            if not abs(m["first_loss"] - m["first_loss_f32"]) <= \
                    at + rt * abs(m["first_loss_f32"]):
                bad.append(f"{mode} rank {r}: bf16 loss {m['first_loss']} "
                           f"against f32 {m['first_loss_f32']}")
            if not all(np.isfinite(m["losses"])):
                bad.append(f"{mode} rank {r}: losses {m['losses']}")
        hops = sum(m["hop_launches_per_layer_total"] for m in ms)
        kernel_hops = sum(sum(m["hop_kernel_launches_per_layer"].values())
                          for m in ms)
        if per_rank[0]["backend"] == "nccl" and kernel_hops != hops:
            bad.append(f"{mode}: {kernel_hops} hop kernels launched a "
                       f"layer, {hops} hops run")
        rot = ms[0]["rotations_per_layer"]
        want_hops, want_rot = {"ring": (n * (n + 1) // 2, n - 1),
                               "ring_serial": (n * n, n),
                               "ring_striped": (n * n, n - 1),
                               "ulysses": (0, 0)}[mode]
        if n == 1 and mode != "ring_serial":
            want_rot = 0
        # A ring of one rotates by the identity, which has no backward.
        want_inv = 0 if n == 1 else rot
        if hops != want_hops or any(m["rotations_per_layer"] != want_rot
                                    for m in ms) or \
                any(m["inverse_rotations_per_layer"] != want_inv
                    for m in ms):
            bad.append(f"{mode}: {hops} hop launches a layer over the "
                       f"ranks (want {want_hops}), rotations "
                       f"{[m['rotations_per_layer'] for m in ms]} forward "
                       f"and {[m['inverse_rotations_per_layer'] for m in ms]}"
                       f" backward a layer (want {want_rot})")
    return bad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv,
           module: str = "horovod_tpu_torch.examples.seqpar_bench") -> int:
    """Build the kernels once, start ``--nproc`` ranks of ``module`` (this
    script by default) and wait for them; rank 0 prints the result."""
    if args.device != "cpu":
        from horovod_tpu_torch.csrc import build
        build.build()
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    port = _free_port()
    procs = []
    for r in range(args.nproc):
        env = dict(os.environ, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE=str(args.nproc), HOROVOD_LOCAL_RANK=str(r),
                   HOROVOD_LOCAL_SIZE=str(args.nproc),
                   HVD_TPU_COORDINATOR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + list(argv), env=env))
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
    per_rank = rank_main(args)
    bad = checks(per_rank)
    if os.environ["HOROVOD_RANK"] == "0":
        for b in bad:
            print(f"FAIL: {b}", file=sys.stderr, flush=True)
        print(json.dumps({"seqpar": {
            "ok": not bad, "card": card_tag() if args.device != "cpu"
            else "cpu", "ranks": per_rank[0]["ranks"],
            "tokens_per_step": per_rank[0]["tokens_per_step"],
            "summary": summary(per_rank), "per_rank": per_rank}}),
            flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
