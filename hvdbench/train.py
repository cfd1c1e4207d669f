"""One rank of a training cell.

Set-up builds one training step of the program (the port's
``Transformer`` with flash attention, ``lm_loss``, ``DistributedOptimizer``
around AdamW), drives it through the checked steps, whose readings the
reference is compared with, and the warm-up steps; then the window runs
the same step until ``seconds`` have passed.  With ``trace`` the
profiler records a few steps inside the window.  After the window the
program is freed and the reference works the checked steps out again.

The harness's spans, put around the calls into each layer:
``data`` (picking the batch), ``fwd`` (the model and the loss), ``bwd``
(``loss.backward()``), ``opt`` (``DistributedOptimizer.step()``).  Each
is a ``record_function`` and, while the profiler runs, a pair of
markers that ``traces.py`` reads (the profiler records the device
alone, see there).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
import types
from collections import defaultdict
from typing import Callable, List, Optional

import torch
from torch.profiler import record_function

from . import (compare, data, faults, nccl_log, peaks, roofline, traces,
               weights)
from .reference import train as reference_train

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
PROFILE_START = 3   # window step at which the profiler starts


def log(msg: str) -> None:
    print(f"[hvdbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's spans: ``record_function`` always; while ``marking``,
    a ``traces.MARKER`` call at entry and exit, and the names entered."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marking = False
        self.names: List[str] = []
        self.times: List[float] = []   # µs, host clock, entry and exit

    def _mark(self) -> None:
        t0 = time.perf_counter_ns()
        torch.cuda.current_stream().query()
        self.times.append((t0 + time.perf_counter_ns()) / 2e3)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with record_function(name):
            if self.marking:
                self.names.append(name)
                self._mark()
            try:
                yield
            finally:
                if self.marking:
                    self._mark()


class Program:
    """The port's training step for one rank, built from the cell's
    files and the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 rank: int):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import transformer as T
        self.hvd, self.T, self.lm_loss = hvd, T, T.lm_loss
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.rank = device, rank
        m = config["model"]
        if m["activation"] != "gelu_tanh" or m["param_dtype"] != "float32":
            raise ValueError("the port's block is tanh-GELU over f32 "
                             "parameters")
        cfg = T.TransformerConfig(
            vocab_size=m["vocab_size"], num_layers=m["num_layers"],
            num_heads=m["num_heads"], d_model=m["d_model"], d_ff=m["d_ff"],
            max_len=m["max_len"], causal=bool(m["causal"]),
            dtype=getattr(torch, m["compute_dtype"]),
            attention_impl="flash" if m["attention"] == "flash" else None,
            remat=bool(m["remat"]))
        model = T.Transformer(cfg, device=device)
        if (model.blocks[0].ln1.eps, model.ln_f.eps) != \
                (m["block_ln_eps"], m["final_ln_eps"]):
            raise ValueError("the configuration's LayerNorm eps differ from "
                             "the port's")
        lay = weights.layout(m)
        have = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        if have != list(lay.items()):
            raise ValueError("the port's parameters differ from the "
                             "configuration's layout")
        with torch.no_grad():
            w = weights.make(config, seed, device)
            for n, p in model.named_parameters():
                p.copy_(w[n])
            del w
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        o, red = traffic["optimizer"], traffic["reduce"]
        if o["name"] != "AdamW":
            raise ValueError(f"unknown optimizer {o['name']!r}")
        inner = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                                  betas=tuple(o["betas"]), eps=o["eps"],
                                  weight_decay=o["weight_decay"])
        self.opt = hvd.DistributedOptimizer(
            inner, backward_passes_per_step=int(
                traffic["backward_passes_per_step"]),
            op={"Average": hvd.Average, "Sum": hvd.Sum}[red["op"]],
            compression=getattr(hvd.Compression, red["compression"]))
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.micros = data.micro_batches(config, traffic, seed, rank, device)
        self.passes = int(traffic["backward_passes_per_step"])
        self.span = Spans(device)

    def loss(self, batch):
        if self.traffic["task"] == "causal_lm":
            tokens = batch["tokens"]
            return self.lm_loss(self.model(tokens)[:, :-1], tokens[:, 1:])
        logits = self.model(batch["inputs"],
                            predict_positions=batch["positions"])
        return self.lm_loss(logits, batch["labels"])

    def step(self, i: int) -> List[torch.Tensor]:
        """Optimizer step ``i``: its passes, each with its spans.
        Returns each pass's loss, on the device."""
        losses = []
        for m in range(self.passes):
            with self.span("data"):
                batch = self.micros[data.micro_batch_of(self.traffic, i, m)]
            self.opt.zero_grad()
            with self.span("fwd"):
                loss = self.loss(batch)
            with self.span("bwd"):
                loss.backward()
            with self.span("opt"):
                self.opt.step()
            losses.append(loss.detach())
        return losses

    @torch.no_grad()
    def first_grad_norms(self) -> torch.Tensor:
        """Each leaf's norm of the gradient the optimizer got in its first
        step, from AdamW's first moment ((1 - beta1) g after one step);
        zero where the optimizer holds no state."""
        b1 = self.traffic["optimizer"]["betas"][0]
        out = []
        for p in self.params:
            st = self.opt.state.get(p, {})
            m = st.get("exp_avg")
            out.append(torch.zeros((), device=self.device) if m is None
                       else torch.linalg.vector_norm(m) / (1.0 - b1))
        return torch.stack(out)

    @torch.no_grad()
    def delta(self) -> torch.Tensor:
        """Every parameter's change from the seed's weights, flat."""
        w0 = weights.make(self.config, self.seed, self.device)
        out = torch.cat([(p - w0[n]).reshape(-1)
                         for n, p in zip(self.names, self.params)])
        del w0
        return out


class Clock:
    """Step ends on the device: CUDA events on the stream (read after the
    window), or the host clock on the CPU, where every op is done when
    it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations_s(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def checked_readings(program: Program, n: int) -> dict:
    """Run the program's steps 0..n-1 and take its readings: each step's
    loss, the first gradient's leaf norms, the leaves' change."""
    losses, grad_norms = [], None
    for t in range(n):
        losses.append(program.step(t))
        if t == 0:
            grad_norms = program.first_grad_norms()
    return {"losses": {program.rank: [float(torch.stack(ls).mean())
                                      for ls in losses]},
            "grad_norms": grad_norms.double().cpu(),
            # kept on the host through the window, off the device's peak
            "delta": program.delta().cpu()}


def reference_readings(config: dict, traffic: dict, seed: int, device,
                       ranks: List[int], world: int,
                       allreduce_sum: Optional[Callable] = None,
                       mode: str = "f32", half_batch: bool = False) -> dict:
    """The reference's readings of the checked steps, for the ranks this
    process computes (``ranks``) of ``world``."""
    n = int(traffic["checked_steps"])
    passes = int(traffic["backward_passes_per_step"])
    params = weights.make(config, seed, device)
    micros_by_rank = {}
    for r in ranks:
        micros = data.micro_batches(config, traffic, seed, r, device)
        micros_by_rank[r] = [
            [micros[data.micro_batch_of(traffic, t, m)] for m in range(passes)]
            for t in range(n)]
    return reference_train.run(config, traffic, params, micros_by_rank,
                               world, allreduce_sum=allreduce_sum, mode=mode,
                               half_batch=half_batch)


def _profiler(device):
    """The device's activity alone (kernels, copies, the runtime's
    launches); on the CPU, the host's, so a rehearsal has a trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" \
        else [ProfilerActivity.CPU]
    return profile(activities=acts)


def _read_trace(prof, spans: Spans) -> traces.Trace:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="hvdbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return traces.Trace.from_file(path, spans.names, spans.times)
    finally:
        os.remove(path)


def harness_groups(world: int, dev):
    """The harness's own process groups in a world of more than one: a
    host-side one (gloo) to agree on the window's last step, and the
    reference's exchange, a sum over the world."""
    import torch.distributed as dist
    if world < 2:
        return None, None
    ctl = dist.new_group(backend="gloo")
    ref_group = ctl if dev.type == "cpu" else dist.new_group(backend="nccl")

    def allreduce_sum(flat):
        dist.all_reduce(flat, group=ref_group)
        return flat
    return ctl, allreduce_sum


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def check(cell, seed, dev, rank, world, allreduce_sum, prog_readings):
    """The reference's readings of the checked steps and the gaps of the
    program's from them."""
    config = cell.config
    ref = reference_readings(config, cell.traffic, seed, dev, [rank], world,
                             allreduce_sum)
    sizes = [weights.numel(s)
             for s in weights.layout(config["model"]).values()]
    prog_readings["delta"] = prog_readings["delta"].to(dev)
    return compare.gaps(prog_readings, ref, sizes), ref


def run_rank(cell, seed: int, seconds: float, trace: bool, device: str,
             rank: int, world: int, t0_wall: float,
             fault: Optional[str] = None) -> dict:
    """Everything one rank does in a run; returns its part of the
    result (plain JSON types)."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    config, traffic = cell.config, cell.traffic
    shm_before = set(_shm())
    nccl_dir = nccl_log.begin() if device.startswith("cuda") else None
    marks = [("imports", time.time())]
    hvd.init(device=device)
    marks.append(("hvd.init", time.time()))
    dev = hvd.device()
    if hvd.size() != world or hvd.rank() != rank:
        raise RuntimeError(f"world {hvd.size()}/{hvd.rank()}, expected "
                           f"{world}/{rank}")
    ctl, allreduce_sum = harness_groups(world, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    program = Program(config, traffic, seed, dev, rank)
    marks.append(("program built", time.time()))
    if fault:
        faults.plant(fault, program)
    n_checked = int(traffic["checked_steps"])
    prog_readings = checked_readings(program, n_checked)
    marks.append(("checked steps", time.time()))
    step = n_checked
    for _ in range(int(traffic["warmup_steps"])):
        program.step(step)
        step += 1
    _sync(dev)
    marks.append(("warm-up steps", time.time()))
    log(f"rank {rank} set-up: " + ", ".join(
        f"{name} {t - t0_wall:.3f} s" for name, t in marks))

    def agree(done: bool) -> bool:
        if ctl is None:
            return done
        flag = torch.tensor([1 if done else 0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctl)
        return bool(flag.item())

    agree(False)  # every rank starts the window together
    clock = Clock(dev)
    n_prof = int(traffic["profile_steps"]) if trace else 0
    prof = None
    window_losses = []
    setup_s = time.time() - t0_wall
    t_start = time.perf_counter()
    clock.mark()
    k = 0
    while True:
        if trace and k == PROFILE_START:
            _sync(dev)
            prof = _profiler(dev)
            prof.start()
            program.span.marking = program.span.cuda
        window_losses.extend(program.step(step))
        clock.mark()
        step += 1
        k += 1
        if trace and k == PROFILE_START + n_prof:
            program.span.marking = False
            _sync(dev)
            prof.stop()
        profiling_open = trace and k < PROFILE_START + n_prof + 1
        if agree(time.perf_counter() - t_start >= seconds
                 and not profiling_open):
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start
    durations = clock.durations_s()
    finite = torch.stack(window_losses).isfinite().view(
        k, program.passes).all(dim=1)
    failed = int((~finite).sum())
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"rank": rank, "steps": k, "window_s": window_s,
           "setup_s": setup_s, "step_s": durations, "failed": failed,
           "samples_per_step": data.samples_per_step(traffic),
           "memory_peak_bytes": int(memory_peak), "kind": kind,
           "platform": "gpu" if dev.type == "cuda" else "cpu"}
    if trace:
        out.update(_trace_part(cell, prof, program.span, durations, kind,
                               world))
    prof = None
    # Free the program before the reference runs.
    del program, window_losses
    free(dev)
    t_ref = time.perf_counter()
    out["gaps"], ref = check(cell, seed, dev, rank, world, allreduce_sum,
                             prog_readings)
    out["reference_s"] = time.perf_counter() - t_ref
    out["program_losses"] = prog_readings["losses"][rank]
    out["reference_losses"] = ref["losses"][rank]
    hvd.shutdown()
    out["nccl"] = nccl_log.end(nccl_dir) if nccl_dir else "no NCCL"
    out["forbidden"] = forbidden_modules()
    # What the run left in shared memory (NCCL's segments would be
    # there) once the world is down.
    out["dev_shm_new"] = sorted(set(_shm()) - shm_before)
    return out


def _shm() -> List[str]:
    return os.listdir("/dev/shm") if os.path.isdir("/dev/shm") else []


def _trace_part(cell, prof, spans, durations, kind, world) -> dict:
    """The per-layer metrics from the profiled stretch, and the device's
    busy and traced seconds."""
    tr = _read_trace(prof, spans)
    log(f"trace: {len(tr.ops)} device operations, {len(tr.spans)} spans "
        f"of {len(spans.names)} marked")
    nccl = defaultdict(lambda: [0, 0.0])
    for o in tr.ops:
        if traces.is_nccl(o):
            nccl[o.name][0] += 1
            nccl[o.name][1] += o.end - o.start
    if nccl:
        # NCCL names its kernels by one entry point each, whatever
        # algorithm and protocol they run (those are in NCCL's log).
        log("trace: NCCL kernels " + ", ".join(
            f"{n} x{c} {us / 1e3:.3f} ms" for n, (c, us) in sorted(
                nccl.items())))
    if spans.names and not tr.spans:
        log("trace: the span markers were not found; the metrics read "
            "from spans are left out")
    n_prof = int(cell.traffic["profile_steps"])
    model = cell.config["model"]
    top_f = peaks.peak(kind, "bf16_flops")
    top_b = peaks.peak(kind, "hbm_bytes")
    bounds = None
    if top_f is not None and model["attention"] == "flash":
        bounds = roofline.flash_bounds_s(model, cell.traffic, top_f, top_b)
    # Window steps PROFILE_START .. PROFILE_START + n_prof hold the
    # profiler's start and stop: mfu reads the others.
    skip = set(range(PROFILE_START, PROFILE_START + n_prof + 1))
    ctx = types.SimpleNamespace(
        trace=tr, steps_profiled=n_prof, world=world, device_kind=kind,
        flops_per_step=roofline.step_flops(model, cell.traffic),
        flash_bounds=bounds,
        mfu_steps_s=[d for i, d in enumerate(durations) if i not in skip])
    values = {}
    for m in cell.per_layer:
        v = m.read(ctx)
        if v is not None:
            values[m.name] = float(v)
    w0, w1 = tr.wall()
    return {"per_layer": values, "busy_s": tr.busy() / 1e6,
            "traced_s": (w1 - w0) / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in tr.top_ops(10)],
            "idle_gaps": [[n, us / 1e6] for n, us in tr.top_gaps(10)]}
