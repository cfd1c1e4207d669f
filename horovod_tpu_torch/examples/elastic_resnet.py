"""Elastic ResNet-50 training under worker churn (BASELINE config 5).

Port of ``examples/elastic_resnet.py``: ResNet-50 with synchronized batch
norm, SGD with momentum through ``DistributedOptimizer``, under
``TorchState`` and ``@hvd.elastic.run``.  The data is a synthetic set of
``--dataset-size`` images made on the device from a seed; an
``ElasticSampler`` shards each epoch over the current world, so every
reset re-shards what is left of the epoch and each rank's batch is
rebuilt from the world it is in (``--batch-size`` images a rank).  The
state commits every ``--commit-every`` steps (spilled to disk with
``HVD_TPU_ELASTIC_SPILL_DIR`` or ``--spill-dir``), and rank 0 writes a
checkpoint (``hvd.checkpoint.save_model``) at the end of each epoch.

Under the elastic launcher, on cards:
    python -m horovod_tpu_torch.runner.launch --min-np 1 --max-np 8 \\
        --host-discovery-script ./discover.sh \\
        python -m horovod_tpu_torch.examples.elastic_resnet
On the CPU (gloo), small:
    python -m horovod_tpu_torch.examples.elastic_resnet --device cpu --small

``--churn`` drives a world through a scale-up and a kill: run without a
launcher, it writes a hosts file and a discovery script and starts the
launcher (``--min-np 2 --max-np 4``) over itself.  The world starts at 2
ranks on host ``localhost``; after ``--scale-up-at`` steps rank 0 adds
host ``127.0.0.1`` with 2 more slots to the hosts file (the driver sees
an added host: ``HostsUpdatedInterrupt(skip_sync=True)`` at the next
commit, and the world grows to 4); after ``--kill-at`` steps the last
rank SIGKILLs itself and the driver respawns the world at 4.  Each rank
of host ``h`` runs on card ``offset(h) + local rank`` (localhost 0–1,
127.0.0.1 2–3).  After every reset each rank checksums its parameters
and rank 0 checks that all agree.  It prints one ``{"elastic_multi":
...}`` line: images/s at each world size, seconds from the scale-up and
from the kill to the first step of the next world, steps redone, the
seconds each survivor took to leave its collective, and the checksums.
    python -m horovod_tpu_torch.examples.elastic_resnet --churn
    python -m horovod_tpu_torch.examples.elastic_resnet --churn --device cpu --small

Every rank appends its events (steps, resets, rates, the kill) as JSON
lines to ``HVD_TPU_ELASTIC_EVENT_LOG`` (``--events``), where the elastic
layer also logs each collective failure it catches.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.elastic import log_event, read_events

# The churn drive's hosts, in card order: a rank of host h runs on card
# offset(h) + its local rank.
CHURN_HOSTS = (("localhost", 2), ("127.0.0.1", 2))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (a gloo world)")
    p.add_argument("--small", action="store_true",
                   help="32x32 images, 4 a rank, 32 in the set, lr "
                        "0.01")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32,
                   help="images a rank a step")
    p.add_argument("--dataset-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0,
                   help="stop after this many steps (0: run the epochs)")
    p.add_argument("--commit-every", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--no-sync-bn", action="store_true")
    p.add_argument("--fast-stem", action="store_true",
                   help="SpaceToDepthStem + max_pool_eq_grad (whose "
                        "backward is deterministic)")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True)")
    p.add_argument("--spill-dir")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--events", help="JSON-lines event log")
    p.add_argument("--die-after", type=int, default=0,
                   help="os._exit(1) after this step, first incarnation")
    p.add_argument("--save-params",
                   help="rank 0 saves the final state_dict here")
    p.add_argument("--start-after",
                   help="train only once this file exists (a run that "
                        "shares the card with another waits its turn)")
    p.add_argument("--ready-file",
                   help="create this file once the model is built (the "
                        "run that shares the card starts after it)")
    p.add_argument("--roundtrip",
                   help="then check save_model / load_model bit for bit "
                        "at backward_passes_per_step=2, mid-cycle, in "
                        "this directory")
    p.add_argument("--churn", action="store_true")
    p.add_argument("--scale-up-at", type=int, default=10)
    p.add_argument("--kill-at", type=int, default=25,
                   help="odd, between commits: a step is redone")
    p.add_argument("--workdir", help="--churn: where its files go")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="--churn: the launcher's time limit, seconds")
    args = p.parse_args(argv)
    if args.small:
        args.image_size, args.batch_size = 32, 4
        args.dataset_size = min(args.dataset_size, 32)
        args.lr = min(args.lr, 0.01)
    return args


def churn_device(args) -> str:
    """The card of this rank in the churn drive (see CHURN_HOSTS)."""
    if args.device == "cpu":
        return "cpu"
    host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
    offset = 0
    for h, slots in CHURN_HOSTS:
        if h == host:
            break
        offset += slots
    return f"cuda:{offset + int(os.environ.get('HOROVOD_LOCAL_RANK', '0'))}"


def make_model(args, device):
    """ResNet-50 (bf16 products on a card, f32 on the CPU) from seed 0."""
    import torch
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models.resnet import init_kernels_
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    return init_kernels_(ResNet50(
        num_classes=1000, dtype=dtype, sync_bn=not args.no_sync_bn,
        s2d_stem=args.fast_stem, eq_pool_grad=args.fast_stem,
        device=device), torch.Generator(device=device).manual_seed(0))


def build(args, device):
    """The model, its optimizer (SGD, momentum 0.9, through
    ``DistributedOptimizer``) and the synthetic set on ``device``."""
    import torch
    import horovod_tpu_torch as hvd
    model = make_model(args, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9))
    gen = torch.Generator(device=device).manual_seed(1)
    hw = args.image_size
    images = torch.rand((args.dataset_size, hw, hw, 3), generator=gen,
                        device=device)
    labels = torch.randint(0, 1000, (args.dataset_size,), generator=gen,
                           device=device)
    return model, opt, images, labels


def train_step(model, opt, images, labels):
    """One step on a batch; the loss on the device, not averaged."""
    from torch.nn import functional as F
    opt.zero_grad()
    loss = F.cross_entropy(model(images, train=True).float(), labels)
    loss.backward()
    opt.step()
    return loss.detach()


def param_checksum(model) -> str:
    """sha1 of the bytes of every parameter and buffer, in order."""
    import torch
    h = hashlib.sha1()
    for t in model.state_dict().values():
        h.update(t.detach().contiguous().cpu().view(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_worker(args, started: float) -> int:
    import torch
    import horovod_tpu_torch as hvd
    events = args.events or os.environ.get("HVD_TPU_ELASTIC_EVENT_LOG")
    if events:
        os.environ["HVD_TPU_ELASTIC_EVENT_LOG"] = events
    log_event("start", at=started)
    if args.deterministic:
        import warnings
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # warn_only: an op without a deterministic kernel is named in the
        # event log ("nondeterministic") instead of failing the run.
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
        seen_warnings = []

        def note(message, category, filename, lineno, file=None,
                 line=None):
            text = str(message)
            if "deterministic" in text and text not in seen_warnings:
                seen_warnings.append(text)
                log_event("nondeterministic", warning=text[:300])
        warnings.showwarning = note
    if args.spill_dir:
        os.environ["HVD_TPU_ELASTIC_SPILL_DIR"] = args.spill_dir
    hvd.init(device=churn_device(args) if args.churn else args.device)
    dev = hvd.device()
    log_event("init")
    if dev.type == "cpu":
        # One process a rank shares the host's cores: spinning OpenMP
        # pools of every rank on every core would stall them all.
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // (4 if args.churn else hvd.size())))
    model, opt, images, labels = build(args, dev)
    _sync(dev)
    log_event("built")
    if args.ready_file:
        open(args.ready_file, "w").close()
    sampler = hvd.elastic.ElasticSampler(args.dataset_size, seed=2)
    state = hvd.elastic.TorchState(model, opt, sampler=sampler, step=0,
                                   epoch=0, scaled_up=False)
    marker_dir = args.spill_dir or os.environ.get(
        "HVD_TPU_ELASTIC_SPILL_DIR") or tempfile.gettempdir()
    total = args.steps or 10 ** 9

    @hvd.elastic.run
    def train(state):
        if args.churn:
            # Every rank's parameters after the sync: one allgather.
            sums = hvd.allgather_object(param_checksum(model))
            if hvd.rank() == 0:
                log_event("entry", size=hvd.size(),
                          step=state.step, checksums=sums,
                          equal=len(set(sums)) == 1)
        else:
            log_event("entry", size=hvd.size(), step=state.step)
        bidx = 0
        world_first = True
        while state.epoch < args.epochs:
            idx = sampler.get_indices(bidx, args.batch_size)
            if len(idx) < args.batch_size:  # the epoch is done
                _end_epoch(state, model, opt, sampler, args)
                bidx = 0
                continue
            if state.step >= total:
                break
            t0 = time.perf_counter()
            t = torch.as_tensor(idx, device=dev)
            loss = train_step(model, opt, images[t], labels[t])
            lv = float(loss)  # waits for the step
            step_ms = 1e3 * (time.perf_counter() - t0)
            if lv != lv or lv in (float("inf"), float("-inf")):
                raise RuntimeError(f"non-finite loss {lv} at step "
                                   f"{state.step}")
            sampler.record_batch(bidx, args.batch_size)
            bidx += 1
            state.step += 1
            log_event("step", step=state.step, size=hvd.size(),
                      loss=lv, ms=step_ms, first_of_world=world_first)
            world_first = False
            if state.step % args.commit_every == 0:
                state.commit()
                save_ms, spill_ms = state.last_commit_ms
                log_event("commit", step=state.step, save_ms=save_ms,
                          commit_ms=save_ms + spill_ms)
            if args.die_after and state.step == args.die_after and \
                    not os.path.exists(os.path.join(marker_dir, "died")):
                open(os.path.join(marker_dir, "died"), "w").close()
                log_event("kill", step=state.step)
                os._exit(1)
            if args.churn:
                _churn(args, state, events)
        return state.step

    state.register_reset_callbacks([lambda: log_event(
        "restore", restore_ms=state.last_restore_ms, step=state.step,
        size=hvd.size())])
    t0 = time.perf_counter()
    if state.load_spill():  # elastic.run would; timed here with the read
        log_event("resumed", step=state.step,
                  restore_ms=1e3 * (time.perf_counter() - t0))
    if args.start_after:
        deadline = time.time() + 600
        while not os.path.exists(args.start_after):
            if time.time() > deadline:
                raise TimeoutError(f"{args.start_after} never appeared")
            time.sleep(0.05)
    steps = train(state)
    if hvd.rank() == 0:
        log_event("done", step=steps, size=hvd.size(),
                  checksum=param_checksum(model))
        if args.save_params:
            torch.save({k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
                       args.save_params)
    if args.roundtrip:
        roundtrip_check(args, model, images, labels)
    return 0


def _end_epoch(state, model, opt, sampler, args) -> None:
    """The next epoch, rank 0's checkpoint of the finished one (every
    rank calls it: the others wait at its barrier), and a commit."""
    import horovod_tpu_torch as hvd
    state.epoch += 1
    sampler.set_epoch(state.epoch)
    if args.checkpoint_dir:
        hvd.checkpoint.save_model(
            os.path.join(args.checkpoint_dir, f"epoch_{state.epoch}"),
            model, opt, extra={"epoch": state.epoch, "step": state.step})
    state.commit()


def _churn(args, state, events) -> None:
    """The churn schedule (module docstring)."""
    import horovod_tpu_torch as hvd
    hosts = os.environ.get("HVD_ELASTIC_RESNET_HOSTS_FILE")
    if hosts and not state.scaled_up and hvd.size() == 2 and \
            state.step >= args.scale_up_at:
        state.scaled_up = True
        if hvd.rank() == 0:
            with open(hosts + ".tmp", "w") as f:
                f.write("".join(f"{h}:{s}\n" for h, s in CHURN_HOSTS))
            os.replace(hosts + ".tmp", hosts)
            log_event("scale_up", step=state.step)
    if hvd.size() == 4 and state.step == args.kill_at and \
            hvd.rank() == hvd.size() - 1:
        marker = os.path.join(os.path.dirname(events), "killed")
        if not os.path.exists(marker):
            open(marker, "w").close()
            log_event("kill", step=state.step)
            os.kill(os.getpid(), signal.SIGKILL)


def roundtrip_check(args, model, images, labels) -> None:
    """save_model / load_model of the trained model with a
    ``backward_passes_per_step=2`` optimizer saved mid-cycle: the loaded
    model, optimizer state and accumulators equal the saved ones bit
    for bit, and one more step on each gives the same bits."""
    import torch
    import horovod_tpu_torch as hvd
    dev = hvd.device()
    base = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    opt = hvd.DistributedOptimizer(base, backward_passes_per_step=2)
    b = args.batch_size
    for k in range(3):
        train_step(model, opt, images[k * b:(k + 1) * b],
                   labels[k * b:(k + 1) * b])
    assert opt._passes == 1
    path = os.path.join(args.roundtrip, "model")
    hvd.checkpoint.save_model(path, model, opt, extra={"step": 3})
    fresh = make_model(args, dev)
    fresh_base = torch.optim.SGD(fresh.parameters(), lr=args.lr,
                                 momentum=0.9)
    _, opt2, _, extra = hvd.checkpoint.load_model(
        path, fresh, fresh_base, backward_passes_per_step=2)
    bad = [k for k, v in model.state_dict().items()
           if not torch.equal(v, fresh.state_dict()[k])]
    for p, q in zip(model.parameters(), fresh.parameters()):
        if not torch.equal(base.state[p]["momentum_buffer"],
                           fresh_base.state[q]["momentum_buffer"]):
            bad.append("momentum")
    bad += [f"acc {i}" for i, (a, c) in enumerate(zip(opt._acc, opt2._acc))
            if not torch.equal(a, c)]
    if opt2._passes != 1 or extra != {"step": 3}:
        bad.append("cycle or extra")
    x, y = images[3 * b:4 * b], labels[3 * b:4 * b]
    la, lb = train_step(model, opt, x, y), train_step(fresh, opt2, x, y)
    bad += [k for k, v in model.state_dict().items()
            if not torch.equal(v, fresh.state_dict()[k])]
    if not torch.equal(la, lb):
        bad.append("loss")
    if hvd.rank() == 0:
        log_event("roundtrip", equal=not bad, mismatches=bad[:10])
    if bad:
        raise AssertionError(f"save_model / load_model round trip "
                             f"differs: {bad[:10]}")


# ---------------------------------------------------------------------------
# Reading the event log
# ---------------------------------------------------------------------------

def segments(events: List[dict], batch: int) -> List[dict]:
    """Rank 0's steps grouped by world (version, size): images/s over
    each world's steps after its first 2."""
    steps = [e for e in events if e["event"] == "step" and e["rank"] == 0]
    worlds: Dict[tuple, List[dict]] = {}
    for e in steps:
        worlds.setdefault((e["world_version"], e["size"]), []).append(e)
    out = []
    for (ver, size), es in sorted(worlds.items()):
        out.append({"world_version": ver, "size": size, "steps": len(es),
                    "first_step": es[0]["step"],
                    "images_per_s": step_rate(es[2:], batch * size)})
    return out


def step_rate(steps: List[dict], images: int) -> Optional[float]:
    """images/s of training steps, from each step's own time (the
    commits between steps left out)."""
    ms = sum(e["ms"] for e in steps)
    return images * len(steps) / (ms / 1e3) if steps and ms > 0 else None


def first_step_after(events: List[dict], wall: float) -> Optional[dict]:
    later = [e for e in events if e["event"] == "step"
             and e["wall"] > wall and e.get("first_of_world")]
    return min(later, key=lambda e: e["wall"]) if later else None


def churn_summary(events: List[dict], batch: int) -> dict:
    """The ``elastic_multi`` numbers from the drive's event log."""
    out: dict = {"worlds": segments(events, batch)}
    for name in ("scale_up", "kill"):
        ev = [e for e in events if e["event"] == name]
        if not ev:
            out[name] = None
            continue
        at = ev[0]
        first = first_step_after(events, at["wall"])
        rec = {"at_step": at["step"],
               "recover_s": first["wall"] - at["wall"] if first else None,
               "resumed_at_step": first["step"] - 1 if first else None}
        if name == "kill":
            rec["steps_redone"] = at["step"] - rec["resumed_at_step"] \
                if first else None
            left = [e for e in events if e["wall"] > at["wall"]
                    and e["event"] in ("failure", "wedge_exit")]
            rec["survivors_left_s"] = {
                f"rank {e['rank']} ({e['event']})":
                    e["wall"] - at["wall"] for e in left}
        out[name] = rec
    # Each rank's median step time in each world: a slow rank sets the
    # pace of the world.
    by_rank: Dict[str, Dict[str, float]] = {}
    for s in out["worlds"]:
        ver = s["world_version"]
        for r in sorted({e["rank"] for e in events
                         if e["event"] == "step"
                         and e["world_version"] == ver}):
            ms = sorted(e["ms"] for e in events if e["event"] == "step"
                        and e["world_version"] == ver and e["rank"] == r)
            by_rank.setdefault(str(ver), {})[str(r)] = ms[len(ms) // 2]
    out["step_ms_median_by_rank"] = by_rank
    entries = [e for e in events if e["event"] == "entry"]
    out["checksums"] = [{"world_version": e["world_version"],
                         "size": e["size"], "step": e["step"],
                         "equal": e["equal"], "sha1": e["checksums"][0]}
                        for e in entries]
    rates = {}
    for s in out["worlds"]:
        if s["images_per_s"] is not None:
            rates.setdefault(s["size"], []).append(s["images_per_s"])
    out["images_per_s"] = {str(k): v for k, v in sorted(rates.items())}
    return out


def run_churn(args, argv) -> int:
    """Write the hosts file and discovery script, start the launcher over
    this script, then read the event log and print ``elastic_multi``."""
    work = args.workdir or tempfile.mkdtemp(prefix="elastic_resnet_")
    os.makedirs(work, exist_ok=True)
    hosts = os.path.join(work, "hosts")
    with open(hosts, "w") as f:
        f.write(f"{CHURN_HOSTS[0][0]}:{CHURN_HOSTS[0][1]}\n")
    script = os.path.join(work, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts}\n")
    os.chmod(script, 0o755)
    events = os.path.join(work, "events.jsonl")
    if os.path.exists(events):
        os.remove(events)
    env = dict(os.environ, HVD_ELASTIC_RESNET_HOSTS_FILE=hosts,
               HVD_TPU_ELASTIC_EVENT_LOG=events,
               HVD_TPU_ELASTIC_SPILL_DIR=os.path.join(work, "spill"))
    passthrough = [a for a in argv if a not in ("--churn",)]
    if not args.checkpoint_dir:
        passthrough += ["--checkpoint-dir", os.path.join(work, "ckpt")]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--min-np", "2", "--max-np", "4",
           "--host-discovery-script", script,
           # A failed host is not kept out: the kill must respawn the
           # world at 4 cards.
           "--blacklist-cooldown-range", "0", "0",
           sys.executable, "-m", "horovod_tpu_torch.examples.elastic_resnet",
           "--churn", "--events", events] + passthrough
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, timeout=args.timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc = 124
    evs = read_events(events)
    summary = churn_summary(evs, args.batch_size)
    summary.update(seconds=time.time() - t0, launcher_rc=rc,
                   device=args.device, image_size=args.image_size,
                   batch_per_rank=args.batch_size)
    ok = rc == 0 and summary["scale_up"] and summary["kill"] and \
        summary["kill"]["recover_s"] is not None and \
        all(c["equal"] for c in summary["checksums"]) and \
        {2, 4} <= {c["size"] for c in summary["checksums"]}
    summary["ok"] = bool(ok)
    print(json.dumps({"elastic_multi": summary}), flush=True)
    return 0 if ok else 1


def process_start_time() -> float:
    """When this process started (Linux ``/proc``), else now: the
    incarnation's startup then counts the interpreter and its imports."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def main(argv=None) -> int:
    started = process_start_time()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.churn and os.environ.get("HOROVOD_ELASTIC") != "1":
        return run_churn(args, argv)
    if args.churn:
        args.steps = args.steps or args.kill_at + 8
        args.epochs = max(args.epochs, args.steps)
        args.dataset_size = max(args.dataset_size, 64 * args.batch_size)
    return run_worker(args, started)


if __name__ == "__main__":
    sys.exit(main())
