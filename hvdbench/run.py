#!/usr/bin/env python3
"""The benchmark of ``horovod_tpu_torch``: one run of one cell.

    python3 hvdbench/run.py --workload gpt2m.lm1024.1c --seed 7 \
        --seconds 51 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled stretch of the window.  The last
line of standard output is the result (one JSON object); the numbers
that decide ``correct`` are the last lines of standard error.

A one-chip cell runs in this process.  A cell of N chips starts the
port's launcher (``python -m horovod_tpu_torch.runner.launch -np N``),
one worker a card, each running this file with ``--worker``; the
workers leave their parts in a temporary directory, and this process
merges them.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Import the harness as a package from the checkout's root, not its
# modules from this directory.
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "hvdbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / "hvdbench" / ".cache"
# Fixed directories inside the checkout, so only a checkout's first run
# builds; variables a library reads to stay off JAX.
ENV = {
    "TRITON_CACHE_DIR": str(CACHE / "triton"),
    "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
    "TORCHINDUCTOR_CACHE_DIR": str(CACHE / "inductor"),
    "CUDA_CACHE_PATH": str(CACHE / "nv"),
    "USE_FLAX": "0",
    "USE_JAX": "0",
    "NCCL_SHM_DISABLE": "1",
}
WORKER_TIMEOUT_S = 1150


def apply_env() -> None:
    for k, v in ENV.items():
        os.environ[k] = v
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
              "TORCHINDUCTOR_CACHE_DIR", "CUDA_CACHE_PATH"):
        os.makedirs(os.environ[k], exist_ok=True)


def log(msg: str) -> None:
    print(f"[hvdbench] {msg}", file=sys.stderr, flush=True)


def p90(values):
    """The 90th percentile, nearest rank."""
    s = sorted(values)
    if not s:
        return None
    return s[max(0, -(-9 * len(s) // 10) - 1)]


def merge(cell, parts, trace: bool, forbidden) -> dict:
    """The result line from every rank's part."""
    from hvdbench import compare
    world = len(parts)
    steps = min(p["steps"] for p in parts)
    window_s = max(p["window_s"] for p in parts)
    samples = steps * parts[0]["samples_per_step"] * world
    failed = sum(p["failed"] for p in parts)
    step_ms = [d * 1e3 for p in parts for d in p["step_s"]]
    gaps = {name: max(p["gaps"][name] for p in parts)
            for name in compare.CHECKS}
    ok, checks = compare.verdict(gaps, cell.limits)
    correct = ok and failed == 0 and steps > 0 and not forbidden
    metrics = {}
    units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {"train_samples_per_s": samples / window_s,
                  "step_ms_p90": p90(step_ms),
                  "setup_s": max(p["setup_s"] for p in parts)}
    else:
        values = {}
        for m in cell.per_layer:
            got = [p["per_layer"][m.name] for p in parts
                   if m.name in p.get("per_layer", {})]
            if got:
                values[m.name] = sum(got) / len(got)
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if m.name in values and values[m.name] is not None:
            metrics[m.name] = {"value": values[m.name], "unit": units[m.name]}
    device = {"platform": parts[0]["platform"], "kind": parts[0]["kind"],
              "count": world,
              "memory_peak_bytes": max(p["memory_peak_bytes"] for p in parts)}
    if trace:
        device["busy_s"] = sum(p["busy_s"] for p in parts) / world
        device["window_s"] = sum(p["traced_s"] for p in parts) / world
    out = {"correct": bool(correct), "attempted": steps, "failed": failed,
           "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = {"device_ops": parts[0]["device_ops"],
                            "idle_gaps": parts[0]["idle_gaps"]}
    out["checks"] = {k: checks[k] for k in compare.CHECKS}
    return out


def report(cell, parts, out: dict) -> None:
    """Earlier lines: the counts behind the metrics; the checks last."""
    steps, world = out["attempted"], len(parts)
    window_s = max(p["window_s"] for p in parts)
    tokens = steps * parts[0]["samples_per_step"] * world * \
        int(cell.traffic["seq_len"])
    log(f"cell {cell.name}: {steps} optimizer steps on {world} rank(s) in "
        f"{window_s:.3f} s; {tokens / window_s:.1f} tokens/s; "
        f"{sum(len(p['step_s']) for p in parts)} step times")
    log(f"card: {out['device']['kind']}; power limit {power_limit()}")
    steps_ms = sorted(d * 1e3 for p in parts for d in p["step_s"])
    if steps_ms:
        q = statistics.quantiles(steps_ms, n=10) if len(steps_ms) > 1 \
            else steps_ms * 9
        log(f"step ms: min {steps_ms[0]:.3f}, p10 {q[0]:.3f}, median "
            f"{statistics.median(steps_ms):.3f}, p90 {q[8]:.3f}, max "
            f"{steps_ms[-1]:.3f}")
    shm = sorted(set().union(*[p["dev_shm_new"] for p in parts]))
    log(f"left in /dev/shm: {shm[:20]}")
    for p in parts:
        log(f"rank {p['rank']}: setup {p['setup_s']:.3f} s, reference "
            f"{p['reference_s']:.3f} s, losses program "
            f"{p['program_losses']} reference {p['reference_losses']}")
        log(f"rank {p['rank']}: {p['nccl']}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")


def power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return "; ".join(line.strip() for line in r.stdout.splitlines()) \
        or "not read"


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT, fault=None):
    """Run the cell; returns (cell, parts, result)."""
    from hvdbench import spec, train
    cell = spec.load_cell(workload, root, spec.bench_dirs_for(root))
    if cell.chips == 1:
        parts = [train.run_rank(cell, seed, seconds, trace, device, 0, 1,
                                T0_WALL, fault)]
    else:
        parts = _launch(cell, workload, seed, seconds, trace, device, root,
                        fault)
    forbidden = sorted(set(train.forbidden_modules()).union(
        *[p["forbidden"] for p in parts]))
    if forbidden:
        raise SystemExit(f"[hvdbench] forbidden modules loaded: {forbidden}")
    return cell, parts, merge(cell, parts, trace, forbidden)


def _launch(cell, workload, seed, seconds, trace, device, root, fault):
    with tempfile.TemporaryDirectory(prefix="hvdbench-") as out_dir:
        payload = json.dumps({
            "workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "device": device, "root": str(root),
            "out_dir": out_dir, "fault": fault, "world": cell.chips})
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(cell.chips), sys.executable,
               str(ROOT / "hvdbench" / "run.py"), "--worker", payload]
        env = dict(os.environ, HVDBENCH_T0=repr(T0_WALL))
        # One process a card: split the host's threads among them.
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // cell.chips)))
        proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                stdout=sys.stderr, stderr=sys.stderr,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=WORKER_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        if rc != 0:
            raise SystemExit(f"[hvdbench] the launcher exited with {rc}")
        parts = []
        for r in range(cell.chips):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                parts.append(json.load(f))
    return parts


def worker_main(payload: str) -> int:
    """One rank under the launcher: run it, leave its part."""
    from hvdbench import spec, train
    a = json.loads(payload)
    rank = int(os.environ["HOROVOD_RANK"])
    root = Path(a["root"])
    cell = spec.load_cell(a["workload"], root, spec.bench_dirs_for(root))
    part = train.run_rank(cell, a["seed"], a["seconds"], a["trace"],
                          a["device"], rank, a["world"],
                          float(os.environ["HVDBENCH_T0"]), a["fault"])
    tmp = os.path.join(a["out_dir"], f".rank{rank}.json")
    with open(tmp, "w") as f:
        json.dump(part, f)
    os.replace(tmp, os.path.join(a["out_dir"], f"rank{rank}.json"))
    return 0


def _terminate(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    apply_env()
    if args.worker:
        return worker_main(args.worker)
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    signal.signal(signal.SIGTERM, _terminate)
    import torch
    from hvdbench import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this "
            f"machine has {have}")
        return 2
    cell, parts, out = run(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    report(cell, parts, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
