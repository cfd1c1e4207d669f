#!/usr/bin/env python3
"""The readings that the correctness limits are set from.

    python3 hvdbench/calibrate.py --workload W --seeds 1,2,3 --what program
    python3 hvdbench/calibrate.py --workload W --seeds 1,2,3 --what control

``program``: the program's checked steps and the reference's, seed after
seed in one process a rank (through the launcher on a cell of several
chips), with no measured window: the lower readings.

``control``: on one device, the reference with every product in fp8
(``reference/products.py``) put in the program's place, and the faults
planted in the reference put in its place: half of each batch left out,
and, for a cell of several ranks, each rank stepping on its own
gradient (the exchange left out).  Every rank of the cell is computed
in this process.  A state left unchanged reads 1 on ``delta_gap`` by
construction and is not run.

One JSON line a seed on standard output, and the maxima at the end.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

from run import ROOT, apply_env, log  # noqa: E402  (sets sys.path)


def _program_rank(cell, seeds, device, rank, world):
    import horovod_tpu_torch as hvd
    from hvdbench import train
    hvd.init(device=device)
    dev = hvd.device()
    _, allreduce_sum = train.harness_groups(world, dev)
    rows = []
    for seed in seeds:
        program = train.Program(cell.config, cell.traffic, seed, dev, rank)
        readings = train.checked_readings(
            program, int(cell.traffic["checked_steps"]))
        del program
        train.free(dev)
        gaps, ref = train.check(cell, seed, dev, rank, world, allreduce_sum,
                                readings)
        del ref, readings
        train.free(dev)
        rows.append({"seed": seed, "rank": rank, **gaps})
        log(f"program seed {seed} rank {rank}: {gaps}")
    hvd.shutdown()
    return rows


def _as_program(readings, sizes, ranks):
    from hvdbench import compare
    return {"losses": {r: readings["losses"][r] for r in ranks},
            "grad_norms": compare.leaf_norms(readings["grad"], sizes),
            "delta": readings["delta"]}


def _control(cell, seeds, device):
    import torch
    from hvdbench import compare, train, weights
    dev = torch.device(device)
    world = cell.chips
    ranks = list(range(world))
    sizes = [weights.numel(s)
             for s in weights.layout(cell.config["model"]).values()]
    rows = []
    for seed in seeds:
        args = (cell.config, cell.traffic, seed, dev)
        ref = train.reference_readings(*args, ranks, world)
        row = {"seed": seed}
        fp8 = train.reference_readings(*args, ranks, world, mode="fp8")
        row["fp8"] = compare.gaps(_as_program(fp8, sizes, ranks), ref, sizes)
        del fp8
        half = train.reference_readings(*args, ranks, world, half_batch=True)
        row["half_batch"] = compare.gaps(_as_program(half, sizes, ranks),
                                         ref, sizes)
        del half
        if world > 1:
            own = train.reference_readings(*args, [0], 1)
            row["no_exchange"] = compare.gaps(_as_program(own, sizes, [0]),
                                              ref, sizes)
            del own
        del ref
        train.free(dev)
        rows.append(row)
        log(f"control seed {seed}: {row}")
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    apply_env()
    from hvdbench import spec
    root = Path(args.root)
    cell = spec.load_cell(args.workload, root, spec.bench_dirs_for(root))
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "control":
        rows = _control(cell, seeds, args.device)
        for key in ("fp8", "half_batch", "no_exchange"):
            got = [r[key] for r in rows if key in r]
            if got:
                least = {k: min(g[k] for g in got) for k in got[0]}
                print(json.dumps({key: least, "least_of": len(got)}))
        return 0
    if args.worker:
        rank = int(os.environ["HOROVOD_RANK"])
        rows = _program_rank(cell, seeds, args.device, rank, cell.chips)
        with open(os.path.join(args.worker, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
        return 0
    if cell.chips == 1:
        rows = _program_rank(cell, seeds, args.device, 0, 1)
    else:
        import subprocess
        with tempfile.TemporaryDirectory(prefix="hvdbench-cal-") as out:
            cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                   "-np", str(cell.chips), sys.executable,
                   str(ROOT / "hvdbench" / "calibrate.py"),
                   "--workload", args.workload, "--seeds", args.seeds,
                   "--what", "program", "--device", args.device,
                   "--root", args.root, "--worker", out]
            env = dict(os.environ)
            env.setdefault("OMP_NUM_THREADS",
                           str(max(1, (os.cpu_count() or 1) // cell.chips)))
            subprocess.run(cmd, cwd=str(ROOT), env=env, check=True,
                           stdout=sys.stderr)
            rows = []
            for r in range(cell.chips):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    rows.extend(json.load(f))
    by_seed = {}
    for row in rows:
        cur = by_seed.setdefault(row["seed"], {"seed": row["seed"]})
        for k in ("loss_gap", "grad_gap", "delta_gap"):
            cur[k] = max(cur.get(k, 0.0), row[k])
    for row in by_seed.values():
        print(json.dumps(row), flush=True)
    print(json.dumps({"max": {k: max(r[k] for r in by_seed.values())
                              for k in ("loss_gap", "grad_gap", "delta_gap")},
                      "seeds": len(by_seed)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
