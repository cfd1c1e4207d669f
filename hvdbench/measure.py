#!/usr/bin/env python3
"""Measure a cell's spread: the runs that its bounds are set from.

    python3 hvdbench/measure.py --workload W --seeds 1,2,3,4,5,6 \
        --sets 2 --warm-seed 9 --trace-seeds 7,8,10 --out runs.jsonl

Each run is a process of its own, as a check makes it: ``run.py`` with
``--seconds`` from ``BENCHMARK.json``.  A first run (``--warm-seed``,
10 seconds; a full traced run with ``--warm-trace``) builds and
compiles, so no set holds a cold start.  Then
``--sets`` sets of runs over the same ``--seeds``, then traced runs.
Per metric and set: the spread, the distance between the first and
third quartile (``statistics.quantiles(values, n=4)``) over the median;
five times the widest is the bound it suggests (never under 1%).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


RUN_TIMEOUT_S = 1200   # a check allows a cell's first run as long


def one(workload, seed, seconds, trace) -> dict:
    t = time.time()
    cmd = [sys.executable, str(ROOT / "hvdbench" / "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    try:
        r = subprocess.run(cmd, cwd=str(ROOT), capture_output=True,
                           text=True, timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        r = subprocess.CompletedProcess(cmd, 124, e.stdout or "",
                                        e.stderr or "")
    lines = r.stdout.strip().splitlines()
    result = None
    if r.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "trace": trace, "rc": r.returncode,
            "wall_s": time.time() - t, "result": result,
            "stderr_tail": [ln for ln in r.stderr.splitlines()
                            if ln.startswith("[hvdbench]")][-14:]}


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--warm-seed", type=int)
    ap.add_argument("--warm-trace", action="store_true")
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []

    def record(rec, label):
        rec["set"] = label
        runs.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec["result"] or {}
        print(json.dumps({"set": label, "seed": rec["seed"], "rc": rec["rc"],
                          "wall_s": round(rec["wall_s"], 1),
                          "correct": res.get("correct"),
                          "attempted": res.get("attempted"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in
                                     res.get("checks", {}).items()}}),
              flush=True)

    if args.warm_seed is not None and args.warm_trace:
        record(one(args.workload, args.warm_seed, seconds, 1), "trace")
    elif args.warm_seed is not None:
        record(one(args.workload, args.warm_seed, 10, 0), "warm")
    for k in range(args.sets):
        for s in seeds:
            record(one(args.workload, s, seconds, 0), f"set{k + 1}")
    for s in [int(x) for x in args.trace_seeds.split(",") if x]:
        record(one(args.workload, s, seconds, 1), "trace")
    summary = {"workload": args.workload, "sets": {}}
    for k in range(args.sets):
        got = [r["result"] for r in runs
               if r["set"] == f"set{k + 1}" and r["result"]]
        per = {}
        for name in (got[0]["metrics"] if got else {}):
            vals = [g["metrics"][name]["value"] for g in got]
            per[name] = {"median": statistics.median(vals),
                         "spread": spread(vals) if len(vals) >= 2 else None,
                         "values": vals}
        summary["sets"][f"set{k + 1}"] = per
    names = set().union(*[set(v) for v in summary["sets"].values()])
    summary["bound_suggested"] = {
        n: max(0.01, 5 * max(s[n]["spread"] for s in summary["sets"].values()
                             if n in s and s[n]["spread"] is not None))
        for n in names}
    summary["correct"] = sum(bool(r["result"] and r["result"]["correct"])
                             for r in runs)
    summary["runs"] = len(runs)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
