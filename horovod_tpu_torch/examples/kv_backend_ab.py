"""The KV server's backends against each other, on the phases that use it.

Runs ``chip_smoke.py``'s phases 12 (elastic kill-and-rejoin), 15 (the
tiered KV hierarchy: prefix migration over the KV server) and 18 (the
Spark estimator through ``hvd.run``, ``run_elastic``) once per entry of
``--order``, each in a fresh process with ``HVD_TPU_KV_SERVER`` set to
that backend, so the two backends alternate inside one call on one card
(native, python, python, native by default).  Each run appends one JSON
line to ``--out``: the phase's times that wait on the KV server (kill to
first step; migrated and local TTFT; ``fit`` to first step and
``run_elastic``'s kill to first step), the phase's seconds, the servers
started by backend, and the card's name and power limit.  Run from the
root of a checkout (it imports ``chip_smoke``):
    python -m horovod_tpu_torch.examples.kv_backend_ab --out ab.jsonl
On the CPU (the smoke's rehearsal sizes):
    python -m horovod_tpu_torch.examples.kv_backend_ab --device cpu --phases 15
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_one(backend: str, phase: str, device: str) -> dict:
    """One phase in this process on ``backend``: its KV-bound numbers."""
    os.environ["HVD_TPU_KV_SERVER"] = backend
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from horovod_tpu_torch.runner import http_server
    rehearsal = device == "cpu"
    dev = torch.device(device)
    t0 = time.monotonic()
    if phase == "12":
        r = c.elastic_phase(torch, dev, rehearsal)
        rec = {"kill_to_first_step_s": r["kill_to_first_step_s"]}
    elif phase == "15":
        _, r = c.tier_phase(torch, dev, rehearsal, 1234)
        mig = r["fleet_tier"]["migration"]
        rec = {"migrated_ttft_ms": {k: v["ttft_ms_migrated"]
                                    for k, v in mig.items()},
               "local_ttft_ms": {k: v["ttft_ms_local_prefill"]
                                 for k, v in mig.items()}}
    elif phase == "18":
        _, r = c.integrations_phase(torch, dev, rehearsal, 1234)
        rec = {"fit_to_first_step_s": r["estimator"]["fit_to_first_step_s"],
               "elastic_kill_to_first_step_s":
                   r["elastic"]["kill_to_first_step_s"]}
    else:
        raise ValueError(f"phase {phase!r}: one of 12, 15, 18")
    rec.update(backend=backend, phase=phase,
               seconds=time.monotonic() - t0,
               starts=dict(http_server.STARTS),
               card=None if rehearsal else c.card_tag())
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="15,12,18")
    parser.add_argument("--order", default="native,python,python,native")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="kv_backend_ab.jsonl")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds for one phase's process")
    parser.add_argument("--one", nargs=2, metavar=("BACKEND", "PHASE"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        rec = run_one(*args.one, args.device)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec))
        return 0
    failed = []
    for phase in args.phases.split(","):
        for backend in args.order.split(","):
            cmd = [sys.executable, "-m", "horovod_tpu_torch.examples."
                   "kv_backend_ab", "--one", backend, phase, "--device",
                   args.device, "--out", args.out]
            try:
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append(f"phase {phase} on {backend}: {rc}")
    for f in failed:
        print(f"kv_backend_ab: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
