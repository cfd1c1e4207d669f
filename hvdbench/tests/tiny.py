"""A throwaway cell at a tiny size, laid out as a later change would add
one: a configuration, a mix and limits in files of their own, and a
``BENCHMARK.json`` naming them, under a temporary root."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# Limits for the tiny cells, set from CPU readings at this size: sound
# runs read loss <= 1e-4, gradient <= 3.1e-3, change <= 6.1e-3; the fp8
# control reads loss >= 3.7e-4, gradient >= 1.05e-2, change >= 1.7e-2.
TINY_LIMITS = {"loss_gap": 2e-4, "grad_gap": 6e-3, "delta_gap": 1.1e-2}


def make(root, *, task="causal_lm", ranks=1, passes=1, dtype="bfloat16",
         attention="flash", name="tiny", limits=None) -> str:
    """Write the cell's files under ``root``; returns the cell's name."""
    root = Path(root)
    hb = root / "hvdbench"
    for d in ("configs", "traffic", "limits"):
        (hb / d).mkdir(parents=True, exist_ok=True)
    model = {"vocab_size": 512, "num_layers": 2, "num_heads": 2,
             "d_model": 128, "d_ff": 256, "max_len": 64,
             "causal": task == "causal_lm", "block_ln_eps": 1e-5,
             "final_ln_eps": 1e-6, "activation": "gelu_tanh",
             "compute_dtype": dtype, "param_dtype": "float32",
             "attention": attention, "remat": False, "mask_token_id": 3,
             "min_token_id": 5}
    config = {"name": name, "reference": "transformer", "model": model,
              "init": {"kernel_std": 0.02, "token_embedding_std": 0.02,
                       "position_embedding_std": 0.01}}
    traffic = {"task": task, "seq_len": 32, "micro_batch": 4,
               "backward_passes_per_step": passes, "distinct_steps": 8,
               "predictions_per_seq": 5,
               "optimizer": {"name": "AdamW", "lr": 1e-3,
                             "betas": [0.9, 0.999], "eps": 1e-8,
                             "weight_decay": 1e-4},
               "reduce": {"op": "Average", "compression": "none"},
               "warmup_steps": 1, "checked_steps": 3, "profile_steps": 2}
    cell = f"{name}.{task}.{ranks}r"
    mix = f"{name}-{task}-{ranks}r"
    (hb / "configs" / f"{name}.json").write_text(json.dumps(config))
    (hb / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    lim = {k: {"limit": v} for k, v in (limits or TINY_LIMITS).items()}
    (hb / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": name, "source": "test",
                         "file": f"hvdbench/configs/{name}.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": cell, "config": name, "traffic": mix,
                           "chips": ranks, "why": "a test"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m["workloads"] = [cell]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell
