"""The traffic generator: a mix file's parameters to batches on the device.

Each rank draws ``distinct_steps * backward_passes_per_step``
micro-batches from ``(seed, rank)`` in a few calls and cycles them, so
every rank's data differ and a step's rows differ from the next
``distinct_steps - 1`` steps'.  Tasks:

* ``causal_lm``: ``tokens`` [B, S], uniform over the vocabulary; the
  loss predicts ``tokens[:, 1:]`` from ``tokens[:, :-1]``.
* ``masked_lm``: ``tokens`` uniform over ``[min_token_id, vocab)``,
  exactly ``predictions_per_seq`` distinct sorted positions a row
  (BERT's ``max_predictions_per_seq``), replaced by ``mask_token_id`` in
  ``inputs``; ``labels`` are the original tokens there.
"""

from __future__ import annotations

from typing import Dict, List

from . import seeds


def micro_batches(config: dict, traffic: dict, seed: int, rank: int,
                  device) -> List[Dict[str, "object"]]:
    import torch
    model = config["model"]
    n = int(traffic["distinct_steps"]) * \
        int(traffic["backward_passes_per_step"])
    B, S = int(traffic["micro_batch"]), int(traffic["seq_len"])
    V = model["vocab_size"]
    if S > model["max_len"]:
        raise ValueError(f"seq_len {S} exceeds the model's {model['max_len']}")
    gen = seeds.generator(device, seed, seeds.DATA, rank)
    task = traffic["task"]
    if task == "causal_lm":
        tokens = torch.randint(0, V, (n, B, S), generator=gen, device=device)
        return [{"tokens": tokens[i]} for i in range(n)]
    if task == "masked_lm":
        K = int(traffic["predictions_per_seq"])
        lo, mask_id = int(model["min_token_id"]), int(model["mask_token_id"])
        tokens = torch.randint(lo, V, (n, B, S), generator=gen, device=device)
        order = torch.rand((n, B, S), generator=gen,
                           device=device).argsort(dim=-1)
        positions = order[..., :K].sort(dim=-1).values
        labels = torch.gather(tokens, -1, positions)
        inputs = tokens.scatter(-1, positions, mask_id)
        return [{"inputs": inputs[i], "positions": positions[i],
                 "labels": labels[i]} for i in range(n)]
    raise ValueError(f"unknown task {task!r}")


def micro_batch_of(traffic: dict, step: int, m: int) -> int:
    """The micro-batch index that pass ``m`` of optimizer step ``step``
    takes."""
    passes = int(traffic["backward_passes_per_step"])
    return (step * passes + m) % (int(traffic["distinct_steps"]) * passes)


def samples_per_step(traffic: dict) -> int:
    """Sequences one rank consumes in one optimizer step."""
    return int(traffic["micro_batch"]) * \
        int(traffic["backward_passes_per_step"])
