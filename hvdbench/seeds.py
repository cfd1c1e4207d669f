"""Every random draw of a run comes from ``--seed`` through one of these
streams, so the same seed gives the same weights and batches on every
run, and each rank's batches differ."""

from __future__ import annotations

import numpy as np

WEIGHTS = 0x77656967
DATA = 0x64617461


def derive(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for ``(seed, *stream)``; any whole
    ``seed``, negative or above 64 bits included."""
    words = [int(seed) % (1 << 64)] + [int(s) for s in stream]
    state = np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)
    return int(state[0]) >> 1


def generator(device, seed: int, *stream: int):
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *stream))
