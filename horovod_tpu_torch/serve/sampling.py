"""Request-level sampling fields: the seed and the ``/generate`` payload
contract.

Port of the framework-free part of ``horovod_tpu/serve/sampling.py``
(``new_seed`` and ``validate_params``, copied unchanged), which the
batcher's ``Request`` needs.  Seeded sampling itself (temperature,
top-k, top-p, n>1 forks) is not ported yet: the port's engine decodes
greedily and fails a request that asks for more with a ValueError that
names the missing feature (the server answers 400).
"""

from __future__ import annotations

import random as _stdlib_random
from typing import Optional, Tuple

import numpy as np


def new_seed() -> int:
    """Server-assigned request seed (echoed in the response so a sampled
    output is reproducible)."""
    return _stdlib_random.getrandbits(31)


def validate_params(temperature, top_k, top_p, n, seed
                    ) -> Tuple[float, Optional[int], float, int, int]:
    """Validate + normalize the sampling fields of one request.

    Raises ``ValueError`` per field (the server maps it to HTTP 400);
    returns ``(temperature, top_k, top_p, n, seed)`` with ``seed``
    assigned when the client sent none."""
    # JSON booleans are client bugs on every field, not numbers to
    # coerce (True -> temperature 1.0 would silently serve a SAMPLED
    # answer to a malformed request).
    for name, value in (("temperature", temperature), ("top_k", top_k),
                        ("top_p", top_p), ("n", n)):
        if isinstance(value, bool):
            raise ValueError(f"{name} must be a number, got {value!r}")
    t = float(temperature)
    if not np.isfinite(t) or t < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature!r}")
    if top_k is not None:
        k = float(top_k)
        if not np.isfinite(k) or k != int(k):
            raise ValueError(f"top_k must be an integer, got {top_k!r}")
        top_k = int(k)
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k!r}")
    p = float(top_p)
    if not np.isfinite(p) or not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p!r}")
    nf = float(n)
    if not np.isfinite(nf) or nf != int(nf):
        raise ValueError(f"n must be an integer, got {n!r}")
    n = int(nf)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n!r}")
    if seed is None:
        seed = new_seed()
    elif isinstance(seed, bool) or not isinstance(seed, int):
        # JSON floats/strings/bools are all client errors: a seed is the
        # reproducibility handle, so a lossy coercion would be worse
        # than a 400.
        raise ValueError(f"seed must be an integer, got {seed!r}")
    return t, top_k, p, n, int(seed)
