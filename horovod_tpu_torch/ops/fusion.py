"""The tensor-fusion planner, in Python.

Copy of ``PlanFusion`` (``horovod_tpu/csrc/hvd_core.cc:282-306``, the
reference's ``controller.cc:901`` ``FuseResponses``) that the JAX package
reaches through ``horovod_tpu.csrc.plan_fusion``; the port does not build
that native core.  Given the ready entries in order, it fills buckets
greedily up to the threshold, fusing only entries with the same
(dtype, op, process set); the look-ahead scans past a non-matching or
too-large entry to keep filling the current bucket, and the relative
order inside a bucket is the submission order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Entry = Tuple[str, str, int, int, int]  # name, dtype, bytes, op, set id


def plan_fusion(entries: Sequence[Entry], threshold_bytes: int
                ) -> List[List[int]]:
    """Fusion buckets as lists of entry indices (the signature of
    ``horovod_tpu.csrc.plan_fusion``)."""
    buckets: List[List[int]] = []
    used = [False] * len(entries)
    for i, (_, dtype, nbytes, op, ps) in enumerate(entries):
        if used[i]:
            continue
        bucket, total = [i], nbytes
        used[i] = True
        for j in range(i + 1, len(entries)):
            _, dt_j, nb_j, op_j, ps_j = entries[j]
            if used[j] or (dt_j, op_j, ps_j) != (dtype, op, ps):
                continue  # look-ahead: skip, keep scanning
            if total + nb_j > threshold_bytes:
                continue
            bucket.append(j)
            used[j] = True
            total += nb_j
        buckets.append(bucket)
    return buckets
