"""The exchange's bus bandwidth, GB/s: the bytes the optimizer handed to
its collectives a step (the program's ``opt`` counters) times
2 (n - 1) / n, over the NCCL kernels' device seconds a step (a world of
n > 1; ``hvdbench/program_spans.py``)."""

from hvdbench import program_spans
from hvdbench.traces import is_nccl


def read(ctx):
    if ctx.world < 2 or not ctx.steps_profiled:
        return None
    sent = program_spans.bytes_per_step(ctx)
    us = sum(o.end - o.start for o in ctx.trace.ops if is_nccl(o))
    if not sent or us <= 0:
        return None
    seconds = us / 1e6 / ctx.steps_profiled
    return sent * 2 * (ctx.world - 1) / ctx.world / seconds / 1e9
