"""ms a step in which an NCCL kernel runs on the device and no other
operation does (a world of more than one)."""

from hvdbench.traces import is_nccl


def read(ctx):
    if ctx.world < 2 or not ctx.steps_profiled:
        return None
    if not any(is_nccl(o) for o in ctx.trace.ops):
        return None
    return ctx.trace.exposed(is_nccl) / 1e3 / ctx.steps_profiled
