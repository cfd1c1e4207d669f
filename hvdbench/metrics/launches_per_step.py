"""Kernels launched a step in the profiled stretch (an exact count)."""


def read(ctx):
    kernels = ctx.trace.kernels()
    if not kernels or not ctx.steps_profiled:
        return None
    return len(kernels) / ctx.steps_profiled
