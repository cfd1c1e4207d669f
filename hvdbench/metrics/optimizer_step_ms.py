"""Device ms a step of the operations launched in the harness's ``opt``
spans (``DistributedOptimizer.step``: accumulation, the reduction, the
wrapped AdamW)."""


def read(ctx):
    spans = ("opt",)
    if not ctx.trace.ops or not ctx.steps_profiled or \
            not ctx.trace.has_spans(spans):
        return None
    return ctx.trace.time_in(spans) / 1e3 / ctx.steps_profiled
