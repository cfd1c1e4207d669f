"""Device ms a step of the operations launched in the harness's ``fwd``
and ``bwd`` spans (the transformer's forward and backward)."""


def read(ctx):
    spans = ("fwd", "bwd")
    if not ctx.trace.ops or not ctx.steps_profiled or \
            not ctx.trace.has_spans(spans):
        return None
    return ctx.trace.time_in(spans) / 1e3 / ctx.steps_profiled
