"""%: one less the union of every device operation's interval, on any
stream, over the profiled wall span."""


def read(ctx):
    w0, w1 = ctx.trace.wall()
    if not ctx.trace.ops or w1 <= w0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy() / (w1 - w0))
