"""Device ms a step of the operations launched in
``DistributedOptimizer.step``'s ``opt.inner`` span: the wrapped
optimizer's ``step()`` (``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("opt.inner",))
