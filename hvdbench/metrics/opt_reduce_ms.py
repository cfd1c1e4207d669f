"""Device ms a step of the operations launched in
``DistributedOptimizer.step``'s ``opt.reduce`` span: each fusion bucket's
pack, collective and unpack (``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("opt.reduce",))
