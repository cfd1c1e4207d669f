"""Device ms a step of the operations launched in
``DistributedOptimizer.step``'s ``opt.accumulate`` (the add into the f32
accumulators) and ``opt.writeback`` (each ``grad`` set, the accumulators
zeroed) spans (``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("opt.accumulate",
                                           "opt.writeback"))
