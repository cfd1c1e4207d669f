"""Device ms a step of the operations launched in the program's ``mlp``
spans (each block's ln2 through the fc2 residual), forward and backward
(``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("mlp",))
