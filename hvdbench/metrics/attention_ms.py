"""Device ms a step of the operations launched in the program's ``attn``
spans (each block's ln1 through the proj residual), forward and
backward (``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("attn",))
