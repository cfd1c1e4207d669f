"""Device ms a step of the operations launched in the program's ``head``
(``ln_f``, the tied LM head, the f32 cast) and ``loss`` (``lm_loss``)
spans, forward and backward (``hvdbench/program_spans.py``)."""

from hvdbench import program_spans


def read(ctx):
    return program_spans.ms_per_step(ctx, ("head", "loss"))
