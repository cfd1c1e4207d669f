"""The step's share of the chip's bf16 peak, %: the model's operations a
step (``hvdbench/roofline.py`` ``step_flops``) times the timed steps
outside the profiled stretch, over their seconds and the peak."""

from hvdbench.peaks import peak


def read(ctx):
    top = peak(ctx.device_kind, "bf16_flops")
    seconds = sum(ctx.mfu_steps_s)
    if top is None or seconds <= 0:
        return None
    return 100.0 * ctx.flops_per_step * len(ctx.mfu_steps_s) / (seconds * top)
