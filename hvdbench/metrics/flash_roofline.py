"""The flash kernels' share of their roofline, %: the sum of each
launch's least time (``hvdbench/roofline.py``, the cell's shapes) over
the sum of their measured times."""

from hvdbench.roofline import flash_kernel_of


def read(ctx):
    if not ctx.flash_bounds:
        return None
    bound = spent = 0.0
    for op in ctx.trace.kernels():
        k = flash_kernel_of(op.name)
        if k is not None:
            bound += ctx.flash_bounds[k]
            spent += (op.end - op.start) / 1e6
    if spent <= 0:
        return None
    return 100.0 * bound / spent
