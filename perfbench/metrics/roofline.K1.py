"""K1's share of its roofline: Σ bound / Σ device time over its launches,
the bound of each from the frozen counts at the cell's shape."""

from perfbench.roofline import kernel_roofline


def read(trace, ctx):
    return kernel_roofline("K1", trace, ctx)
