"""The flash kernels' share of their roofline in the traced train steps:
the sum of each call's bound over their device time."""
from portbench.core.readers import flash_roofline_pct


def read(ctx):
    return flash_roofline_pct(ctx, "train")
