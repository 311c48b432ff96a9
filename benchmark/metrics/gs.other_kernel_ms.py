"""gs.other_kernel_ms: device time of every operation in the traced
stretch that is no composite kernel (projection, binning, gathers, loss,
Adam, densify: kernels, copies and memsets; ``harness/gs_kernels.py``),
per train step, ms."""

from harness import gs_kernels


def read(ctx):
    if ctx.get("kind") != "gs" or ctx["busy_s"] <= 0:
        return None
    return 1e3 * gs_kernels.other_s(ctx["profile"]) / ctx["steps"]
