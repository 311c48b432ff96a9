"""gs.composite_bwd_roofline: the composite backward's roofline bound
(``counts/composite.py``, as the forward's) over the device time of its
three kernels in the traced stretch."""

from harness import gs_kernels


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    spent = gs_kernels.composite_bwd_s(ctx["profile"])
    if spent <= 0:
        return None
    return 100.0 * ctx["composite_bound"]["bwd_s"] / spent
