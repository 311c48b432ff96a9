"""gs.composite_fwd_roofline: the composite forward kernel's roofline
bound (``counts/composite.py``: operations over the float32 peak or bytes
over the HBM peak, whichever is larger, from each traced step's live
entries and hit pairs) over its device time in the traced stretch."""

from harness import gs_kernels


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    spent = gs_kernels.composite_fwd_s(ctx["profile"])
    if spent <= 0:
        return None
    return 100.0 * ctx["composite_bound"]["fwd_s"] / spent
