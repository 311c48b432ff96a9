"""gs.composite_ms: device time of the tile-composite kernels (forward and
the backward's three launches, ``harness/gs_kernels.py``) per train step
of the traced stretch, ms."""

from harness import gs_kernels


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    spent = gs_kernels.composite_fwd_s(ctx["profile"]) \
        + gs_kernels.composite_bwd_s(ctx["profile"])
    if spent <= 0:
        return None
    return 1e3 * spent / ctx["steps"]
