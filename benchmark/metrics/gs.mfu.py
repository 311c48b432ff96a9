"""gs.mfu: the traced stretch's counted operations (the composite kernels'
from each step's live entries and hit pairs, ``counts/composite.py``, and
the rest of each step, ``counts/gs_step.py``, with the LPIPS term's
products where the step has one, ``counts/lpips.py``) over its wall time x the
card's float32 peak outside the tensor cores (67 TFLOP/s): the whole
step's share, which bounds the composite rooflines' gains; nothing where
no operation ran on the device."""

from counts.composite import PEAK_F32_FLOPS


def read(ctx):
    if ctx.get("kind") != "gs" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * ctx["composite_bound"]["ops"] / (ctx["traced_wall_s"]
                                                    * PEAK_F32_FLOPS)
