"""gs.lpips_conv_roofline: the LPIPS term's counted products of the traced
stretch's steps (``counts/lpips.step_ops`` of the cell's 960x540 frame a
step: the render's forward and its input gradient) over the device time of
its convolution kernels (``harness/lpips_kernels.py``) x the card's float32
peak outside the tensor cores (67 TFLOP/s, as ``gs.mfu``). The target's
forward is in the time and not in the count. Products moved onto TF32 or
split-TF32 tensor cores could read above 100% against this peak. Nothing
where no such kernel ran."""

from counts.composite import PEAK_F32_FLOPS
from counts.lpips import step_ops
from harness import lpips_kernels

# the frame of the cell that reports this metric (configs/
# gs_dl3dv_refine_lpips.json, scene)
FRAME = (540, 960)


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    spent = lpips_kernels.conv_s(ctx["profile"])
    if spent <= 0:
        return None
    return 100.0 * step_ops(*FRAME) * ctx["steps"] / (spent * PEAK_F32_FLOPS)
