"""gs.lpips_conv_ms: device time of the LPIPS term's convolution kernels
(cuDNN's forward of the render and of the target, the render's input
gradient and their layout transforms; ``harness/lpips_kernels.py``) per
train step of the traced stretch, ms; nothing where no such kernel ran."""

from harness import lpips_kernels


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    spent = lpips_kernels.conv_s(ctx["profile"])
    if spent <= 0:
        return None
    return 1e3 * spent / ctx["steps"]
