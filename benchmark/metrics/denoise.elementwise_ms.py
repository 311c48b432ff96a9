"""denoise.elementwise_ms: the device time of the kernels launched inside
the port's ``unet.forward`` spans that are none of the hand-written
kernels (flash, GEGLU, GroupNorm, LayerNorm), cuDNN convolutions or GEMMs
by name (``harness/spans.FAMILIES``): the elementwise, reduction, copy and
layout work around them, in the profiler's trace of one call, per UNet
forward of that call."""

from harness import spans


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    s = spans.of(ctx["profile"])
    return s.per(s.under("unet.forward", {spans.ELEMENTWISE}),
                 "unet.forward")
