"""denoise.transformer_ms: the device time of the kernels launched inside
the port's ``unet.transformer`` spans (each TransformerSpatioTemporalModel:
its spatial and temporal blocks, GroupNorm, projections, position
embedding, reshapes and mixer) in the profiler's trace of one call, per
UNet forward (``unet.forward`` span) of that call (``harness/spans.py``)."""

from harness import spans


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    s = spans.of(ctx["profile"])
    return s.per(s.under("unet.transformer"), "unet.forward")
