"""denoise.step_own_ms: the device time of the kernels launched inside the
port's ``denoise.step`` spans but outside its ``denoise.unet`` spans (the
guidance gradient, the CFG combination and scheduler step, the input
flips and the direction merge) in the profiler's trace of one call, per
denoise step (``denoise.step`` span) of that call (``harness/spans.py``)."""

from harness import spans


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    s = spans.of(ctx["profile"])
    return s.per(s.under("denoise.step", without="denoise.unet"),
                 "denoise.step")
