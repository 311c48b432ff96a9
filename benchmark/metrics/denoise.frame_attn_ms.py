"""denoise.frame_attn_ms: the device time of the kernels launched inside
the port's ``unet.frame_attention`` spans (the short path of
``ops/attention.attention``: the UNet's temporal self-attention over the
frames, the frame-attention kernel on the card) in the profiler's trace of
one call, per UNet forward (``unet.forward`` span) of that call
(``harness/spans.py``). None where the trace holds no such span: a program
without it."""

from harness import spans


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    s = spans.of(ctx["profile"])
    if not s.counts["unet.frame_attention"]:
        return None
    return s.per(s.under("unet.frame_attention"), "unet.forward")
