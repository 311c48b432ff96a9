"""denoise.step_idle_ms: the device's idle time in the profiler's trace of
one call whose gap starts while the host is inside the port's
``denoise.call`` span but outside every ``unet.forward`` span (idle the
pipeline's host work causes), per denoise step (``denoise.step`` span) of
that call (``harness/spans.py``)."""

from harness import spans


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    s = spans.of(ctx["profile"])
    return s.per(s.idle_us["pipeline"], "denoise.step")
