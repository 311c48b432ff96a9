"""denoise.pipeline_ms: the pipeline's own time a step (guidance gradient,
classifier-free guidance, Euler or soft replacement, direction merge, the
pipeline's Python): the window's time less the UNet forwards' time by CUDA
events, over the window's steps."""


def read(ctx):
    if ctx.get("kind") != "denoise" or not ctx["forward_s"]:
        return None
    return (ctx["window_s"] - sum(ctx["forward_s"])) / ctx["steps"] * 1e3
