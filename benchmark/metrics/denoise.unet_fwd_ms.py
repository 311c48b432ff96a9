"""denoise.unet_fwd_ms: one UNet forward (in both cells a direction's
call: batch 3 post, batch 2 prob), by CUDA events from forward pre and post hooks, the
mean over the window's forwards."""


def read(ctx):
    if ctx.get("kind") != "denoise" or not ctx["forward_s"]:
        return None
    return sum(ctx["forward_s"]) / len(ctx["forward_s"]) * 1e3
