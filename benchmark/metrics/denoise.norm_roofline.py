"""denoise.norm_roofline: the GroupNorm (stats and apply) and LayerNorm kernels together; a norm needs one read of x and one write of y, so the stats pass is time with no counted work: its roofline bound
(counts/unet.py: the larger of operations over the bf16 peak and bytes over
the HBM peak), at the shapes of the traced call's forwards, over its device
time in the profiler's trace of that call."""

KERNELS = ("gn_stats_kernel", "gn_apply_kernel", "layer_norm_kernel")


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    spent = ctx["profile"].kernel_s(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx["traced_bound_s"]["norm"] / spent
