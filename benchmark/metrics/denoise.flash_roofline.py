"""denoise.flash_roofline: the flash-attention forward kernel (flash_wgmma_kernel): its roofline bound
(counts/unet.py: the larger of operations over the bf16 peak and bytes over
the HBM peak), at the shapes of the traced call's forwards, over its device
time in the profiler's trace of that call."""

KERNELS = ("flash_wgmma_kernel",)


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    spent = ctx["profile"].kernel_s(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx["traced_bound_s"]["flash"] / spent
