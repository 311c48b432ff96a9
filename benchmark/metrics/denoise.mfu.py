"""denoise.mfu: the whole step's share of the card's bf16 peak: the
matrix-product operations of the window's UNet forwards at the shapes the
forward log saw (counts/unet.py: convolutions, linear layers, GEGLU,
attention) over the window's time times 989 TFLOP/s."""

from counts.peaks import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "denoise":
        return None
    return 100.0 * ctx["window_flops"] / (ctx["window_s"] * PEAK_BF16_FLOPS)
