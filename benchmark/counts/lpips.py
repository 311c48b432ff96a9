"""Products of the GS refine's LPIPS term (VGG-16 to relu5_3 and the five
``lin`` layers, ``reference/lpips.py``) in one train step, counted from
the frame's shape: multiply-adds, two operations each.

A 3x3 convolution costs H x W x C_in x C_out x 9 multiply-adds at its
input's size, each 2x2 max-pool halving H and W (floor); a ``lin`` layer
costs C a pixel of its tap. A step counts the render's forward and its
input gradient, which costs what the forward costs: 2 x 2 x the forward's
multiply-adds. Left out: the target's forward, which depends on the view
alone and can be kept between steps, and weight gradients, since the
weights are frozen; and every operation that is no product (bias, ReLU,
pooling, the unit normalisation, the means).
"""

from __future__ import annotations

from reference.lpips import TAP_CHANNELS, layers


def conv_macs(height: int, width: int) -> int:
    """Multiply-adds of VGG-16's 13 convolutions to relu5_3 on one
    (height, width) image."""
    total = 0
    for _, kind, c_in, c_out in layers():
        if kind == "pool":
            height, width = height // 2, width // 2
        else:
            total += height * width * c_in * c_out * 9
    return total


def lin_macs(height: int, width: int) -> int:
    """Multiply-adds of the five ``lin`` layers on the taps of one
    (height, width) image."""
    total = 0
    for t, c in enumerate(TAP_CHANNELS):
        total += (height >> t) * (width >> t) * c
    return total


def step_ops(height: int, width: int) -> int:
    """Operations of LPIPS in one train step on a (height, width) frame:
    the render's forward and its input gradient."""
    return 2 * 2 * (conv_macs(height, width) + lin_macs(height, width))
