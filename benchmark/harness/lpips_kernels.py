"""The GS step's LPIPS convolutions by kernel name in a profile.

The LPIPS term (``syn3r_tpu_torch/models/lpips.py``: VGG-16 to relu5_3
and five 1x1 ``lin`` layers, float32) runs its convolutions through
cuDNN: the forward of the render and of the target, the render's input
gradient, and what cuDNN's engines launch for them. No other part of the
GS step calls cuDNN or computes on complex numbers: SSIM's 11-tap windows
are PyTorch's own depthwise kernels (``conv_depthwise2d``), the composite
and the projection are the port's hand-written kernels. So a kernel is
the term's convolution where its name holds none of ``EXCLUDED`` and
either one of ``FRAGMENTS`` or every one of ``COMPLEX_GEMV``.
"""

from __future__ import annotations

# cuDNN's engines: implicit-GEMM forward and data-gradient kernels
# (``sm80_xmma_fprop_*``, ``sm80_xmma_dgrad_*``,
# ``cudnn::cnn::dgrad2d_grouped_direct_kernel``), the older
# ``implicit_convolve_sgemm`` family, the FFT-tiled engines' transforms
# (``fft2d_r2c_*``, ``fft2d_c2r_*``), and the layout transforms
# (``nchwToNhwcKernel``, ``nhwcToNchwKernel``)
FRAGMENTS = ("fprop", "dgrad", "wgrad", "convolve", "cudnn", "xmma",
             "fft2d", "nchwToNhwc", "nhwcToNchw")
# the FFT engines' products between the transforms: cuBLAS's batched GEMV
# on complex operands (``gemv2N_kernel<int, int, float2, ...>``)
COMPLEX_GEMV = ("gemv", "float2")
# PyTorch's depthwise convolution (SSIM's windows) and the port's kernels
EXCLUDED = ("conv_depthwise", "composite_", "project_")


def is_conv(name: str) -> bool:
    """Whether kernel ``name`` is one of the LPIPS term's convolutions."""
    if any(f in name for f in EXCLUDED):
        return False
    return (any(f in name for f in FRAGMENTS)
            or all(f in name for f in COMPLEX_GEMV))


def conv_s(prof) -> float:
    """Device seconds of the LPIPS term's convolution kernels in a read
    ``harness.common.Profile``."""
    return sum(s for name, (s, _) in prof.kernels.items() if is_conv(name))
