"""The GS cells' kernels by name in a profile: the tile-composite forward
(one launch a call) and backward (three launches a call: the tot pass,
the gradient pass and the fixed-order sum of the pixel blocks' partials),
the hand-written kernels of ``syn3r_tpu_torch/csrc/composite_fwd.cu``
and ``composite_bwd.cu``. Everything else the traced stretch ran on the
device (the projection, binning, loss, Adam and densify work: kernels,
copies and memsets) is "other"."""

from __future__ import annotations

COMPOSITE_FWD = ("composite_fwd_kernel",)
COMPOSITE_BWD = ("composite_bwd_tot", "composite_bwd_grad",
                 "composite_bwd_reduce")


def composite_fwd_s(prof) -> float:
    return prof.kernel_s(*COMPOSITE_FWD)


def composite_bwd_s(prof) -> float:
    return prof.kernel_s(*COMPOSITE_BWD)


def other_s(prof) -> float:
    """Device seconds of every operation that is no composite kernel."""
    return prof.kernel_s("") - composite_fwd_s(prof) - composite_bwd_s(prof)
