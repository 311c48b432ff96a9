"""Operations of one GS train step outside the composite kernels, counted
from the formulas as ``counts/composite.py`` counts the composite's (an
exp, sqrt, divide or compare counts one), for the step's share of the
card's float32 peak (``gs.mfu``).

Per slot of the capacity (the step computes every slot, live or not):
the projection forward ~435 (the camera transform 18, perspective and
the clamped Jacobian 18, J R 36, the quaternion's rotation 40, R S S^T
R^T 54, the 2D covariance 96, conic and radius 20, view direction 12, SH
degree 3 136, sigmoid 5) and its backward twice that, 870; binning ~860
(the 3-sigma box against 96 tiles, 8 each, and their prefix sums); Adam
~826 (14 over each of 59 values); about 3,000 in all.
Per pixel of the frame: L1 9, SSIM ~765 (15 maps, two 11-tap passes of 2
operations, the combination) and their backward twice that, the depth
term ~20: about 2,300.
Where the step has the LPIPS term, plus its products (``counts/lpips.py``).
"""

from .lpips import step_ops as lpips_ops

OPS_PER_SLOT = 3000
OPS_PER_PIXEL = 2300


def step_ops(capacity: int, height: int, width: int,
             lpips: bool = False) -> float:
    """Operations of one step outside the composite kernels, on a (height,
    width) frame, with the LPIPS term where ``lpips``."""
    ops = OPS_PER_SLOT * capacity + OPS_PER_PIXEL * height * width
    return ops + (lpips_ops(height, width) if lpips else 0)
