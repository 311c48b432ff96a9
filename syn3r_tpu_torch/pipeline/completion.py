"""The lambda schedule of guided completion.

Counterpart of ``syn3r_tpu/pipeline/completion.py:36-68`` (``quad_tau``,
``search_hypers_v2``; reference ``model/diffusionGS.py:1120-1205``). The
rest of that module (pose interpolation, warping, uncertainty fusion) is
not ported yet.
"""

from __future__ import annotations

import torch


def quad_tau(u: torch.Tensor) -> torch.Tensor:
    """Per-frame guidance-stop threshold, the reference's quadratic."""
    a, b, c = -0.22 / 1.4, 2.4 * 0.22 / 1.4, 0.2
    return (a * u ** 2 + b * u + c) * 100.0


def search_hypers_v2(masks: torch.Tensor,
                     num_steps: int = 100) -> torch.Tensor:
    """lambda in {0,1}^(num_steps x F) from the (F-2, h, w) uncertainty
    masks of the inner frames (the 'double_end' mode, the only one the
    completion unit uses): frame tau keeps lambda = 1 while
    num_steps - t > quad_tau(u_tau); both endpoints always keep 1."""
    u = masks.float().mean(dim=(-1, -2))
    u = torch.clamp(u / torch.clamp(u.max(), min=0.5), 0.0, 1.0)
    zero = u.new_zeros(1)
    u = torch.cat([zero, u, zero])
    steps = torch.arange(num_steps, dtype=torch.float32,
                         device=u.device)[:, None]
    lam = (num_steps - steps > quad_tau(u)[None, :]).float()
    lam[:, 0] = 1.0
    lam[:, -1] = 1.0
    return lam
