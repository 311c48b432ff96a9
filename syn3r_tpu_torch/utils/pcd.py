"""Point-cloud post-processing.

Counterpart of ``syn3r_tpu/utils/pcd.py``: open3d's
``remove_statistical_outlier`` on the port's blocked k-nearest-neighbour
search (``ops/knn.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.knn import knn_sq_dists


def remove_statistical_outliers(xyz: np.ndarray, rgb: np.ndarray,
                                k: int = 8, std_ratio: float = 2.0,
                                device="cuda"):
    """Drop the points whose mean distance to their k nearest neighbours
    exceeds the cloud's mean of that distance by ``std_ratio`` standard
    deviations (population std). The search runs on ``device``; a cloud
    of at most k points comes back as it is."""
    if len(xyz) <= k:
        return xyz, rgb
    pts = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    d = torch.sqrt(knn_sq_dists(pts, k=k)).cpu().numpy()
    mean_d = d.mean(axis=1)
    keep = mean_d < mean_d.mean() + std_ratio * mean_d.std()
    return xyz[keep], rgb[keep]
