"""Adaptive density control (clone / split / prune) at fixed capacity.

Counterpart of ``syn3r_tpu/gs/densify.py``. Candidates (clones, two split
samples per split Gaussian, and with proximity unpooling two edge
midpoints per selected Gaussian) are compacted to the front by a stable
sort; pruned and split-origin slots are freed; candidate j goes into the
j-th free slot, and candidates beyond the free slots are dropped. The slot
order is the JAX package's, so states compare slot by slot.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.gaussians import GaussianState, quat_to_rotmat


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    grad_accum: torch.Tensor   # (cap,) accumulated screen-grad norms
    denom: torch.Tensor        # (cap,) iterations seen visible
    max_radii: torch.Tensor    # (cap,) largest screen radius seen

    @staticmethod
    def zeros(capacity: int, device=None) -> "DensifyStats":
        def z():
            return torch.zeros((capacity,), dtype=torch.float32,
                               device=device)
        return DensifyStats(grad_accum=z(), denom=z(), max_radii=z())

    def update(self, screen_grad: torch.Tensor, radii: torch.Tensor,
               visible: torch.Tensor) -> "DensifyStats":
        """screen_grad: (cap, 2) d(loss)/d(screen centre); radii: (cap,)."""
        gnorm = torch.linalg.norm(screen_grad, dim=-1)
        vis = visible.float()
        return DensifyStats(grad_accum=self.grad_accum + gnorm * vis,
                            denom=self.denom + vis,
                            max_radii=torch.maximum(self.max_radii,
                                                    radii * vis))


def densify_and_prune(state: GaussianState, stats: DensifyStats,
                      generator: torch.Generator | None = None,
                      grad_threshold: float = 2e-4,
                      percent_dense: float = 0.01, extent: float = 1.0,
                      min_opacity: float = 0.005,
                      max_world_scale: float | None = None,
                      max_screen_size: float | None = None,
                      big_point_gate: bool = True,
                      split_factor: float = 1.6,
                      use_proximity: bool = False,
                      proximity_k: int = 3,
                      proximity_threshold: float = 0.01,
                      noise: tuple | None = None):
    """One adaptive-density step. Returns (new_state, written): ``written``
    marks the slots whose parameters were rewritten (their Adam moments are
    zeroed by the trainer).

    The split samples are ``R (noise * scales)`` with ``noise`` two (cap, 3)
    standard normal draws; given as ``noise=(eps1, eps2)`` (the tests feed
    the JAX package's draws), else drawn from ``generator``.
    """
    cap = state.capacity
    dev = state.means.device
    avg_grad = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
    scales = torch.exp(state.log_scales)
    scale_max = scales.max(dim=-1).values

    hot = state.active & (avg_grad > grad_threshold)
    clone = hot & (scale_max <= percent_dense * extent)
    split = hot & (scale_max > percent_dense * extent)

    opacity = torch.sigmoid(state.opacity_logits[:, 0])
    keep = state.active & (opacity > min_opacity) & ~split
    big = torch.zeros((cap,), dtype=torch.bool, device=dev)
    if max_world_scale is not None:
        big = big | (scale_max > max_world_scale * extent)
    if max_screen_size is not None:
        big = big | (stats.max_radii > max_screen_size)
    if big_point_gate:
        keep = keep & ~big

    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator,
                                  device=generator.device).to(dev)
                      for _ in range(2))
    R = quat_to_rotmat(state.quats)
    off1, off2 = (torch.einsum("nij,nj->ni", R, eps.to(dev) * scales)
                  for eps in noise)
    split_log_scales = state.log_scales - math.log(split_factor)
    cand = {
        "means": [state.means, state.means + off1, state.means + off2],
        "quats": [state.quats] * 3,
        "log_scales": [state.log_scales, split_log_scales, split_log_scales],
        "opacity_logits": [state.opacity_logits] * 3,
        "sh_dc": [state.sh_dc] * 3,
        "sh_rest": [state.sh_rest] * 3,
    }
    cand_valid = [clone, split, split]

    if use_proximity:
        assert proximity_k >= 2, "midpoint growth needs >= 2 neighbours"
        from ..ops.knn import knn_with_indices
        d2, nbr, nbr_ok = knn_with_indices(state.means, k=proximity_k,
                                           valid=state.active)
        prox = torch.sqrt(d2).mean(-1)
        grow = (state.active & nbr_ok.all(-1)
                & (prox > proximity_threshold * extent))
        for t in range(2):                 # edges to the 2 nearest
            nb = nbr[:, t]
            cand["means"].append(0.5 * (state.means + state.means[nb]))
            cand["quats"].append(state.quats)
            for name in ("opacity_logits", "sh_dc", "sh_rest", "log_scales"):
                f = getattr(state, name)
                cand[name].append(0.5 * (f + f[nb]))
            cand_valid.append(grow)

    cand_valid = torch.cat(cand_valid)
    order = torch.argsort((~cand_valid).to(torch.int8), stable=True)
    n_new = int(cand_valid.sum())
    free_order = torch.argsort(keep.to(torch.int8), stable=True)
    n_free = cap - int(keep.sum())
    n_write = min(n_new, n_free)
    slot = free_order[:n_write]
    src = order[:n_write]

    new_fields = {}
    for name, parts in cand.items():
        field = getattr(state, name).clone()
        field[slot] = torch.cat(parts)[src]
        new_fields[name] = field
    written = torch.zeros((cap,), dtype=torch.bool, device=dev)
    written[slot] = True
    return state.replace(active=keep | written, **new_fields), written


def reset_opacity(state: GaussianState,
                  max_opacity: float = 0.01) -> GaussianState:
    """Clamp every opacity to <= max_opacity (the periodic 3DGS reset)."""
    cap_logit = math.log(max_opacity / (1.0 - max_opacity))
    return state.replace(opacity_logits=torch.clamp(state.opacity_logits,
                                                    max=cap_logit))
