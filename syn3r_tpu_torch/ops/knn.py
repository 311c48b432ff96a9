"""Blocked brute-force k nearest neighbours.

Counterpart of ``syn3r_tpu/ops/knn.py`` (not a Pallas kernel there: a
blocked XLA scan). Query blocks meet database chunks through
|q|^2 + |p|^2 - 2 q.p in float32, and a running ``topk`` keeps the best k;
the N x N distance matrix never exists. Self and invalid points are never
neighbours; where a query has fewer than k valid neighbours (or is itself
invalid) ``nbr_ok`` is False, the distance 0 and the index the query's own.
"""

from __future__ import annotations

import torch

_BIG = 3.0e37


def knn_with_indices(points: torch.Tensor, k: int = 3,
                     query_block: int = 2048, db_chunk: int = 65536,
                     valid: torch.Tensor | None = None):
    """k nearest neighbours of each point, self excluded.

    points: (N, 3) float32; valid: optional (N,) bool. Returns
    (sq_dists (N, k) f32 ascending, idx (N, k) int64, nbr_ok (N, k) bool).
    """
    n = points.shape[0]
    dev = points.device
    pts = points.float()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    sq = (pts * pts).sum(-1)
    best_d = torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    for q0 in range(0, n, query_block):
        q1 = min(q0 + query_block, n)
        qb = pts[q0:q1]
        q_idx = torch.arange(q0, q1, device=dev)
        bd, bi = best_d[q0:q1], best_i[q0:q1]
        for d0 in range(0, n, db_chunk):
            d1 = min(d0 + db_chunk, n)
            d = sq[q0:q1, None] + sq[None, d0:d1] - 2.0 * (qb @ pts[d0:d1].T)
            col = torch.arange(d0, d1, device=dev)
            bad = (col[None, :] == q_idx[:, None]) | ~valid[None, d0:d1]
            d = torch.where(bad, _BIG, d.clamp_min(0.0))
            kk = min(k, d1 - d0)
            top_d, top_p = torch.topk(d, kk, dim=1, largest=False)
            cat_d = torch.cat([bd, top_d], dim=1)
            cat_i = torch.cat([bi, col[top_p]], dim=1)
            sd, order = torch.sort(cat_d, dim=1, stable=True)
            bd = sd[:, :k]
            bi = torch.gather(cat_i, 1, order[:, :k])
        best_d[q0:q1], best_i[q0:q1] = bd, bi
    nbr_ok = (best_d < _BIG * 0.5) & valid[:, None]
    self_idx = torch.arange(n, device=dev)[:, None].expand(n, k)
    return (torch.where(nbr_ok, best_d, 0.0),
            torch.where(nbr_ok, best_i, self_idx), nbr_ok)


def knn_sq_dists(points: torch.Tensor, k: int = 3,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Squared distances (N, k) to the k nearest neighbours (self excluded;
    0 where there is no such neighbour)."""
    return knn_with_indices(points, k=k, valid=valid)[0]


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared distance to the (up to) k nearest neighbours, divided by
    the number of real neighbours: the 3DGS scale-init quantity."""
    d, _, ok = knn_with_indices(points, k=k, valid=valid)
    return d.sum(-1) / ok.sum(-1).clamp_min(1)
