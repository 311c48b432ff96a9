"""counts/composite.py against the kernel table's composite bounds
(PERF.md: 0.0547 ms forward, 0.0738 ms backward, both operations-bound)
at the table's shapes: the GS scene of ``scripts/kernel_timing.py``
(65,536 points from numpy seed 0 in a slab before one 504x378 camera),
binned by the port into T 96 tiles of 2048 pixels, cap 1024, K 128; and
the reference's tile lists against the port's on it. ``counts/lpips.py``
against VGG-16's published 15.35 GMAC at 224x224 and the reference's tap
shapes, and the step's count with and without the LPIPS term."""

import numpy as np
import torch

from counts import composite as cc
from counts import gs_step
from counts import lpips as lc
from reference import gs as ref
from reference import lpips as ref_lpips
from syn3r_tpu_torch.models.gaussians import from_points
from syn3r_tpu_torch.ops import rasterize as RZ
from syn3r_tpu_torch.utils.camera import camera_from_fov, look_at_w2c

N, W, H, CAP = 65_536, 504, 378, 1024


def table_scene():
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)),
                          rng.uniform(1.5, 4.0, (N, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    state = from_points(torch.from_numpy(xyz), torch.from_numpy(rgb),
                        capacity=N)
    cam = camera_from_fov(0.9, 0.7, W, H,
                          look_at_w2c([0.0, 0.0, 0.0], [0.0, 0.0, 2.5]))
    return state, cam


def test_bounds_reproduce_the_kernel_table():
    state, cam = table_scene()
    with torch.no_grad():
        tl = RZ.bin_tiles(RZ.project_gaussians(state, cam), H, W, cap=CAP,
                          chunk=256)
    T, _, cap = tl.G.shape
    px = tl.P.shape[1]
    assert (T, px, cap, tl.K) == (96, 2048, 1024, 128)
    live, hits = [], []
    for s in range(0, T, 8):
        lv, ht = cc.pairs(tl.P.T, tl.G[s:s + 8], tl.O[s:s + 8, 0])
        live += lv.tolist()
        hits += ht.tolist()
    fwd_s, fwd_by = cc.bound_s(*cc.fwd_cost(px, cap // tl.K, live, hits))
    bwd_s, bwd_by = cc.bound_s(*cc.bwd_cost(px, cap // tl.K, live, hits))
    assert (round(1e3 * fwd_s, 4), fwd_by) == (0.0547, "operations")
    assert (round(1e3 * bwd_s, 4), bwd_by) == (0.0738, "operations")


def test_reference_tile_lists_match_the_ports():
    """The same entries in the same order in every tile."""
    state, cam = table_scene()
    train = {"sh_degree": 3, "tile_cap": CAP}
    with torch.no_grad():
        sg = RZ.project_gaussians(state, cam)
        tl = RZ.bin_tiles(sg, H, W, cap=CAP, chunk=256)
        c = {"K": cam.K, "w2c": cam.w2c, "width": W, "height": H}
        params = {f: getattr(state, f) for f in ref.FIELDS}
        proj = ref.project(params, state.active, c, train["sh_degree"],
                           ref.Precision())
        ids, counts = ref.tile_lists(proj, H, W, CAP)
    # the port's lists hold features, not slots: compare each tile's
    # sequence of depths (row 3 of C), which tells the slots apart
    live = torch.arange(ids.shape[1])[None] < counts[:, None]
    depth = torch.where(live, proj["depth"][ids], 0.0)
    assert torch.equal(counts, (tl.O[:, 0] > 0).sum(1))
    assert torch.allclose(depth, tl.C[:, 3, :ids.shape[1]], rtol=1e-6,
                          atol=0)


def test_lpips_products():
    assert lc.conv_macs(224, 224) == 15_346_630_656
    assert lc.lin_macs(224, 224) == 6_121_472
    # the render's forward and its input gradient, two operations a product
    assert lc.step_ops(540, 960) == 4 * (157_883_351_040 + 63_191_040)
    assert lc.step_ops(378, 504) == 4 * (57_862_702_080 + 23_202_304)
    for h, w in ((540, 960), (378, 504), (64, 128)):
        assert gs_step.step_ops(1024, h, w, lpips=True) \
            - gs_step.step_ops(1024, h, w) == lc.step_ops(h, w)
    assert gs_step.step_ops(1024, 378, 504) == 3000 * 1024 + 2300 * 378 * 504


def test_lpips_counts_follow_the_reference_shapes():
    """The taps' shapes of ``reference/lpips.py`` at an odd frame give
    ``lin_macs``; the convolutions' inputs give ``conv_macs``."""
    h, w = 45, 71
    weights = {k: torch.zeros(s) for k, s in ref_lpips.shapes().items()}
    taps = ref_lpips.taps(weights, torch.zeros(1, 3, h, w), ref.Precision())
    assert lc.lin_macs(h, w) == sum(t.shape[1] * t.shape[2] * t.shape[3]
                                    for t in taps)
    macs, size = 0, (h, w)
    for _, kind, c_in, c_out in ref_lpips.layers():
        if kind == "pool":
            size = (size[0] // 2, size[1] // 2)
        else:
            macs += size[0] * size[1] * c_in * c_out * 9
    assert size == tuple(taps[-1].shape[2:])
    assert lc.conv_macs(h, w) == macs
