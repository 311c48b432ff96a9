"""Parity of the port's rasterizer (projection, binning, tile composite and
its analytic backward) against the JAX package on the CPU.

The same numpy-made scene goes through both packages. The port's
``composite_tiles`` runs its plain versions on CPU tensors (the CUDA
kernels are held against those on the card by chip_smoke.py); the JAX
Pallas kernels run in interpret mode, as tests/test_pallas_rasterize.py
runs them. Tolerances are that file's, f32 on both sides with sums in
another order: forward atol 2e-5, rtol 1e-4 (depth 1e-4); gradients
atol 1e-6 + 1e-3 max|g|, rtol 2e-3.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.ops import rasterize as jrz
from syn3r_tpu.ops.pallas_rasterize import (_composite_bwd_impl,
                                            _composite_fwd_impl)
from syn3r_tpu.utils.camera import camera_from_fov as j_camera_from_fov
from syn3r_tpu.utils.camera import look_at_w2c as j_look_at_w2c
from syn3r_tpu_torch.models.gaussians import gaussians_from_numpy
from syn3r_tpu_torch.ops import composite as TC
from syn3r_tpu_torch.ops import rasterize as rz
from syn3r_tpu_torch.utils.camera import camera_from_numpy
from syn3r_tpu_torch.utils.profiling import counters

FWD = dict(atol=2e-5, rtol=1e-4)
DEPTH = dict(atol=1e-4, rtol=1e-4)
FIELDS = ["means", "quats", "log_scales", "opacity_logits", "sh_dc",
          "sh_rest"]


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=1e-6 + 1e-3 * np.abs(want).max())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    n = 500
    xyz = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                          rng.uniform(1.5, 3.5, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = JG.from_points(jnp.asarray(xyz), jnp.asarray(rgb), capacity=512)
    sh_rest = rng.normal(0, 0.05, (512, 45)).astype(np.float32)
    quats = rng.normal(0, 1, (512, 4)).astype(np.float32)
    st = st.replace(log_scales=st.log_scales + 0.5,
                    opacity_logits=jnp.where(st.active[:, None], 1.0, -100.0),
                    sh_rest=jnp.asarray(sh_rest), quats=jnp.asarray(quats))
    cam = j_camera_from_fov(0.9, 0.7, 128, 64,
                            j_look_at_w2c(jnp.asarray([0.1, 0.0, 0.0]),
                                          jnp.asarray([0.0, 0.0, 2.5])))
    return st, cam, gaussians_from_numpy(st), camera_from_numpy(cam)


def test_project_matches_jax(scene):
    jst, jcam, st, cam = scene
    want = jrz.project_gaussians(jst, jcam, sh_degree=3)
    got = rz.project_gaussians(st, cam, sh_degree=3)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in ("center", "conic", "rgb", "depth", "opacity"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # ceil(3 sigma): equal up to the ulp straddling an integer
    assert np.abs(got.radius.numpy() - np.asarray(want.radius)).max() <= 1


@pytest.fixture(scope="module")
def tiles(scene):
    _, _, st, cam = scene
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    tl = rz.bin_tiles(sg, cam.height, cam.width, cap=256, chunk=128)
    rng = np.random.default_rng(1)
    dout = rng.normal(0, 1, tuple(tl.G.shape[:1]) + (6, tl.P.shape[1]))
    return tl, torch.from_numpy(dout.astype(np.float32))


def test_composite_plain_versions_match_pallas(tiles):
    tl, dout = tiles
    args = [x.numpy() for x in (tl.P, tl.G, tl.C, tl.O)]
    want_out, want_ltc = _composite_fwd_impl(*args, tl.K, interpret=True)
    out, ltc = TC.composite_fwd_reference(tl.P, tl.G, tl.C, tl.O, tl.K)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **DEPTH)
    np.testing.assert_allclose(ltc.numpy(), np.asarray(want_ltc), **DEPTH)
    want = _composite_bwd_impl(*args, np.asarray(want_ltc), dout.numpy(),
                               tl.K, interpret=True)
    got = TC.composite_bwd_reference(tl.P, tl.G, tl.C, tl.O, ltc, dout,
                                     tl.K)
    for g, w in zip(got, want):
        _grad_close(g.numpy(), np.asarray(w))


def test_function_backward_matches_autograd(tiles):
    """The analytic backward against autograd through the plain forward."""
    tl, dout = tiles
    counters.clear()
    leaves = [x.clone().requires_grad_(True) for x in (tl.G, tl.C, tl.O)]
    out = TC.composite_tiles(tl.P, *leaves, tl.K)
    got = torch.autograd.grad(out, leaves, dout)
    leaves = [x.clone().requires_grad_(True) for x in (tl.G, tl.C, tl.O)]
    out_ref, _ = TC.composite_fwd_reference(tl.P, *leaves, tl.K)
    want = torch.autograd.grad(out_ref, leaves, dout)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  out_ref.detach().numpy())
    for g, w in zip(got, want):
        _grad_close(g.numpy(), w.numpy())
    # CPU tensors take the plain versions: no kernel launched
    assert (counters["launches.composite_fwd"],
            counters["launches.composite_bwd"]) == (0, 0)


def _two_stage_bwd(P, G, C, O, ltc, dout, K):
    """The backward kernel's decomposition in plain torch: every chunk's
    tot at once, then each chunk on its own, its carry formed from the
    later chunks' tots in the order of the sequential walk (d logT, then
    tot of the last chunk down to the next one)."""
    n = G.shape[2] // K
    gacc = dout[:, 0:5]

    def chunk(c):
        sl = slice(c * K, (c + 1) * K)
        praw, epow, alpha_raw, alpha = TC._chunk_alpha(P, G[:, :, sl],
                                                       O[:, :, sl])
        l1ma = torch.log1p(-alpha)
        excl = torch.cumsum(l1ma, dim=1) - l1ma
        t_in = torch.exp(ltc[:, c:c + 1] + excl)
        w = alpha * t_in
        g_c = torch.einsum("trk,trp->tkp", C[:, :, sl], gacc)
        return praw, epow, alpha_raw, alpha, t_in, w, g_c, w * g_c

    tot = [chunk(c)[-1].sum(1, keepdim=True) for c in range(n)]
    dG, dC, dO = (torch.zeros_like(G), torch.zeros_like(C),
                  torch.zeros_like(O))
    for c in range(n):                       # any order: chunks independent
        s = dout[:, 5:6]
        for later in reversed(range(c + 1, n)):
            s = s + tot[later]
        praw, epow, alpha_raw, alpha, t_in, w, g_c, wgc = chunk(c)
        suffix = tot[c] - torch.cumsum(wgc, dim=1) + s
        dalpha = t_in * g_c - suffix / (1.0 - alpha)
        dalpha = torch.where((alpha == 0.0) | (alpha_raw > TC.ALPHA_MAX),
                             0.0, dalpha)
        dpower = torch.where(praw > 0.0, 0.0, dalpha * alpha_raw)
        sl = slice(c * K, (c + 1) * K)
        dG[:, :, sl] = torch.einsum("fp,tkp->tfk", P, dpower)
        dC[:, :, sl] = torch.einsum("trp,tkp->trk", gacc, w)
        dO[:, :, sl] = (dalpha * epow).sum(2)[:, None, :]
    return dG, dC, dO


def test_chunk_parallel_backward_is_the_sequential_walk(tiles):
    """The kernel's two stages give composite_bwd_reference's bits, and
    JAX's interpret-mode kernel within the gradient tolerance."""
    tl, dout = tiles
    args = (tl.P, tl.G, tl.C, tl.O)
    _, ltc = TC.composite_fwd_reference(*args, tl.K)
    assert ltc.shape[1] > 1                  # several chunks to carry over
    got = _two_stage_bwd(*args, ltc, dout, tl.K)
    want = TC.composite_bwd_reference(*args, ltc, dout, tl.K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jax_want = _composite_bwd_impl(*[x.numpy() for x in args], ltc.numpy(),
                                   dout.numpy(), tl.K, interpret=True)
    for g, w in zip(got, jax_want):
        _grad_close(g.numpy(), np.asarray(w))


def _rect_hits(tl):
    """(T, n_rect, cap): some pixel of the backward kernel's warp
    rectangle has alpha >= 1/255."""
    pm = TC.bwd_pixel_map(tl.P.shape[1]).reshape(-1, 128)
    praw = torch.einsum("tfk,fp->tkp", tl.G, tl.P)
    alpha = (tl.O.transpose(1, 2) * torch.exp(praw.clamp(max=0.0))
             ).clamp(max=TC.ALPHA_MAX)
    hit = (alpha >= TC.ALPHA_MIN)[:, :, pm.clamp_min(0)] & (pm >= 0)
    return hit.any(-1).transpose(1, 2)


@pytest.mark.parametrize("cap,chunk", [(256, 128), (499, 128), (24, 128)])
def test_rectangle_skip_never_drops_a_hit(scene, cap, chunk):
    """The backward kernel's skip test (its plain mirror) skips no (entry,
    warp rectangle) with a pixel whose alpha reaches 1/255, keeps no entry
    below 1/255 opacity, and skips something on these lists."""
    _, _, st, cam = scene
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    tl = rz.bin_tiles(sg, cam.height, cam.width, cap=cap, chunk=chunk)
    keep = TC.reach_mask(tl.P, tl.G, tl.O, tl.K)
    hits = _rect_hits(tl)
    assert keep.shape == hits.shape == (tl.G.shape[0], 16, tl.G.shape[2])
    assert not bool((hits & ~keep).any())
    assert not bool((keep & (tl.O[:, 0, None, :] < TC.ALPHA_MIN)).any())
    opaque = int((tl.O >= TC.ALPHA_MIN).sum()) * 16
    assert int(keep.sum()) < opaque


def test_rectangle_skip_needs_pixel_features():
    """Pixels whose P is not [x^2, xy, y^2, x, y, 1] keep every entry with
    opacity >= 1/255; a warp with no pixel keeps none."""
    px = 1100              # the second block: rows 0-1 live, warps 2-7 dead
    ys, xs = torch.div(torch.arange(px), 64, rounding_mode="floor"), \
        torch.arange(px) % 64
    P = rz.pixel_features(ys.float(), xs.float()).T.contiguous()
    G = torch.zeros((1, 6, 4))
    G[0, 0], G[0, 2], G[0, 5] = -1.0, -1.0, -1e4  # far below 1/255
    O = torch.tensor([[[0.9, 0.9, 1e-3, 0.5]]])
    keep = TC.reach_mask(P, G, O, 4)
    assert keep.shape == (1, 16, 4) and not bool(keep.any())
    P[0] += 0.5                               # x^2 no longer matches x
    keep = TC.reach_mask(P, G, O, 4)
    want = torch.tensor([True, True, False, True])
    live = TC.bwd_pixel_map(px).reshape(-1, 128).ge(0).any(1)
    assert live.tolist() == [True] * 10 + [False] * 6
    assert torch.equal(keep[0], live[:, None] & want[None, :])


def test_keep_words_unpack_to_the_mirror_layout():
    T, n_chunks, n_blk, K = 2, 3, 2, 24
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random((T, n_chunks, n_blk * 8, K)) < 0.5)
    bits = torch.zeros((T, n_chunks, n_blk * 8, 128), dtype=torch.long)
    bits[..., :K] = mask.long()
    words = (bits.reshape(T, n_chunks, n_blk, 8, 4, 32)
             << torch.arange(32)).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()
    got = TC.keep_words_to_mask(words, K)
    assert torch.equal(got, mask.permute(0, 2, 1, 3).reshape(T, n_blk * 8,
                                                             n_chunks * K))


def _walk_fwd(P, G, C, O, K, keep=None):
    """The forward kernel's walk in plain torch: each chunk's exclusive sums
    and the carried logT in base 2 (log2(1 - alpha), w = alpha
    2^(logT2 + excl2)), natural logs where ltc and row 5 are written
    (ln 2 logT2). ``keep`` (T, cap, px) cuts alpha to 0 where False, as
    the kernel's skip does."""
    T, _, cap = G.shape
    acc = G.new_zeros((T, 5, P.shape[1]))
    logT2 = G.new_zeros((T, 1, P.shape[1]))
    ltc = []
    for c in range(cap // K):
        ltc.append(logT2 * math.log(2.0))
        sl = slice(c * K, (c + 1) * K)
        _, _, _, alpha = TC._chunk_alpha(P, G[:, :, sl], O[:, :, sl])
        if keep is not None:
            alpha = torch.where(keep[:, sl], alpha, 0.0)
        l1ma2 = torch.log2(1.0 - alpha)
        excl2 = torch.cumsum(l1ma2, dim=1) - l1ma2
        w = alpha * torch.exp2(logT2 + excl2)
        acc = acc + torch.einsum("trk,tkp->trp", C[:, :, sl], w)
        logT2 = logT2 + l1ma2.sum(1, keepdim=True)
    return torch.cat([acc, logT2 * math.log(2.0)], 1), torch.cat(ltc, 1)


@pytest.mark.parametrize("cap,chunk", [(256, 128), (499, 128), (24, 128)])
def test_forward_walk_is_the_reference(scene, cap, chunk):
    """The forward kernel's walk in base 2 gives composite_fwd_reference
    within the float32 tolerance, and JAX's interpret-mode kernel within
    the depth tolerance, out and ltc."""
    _, _, st, cam = scene
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    tl = rz.bin_tiles(sg, cam.height, cam.width, cap=cap, chunk=chunk)
    args = (tl.P, tl.G, tl.C, tl.O)
    out, ltc = _walk_fwd(*args, tl.K)
    want_out, want_ltc = TC.composite_fwd_reference(*args, tl.K)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), **FWD)
    np.testing.assert_allclose(ltc.numpy(), want_ltc.numpy(), **FWD)
    jax_out, jax_ltc = _composite_fwd_impl(*[x.numpy() for x in args], tl.K,
                                           interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **DEPTH)
    np.testing.assert_allclose(ltc.numpy(), np.asarray(jax_ltc), **DEPTH)


@pytest.mark.parametrize("cap,chunk", [(256, 128), (499, 128), (24, 128)])
def test_forward_skip_drops_no_hit(scene, cap, chunk):
    """The forward's skip (reach_mask on its pixel geometry, the
    backward's) cuts only pairs whose alpha is already cut: the forward
    with it gives the forward without it, bit for bit, and some pairs
    are cut."""
    _, _, st, cam = scene
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    tl = rz.bin_tiles(sg, cam.height, cam.width, cap=cap, chunk=chunk)
    plan = TC.composite_fwd_plan(tl.G.shape[0], tl.P.shape[1],
                                 tl.G.shape[2], tl.K)
    pm = TC.bwd_pixel_map(tl.P.shape[1]).reshape(-1, 128)   # rect, pixel
    assert plan["scratch"]["keep"][2] == pm.shape[0]       # its rectangles
    rect_of = torch.empty(tl.P.shape[1], dtype=torch.long)
    rect_of[pm[pm >= 0]] = torch.arange(pm.shape[0])[:, None].expand_as(
        pm)[pm >= 0]
    keep = TC.reach_mask(tl.P, tl.G, tl.O, tl.K)[:, rect_of].transpose(1, 2)
    assert not bool(keep.all())
    args = (tl.P, tl.G, tl.C, tl.O)
    got = _walk_fwd(*args, tl.K, keep=keep)
    # the same walk with nothing cut (torch.where makes alpha contiguous,
    # and the sums' order follows the layout)
    want = _walk_fwd(*args, tl.K, keep=torch.ones_like(keep))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _jax_tiled(jsg, jcam, cap, chunk, composite):
    return jrz.rasterize_tiled(jsg, jcam.height, jcam.width, cap=cap,
                               chunk=chunk, composite=composite)


@pytest.mark.parametrize("cap,chunk", [
    (256, 128),      # even chunks
    (384, 256),      # cap not a multiple of chunk: K = 128, padded lists
    (499, 128),      # odd cap, padded up to 512
    (24, 128),       # every tile overflows its list: rearmost dropped
])
def test_rasterize_tiled_matches_jax(scene, cap, chunk):
    jst, jcam, st, cam = scene
    jsg = jrz.project_gaussians(jst, jcam, sh_degree=3)
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    got = rz.rasterize_tiled(sg, cam.height, cam.width, cap=cap, chunk=chunk)
    plain = rz.rasterize_tiled(sg, cam.height, cam.width, cap=cap,
                               chunk=chunk, composite="plain")
    for route in ("pallas", "xla"):
        want = _jax_tiled(jsg, jcam, cap, chunk, route)
        for mine in (got, plain):
            np.testing.assert_allclose(mine.rgb.numpy(),
                                       np.asarray(want.rgb), **FWD)
            np.testing.assert_allclose(mine.alpha.numpy(),
                                       np.asarray(want.alpha), **FWD)
            np.testing.assert_allclose(mine.depth.numpy(),
                                       np.asarray(want.depth), **DEPTH)
    assert float(got.alpha.max()) > 0.5


def test_dense_rasterize_matches_jax(scene):
    jst, jcam, st, cam = scene
    want = jrz.rasterize(jrz.project_gaussians(jst, jcam), jcam.height,
                         jcam.width, chunk=128, group=1)
    got = rz.rasterize(rz.project_gaussians(st, cam), cam.height, cam.width,
                       chunk=128)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), **FWD)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               **DEPTH)


def test_zero_gaussians_render_empty():
    st = gaussians_from_numpy(JG.from_points(jnp.zeros((0, 3)),
                                             jnp.zeros((0, 3)), capacity=0))
    cam = camera_from_numpy(j_camera_from_fov(
        0.9, 0.7, 64, 32, j_look_at_w2c(jnp.asarray([0.0, 0.0, 0.0]),
                                        jnp.asarray([0.0, 0.0, 2.5]))))
    sg = rz.project_gaussians(st, cam, sh_degree=3)
    out = rz.rasterize_tiled(sg, cam.height, cam.width, cap=256, chunk=128)
    assert out.rgb.shape == (32, 64, 3)
    assert float(out.alpha.max()) == 0.0


@pytest.fixture(scope="module")
def grads(scene):
    """Gradients of one loss w.r.t. every parameter field, both packages
    (JAX through its Pallas kernels, the port through composite_tiles)."""
    jst, jcam, st, cam = scene
    target = np.full((cam.height, cam.width, 3), 0.3, np.float32)

    def jloss(params):
        s = jst.replace(**params)
        out = jrz.rasterize_tiled(jrz.project_gaussians(s, jcam, sh_degree=3),
                                  jcam.height, jcam.width, cap=256, chunk=128,
                                  composite="pallas")
        return (jnp.abs(out.rgb - target).mean() + 0.1 * out.alpha.mean()
                + 0.05 * out.depth.mean())

    want = jax.grad(jloss)({f: getattr(jst, f) for f in FIELDS})
    params = {f: getattr(st, f).clone().requires_grad_(True) for f in FIELDS}
    out = rz.rasterize_tiled(
        rz.project_gaussians(st.replace(**params), cam, sh_degree=3),
        cam.height, cam.width, cap=256, chunk=128)
    loss = ((out.rgb - torch.from_numpy(target)).abs().mean()
            + 0.1 * out.alpha.mean() + 0.05 * out.depth.mean())
    got = dict(zip(FIELDS, torch.autograd.grad(loss, list(params.values()))))
    return got, want


@pytest.mark.parametrize("field", FIELDS)
def test_gradients_match_jax(grads, field):
    got, want = grads
    w = np.asarray(want[field])
    assert np.abs(w).max() > 0
    _grad_close(got[field].numpy(), w)
