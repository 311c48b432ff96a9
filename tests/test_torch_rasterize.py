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
    TC.composite_tiles.launches.update(fwd=0, bwd=0)
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
    assert TC.composite_tiles.launches == {"fwd": 0, "bwd": 0}


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
