"""The projection's autograd Function (``ops/rasterize._Project``): on the
CPU, the plain mirror of the backward kernel (``project_bwd_reference``)
against autograd through the plain forward (``project_gaussians_reference``)
on scenes built to reach every edge of the backward's rules; on the card,
both kernels (``csrc/project.cu``) against the plain versions at the gs
cell's shape and at others, with their launch counters.

The CPU tests run in the tier-1 suite. The card tests (marker ``chip``)
skip without a CUDA card; on the card, from the root of the repository
(the tests' conftest imports JAX, which that machine lacks)::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_project.py
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import numpy as np
import pytest
import torch

from syn3r_tpu_torch.models import gaussians as G
from syn3r_tpu_torch.ops import rasterize as rz
from syn3r_tpu_torch.utils.camera import Camera, camera_from_fov, look_at_w2c
from syn3r_tpu_torch.utils.profiling import counters
from scripts.kernel_timing import GS_H, GS_W, PROJECT_N, project_scene

OUT_FIELDS = ("center", "conic", "rgb", "depth", "opacity")
# The mirror against autograd (CPU) and a kernel against its plain version
# (card), float32 on both sides with the same formulas in another order
# (autograd's products and sums, FMAs on the card): per slot, elementwise
# |got - want| <= tol (|want| + max over the slot's row of |want| + 1e-6 max
# over the field of |want|), the last for rows whose gradient is rounding
# (a slot at |tz| < 1e-6 gets ~1e-16 where others get ~1)
MIRROR_TOL = 1e-4
CARD_TOL = {"fwd": 1e-4, "bwd": 1e-3}


def _slot_close(got, want, tol, what=""):
    got, want = got.detach().double(), want.detach().double()
    n = want.shape[0]
    w = want.reshape(n, -1)
    bound = tol * (w.abs() + w.abs().amax(1, keepdim=True)
                   + 1e-6 * w.abs().max())
    err = (got.reshape(n, -1) - w).abs()
    both_nan = torch.isnan(got.reshape(n, -1)) & torch.isnan(w)
    bad = ~((err <= bound) | both_nan)
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} entries beyond tolerance, worst "
        f"{float((err - bound)[bad].max())} at slot "
        f"{int(bad.any(1).nonzero()[0])}")


def _state(means, log_scales, quats, sh_dc, sh_rest, opacity, active):
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return G.GaussianState(
        means=f(means), quats=f(quats), log_scales=f(log_scales),
        opacity_logits=f(opacity)[:, None], sh_dc=f(sh_dc)[:, None],
        sh_rest=f(sh_rest), active=torch.from_numpy(active))


def _exact_black_dc():
    """An sh_dc value v with float32(SH_C0) * v + 0.5 == 0 in float32: the
    colour clamp's inclusive bound, reached exactly."""
    c0 = np.float32(G.SH_C0)
    v = np.float32(-0.5 / c0)
    for _ in range(64):
        r = np.float32(c0 * v)
        if r == np.float32(-0.5):
            return v
        v = np.nextafter(v, np.float32(np.inf if r < -0.5 else -np.inf),
                         dtype=np.float32)
    raise AssertionError("no sh_dc reaches -0.5 exactly")


def edge_scene():
    """512 slots before a 128x64 camera: most in view, then inactive slots,
    slots behind ``near`` and behind the camera, |tz| < 1e-6, slots whose
    tx/tz and ty/tz pass the Jacobian's clamp on either side, colours
    clamped at 0 (one exactly on the bound), all-zero quaternions."""
    rng = np.random.default_rng(0)
    cam = camera_from_fov(0.9, 0.7, 128, 64,
                          look_at_w2c([0.1, 0.0, 0.0], [0.0, 0.0, 2.5]))
    w2c = cam.w2c.double().numpy()
    R, tv = w2c[:3, :3], w2c[:3, 3]
    n = 512
    lim = np.array([0.65 * 128 / float(cam.K[0, 0]),
                    0.65 * 64 / float(cam.K[1, 1])])
    tz = rng.uniform(1.5, 4.0, n)
    txy = rng.uniform(-0.8, 0.8, (n, 2)) * lim * tz[:, None]
    tz[300:320] = rng.uniform(-1.0, 0.19, 20)           # behind near
    tz[320:324] = [0.0, 3e-7, -4e-7, 0.0]               # |tz| < 1e-6
    sides = np.array([[3.0, 0.0], [-3.0, 0.0], [0.0, 3.0], [0.0, -3.0],
                      [2.5, -2.5], [-2.5, 2.5], [4.0, 4.0], [-4.0, -4.0]])
    txy[324:332] = sides * lim * tz[324:332, None]      # Jacobian clamped
    t = np.concatenate([txy, tz[:, None]], 1)
    means = (t - tv) @ R                                # R^T (t - tv)
    log_scales = rng.uniform(-4.0, -1.5, (n, 3))
    quats = rng.normal(0, 1, (n, 4))
    quats[350:354] = 0.0                                # all-zero quaternion
    sh_dc = rng.normal(0, 0.6, (n, 3))
    sh_rest = rng.normal(0, 0.3, (n, 45))
    sh_dc[340:348] = -3.0                               # clamped at 0
    sh_dc[348] = _exact_black_dc()
    sh_rest[348] = 0.0
    opacity = rng.normal(0, 1.5, n)
    active = np.ones(n, bool)
    active[250:300] = False
    active[480:] = False
    return _state(means, log_scales, quats, sh_dc, sh_rest, opacity,
                  active), cam


def flat_scene():
    """A camera whose rotation has two equal rows (a projection onto a
    line, fx = fy, a square image): every slot has T's two rows equal, so
    its 2D covariance is rank one plus the 0.3 dilation. Large Gaussians
    round det = a c - b^2 to exactly 0 (det <= 0, the det_safe branch);
    tiny ones keep det > 0 well away from 0."""
    rng = np.random.default_rng(1)
    n = 256
    w2c = torch.eye(4)
    w2c[:3, :3] = torch.tensor([[0.6, 0.0, 0.8], [0.6, 0.0, 0.8],
                                [0.0, 1.0, 0.0]])
    w2c[:3, 3] = torch.tensor([0.0, 0.0, 0.5])
    K = torch.tensor([[100.0, 0.0, 32.0], [0.0, 100.0, 32.0],
                      [0.0, 0.0, 1.0]])
    cam = Camera(K=K, w2c=w2c, confidence=torch.ones(()), width=64,
                 height=64)
    means = np.concatenate([rng.uniform(-0.3, 0.3, (n, 1)),
                            rng.uniform(1.0, 3.0, (n, 1)),
                            rng.uniform(-0.3, 0.3, (n, 1))], 1)
    log_scales = np.where(np.arange(n)[:, None] % 2 == 0,
                          rng.uniform(6.0, 8.0, (n, 3)),
                          rng.uniform(-9.0, -8.0, (n, 3)))
    return _state(means, log_scales, rng.normal(0, 1, (n, 4)),
                  rng.normal(0, 0.6, (n, 3)), rng.normal(0, 0.3, (n, 45)),
                  rng.normal(0, 1.5, n), np.ones(n, bool)), cam


SCENES = {"edges": edge_scene, "flat": flat_scene}


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


def _cotangents(sg, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(getattr(sg, f).shape, generator=g)
            for f in OUT_FIELDS]


def _autograd_grads(state, cam, degree, offset, cots):
    params = {f: getattr(state, f).clone().requires_grad_(True)
              for f in G.PARAM_FIELDS}
    leaves = list(params.values())
    if offset is not None:
        offset = offset.clone().requires_grad_(True)
        leaves.append(offset)
    sg = rz.project_gaussians_reference(state.replace(**params), cam,
                                        sh_degree=degree,
                                        center_offset=offset)
    grads = torch.autograd.grad([getattr(sg, f) for f in OUT_FIELDS],
                                leaves, cots, allow_unused=True)
    return sg, [torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads)]


def test_scenes_reach_every_edge(scenes):
    """The scenes hold every case the backward's rules distinguish."""
    st, cam = scenes["edges"]
    sg = rz.project_gaussians_reference(st, cam, sh_degree=3)
    t = st.means @ cam.w2c[:3, :3].T + cam.w2c[:3, 3]
    tz = t[:, 2]
    lim = torch.tensor([0.65 * cam.width, 0.65 * cam.height]) \
        / torch.stack([cam.K[0, 0], cam.K[1, 1]])
    r = t[:, :2] / torch.where(tz.abs() < 1e-6, 1e-6, tz)[:, None]
    raw = G.eval_sh(st.sh, torch.nn.functional.normalize(
        st.means - cam.position, dim=-1), 3) + 0.5
    assert int((~st.active).sum()) > 0
    assert int((st.active & (tz <= 0.2) & (tz.abs() >= 1e-6)).sum()) > 0
    assert int((tz.abs() < 1e-6).sum()) == 4
    for axis in (0, 1):
        assert int((r[:, axis] > lim[axis]).sum()) > 0
        assert int((r[:, axis] < -lim[axis]).sum()) > 0
    assert int((raw < 0).sum()) > 0 and int((raw == 0).sum()) > 0
    assert int((st.quats == 0).all(1).sum()) == 4
    assert int(sg.valid.sum()) > 200
    flat, fcam = scenes["flat"]
    fs = rz.project_gaussians_reference(flat, fcam, sh_degree=3)
    det_zero = ~fs.valid & flat.active
    assert int(det_zero.sum()) > 50 and int(fs.valid.sum()) > 50
    # det <= 0 gives conic = (c, -b, a): det_safe took its other side
    assert float(fs.conic[det_zero].abs().max()) > 1e6


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_backward_mirror_matches_autograd(scenes, scene, degree, offset):
    """project_bwd_reference gives autograd's gradients through the plain
    forward, every parameter field and the centre offset."""
    st, cam = scenes[scene]
    n = st.capacity
    off = (torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.5, (n, 2)).astype(np.float32)) if offset else None)
    sg = rz.project_gaussians_reference(st, cam, sh_degree=degree,
                                        center_offset=off)
    cots = _cotangents(sg, 10 * degree + offset)
    _, want = _autograd_grads(st, cam, degree, off, cots)
    got = rz.project_bwd_reference(st, cam, *cots, sh_degree=degree)
    for f, w in zip(G.PARAM_FIELDS, want):
        assert got[f].shape == w.shape
        _slot_close(got[f], w, MIRROR_TOL, f"{scene} degree {degree} {f}")
    if degree == 0:
        assert not bool(got["sh_rest"].any())


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("degree", [0, 3])
def test_function_runs_the_plain_versions_on_cpu(scenes, degree, offset):
    """On CPU tensors project_gaussians is the plain forward, bit for bit,
    and its backward the mirror; the offset's gradient is the centre's;
    no kernel is launched."""
    st, cam = scenes["edges"]
    n = st.capacity
    off = torch.full((n, 2), 0.25) if offset else None
    counters["launches.project_fwd"] = counters["launches.project_bwd"] = 0
    params = {f: getattr(st, f).clone().requires_grad_(True)
              for f in G.PARAM_FIELDS}
    leaves = list(params.values())
    if off is not None:
        off = off.clone().requires_grad_(True)
        leaves.append(off)
    sg = rz.project_gaussians(st.replace(**params), cam, sh_degree=degree,
                              center_offset=off)
    want = rz.project_gaussians_reference(st, cam, sh_degree=degree,
                                          center_offset=off)
    for name in rz.ScreenGaussians._fields:
        assert torch.equal(getattr(sg, name).detach(),
                           getattr(want, name).detach()), name
    assert not sg.radius.requires_grad and sg.valid.dtype == torch.bool
    cots = _cotangents(sg, 5)
    got = torch.autograd.grad([getattr(sg, f) for f in OUT_FIELDS], leaves,
                              cots)
    mirror = rz.project_bwd_reference(st, cam, *cots, sh_degree=degree)
    for f, g in zip(G.PARAM_FIELDS, got):
        assert torch.equal(g, mirror[f]), f
    if off is not None:
        assert torch.equal(got[-1], cots[0])
    assert (counters["launches.project_fwd"],
            counters["launches.project_bwd"]) == (0, 0)


def test_function_takes_missing_gradients_as_zero(scenes):
    """Outputs the loss does not use reach the backward as None: the
    gradients are those of zero cotangents there."""
    st, cam = scenes["edges"]
    params = {f: getattr(st, f).clone().requires_grad_(True)
              for f in G.PARAM_FIELDS}
    sg = rz.project_gaussians(st.replace(**params), cam)
    loss = (sg.rgb * sg.rgb).sum() + sg.opacity.sum()
    got = torch.autograd.grad(loss, list(params.values()))
    zero = [torch.zeros_like(getattr(sg, f)) for f in OUT_FIELDS]
    want = rz.project_bwd_reference(st, cam, zero[0], zero[1],
                                    2.0 * sg.rgb.detach(), zero[3],
                                    torch.ones_like(sg.opacity), 3)
    for f, g in zip(G.PARAM_FIELDS, got):
        assert torch.equal(g, want[f]), f


def test_launch_refuses_what_the_kernel_does_not_take(scenes):
    """The kernel route raises on CPU tensors and on an SH degree its rows
    do not hold, before anything is built or launched."""
    st, cam = scenes["edges"]
    with pytest.raises(ValueError, match="on cpu"):
        rz.project_fwd_launch(st, cam)
    small = st.replace(sh_rest=st.sh_rest[:, :24].contiguous())
    with pytest.raises(ValueError, match="SH degree 3"):
        rz.project_fwd_launch(small, cam, sh_degree=3)
    with pytest.raises(ValueError, match="on cpu"):
        rz.project_bwd_launch(st, cam, None, None, None, None, None)


# -- on the card --------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_fwd(st, cam, degree, offset=None):
    before = counters["launches.project_fwd"]
    got = rz.project_fwd_launch(st, cam, degree, center_offset=offset)
    assert counters["launches.project_fwd"] == before + 1
    with torch.no_grad():
        want = rz.project_gaussians_reference(st, cam, degree,
                                              center_offset=offset)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.chip
def test_card_kernels_match_plain_at_the_cell_shape(dev):
    """131,072 slots, 504x378, degree 3: the forward's every output and the
    backward's every gradient against the plain versions on the card; two
    calls of each give the same bits; one launch a call."""
    st, cam = project_scene(dev)
    assert (st.capacity, cam.width, cam.height) == (PROJECT_N, GS_W, GS_H)
    got, want = _card_fwd(st, cam, 3)
    assert torch.equal(got.valid, want.valid)
    for f in OUT_FIELDS:
        _slot_close(getattr(got, f), getattr(want, f), CARD_TOL["fwd"], f)
    assert float((got.radius - want.radius).abs().max()) <= 1.0
    assert float((got.radius != want.radius).float().mean()) < 1e-3
    again = rz.project_fwd_launch(st, cam, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    g = torch.Generator(device=dev).manual_seed(1)
    cots = [torch.randn(getattr(got, f).shape, generator=g, device=dev)
            for f in OUT_FIELDS]
    before = counters["launches.project_bwd"]
    grads = rz.project_bwd_launch(st, cam, *cots, sh_degree=3)
    assert counters["launches.project_bwd"] == before + 1
    want_g = rz.project_bwd_reference(st, cam, *cots, sh_degree=3)
    torch.cuda.synchronize()
    for f in G.PARAM_FIELDS:
        _slot_close(grads[f], want_g[f], CARD_TOL["bwd"], f)
    again = rz.project_bwd_launch(st, cam, *cots, sh_degree=3)
    assert all(torch.equal(grads[f], again[f]) for f in G.PARAM_FIELDS)


@pytest.mark.chip
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_card_kernels_at_other_degrees_and_sizes(dev, degree):
    """A ragged last block (1,000 slots), the degree's coefficients only
    (zero gradients beyond them), an offset, a missing cotangent, and the
    DTU refine's 400x300 camera; through autograd, one launch each way."""
    st, cam = project_scene(dev, n=1000, width=400, height=300, seed=degree)
    off = torch.full((1000, 2), 0.5, device=dev)
    got, want = _card_fwd(st, cam, degree, off)
    assert torch.equal(got.valid, want.valid)
    for f in OUT_FIELDS:
        _slot_close(getattr(got, f), getattr(want, f), CARD_TOL["fwd"], f)
    params = {f: getattr(st, f).clone().requires_grad_(True)
              for f in G.PARAM_FIELDS}
    off = off.clone().requires_grad_(True)
    before = (counters["launches.project_fwd"],
              counters["launches.project_bwd"])
    sg = rz.project_gaussians(st.replace(**params), cam, degree,
                              center_offset=off)
    loss = (sg.rgb.sum() + (sg.conic * sg.conic).sum() + sg.center.sum()
            + sg.opacity.sum())                       # no depth gradient
    grads = torch.autograd.grad(loss, list(params.values()) + [off])
    assert (counters["launches.project_fwd"] - before[0],
            counters["launches.project_bwd"] - before[1]) == (1, 1)
    want_g = rz.project_bwd_reference(
        st, cam, torch.ones_like(sg.center), 2.0 * sg.conic.detach(),
        torch.ones_like(sg.rgb), None, torch.ones_like(sg.opacity), degree)
    torch.cuda.synchronize()
    for f, g in zip(G.PARAM_FIELDS, grads):
        _slot_close(g, want_g[f], CARD_TOL["bwd"], f)
    assert torch.equal(grads[-1], torch.ones_like(off))
    kc = (degree + 1) ** 2
    assert not bool(grads[5][:, 3 * (kc - 1):].any())


@pytest.mark.chip
def test_card_kernels_capture_in_a_graph(dev):
    """Forward and backward captured as one CUDA graph: a replay gives the
    eager call's bits."""
    st, cam = project_scene(dev, n=4096, seed=7)
    params = {f: getattr(st, f).clone().requires_grad_(True)
              for f in G.PARAM_FIELDS}

    def step():
        sg = rz.project_gaussians(st.replace(**params), cam)
        loss = sg.rgb.sum() + sg.conic.sum() + sg.depth.sum()
        return torch.autograd.grad(loss, list(params.values()))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))
