"""The port's LPIPS (``models/lpips.py``, the flax bridge
``models/convert.lpips_state_from_flax``) and the GS trainer's LPIPS
refine loss against the JAX package on the CPU.

The VGG params are made with numpy from a seed in the flax layout
(``random_lpips_params``: He-normal 3x3 kernels, so the features keep
their scale through 13 layers; non-negative 1x1 heads, as trained LPIPS
heads are) and fed to both packages. Tolerances, float32 on both sides
with sums in another order:
- the LPIPS value: 1e-5 relative, 1e-9 absolute (the largest difference
  seen is ~2e-7 relative);
- its gradient with respect to the first image: rtol 1e-3, atol 1e-5 x
  max|g| (the backward through 13 convolutions cancels to ~1e-5 of the
  largest entry in places; the largest difference seen is 5e-6 x max|g|);
- one train step with the LPIPS term on, against JAX's: the rule of
  tests/test_torch_gs.py (values 1e-5 relative, 1e-6 absolute; Adam's
  first moment and the densify statistics atol 1e-6 + 1e-3 max|g|, rtol
  2e-3);
- the port's segmented run against its per-step path, both with LPIPS:
  bit for bit, as without it (tests/test_torch_gs_segments.py).
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.gs import trainer as JT
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.models.lpips import LPIPS as JLPIPS
from syn3r_tpu.models.lpips import convert_lpips_torch
from syn3r_tpu.models.lpips import load_lpips_fn as j_load_lpips_fn
from syn3r_tpu.utils.camera import camera_from_fov as j_camera_from_fov
from syn3r_tpu.utils.camera import look_at_w2c as j_look_at_w2c
from syn3r_tpu.utils.params import save_params
from scripts.kernel_timing import random_lpips_params
from syn3r_tpu_torch.gs import trainer as TT
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.models.convert import lpips_state_from_flax
from syn3r_tpu_torch.models.lpips import (LPIPS, load_lpips_fn, lpips_module,
                                          vgg_conv_keys)
from syn3r_tpu_torch.utils.camera import camera_from_numpy

VALUE = dict(rtol=1e-5, atol=1e-9)
VAL = dict(rtol=1e-5, atol=1e-6)
FIELDS = list(TG.PARAM_FIELDS)


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def test_state_dict_follows_the_lpips_package():
    """The lpips package's LPIPS(net='vgg') names, in its order; JAX's
    converter of such a state dict gives back the flax tree exactly."""
    params = random_lpips_params(0)
    state = lpips_state_from_flax(params)
    assert list(state) == list(LPIPS().state_dict())
    assert vgg_conv_keys()[:3] == ["net.slice1.0", "net.slice1.2",
                                   "net.slice2.5"]
    assert state["lin4.model.1.weight"].shape == (1, 512, 1, 1)
    back = convert_lpips_torch({k: v.numpy() for k, v in state.items()})
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])
    with pytest.raises(ValueError, match="not an LPIPS"):
        lpips_state_from_flax({"net": {}})


@pytest.mark.parametrize("shape", [(32, 32, 3), (48, 40, 3), (2, 48, 40, 3)])
def test_lpips_matches_flax(shape):
    params = random_lpips_params(0)
    a, b = _images(shape, 1)
    want = np.asarray(JLPIPS().apply(params, jnp.asarray(a), jnp.asarray(b)))
    model = lpips_module(params, "cpu")
    got = model(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    assert got.shape == want.shape == shape[:-3]
    np.testing.assert_allclose(got, want, **VALUE)
    assert np.all(want > 1e-3)
    same = model(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.detach().numpy(), 0.0, atol=1e-7)


def test_lpips_input_grad_matches_jax():
    params = random_lpips_params(0)
    a, b = _images((40, 48, 3), 2)
    want = np.asarray(jax.grad(lambda x: JLPIPS().apply(
        params, x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    got, = torch.autograd.grad(lpips_module(params, "cpu")(
        x, torch.from_numpy(b)), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_load_lpips_fn_reads_the_jax_npz(tmp_path):
    path = str(tmp_path / "lpips.npz")
    save_params(random_lpips_params(3), path)
    a, b = _images((2, 32, 32, 3), 4)
    want = np.asarray(j_load_lpips_fn(path)(jnp.asarray(a), jnp.asarray(b)))
    got = load_lpips_fn(path, device="cpu")(a, b)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **VALUE)


# -- the trainer's LPIPS refine loss ------------------------------------------

H, W = 48, 64


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """A JAX and a port trainer on two 64x48 views of an anisotropic
    cloud (the setup of tests/test_torch_gs.py, smaller), LPIPS set."""
    rng = np.random.default_rng(8)
    n, cap = 200, 256
    xyz = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                          rng.uniform(1.5, 3.0, (n, 1))], 1).astype(np.float32)
    st = JG.from_points(jnp.asarray(xyz), jnp.asarray(
        rng.uniform(0, 1, (n, 3)).astype(np.float32)), capacity=cap)
    st = st.replace(
        log_scales=st.log_scales + jnp.asarray(
            rng.uniform(-0.5, 0.0, (cap, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(0, 1, (cap, 4)), jnp.float32),
        sh_rest=jnp.asarray(rng.normal(0, 0.05, (cap, 45)), jnp.float32),
        opacity_logits=jnp.where(st.active[:, None], 0.0, -100.0))
    cams = [j_camera_from_fov(0.9, 0.7, W, H, j_look_at_w2c(
        jnp.asarray([x, 0.0, 0.0]), jnp.asarray([0.0, 0.0, 2.2])))
        for x in (-0.2, 0.2)]
    imgs = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    kw = dict(tile_cap=256, chunk=128, densify_from_iter=10 ** 9, seed=3,
              lpips_weight=0.7)
    jtr = JT.GSTrainer(JT.make_viewset(cams, imgs),
                       JT.TrainConfig(rasterizer="tiled", **kw), st,
                       model_path=str(tmp_path_factory.mktemp("jax")))
    ttr = TT.GSTrainer(TT.make_viewset([camera_from_numpy(c) for c in cams],
                                       imgs), TT.TrainConfig(**kw),
                       TG.gaussians_from_numpy(st),
                       model_path=str(tmp_path_factory.mktemp("port")),
                       device="cpu")
    params = random_lpips_params(5)
    jtr.set_lpips(jax.tree.map(jnp.asarray, params))
    ttr.set_lpips(params)
    return jtr, ttr


def test_train_step_with_lpips_matches_jax(trainers):
    """One step with the LPIPS term: loss, parameters, Adam's first moment
    and the densify statistics; and the term is really in the loss."""
    jtr, ttr = trainers
    jcam, jimg = jtr.train_views.view(1)
    cam, img = ttr.train_views.view(1)
    want_ts, want_m = jtr._train_step(jtr.state, jcam, jimg, None,
                                      jtr._lpips_params, use_lpips=True)
    got_ts, got_m = ttr._train_step(ttr.state, cam, img, use_lpips=True)
    _, plain_m = ttr._train_step(ttr.state, cam, img)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    lp = lpips_module(random_lpips_params(5), "cpu")(
        ttr.render_view(cam)["render"], img)
    np.testing.assert_allclose(float(got_m["loss"] - plain_m["loss"]),
                               0.7 * float(lp), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got_ts.gaussians, f).numpy(),
                                   np.asarray(getattr(want_ts.gaussians, f)),
                                   **VAL, err_msg=f)
        w = np.asarray(want_ts.adam.mu[f])
        np.testing.assert_allclose(got_ts.adam.mu[f].numpy(), w, rtol=2e-3,
                                   atol=1e-6 + 1e-3 * np.abs(w).max(),
                                   err_msg=f"mu {f}")
    for f in ("grad_accum", "denom", "max_radii"):
        w = np.asarray(getattr(want_ts.stats, f))
        np.testing.assert_allclose(getattr(got_ts.stats, f).numpy(), w,
                                   rtol=2e-3,
                                   atol=1e-6 + 1e-3 * np.abs(w).max(),
                                   err_msg=f)


def test_segmented_run_with_lpips_is_the_per_step_path(trainers):
    """An 8-step segment with use_lpips_loss on (the gate of _run_loop)
    against the per-step path from the same state and picks: bit for bit;
    the capture key holds use_lpips, so turning it off builds another."""
    _, ttr = trainers
    s0 = ttr.state
    ttr.use_lpips_loss = True
    out = {}
    for name in ("segment", "per_step"):
        ttr.state = s0
        ttr._rng = np.random.default_rng(3)
        if name == "per_step":
            ttr._merged_views = lambda: None
        out[name] = (ttr._run_loop(0, 8, densify=False, log_every=8),
                     ttr.state)
    del ttr._merged_views
    assert ttr._segments.key[-1] is True
    (loss_s, st_s), (loss_p, st_p) = out["segment"], out["per_step"]
    assert loss_s == loss_p
    for f in FIELDS:
        torch.testing.assert_close(getattr(st_s.gaussians, f),
                                   getattr(st_p.gaussians, f), rtol=0, atol=0)
        torch.testing.assert_close(st_s.adam.mu[f], st_p.adam.mu[f], rtol=0,
                                   atol=0)
    ttr.use_lpips_loss = False
    ttr.state = s0
    ttr._run_loop(0, 2, densify=False)
    assert ttr._segments.key[-1] is False
