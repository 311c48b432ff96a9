"""The port's DL3DV vision branch against the JAX package on the CPU:
``utils/image.resize_bilinear``, DUSt3R (``rope_2d``, the blocks, the
network, the state-dict bridge, known-pose alignment, fusion and
``make_dust3r_fn``), ``utils/pcd``, ``utils/ply`` and
``cli/generate_pcd``.

Both packages get the same numpy inputs from a seed and the same weights:
a flax init of the JAX module, bridged by
``models.convert.dust3r_state_from_flax``. Tolerances (float32 on both
sides, sums in another order): resizes 1e-6 absolute; RoPE 1e-6; blocks
and the network atol 1e-4, rtol 1e-4; alignment depths and scales rtol
1e-3 (150 Adam steps), the loss rtol 1e-3; fused and generated points
1e-4 absolute with identical keep masks and counts; the outlier removal
identical; PLY files exact (a file either package writes reads back in
the other); the bridge round trip exact.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syn3r_tpu.cli import generate_pcd as JGP
from syn3r_tpu.models.convert import assert_tree_match
from syn3r_tpu.models import gaussians as JG
from syn3r_tpu.utils import image as JI
from syn3r_tpu.utils import pcd as JPCD
from syn3r_tpu.utils import ply as JPLY
from syn3r_tpu.vision import dust3r as JD
from syn3r_tpu_torch.cli import generate_pcd as TGP
from syn3r_tpu_torch.models import gaussians as TG
from syn3r_tpu_torch.models.convert import dust3r_state_from_flax
from syn3r_tpu_torch.utils import colmap as TCM
from syn3r_tpu_torch.utils import image as TI
from syn3r_tpu_torch.utils import pcd as TPCD
from syn3r_tpu_torch.utils import ply as TPLY
from syn3r_tpu_torch.vision import dust3r as TD
from scripts.vision_weights import random_dust3r_params

NET = dict(rtol=1e-4, atol=1e-4)
TINY = dict(patch=8, enc_dim=64, enc_depth=2, enc_heads=4, dec_dim=48,
            dec_depth=2, dec_heads=4)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("shape,out,antialias", [
    ((540, 960), (288, 512), True),      # densify_pcds' 960 -> 512
    ((37, 53), (20, 29), True),          # odd ratios, borders
    ((20, 29), (37, 53), True),          # upsampling
    ((37, 53), (20, 29), False)])
def test_resize_bilinear_matches_jax(shape, out, antialias):
    img = np.random.default_rng(0).uniform(size=shape + (3,)) \
        .astype(np.float32)
    want = JI.resize_bilinear(jnp.asarray(img), *out, antialias=antialias)
    got = TI.resize_bilinear(_t(img), *out, antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # a batch resizes frame by frame
    both = TI.resize_bilinear(_t(np.stack([img, img[::-1]])), *out,
                              antialias=antialias)
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())


def test_rope_2d_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    k = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    pos = rng.integers(0, 7, size=(2, 10, 2)).astype(np.float32)
    want = JD.rope_2d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    got = TD.rope_2d(_t(q), _t(k), _t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX Dust3R, its flax init and the port's bridged copy."""
    model = JD.Dust3R(**TINY)
    a = jnp.zeros((1, 32, 48, 3))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), a, a)
    port = TD.Dust3R(**TINY)
    port.load_state_dict({k: _t(v) for k, v in
                          dust3r_state_from_flax(params).items()})
    return model, params, port.eval()


@pytest.mark.parametrize("size", [(32, 48), (24, 64)])
def test_dust3r_matches_jax(tiny, size):
    """A tiny Dust3R (patch 8, enc 64 x 2, dec 48 x 2) at two sizes."""
    model, params, port = tiny
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(size=(1,) + size + (3,)).astype(np.float32)
            for _ in range(2))
    want = model.apply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = port(_t(a), _t(b))
    for k in ("pts1", "conf1", "pts2", "conf2"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **NET)


def test_dust3r_blocks_match_jax(tiny):
    """An encoder block and a decoder block (norm_y on the other view's
    tokens) on their own."""
    _, params, port = tiny
    tree = params["params"]
    rng = np.random.default_rng(3)
    n = 12
    pos = np.stack([np.repeat(np.arange(3), 4), np.tile(np.arange(4), 3)],
                   -1)[None].astype(np.float32)
    x = rng.normal(size=(1, n, 64)).astype(np.float32)
    want = JD.EncoderBlock(4).apply({"params": tree["enc_1"]},
                                    jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = port.enc_blocks[1](_t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)
    y, o = (rng.normal(size=(1, n, 48)).astype(np.float32) for _ in range(2))
    want = JD.DecoderBlock(4).apply({"params": tree["dec2_0"]},
                                    jnp.asarray(y), jnp.asarray(o),
                                    jnp.asarray(pos), jnp.asarray(pos))
    with torch.no_grad():
        got = port.dec_blocks2[0](_t(y), _t(o), _t(pos), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)


def test_dust3r_bridge_round_trip():
    """A public-layout state dict -> JAX's convert_dust3r_torch ->
    dust3r_state_from_flax is the same state dict exactly, and the port's
    module loads it (strict) and holds to the numpy oracle of the public
    forward (tests/test_dust3r_oracle.py)."""
    import test_dust3r_oracle as O
    sd = O._state_dict(np.random.default_rng(0))
    back = dust3r_state_from_flax(JD.convert_dust3r_torch(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    port = TD.Dust3R(patch=O.P, enc_dim=O.ED, enc_depth=O.DEPTH,
                     enc_heads=O.HEADS, dec_dim=O.DD, dec_depth=O.DEPTH,
                     dec_heads=O.HEADS)
    port.load_state_dict({k: _t(v) for k, v in back.items()})
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(size=(1, O.EH, O.EW, 3)).astype(np.float32)
            for _ in range(2))
    with torch.no_grad():
        got = port(_t(a), _t(b))
    for k, want in zip(("pts1", "conf1", "pts2", "conf2"),
                       O.np_dust3r(a, b, sd)):
        np.testing.assert_allclose(got[k].numpy(), want, rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_dust3r_bridge_rejects_two_head_norms():
    params = random_dust3r_params(0, **{k: v for k, v in TINY.items()
                                        if "heads" not in k})
    tree = params["params"]
    tree["head2_norm"] = {k: v + 1.0 for k, v in tree["head1_norm"].items()}
    with pytest.raises(ValueError, match="dec_norm"):
        dust3r_state_from_flax(params)


def test_dust3r_full_config_by_shapes():
    """ViT-L/512 by shapes only: JAX's Dust3R() param tree (eval_shape),
    the bridge's state dict (of zero-stride arrays) and the port's
    Dust3R() built on the meta device agree; the config read from the
    shapes is the default one."""
    img = jax.ShapeDtypeStruct((1, 288, 512, 3), jnp.float32)
    shapes = jax.eval_shape(JD.Dust3R().init, jax.random.PRNGKey(0), img,
                            img)["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float16(0), s.shape), shapes)
    with torch.device("meta"):
        port = TD.Dust3R(**TD.dust3r_config(zeros))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {k: v.shape for k, v in dust3r_state_from_flax(zeros).items()}
    assert got == want
    assert TD.dust3r_config(zeros) == dict(
        patch=16, enc_dim=1024, enc_depth=24, enc_heads=16, dec_dim=768,
        dec_depth=12, dec_heads=12)
    assert sum(np.prod(s) for s in want.values()) > 5e8


def test_random_dust3r_params_match_flax_tree(tiny):
    _, params, _ = tiny
    assert_tree_match(random_dust3r_params(0, **{
        k: v for k, v in TINY.items() if "heads" not in k})["params"],
        params["params"])


def _plane_pairs():
    """tests/test_vision.py's two views of a plane: each pair's points are
    the true camera-frame points of view v in camera r, mis-scaled."""
    from syn3r_tpu.utils.camera import transform_points, unproject
    from syn3r_tpu.utils.se3 import se3_inverse
    h, w = 16, 24
    K = jnp.asarray([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    c2w = jnp.stack([jnp.eye(4), jnp.eye(4).at[0, 3].set(0.3)])
    true_depth = jnp.full((h, w), 2.0)
    rng = np.random.default_rng(0)
    pts, conf, pv = [], [], []
    for v, r in [(0, 0), (1, 0), (1, 1), (0, 1)]:
        p = transform_points(unproject(true_depth, K), se3_inverse(c2w[v]),
                             se3_inverse(c2w[r]))
        pts.append(np.asarray(p) / rng.uniform(0.5, 2.0))
        conf.append(rng.uniform(1.0, 3.0, (h, w)))
        pv.append((v, r))
    return (np.stack(pts).astype(np.float32),
            np.stack(conf).astype(np.float32), np.asarray(pv, np.int32),
            np.asarray(c2w, np.float32), np.asarray(K, np.float32))


def test_global_align_known_poses_matches_jax():
    """150 Adam steps (lr 1e-2) from depth 1 on the plane: depths, scales
    and the last loss against JAX's optax loop."""
    pts, conf, pv, c2w, K = _plane_pairs()
    init = np.ones((2,) + pts.shape[1:3], np.float32)
    want = JD.global_align_known_poses(*map(jnp.asarray, (pts, conf, pv, c2w,
                                                          K, init)), iters=150)
    got = TD.global_align_known_poses(*map(_t, (pts, conf, pv, c2w, K,
                                                init)), iters=150)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3)
    # it fits: the loss fell by orders of magnitude
    assert float(got[2]) < 1e-2 * float(
        TD.global_align_known_poses(*map(_t, (pts, conf, pv, c2w, K, init)),
                                    iters=1)[2])


def test_fuse_point_cloud_matches_jax():
    rng = np.random.default_rng(5)
    v, h, w = 3, 10, 14
    depths = rng.uniform(-0.1, 3.0, (v, h, w)).astype(np.float32)
    images = rng.uniform(size=(v, h, w, 3)).astype(np.float32)
    conf = rng.uniform(1.0, 2.0, (v, h, w)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(v, 3))
    K = np.asarray([[20.0, 0, 7], [0, 20.0, 5], [0, 0, 1]], np.float32)
    want = JD.fuse_point_cloud(jnp.asarray(depths), jnp.asarray(images),
                               jnp.asarray(c2w), jnp.asarray(K),
                               conf=jnp.asarray(conf))
    got = TD.fuse_point_cloud(_t(depths), _t(images), _t(c2w), _t(K),
                              conf=_t(conf))
    assert 0 < len(got[0]) == len(want[0]) < v * h * w // 4
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])


def test_make_dust3r_fn_matches_jax(tiny):
    """The pair loop, alignment (30 steps), per-view confidence and fusion
    of three frames: the same cloud as JAX's make_dust3r_fn."""
    model, params, port = tiny
    rng = np.random.default_rng(6)
    frames = rng.uniform(size=(3, 32, 48, 3)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, 0, 3] = [0.0, 0.2, 0.4]
    K = np.asarray([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
    want = JD.make_dust3r_fn(model, params, align_iters=30)(
        jnp.asarray(frames), c2w, K)
    fn = TD.make_dust3r_fn(port, align_iters=30)
    got = fn(_t(frames), _t(c2w), _t(K))
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert set(fn.timer.summary()) == {"dust3r_forward", "dust3r_align"}


def test_remove_statistical_outliers_matches_jax():
    """k 20, std 3 (densify_pcds' setting) and the defaults, on a cloud
    with far points: the same points kept."""
    rng = np.random.default_rng(7)
    xyz = np.concatenate([rng.normal(size=(1500, 3)),
                          rng.uniform(-30, 30, (40, 3))]).astype(np.float32)
    rgb = rng.uniform(size=(len(xyz), 3)).astype(np.float32)
    for kw in (dict(k=20, std_ratio=3.0), {}):
        want = JPCD.remove_statistical_outliers(xyz, rgb, **kw)
        got = TPCD.remove_statistical_outliers(xyz, rgb, device="cpu", **kw)
        assert len(xyz) - 40 <= len(got[0]) < len(xyz)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    few = TPCD.remove_statistical_outliers(xyz[:5], rgb[:5], device="cpu")
    assert few[0] is not None and len(few[0]) == 5


def test_ply_points_read_by_both(tmp_path):
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, (50, 3)).astype(np.float32)
    for writer, reader, name in ((TPLY, JPLY, "t.ply"), (JPLY, TPLY, "j.ply")):
        for colors in (rgb, None):
            path = str(tmp_path / name)
            writer.write_ply_points(path, xyz, colors)
            got, want = reader.read_ply_points(path), \
                writer.read_ply_points(path)
            np.testing.assert_array_equal(got[0], xyz)
            if colors is None:
                assert got[1] is None and want[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_allclose(got[1], np.clip(rgb, 0, 1),
                                           atol=1 / 255)
    with open(tmp_path / "t.ply", "rb") as a, open(tmp_path / "j.ply",
                                                    "rb") as b:
        assert a.read() == b.read()


def test_gaussians_ply_read_by_both(tmp_path):
    """A state with inactive slots, written by either package, loads in
    the other with the same active Gaussians and padding."""
    rng = np.random.default_rng(9)
    n = 40
    js = JG.from_points(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
                        jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32),
                        capacity=64)
    js = js.replace(sh_rest=jnp.asarray(
        rng.normal(size=js.sh_rest.shape), jnp.float32),
        active=js.active.at[3].set(False))
    ts = TG.gaussians_from_numpy(js)
    JPLY.save_gaussians_ply(str(tmp_path / "j.ply"), js)
    TPLY.save_gaussians_ply(str(tmp_path / "t.ply"), ts)
    with open(tmp_path / "t.ply", "rb") as a, open(tmp_path / "j.ply",
                                                    "rb") as b:
        assert a.read() == b.read()
    want = JPLY.load_gaussians_ply(str(tmp_path / "t.ply"))
    got = TPLY.load_gaussians_ply(str(tmp_path / "j.ply"))
    assert got.capacity == want.capacity == 4096
    for f in TG.PARAM_FIELDS + ("active",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.num_active == n - 1


def test_generate_pcd_matches_jax(tmp_path):
    """depth_to_pointcloud and merge_views against JAX's, then main on a
    two-image COLMAP model: the same points3D.bin."""
    from PIL import Image
    rng = np.random.default_rng(10)
    h, w = 24, 32
    K = np.asarray([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    views, imgs, paths = [], {}, []
    for i in range(2):
        img = rng.uniform(size=(h, w, 3)).astype(np.float32)
        depth = rng.uniform(-0.5, 4.0, (h, w)).astype(np.float32)
        q = rng.normal(size=4)
        im = TCM.ColmapImage(i + 1, q / np.linalg.norm(q), rng.normal(size=3),
                             1, f"im{i}.png", np.zeros((0, 2)),
                             np.zeros((0,), np.int64))
        imgs[i + 1] = im
        want = JGP.depth_to_pointcloud(img, depth, K, im.w2c())
        got = TGP.depth_to_pointcloud(img, depth, K, im.w2c())
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[1], want[1])
        views.append(got)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
        np.save(tmp_path / f"d{i}.npy", depth)
        paths.append(str(tmp_path / f"im{i}.png"))
    for voxel in (0.0, 0.3):
        got = TGP.merge_views(views, voxel)
        want = JGP.merge_views(views, voxel)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv)
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    TCM.write_cameras_binary({1: TCM.ColmapCamera(1, "PINHOLE", w, h, np.array(
        [30.0, 30.0, 16.0, 12.0]))}, str(sparse / "cameras.bin"))
    TCM.write_images_binary(imgs, str(sparse / "images.bin"))
    TCM.write_points3d_binary(TCM.ColmapPoints3D(
        np.zeros((0, 3)), np.zeros((0, 3), np.uint8), np.zeros(0)),
        str(sparse / "points3D.bin"))
    argv = ["--images", *paths, "--depths", str(tmp_path / "d0.npy"),
            str(tmp_path / "d1.npy"), "--sparse_dir", str(sparse)]
    JGP.main(argv + ["--out", str(tmp_path / "j.bin")])
    TGP.main(argv + ["--out", str(tmp_path / "t.bin"), "--device", "cpu"])
    got = TCM.read_points3d_binary(str(tmp_path / "t.bin"))
    want = TCM.read_points3d_binary(str(tmp_path / "j.bin"))
    assert 0 < len(got.xyz) == len(want.xyz)
    np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.rgb, want.rgb)
