"""Host-side launch plans of the port's GEGLU-FFN, flash-attention,
composite-backward, LayerNorm and GroupNorm kernels, on the CPU: the tile
and grid choices, the TMA tensor-map geometry and the scratch the wrappers
hand to the CUDA code, what they copy, and what they refuse. The kernels
themselves run only on the card (chip_smoke.py); these are the
plain-Python parts of their wrappers.
"""
import math

import pytest
import torch

from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops import composite as TC
from syn3r_tpu_torch.ops import geglu_ffn as G
from syn3r_tpu_torch.ops import norm as N
from scripts.kernel_timing import GN_SHAPES

H100_SMS = 132


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_geglu_n_tile_wastes_no_column_at_unet_widths(c):
    plan = G.geglu_plan(75 * 576, c, H100_SMS)
    assert plan["bn2"] == 160
    assert c % plan["bn2"] == 0            # no column computed in vain
    # GEMM-1's tiles cover the 4C gated columns exactly too
    assert 4 * c % G.GEMM1_TN == 0


@pytest.mark.parametrize("c, bn2, wasted", [(64, 128, 64), (128, 128, 0),
                                            (256, 128, 0),
                                            (480, 160, 0), (8, 128, 120),
                                            (200, 128, 56)])
def test_geglu_n_tile_fewest_columns_then_larger(c, bn2, wasted):
    plan = G.geglu_plan(1000, c, H100_SMS)
    assert plan["bn2"] == bn2
    assert -(-c // bn2) * bn2 - c == wasted


@pytest.mark.parametrize("rows, c, tiles1, tiles2", [
    (75 * 9216, 320, 2700 * 16, 2700 * 2),
    (75 * 2304, 640, 675 * 32, 675 * 4),
    (75 * 576, 1280, 169 * 64, 169 * 8),
    (75 * 144, 1280, 43 * 64, 43 * 8),
    (100, 64, 4, 1)])
def test_geglu_persistent_grid(rows, c, tiles1, tiles2):
    plan = G.geglu_plan(rows, c, H100_SMS)
    assert (plan["tiles1"], plan["tiles2"]) == (tiles1, tiles2)
    assert plan["grid1"] == min(tiles1, H100_SMS)
    assert plan["grid2"] == min(tiles2, H100_SMS)


def test_flash_persistent_grid():
    assert A.flash_grid(75, 5, 9216, H100_SMS) == H100_SMS
    assert A.flash_grid(75, 20, 576, H100_SMS) == H100_SMS
    assert A.flash_grid(1, 1, 100, H100_SMS) == 1       # one work item
    assert A.flash_grid(1, 2, 300, H100_SMS) == 6       # 2 heads x 3 tiles


@pytest.mark.parametrize("b, s, h", [(75, 9216, 5), (75, 2304, 10),
                                     (75, 576, 20)])
@pytest.mark.parametrize("rows", [A.FLASH_BQ, A.FLASH_BKV])
def test_flash_map_of_unet_projection_views(b, s, h, rows):
    """The UNet's q, k, v are (B, S, H, 64) tensors viewed as (B, H, S, 64):
    the map walks them as they lie (H before S), with no copy."""
    strides = (s * h * 64, 64, h * 64, 1)   # of the (B, H, S, 64) view
    m = A.flash_tensor_map((b, h, s, 64), strides, 4096, rows)
    assert m == {"dims": (64, h, s, b),
                 "strides": (128, h * 128, s * h * 128),
                 "box": (64, 1, rows, 1), "s_dim": 2}


def test_flash_map_of_real_views():
    base = torch.empty((2, 576, 3, 64), dtype=torch.bfloat16)
    view = base.transpose(1, 2)
    t, m = A.mapped(view, A.FLASH_BQ)
    assert t is view                        # no copy
    assert m["dims"] == (64, 3, 576, 2) and m["s_dim"] == 2
    assert m["strides"] == (128, 3 * 128, 576 * 3 * 128)
    # a contiguous (B, H, S, 64) tensor: S is the inner axis
    cont = view.contiguous()
    t, m = A.mapped(cont, A.FLASH_BKV)
    assert t is cont
    assert m == {"dims": (64, 576, 3, 2), "strides": (128, 576 * 128,
                                                      3 * 576 * 128),
                 "box": (64, A.FLASH_BKV, 1, 1), "s_dim": 1}


@pytest.mark.parametrize("strides, ptr", [
    ((576 * 3 * 66, 66, 3 * 66, 1), 0),      # row stride 132 bytes
    ((576 * 3 * 64, 64, 3 * 64, 2), 0),      # head axis not contiguous
    ((576 * 3 * 64, 64, 3 * 64, 1), 8),      # start not 16-byte aligned
])
def test_flash_map_refuses_what_tma_cannot_read(strides, ptr):
    assert A.flash_tensor_map((2, 3, 576, 64), strides, ptr, 128) is None


def test_flash_misaligned_views_are_copied_once():
    # a 66-wide buffer sliced to 64: rows 132 bytes apart
    wide = torch.zeros((2, 576, 3, 66), dtype=torch.bfloat16)[..., :64]
    view = wide.transpose(1, 2)
    t, m = A.mapped(view, A.FLASH_BQ)
    assert t is not view and t.is_contiguous() and torch.equal(t, view)
    assert m["s_dim"] == 1 and t.data_ptr() % 16 == 0
    # a start 2 bytes off alignment
    flat = torch.zeros(2 * 3 * 100 * 64 + 1, dtype=torch.bfloat16)[1:]
    view = flat.view(2, 3, 100, 64)
    assert view.data_ptr() % 16 != 0
    t, m = A.mapped(view, A.FLASH_BQ)
    assert t is not view and t.data_ptr() % 16 == 0 and m is not None


def test_geglu_operands_aligned_or_copied():
    x = torch.zeros((64, 32), dtype=torch.bfloat16)
    assert G.aligned16(x) is x
    off = torch.zeros(64 * 32 + 1, dtype=torch.bfloat16)[1:].view(64, 32)
    got = G.aligned16(off)
    assert got is not off and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
    strided = torch.zeros((32, 64), dtype=torch.bfloat16).t()
    got = G.aligned16(strided)
    assert got.is_contiguous() and torch.equal(got, strided)


def _ffn_args(c, dtype=torch.bfloat16, rows=16):
    return (torch.zeros((rows, c), dtype=dtype),
            torch.zeros((8 * c, c), dtype=dtype), torch.zeros(8 * c),
            torch.zeros((c, 4 * c), dtype=dtype), torch.zeros(c))


def test_geglu_kernel_refuses_unsupported_inputs():
    assert G.check_geglu_args(*_ffn_args(24)) == (16, 24)
    with pytest.raises(ValueError, match="C % 8"):
        G.check_geglu_args(*_ffn_args(12))
    with pytest.raises(TypeError, match="bfloat16"):
        G.check_geglu_args(*_ffn_args(32, torch.float32))
    x, w1, b1, w2, b2 = _ffn_args(32)
    with pytest.raises(ValueError, match="weight shapes"):
        G.check_geglu_args(x, w1[:-8], b1, w2, b2)


def test_flash_kernel_refuses_unsupported_inputs():
    def qkv(d=64, dtype=torch.bfloat16):
        return [torch.zeros((1, 2, 576, d), dtype=dtype) for _ in range(3)]
    A.check_flash_args(*qkv())
    with pytest.raises(ValueError, match="d = 64"):
        A.check_flash_args(*qkv(d=32))
    with pytest.raises(TypeError, match="bfloat16"):
        A.check_flash_args(*qkv(dtype=torch.float32))
    q, k, v = qkv()
    with pytest.raises(ValueError, match="one shape"):
        A.check_flash_args(q, k[:, :, :288], v)


@pytest.mark.parametrize("T, px, cap, K, grid", [
    (96, 2048, 1024, 128, (2, 8, 96)),      # the GS main path
    (4, 2048, 256, 128, (2, 2, 4)),         # tests/test_torch_rasterize.py
    (4, 2048, 384, 128, (2, 3, 4)),
    (4, 2048, 512, 128, (2, 4, 4)),
    (4, 2048, 24, 24, (2, 1, 4)),
    (1, 1100, 128, 128, (2, 1, 1))])        # a ragged last block
def test_composite_bwd_plan(T, px, cap, K, grid):
    plan = TC.composite_bwd_plan(T, px, cap, K)
    assert plan["grid"] == grid
    assert plan["threads"] == 256 and plan["pixels_per_thread"] == 4
    assert plan["block_pixels"] == 256 * 4
    n_blk, n_chunks, _ = grid
    assert plan["scratch"] == {"tot": (T, n_chunks, px),
                               "keep": (T, n_chunks, n_blk, 8, 4),
                               "part": (T, n_blk, 12, cap)}
    assert plan["scratch_bytes"] == 4 * (T * n_chunks * px
                                         + T * n_chunks * n_blk * 32
                                         + T * n_blk * 12 * cap)


def test_composite_bwd_scratch_at_the_gs_shape():
    """tot 6.3 MB, part 9.4 MB, keep bits 0.2 MB: under the 37.7 MB of
    per-256-pixel partials that one chunk at a time wrote."""
    plan = TC.composite_bwd_plan(96, 2048, 1024, 128)
    assert plan["scratch_bytes"] == 4 * (96 * 8 * 2048 + 96 * 8 * 2 * 32
                                         + 96 * 2 * 12 * 1024)
    assert plan["scratch_bytes"] < 16e6 < 4 * 96 * 8 * 12 * 1024


@pytest.mark.parametrize("px", [2048, 1100, 64])
def test_composite_bwd_pixel_map_covers_each_pixel_once(px):
    """Every pixel belongs to exactly one (block, warp, row, lane); a warp
    covers 4 rows x 32 columns of a 64-wide tile."""
    pm = TC.bwd_pixel_map(px)
    got = pm[pm >= 0].sort().values
    assert torch.equal(got, torch.arange(px))
    if px == 2048:
        w = pm[0, 3]                          # rows 4-7, columns 32-63
        assert torch.equal(w // 64, torch.arange(4, 8)[:, None].expand(4, 32))
        assert torch.equal(w % 64, torch.arange(32, 64).expand(4, 32))


@pytest.mark.parametrize("T, px, cap, K, match", [
    (4, 2048, 256, 256, "K <= 128"),         # chunks beyond 128 entries
    (4, 2048, 250, 128, "cap % K"),
    (70000, 2048, 128, 128, "T <="),
    (4, 0, 128, 128, "px >= 1")])
def test_composite_bwd_plan_refuses(T, px, cap, K, match):
    with pytest.raises(ValueError, match=match):
        TC.composite_bwd_plan(T, px, cap, K)


@pytest.mark.parametrize("r, c, dtype, lanes, rows_per_warp", [
    (75 * 9216, 320, torch.bfloat16, 8, 4),  # UNet level 0
    (75 * 2304, 640, torch.bfloat16, 16, 2),
    (75 * 576, 1280, torch.bfloat16, 32, 1),
    (75 * 144, 1280, torch.bfloat16, 32, 1),
    (514, 1280, torch.float32, 32, 1),       # CLIP ViT-H
    (514, 1280, torch.bfloat16, 32, 1)])
def test_layer_norm_plan_has_no_idle_lane_at_census_widths(
        r, c, dtype, lanes, rows_per_warp):
    plan = N.layer_norm_plan(r, c, dtype, H100_SMS)
    assert plan["idle"] == 0
    assert (plan["lanes"], plan["rows_per_warp"]) == (lanes, rows_per_warp)
    assert plan["lanes"] * plan["vectors"] * plan["vec"] == c
    assert plan["vectors"] == (10 if dtype == torch.float32 else 5)
    per_sm = 2 if dtype == torch.bfloat16 else 1
    groups = -(-r // rows_per_warp)
    assert plan["grid"] == min(-(-groups // 8), H100_SMS * per_sm)


def test_layer_norm_plan_falls_back_to_masked_lanes():
    # 33 vectors a row: no power of two divides it with <= 10 a lane
    plan = N.layer_norm_plan(100, 264, torch.bfloat16, H100_SMS)
    assert (plan["lanes"], plan["vectors"], plan["idle"]) == (32, 2, 31)
    assert N.layer_norm_plan(7, 8, torch.bfloat16, H100_SMS) == dict(
        vec=8, lanes=1, vectors=1, rows_per_warp=32, idle=0, grid=1)


@pytest.mark.parametrize("c, dtype, err, match", [
    (12, torch.bfloat16, ValueError, "C % 8"),
    (6, torch.float32, ValueError, "C % 4"),
    (2568, torch.bfloat16, ValueError, "C <="),
    (1284, torch.float32, ValueError, "C <="),
    (64, torch.float16, TypeError, "float32 or bfloat16")])
def test_layer_norm_plan_refuses(c, dtype, err, match):
    with pytest.raises(err, match=match):
        N.layer_norm_plan(16, c, dtype, H100_SMS)


def test_plans_decide_nothing_about_a_card():
    """The plans are plain arithmetic: they run where torch has no CUDA."""
    assert G.geglu_plan(10, 8, 1)["grid1"] == 1
    assert A.flash_grid(1, 1, 1, 1) == 1
    assert TC.composite_bwd_plan(1, 1, 1, 1)["grid"] == (1, 1, 1)
    assert N.layer_norm_plan(1, 8, torch.bfloat16, 1)["grid"] == 1
    assert N.group_norm_plan(1, 1, 8, torch.bfloat16, 1, 1,
                             groups=1)["grid"] == 1


# the VAE's float32 GroupNorms: encode of 25 frames at 576x1024 (C = 128,
# 256, 512 down the levels) and a decode chunk of 8 frames
VAE_GN_SHAPES = [(25, 576 * 1024, 128), (25, 288 * 512, 256),
                 (25, 144 * 256, 512), (25, 72 * 128, 512),
                 (8, 576 * 1024, 128), (8, 288 * 512, 256)]
GN_CASES = ([(b, s, c, torch.bfloat16) for b, s, c, _, _ in GN_SHAPES]
            + [(b, s, c, torch.float32) for b, s, c in VAE_GN_SHAPES])


def _gn_plan(b, s, c, dtype, kernel="stats", sms=H100_SMS):
    """The plan with 2048 resident threads a SM (the occupancy query's
    answer stands in for the card's)."""
    threads = N.group_norm_threads(c, dtype, kernel)
    return N.group_norm_plan(b, s, c, dtype, sms, 2048 // threads,
                             kernel=kernel)


@pytest.mark.parametrize("kernel", N.GN_KERNELS)
@pytest.mark.parametrize("b, s, c, dtype", GN_CASES)
def test_group_norm_plan_has_no_idle_lane(b, s, c, dtype, kernel):
    """Each thread keeps one window of vec channels for the whole launch:
    threads a multiple of 32 and of C/vec; the stats take the most such
    threads up to 512, the apply the fewest from 128."""
    plan = _gn_plan(b, s, c, dtype, kernel)
    vec = 8 if dtype == torch.bfloat16 else 4
    unit = plan["threads"] // plan["rows"]
    assert plan["vec"] == vec and unit == c // vec
    assert plan["threads"] % 32 == 0 and plan["threads"] % unit == 0
    lcm = math.lcm(unit, 32)
    if kernel == "stats":
        assert 512 - lcm < plan["threads"] <= 512
        assert plan["smem"] == plan["threads"] * vec * 8 <= 48 * 1024
    else:
        assert 128 <= plan["threads"] < 128 + lcm and plan["smem"] == 0


@pytest.mark.parametrize("c, stats, apply", [
    (320, 480, 160), (640, 480, 160), (1280, 480, 160), (960, 480, 480),
    (1920, 480, 480), (2560, 320, 320), (64, 512, 128), (192, 480, 192)])
def test_group_norm_threads_at_unet_widths(c, stats, apply):
    assert N.group_norm_threads(c, torch.bfloat16, "stats") == stats
    assert N.group_norm_threads(c, torch.bfloat16, "apply") == apply


@pytest.mark.parametrize("kernel", N.GN_KERNELS)
@pytest.mark.parametrize("b, s, c, dtype", GN_CASES)
def test_group_norm_plan_grid_fits_residency(b, s, c, dtype, kernel):
    """At least four items a block, on at most the resident blocks: the
    UNet's and the VAE's shapes all fill every slot."""
    plan = _gn_plan(b, s, c, dtype, kernel)
    slots = H100_SMS * (2048 // plan["threads"])
    assert plan["items"] == b * plan["items_per_b"]
    assert plan["items_per_b"] == -(-s // plan["rows"])
    assert plan["items"] >= 4 * plan["grid"]
    assert plan["grid"] == slots
    assert plan["slots"] == plan["grid"] + b - 1 and plan["counters"] == b


@pytest.mark.parametrize("kernel", N.GN_KERNELS)
@pytest.mark.parametrize("b, s, c, dtype", [
    (75, 144, 2560, torch.bfloat16), (3, 3600, 1280, torch.bfloat16),
    (75, 9216, 320, torch.bfloat16), (3, 230400, 320, torch.bfloat16),
    (25, 72 * 128, 512, torch.float32),
    (5, 37, 64, torch.bfloat16),      # a short last item in every batch
    (2, 1, 192, torch.bfloat16)])     # fewer items than blocks a SM
def test_group_norm_walk_covers_each_row_once(b, s, c, dtype, kernel):
    """The kernels' walk (mirrored by group_norm_segments) covers each row
    of each batch element exactly once, block loads differ by at most one
    item, and the partial slots of a batch element are the fold's
    (group_norm_parts): unique, in block order, within the scratch."""
    plan = _gn_plan(b, s, c, dtype, kernel)
    covered = {bb: [] for bb in range(b)}
    slots, loads = [], []
    for k in range(plan["grid"]):
        segs = N.group_norm_segments(plan, s, k)
        assert segs, f"block {k} has no item"
        loads.append(sum(-(-(s1 - s0) // plan["rows"])
                         for _, s0, s1, _ in segs))
        for bb, s0, s1, slot in segs:
            covered[bb].append((s0, s1))
            slots.append((bb, slot))
    assert max(loads) - min(loads) <= 1
    for bb, spans in covered.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == s
        assert all(e == s0 for (_, e), (s0, _) in zip(spans, spans[1:]))
        assert [sl for x, sl in slots if x == bb] == \
            list(N.group_norm_parts(plan, bb))
    assert len({sl for _, sl in slots}) == len(slots)
    assert max(sl for _, sl in slots) < plan["slots"]


def test_group_norm_plan_scratch_at_the_temporal_shape():
    """(3, 230400, 320) bf16 stats: 480 threads, 12 rows a pass, 57,600
    items on 132 x 2 resident blocks (the H100's occupancy at 480
    threads); 266 float32 (2, 320) partials (0.68 MB) and 3 counters."""
    plan = N.group_norm_plan(3, 230400, 320, torch.bfloat16, H100_SMS, 2)
    assert (plan["threads"], plan["rows"], plan["items"], plan["grid"]) == \
        (480, 12, 57600, 264)
    assert plan["slots"] == 266 and plan["counters"] == 3
    assert plan["smem"] == 480 * 8 * 8


@pytest.mark.parametrize("c, dtype, groups, err, match", [
    (64, torch.float16, 32, TypeError, "float32 or bfloat16"),
    (64, torch.bfloat16, 32, ValueError, "one of"),     # no such kernel
    (12, torch.bfloat16, 4, ValueError, "C % 8"),
    (6, torch.float32, 2, ValueError, "C % 4"),
    (320, torch.bfloat16, 48, ValueError, "C % G"),
    (1024, torch.float32, 256, ValueError, "G <= 128"),
    (264, torch.bfloat16, 33, ValueError, "lcm"),     # 33 vectors a row
    (8192, torch.bfloat16, 32, ValueError, "lcm")])
def test_group_norm_plan_refuses(c, dtype, groups, err, match):
    kernel = "fold" if match == "one of" else "stats"
    with pytest.raises(err, match=match):
        N.group_norm_plan(3, 64, c, dtype, H100_SMS, 4, kernel=kernel,
                          groups=groups)
