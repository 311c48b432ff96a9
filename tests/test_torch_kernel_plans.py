"""Host-side launch plans of the port's GEGLU-FFN, flash-attention,
frame-attention, composite forward and backward, LayerNorm and GroupNorm
kernels, on the CPU: the tile and grid choices, the TMA tensor-map geometry
and the scratch the wrappers hand to the CUDA code, what they copy, and
what they refuse.
The kernels themselves run only on the card (chip_smoke.py); these are the
plain-Python parts of their wrappers.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

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
    (75 * 9216, 320, 2700 * 20, 2700 * 2),
    (75 * 2304, 640, 675 * 40, 675 * 4),
    (75 * 576, 1280, 169 * 80, 169 * 8),
    (75 * 144, 1280, 43 * 80, 43 * 8),
    (100, 64, 4, 1)])
def test_geglu_persistent_grid(rows, c, tiles1, tiles2):
    plan = G.geglu_plan(rows, c, H100_SMS)
    assert (plan["tiles1"], plan["tiles2"]) == (tiles1, tiles2)
    assert plan["grid1"] == min(tiles1, H100_SMS)
    assert plan["grid2"] == min(tiles2, H100_SMS)


# GEMM-1's shapes in the two denoise cells: rows = batch x 25 frames x
# tokens (batch 3 post, batch 2 prob), C of the UNet level with that many
# tokens; inner 4C for the whole FF, 4C / 2 and 4C / 4 for its
# tensor-parallel shards.
UNET_FFN = [(9216, 320), (2304, 640), (576, 1280), (144, 1280)]


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("batch", [3, 2])
@pytest.mark.parametrize("tokens, c", UNET_FFN)
def test_geglu_plan_fits_the_card_at_unet_shapes(tokens, c, batch, parts):
    """At every GEMM-1 shape the denoise cells run and at its shards: the
    64-column tile divides the inner width (no column masked), each GEMM's
    ring (GEMM-1's with its staging tile) fits a block's shared memory, and
    the producer's and the two consumers' registers fit an SM's."""
    rows, inner = batch * 25 * tokens, 4 * c // parts
    plan = G.geglu_plan(rows, c, H100_SMS, inner)
    assert inner % G.GEMM1_TN == 0
    assert plan["tiles1"] == -(-rows // G.TILE_ROWS) * inner // G.GEMM1_TN
    for ring in (G.gemm_smem(2 * G.GEMM1_TN, geglu=True),
                 G.gemm_smem(plan["bn2"])):
        assert ring["stages"] >= 2 and ring["smem"] <= G.SMEM_PER_BLOCK
    threads = G.THREADS // 3
    assert threads * (G.PRODUCER_REGS + 2 * G.CONSUMER_REGS) <= G.REGS_PER_SM


def test_geglu_budgets_mirror_the_kernel():
    """The .cu file's shared memory (Cfg): GEMM-1's 128-row B tile (64 a
    and 64 g rows of W1) and GEMM-2's 160-row one, each with the 256-row A
    tile, 64 deep: 4 stages within 220 KB; GEMM-1 adds its 256 x 64 bf16
    staging tile of h and its consumer warps' order words and still fits a
    block's 227 KB; setmaxnreg's counts
    are multiples of 8 from 24 to 256."""
    one = G.gemm_smem(2 * G.GEMM1_TN, geglu=True)
    assert one == {"stages": 4, "staging": 32768,
                   "smem": 1024 + 4 * (256 + 128) * 128 + 32768 + 64
                   + 32}
    assert one["smem"] <= G.SMEM_PER_BLOCK
    assert G.gemm_smem(160) == {"stages": 4, "staging": 0,
                                "smem": 1024 + 4 * (256 + 160) * 128 + 64}
    for regs in (G.PRODUCER_REGS, G.CONSUMER_REGS):
        assert regs % 8 == 0 and 24 <= regs <= 256
    assert G.THREADS == 3 * 128


@pytest.mark.parametrize("c, inner, ragged", [(64, 256, 0), (128, 512, 0),
                                              (64, 200, 56), (24, 96, 32),
                                              (8, 8, 56)])
def test_geglu_column_tiles_of_narrow_ffs(c, inner, ragged):
    """The small UNet's C = 64 (inner 256) and 128 (512) fill whole
    64-column tiles; an inner width off the tile plans a last tile whose
    columns past h's edge its TMA store does not write."""
    plan = G.geglu_plan(1000, c, H100_SMS, inner)
    col_tiles = plan["tiles1"] // 4       # 1000 rows: 4 row tiles
    assert col_tiles == -(-inner // G.GEMM1_TN)
    assert col_tiles * G.GEMM1_TN - inner == ragged


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


# (rows, H) of the temporal self-attention (S 25 frames) of an SVD-XT
# forward over 72x128 latents: batch 3 (the post cell's fused forward) and
# batch 2 (the prob cell's CFG pair) at 9216, 2304, 576 and 144 pixels a
# frame; and tensor-parallel shards of the 5 heads of the top level
FRAME_SHAPES = ([(b * px, h) for b in (3, 2)
                 for px, h in ((9216, 5), (2304, 10), (576, 20), (144, 20))]
                + [(3 * 9216, 3), (3 * 9216, 2)])


@pytest.mark.parametrize("rows, h", FRAME_SHAPES)
def test_frame_attention_plan(rows, h):
    """Work items of 8 (row, head) pairs over a persistent grid of one
    block a SM; the ring of q, k, v tiles (32 rows of 128 bytes) and a
    tile a consumer warp for o within the 227 KB a block may use."""
    plan = A.frame_attention_plan(rows, h, 25, H100_SMS)
    tile = A.FRAME_ROWS * 64 * 2
    assert plan["pairs"] == rows * h
    assert plan["items"] == -(-rows * h // A.FRAME_PAIRS)
    assert plan["grid"] == min(plan["items"], H100_SMS) == H100_SMS
    assert plan["smem"] == (1024 + A.FRAME_STAGES * 3 * A.FRAME_PAIRS * tile
                            + A.FRAME_PAIRS * tile + 2 * A.FRAME_STAGES * 8)
    assert plan["smem"] <= A.SMEM_BYTES == 232448


@pytest.mark.parametrize("rows, h, items, grid", [
    (1, 2, 1, 1), (4, 2, 1, 1), (5, 3, 2, 2), (432, 20, 1080, H100_SMS)])
def test_frame_attention_grid_is_persistent(rows, h, items, grid):
    plan = A.frame_attention_plan(rows, h, 25, H100_SMS)
    assert (plan["items"], plan["grid"]) == (items, grid)


@pytest.mark.parametrize("rows, h", FRAME_SHAPES)
def test_frame_attention_maps_of_projection_views(rows, h):
    """The temporal attention's q, k, v are split() views of (rows, F, C)
    Linear outputs, strides (F C, 64, C, 1): the map walks them as they
    lie (H before S), a box of one head's 32 frames, with no copy."""
    c = h * 64
    m = A.flash_tensor_map((rows, h, 25, 64), (25 * c, 64, c, 1), 4096,
                           A.FRAME_ROWS)
    assert m == {"dims": (64, h, 25, rows),
                 "strides": (128, c * 2, 25 * c * 2),
                 "box": (64, 1, A.FRAME_ROWS, 1), "s_dim": 2}


@pytest.mark.parametrize("layout", ["projection", "fused_qkv", "contiguous"])
def test_frame_attention_maps_real_views_without_a_copy(layout):
    """Split views of a projection, of a fused QKV projection (row stride
    3 C) and contiguous (B, H, S, 64) tensors are all read in place."""
    rows, s, h = 6, 25, 5
    c = h * 64
    if layout == "contiguous":
        q = torch.empty((rows, h, s, 64), dtype=torch.bfloat16)
    else:
        width = 3 * c if layout == "fused_qkv" else c
        proj = torch.empty((rows, s, width), dtype=torch.bfloat16)
        q = proj[..., c:2 * c] if layout == "fused_qkv" else proj
        q = q.view(rows, s, h, 64).transpose(1, 2)
    t, m = A.mapped(q, A.FRAME_ROWS)
    assert t is q
    assert m["box"][m["s_dim"]] == A.FRAME_ROWS and m["dims"][0] == 64


def test_frame_attention_output_merges_heads_as_a_view():
    """o is a (B, H, S, 64) view of a (B, S, H, 64) tensor, so the
    transpose and reshape before to_out copy nothing."""
    q = torch.empty((6, 5, 25, 64), dtype=torch.bfloat16)
    out = A.like_projection(q)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    merged = out.transpose(1, 2).reshape(6, 25, -1)
    assert merged.data_ptr() == out.data_ptr() and merged._is_view()


@pytest.mark.parametrize("args, match", [
    ((3, 5, 25, H100_SMS, 32), "d = 64"),
    ((3, 5, 25, H100_SMS, 128), "d = 64"),
    ((3, 5, 33, H100_SMS), "S <= 32"),
    ((3, 5, 0, H100_SMS), "S <= 32"),
    ((0, 5, 25, H100_SMS), "> 0"),
    ((2 ** 28, 8, 25, H100_SMS), "32-bit"),
])
def test_frame_attention_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        A.frame_attention_plan(*args)


def test_frame_attention_plan_refuses_shared_memory_over_227_kb(
        monkeypatch):
    monkeypatch.setattr(A, "SMEM_BYTES", 200 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        A.frame_attention_plan(3, 5, 25, H100_SMS)


def test_frame_attention_kernel_refuses_unsupported_inputs():
    def qkv(d=64, s=25, dtype=torch.bfloat16):
        return [torch.zeros((2, 5, s, d), dtype=dtype) for _ in range(3)]
    A.check_flash_args(*qkv(), "frame_attention")
    with pytest.raises(ValueError, match="d = 64"):
        A.check_flash_args(*qkv(d=32), "frame_attention")
    with pytest.raises(TypeError, match="frame_attention kernel takes "
                       "bfloat16"):
        A.check_flash_args(*qkv(dtype=torch.float32), "frame_attention")
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.frame_attention(*qkv(), 0.125)
    # the CPU never takes the kernel, with or without a gradient
    assert not A.takes_frame_kernel(*qkv())
    assert not A.takes_frame_kernel(*(t.float().requires_grad_()
                                      for t in qkv()))


BWD_SHAPES = [(25, 5, 9216), (25, 10, 2304), (25, 20, 576), (2, 3, 200),
              (1, 2, 1000)]


@pytest.mark.parametrize("b, h, s", BWD_SHAPES)
def test_flash_bwd_plan(b, h, s):
    """Work items of 128 rows (dkv: keys, dq: queries) over a persistent
    grid of at most one block per SM; resident tiles in 128-row boxes,
    streamed stages in 64-row ones; lse and D rows padded to 4 values."""
    plan = A.flash_bwd_plan(b, h, s, H100_SMS)
    items = b * h * math.ceil(s / 128)
    assert plan["items"] == items
    assert plan["ld"] % 4 == 0 and s <= plan["ld"] < s + 4
    assert plan["dkv"]["boxes"] == {"k": 128, "v": 128, "q": 64,
                                    "dout": 64, "lse": 64, "delta": 64}
    assert plan["dq"]["boxes"] == {"q": 128, "dout": 128, "out": 128,
                                   "k": 64, "v": 64}
    for name, resident, stage in (("dkv", 2, 2 * 8192 + 1024),
                                  ("dq", 3, 2 * 8192)):
        p = plan[name]
        assert (p["rows"], p["stage_rows"]) == (128, 64)
        assert p["grid"] == min(items, H100_SMS)
        assert p["smem"] == (1024 + resident * 16384 + p["stages"] * stage
                             + (2 + 2 * p["stages"]) * 8)
        assert p["smem"] <= A.SMEM_BYTES
    # the grad pass fills every SM; the small ragged shapes take one block
    # per item: 2 x 3 heads x 2 tiles, 2 heads x 8 tiles
    if b == 25:
        assert plan["dq"]["grid"] == H100_SMS
    else:
        assert plan["dq"]["grid"] == {200: 12, 1000: 16}[s]


@pytest.mark.parametrize("b, h, s", BWD_SHAPES)
def test_flash_bwd_maps_of_unet_views(b, h, s):
    """The UNet's q, k, v (and dout, out) are (B, S, H, 64) tensors viewed
    as (B, H, S, 64): each kernel maps them as they lie, with its own box
    rows; a contiguous (B, H, S, 64) input maps with S the inner axis."""
    plan = A.flash_bwd_plan(b, h, s, H100_SMS)
    proj = (s * h * 64, 64, h * 64, 1)
    cont = (h * s * 64, s * 64, 64, 1)
    for name, order in A.FLASH_BWD_INPUTS.items():
        for strides, dims, st, s_dim in (
                (proj, (64, h, s, b), (128, h * 128, s * h * 128), 2),
                (cont, (64, s, h, b), (128, s * 128, h * s * 128), 1)):
            views = {n: _meta_view((b, h, s, 64), strides) for n in order}
            maps = A.flash_bwd_maps(name, views, plan)
            for n, m in zip(order, maps):
                rows = plan[name]["boxes"][n]
                box = (64, rows, 1, 1) if s_dim == 1 else (64, 1, rows, 1)
                assert m == {"dims": dims, "strides": st, "box": box,
                             "s_dim": s_dim}


def _meta_view(shape, strides):
    """A bf16 view with the given element strides over a meta buffer (no
    memory), its start 16-byte aligned."""
    size = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.empty(size, dtype=torch.bfloat16,
                       device="meta").as_strided(shape, strides)


def test_flash_bwd_operands_of_real_views():
    """Views TMA can read (the UNet's projections, a contiguous tensor, the
    forward's like_projection output) go to the kernels as they are; lse
    keeps its storage where S is a multiple of 4 and D is a fresh f32
    (B, H, ld) buffer."""
    b, h, s = 2, 3, 200
    q, k = (torch.zeros((b, s, h, 64), dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    v = torch.zeros((b, h, s, 64), dtype=torch.bfloat16)
    out, dout = A.like_projection(q), A.like_projection(q)
    lse = torch.zeros((b, h, s))
    plan = A.flash_bwd_plan(b, h, s, H100_SMS)
    views, lse_k, delta = A.flash_bwd_operands(q, k, v, out, dout, lse,
                                               plan["ld"])
    for n, t in (("q", q), ("k", k), ("v", v), ("out", out),
                 ("dout", dout)):
        assert views[n] is t
    assert lse_k.data_ptr() == lse.data_ptr()
    assert delta.shape == (b, h, 200) and delta.dtype == torch.float32
    for name in ("dkv", "dq"):
        assert len(A.flash_bwd_maps(name, views, plan)) == (
            4 if name == "dkv" else 5)
    # the gradients the backward returns: (B, H, S, 64) views of (B, S, H,
    # 64) tensors, written through element strides with a contiguous last
    # axis and 16-byte rows
    g = A.like_projection(k)
    assert g.stride() == (s * h * 64, 64, h * 64, 1)
    assert g.data_ptr() % 16 == 0


def test_flash_bwd_pads_lse_rows_to_four():
    b, h, s = 1, 2, 201
    q = torch.zeros((b, h, s, 64), dtype=torch.bfloat16)
    lse = torch.arange(b * h * s, dtype=torch.float32).view(b, h, s)
    plan = A.flash_bwd_plan(b, h, s, H100_SMS)
    assert plan["ld"] == 204
    _, lse_k, delta = A.flash_bwd_operands(q, q, q, q, q, lse, plan["ld"])
    assert lse_k.shape == delta.shape == (b, h, 204)
    assert torch.equal(lse_k[..., :s], lse)
    assert not lse_k[..., s:].any()


def test_flash_bwd_misaligned_views_are_copied_once(monkeypatch):
    """A view TMA cannot read (rows 132 bytes apart, or a start off 16-byte
    alignment) is copied once for both kernels, though they map it with
    other box rows; the others are not copied."""
    def wide():             # a 66-wide buffer sliced to 64, as (B, H, S, 64)
        return (torch.randn((2, 576, 3, 66)).to(torch.bfloat16)[..., :64]
                .transpose(1, 2))
    q, dout = wide(), wide()
    flat = torch.zeros(2 * 3 * 576 * 64 + 1, dtype=torch.bfloat16)[1:]
    k = flat.view(2, 3, 576, 64)
    v, out = (torch.zeros((2, 576, 3, 64), dtype=torch.bfloat16)
              .transpose(1, 2) for _ in range(2))
    lse = torch.zeros((2, 3, 576))
    plan = A.flash_bwd_plan(2, 3, 576, H100_SMS)
    copied = []
    real_clone = torch.Tensor.clone

    def counting_clone(t, *a, **kw):
        copied.append(t.data_ptr())
        return real_clone(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "clone", counting_clone)
    views, _, _ = A.flash_bwd_operands(q, k, v, out, dout, lse, plan["ld"])
    monkeypatch.undo()
    assert sorted(copied) == sorted(t.data_ptr() for t in (q, k, dout))
    for n, t in (("q", q), ("k", k), ("dout", dout)):
        assert views[n] is not t and torch.equal(views[n], t)
        assert views[n].is_contiguous() and views[n].data_ptr() % 16 == 0
    assert views["v"] is v and views["out"] is out
    for name in ("dkv", "dq"):
        A.flash_bwd_maps(name, views, plan)     # all mapped, no raise
    # a view handed to the kernels without the copy is refused
    with pytest.raises(ValueError, match="TMA cannot read"):
        A.flash_bwd_maps("dq", dict(views, out=q), plan)


@pytest.mark.parametrize("args, match", [
    ((1, 1, 64, H100_SMS, 128), "d = 64"),
    ((1, 1, 64, H100_SMS, 32), "d = 64"),
    ((0, 1, 64, H100_SMS), "> 0"),
    ((1, 1, 64, 0), "> 0"),
    ((2 ** 20, 2 ** 10, 2 ** 20, H100_SMS), "32-bit"),
])
def test_flash_bwd_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        A.flash_bwd_plan(*args)


def test_flash_bwd_plan_refuses_shared_memory_over_227_kb(monkeypatch):
    """The plan holds the kernels' ring to the 227 KB a block may use:
    twelve stages would pass it."""
    assert A.flash_bwd_plan(1, 1, 64, H100_SMS)["dq"]["smem"] < A.SMEM_BYTES
    monkeypatch.setattr(A, "FLASH_BWD_STAGES", 12)
    with pytest.raises(ValueError, match="shared memory"):
        A.flash_bwd_plan(1, 1, 64, H100_SMS)


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
    assert G.check_geglu_args(*_ffn_args(24)) == (16, 24, 96)
    with pytest.raises(ValueError, match="multiples of 8"):
        G.check_geglu_args(*_ffn_args(12))
    with pytest.raises(TypeError, match="bfloat16"):
        G.check_geglu_args(*_ffn_args(32, torch.float32))
    x, w1, b1, w2, b2 = _ffn_args(32)
    with pytest.raises(ValueError, match="weight shapes"):
        G.check_geglu_args(x, w1[:-8], b1, w2, b2)


def _ffn_shard_args(c, inner, rows=16):
    x, w1, b1, w2, b2 = _ffn_args(c, rows=rows)
    units = torch.cat([torch.arange(inner), 4 * c + torch.arange(inner)])
    return x, w1[units], b1[units], w2[:, :inner].contiguous(), b2


@pytest.mark.parametrize("c, parts", [(320, 2), (320, 4), (640, 2),
                                      (640, 4), (1280, 2), (1280, 4)])
def test_geglu_kernel_takes_tensor_parallel_shards(c, parts):
    """The SVD UNet's FF split by GEGLU units over 2 or 4 cards: each
    shard's inner width (4C / N) is taken, and its GEMM-1 tiles are the
    whole FF's over N (4C / N is a multiple of the 64-column tile)."""
    inner = 4 * c // parts
    assert G.check_geglu_args(*_ffn_shard_args(c, inner)) == (16, c, inner)
    whole = G.geglu_plan(75 * 576, c, H100_SMS)
    shard = G.geglu_plan(75 * 576, c, H100_SMS, inner)
    assert shard["tiles1"] * parts == whole["tiles1"]
    assert shard["tiles2"] == whole["tiles2"] and shard["bn2"] == whole["bn2"]


def test_geglu_kernel_refuses_shard_widths_off_8():
    with pytest.raises(ValueError, match="multiples of 8"):
        G.check_geglu_args(*_ffn_shard_args(32, 44))


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
    (96, 2048, 1024, 128, (4, 96)),      # the GS main path
    (4, 2048, 256, 128, (4, 4)),         # tests/test_torch_rasterize.py
    (4, 2048, 512, 128, (4, 4)),         # chip_smoke.py's gs_small
    (4, 2048, 24, 24, (4, 4)),           # one chunk
    (1, 1100, 128, 128, (3, 1)),         # a ragged last block
    (128, 1536, 1024, 128, (3, 128)),    # tiles of 24 x 64
    (96, 2048, 1008, 24, (4, 96)),       # 42 chunks of 24
    (2, 2048, 2304, 128, (4, 2)),        # 18 chunks
    (1, 2048, 16512, 128, (4, 1)),       # 129 chunks
    (65535, 512, 128, 128, (1, 65535)),  # the most tiles
    (1, 2048, 131072, 128, (4, 1))])     # 1024 chunks: a walk, no limit
def test_composite_fwd_plan(T, px, cap, K, grid):
    plan = TC.composite_fwd_plan(T, px, cap, K)
    assert plan["grid"] == grid and "cluster" not in plan
    assert plan["threads"] == 128 and plan["pixels_per_thread"] == 4
    assert plan["block_pixels"] == 512
    # the backward's keep layout: (T, chunks, 1024-pixel blocks x 8 warps,
    # 4 words); the kernel's 512-pixel blocks write the first 4 a block
    bwd = TC.composite_bwd_plan(T, px, cap, K)["scratch"]["keep"]
    assert plan["scratch"] == {"keep": (*bwd[:2], bwd[2] * bwd[3], bwd[4])}
    assert plan["kernel_rects"] == 4 * grid[0] <= bwd[2] * bwd[3]
    assert plan["scratch_bytes"] == 4 * math.prod(plan["scratch"]["keep"])


@pytest.mark.parametrize("px, rects, written", [
    (2048, 16, 16), (1100, 16, 12), (512, 8, 4), (1536, 16, 12)])
def test_composite_fwd_keep_rectangles(px, rects, written):
    """A 512-pixel block's warp rectangles are those of the backward's
    1024-pixel blocks, in the same order: block b, warp w is rectangle
    4 b + w, and a rectangle past the kernel's last block has no pixel."""
    plan = TC.composite_fwd_plan(1, px, 128, 128)
    assert plan["scratch"]["keep"][2] == rects
    assert plan["kernel_rects"] == written
    pm = TC.bwd_pixel_map(px).reshape(-1, 4, 32)        # rect, row, lane
    assert bool((pm[written:] < 0).all())
    for g in range(written):
        b, w = divmod(g, 4)
        rows = b * 8 + (w // 2) * 4 + torch.arange(4)
        want = rows[:, None] * 64 + (w % 2) * 32 + torch.arange(32)
        assert torch.equal(pm[g], torch.where(want < px, want, -1))


@pytest.mark.parametrize("T, px, cap, K, match", [
    (4, 2048, 256, 256, "K <= 128"),         # chunks beyond 128 entries
    (4, 2048, 250, 128, "cap % K"),
    (4, 2048, 1000, 24, "cap % K"),
    (4, 2048, 0, 128, "cap % K"),
    (70000, 2048, 128, 128, "T <="),
    (0, 2048, 128, 128, "T <="),
    (4, 0, 128, 128, "px >= 1")])
def test_composite_fwd_plan_refuses(T, px, cap, K, match):
    with pytest.raises(ValueError, match=match):
        TC.composite_fwd_plan(T, px, cap, K)


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
    assert A.flash_bwd_plan(1, 1, 1, 1)["dkv"]["grid"] == 1
    assert A.frame_attention_plan(1, 2, 1, 1)["grid"] == 1
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


def _cpu_routes():
    """(name, wrapper call on CPU tensors, its plain version or None where
    the wrapper is a launch that takes CUDA tensors only)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((16, 32), generator=g)
    w1, b1 = torch.randn((256, 32), generator=g), torch.randn(256, generator=g)
    w2, b2 = torch.randn((32, 128), generator=g), torch.randn(32, generator=g)
    q, k, v = (torch.randn((1, 2, 600, 64), generator=g) for _ in range(3))
    fq, fk, fv = (torch.randn((6, 5, 25, 64), generator=g) for _ in range(3))
    x3 = torch.randn((2, 40, 64), generator=g)
    gw, gb = torch.randn(64, generator=g), torch.randn(64, generator=g)
    T, px, cap, K = 2, 64, 128, 64
    P = torch.rand((6, px), generator=g)
    Gm, Cm = torch.rand((T, 6, cap), generator=g), torch.rand((T, 5, cap),
                                                              generator=g)
    Om = torch.rand((T, 1, cap), generator=g)
    return [
        ("geglu_ffn", lambda: G.geglu_ffn(x, w1, b1, w2, b2),
         lambda: G.geglu_ffn_reference(x, w1, b1, w2, b2)),
        ("geglu_launch", lambda: G._geglu_launch(
            x.bfloat16(), w1, b1, w2, b2), None),
        ("flash_attention", lambda: A.flash_attention(q, k, v, 0.125),
         lambda: A.attention_chunked(q, k, v, 0.125)),
        ("flash_forward", lambda: A._flash_forward(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.125, False), None),
        ("attention_short_path", lambda: A.attention(fq, fk, fv, 0.125),
         lambda: A.attention_packed_heads(fq, fk, fv, 0.125)),
        ("frame_attention", lambda: A.frame_attention(
            fq.bfloat16(), fk.bfloat16(), fv.bfloat16(), 0.125), None),
        ("flash_attention_bwd", lambda: A.flash_attention_bwd(
            *(t.bfloat16() for t in (q, k, v, q)),
            torch.zeros((1, 2, 600)), q.bfloat16(), 0.125), None),
        ("group_norm", lambda: N.group_norm(x3, gw, gb, 32, 1e-6, True),
         lambda: N.group_norm_reference(x3, gw, gb, 32, 1e-6, True)),
        ("group_norm_stats", lambda: N.group_norm_stats(x3, gw, gb, 32,
                                                        1e-6),
         lambda: N.group_norm_affine_reference(x3, gw, gb, 32, 1e-6)),
        ("group_norm_sums", lambda: N.group_norm_sums(x3),
         lambda: N.group_norm_sums_reference(x3)),
        ("group_norm_apply", lambda: N.group_norm_apply(
            x3, gw[None].expand(2, -1), gb[None].expand(2, -1), True),
         lambda: N.group_norm_apply_reference(
            x3, gw[None].expand(2, -1), gb[None].expand(2, -1), True)),
        ("layer_norm", lambda: N.layer_norm(x, w2[:, 0], b2, 1e-5),
         lambda: N.layer_norm_reference(x, w2[:, 0], b2, 1e-5)),
        ("composite_fwd", lambda: TC.composite_fwd(P, Gm, Cm, Om, K),
         lambda: TC.composite_fwd_reference(P, Gm, Cm, Om, K)),
        ("composite_fwd_launch", lambda: TC.composite_fwd_launch(
            P, Gm, Cm, Om, K), None),
        ("composite_bwd_launch", lambda: TC.composite_bwd_launch(
            P, Gm, Cm, Om, torch.zeros((T, cap // K, px)),
            torch.zeros((T, 6, px)), K), None),
    ]


@pytest.mark.parametrize("case", range(len(_cpu_routes())),
                         ids=[c[0] for c in _cpu_routes()])
def test_wrappers_route_cpu_tensors_as_before(case):
    """Every kernel wrapper, now launching under its tensor's device
    guard, still takes its plain version for CPU tensors, and a launch
    that takes CUDA tensors only still refuses them."""
    name, call, plain = _cpu_routes()[case]
    if plain is None:
        with pytest.raises((ValueError, RuntimeError, AssertionError)):
            call()
        return
    got, want = call(), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b), name


def test_group_norm_affine_from_sums_is_the_affine_of_the_whole():
    """A GroupNorm's rows split over shards: the shards' sums added in
    order and folded give the whole tensor's affine (the frame-sharded
    GroupNorm's route)."""
    g = torch.Generator().manual_seed(6)
    x3 = torch.randn((2, 50, 64), generator=g) * 1.5 + 0.2
    w, b = torch.randn(64, generator=g), torch.randn(64, generator=g)
    sums = N.group_norm_sums(x3[:, :27]) + N.group_norm_sums(x3[:, 27:])
    got = N.group_norm_affine_from_sums(sums, 50, w, b, 32, 1e-6)
    want = N.group_norm_affine_reference(x3, w, b, 32, 1e-6)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)
