"""Host-side launch plans of the port's GEGLU-FFN and flash-attention
kernels, on the CPU: the tile and grid choices and the TMA tensor-map
geometry the wrappers hand to the CUDA code, what they copy, and what they
refuse. The kernels themselves run only on the card (chip_smoke.py); these
are the plain-Python parts of their wrappers.
"""
import pytest
import torch

from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops import geglu_ffn as G

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


def test_plans_decide_nothing_about_a_card():
    """The plans are plain arithmetic: they run where torch has no CUDA."""
    assert G.geglu_plan(10, 8, 1)["grid1"] == 1
    assert A.flash_grid(1, 1, 1, 1) == 1
