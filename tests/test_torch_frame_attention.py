"""The frame-attention kernel (``csrc/frame_attention.cu``) on the card,
against the packed version it replaces on the temporal self-attention's
short path (``ops/attention.attention_packed_heads``), at the flash
kernel's tolerance: the SVD-XT levels on split projection views and on
contiguous inputs, S from 1 to 32 frames, head counts of tensor-parallel
shards, a fused QKV projection's row stride, the output's layout, and the
dispatch (no kernel where a gradient is taken).

Every test needs a CUDA card (marker ``chip``) and skips without one. On
the card, from the root of the repository (the tests' conftest imports
JAX, which that machine lacks)::

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_frame_attention.py
"""
import pytest
import torch

from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.chip

SCALE = 0.125
# max-abs and rel-RMS of the kernel against the packed version, as the
# flash kernel is held (chip_smoke.TOL): both round P to bf16 and the
# output to bf16; the kernel's exp2 and its f32 sums run in another order
TOL = (2e-2, 1e-2)
# (rows, H, S): the four levels of a batch-3 forward over 72x128 latents
# at 25 frames, then fewer rows at other frame counts
LEVELS = [(3 * 9216, 5, 25), (3 * 2304, 10, 25), (3 * 576, 20, 25),
          (3 * 144, 20, 25)]
FRAMES = [(257, h, s) for h in (5, 10, 20) for s in (1, 2, 7, 16, 32)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _projections(dev, rows, h, s, width=None, offset=0, seed=0):
    """q, k, v as the UNet's ``split`` makes them: (rows, H, S, 64) views
    of (rows, S, width) bf16 tensors, the heads at column ``offset``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = h * 64 if width is None else width
    out = []
    for _ in range(3):
        proj = torch.randn((rows, s, width), generator=g, device=dev)
        proj = proj.to(torch.bfloat16)[..., offset:offset + h * 64]
        out.append(proj.unflatten(-1, (h, 64)).transpose(1, 2))
    return out


def _assert_close(got, want):
    d = got.float() - want.float()
    max_abs = d.abs().max().item()
    rel_rms = (d.pow(2).mean().sqrt()
               / want.float().pow(2).mean().sqrt()).item()
    assert max_abs <= TOL[0] and rel_rms <= TOL[1], (max_abs, rel_rms)


@pytest.mark.parametrize("layout", ["projection", "contiguous"])
@pytest.mark.parametrize("rows, h, s", LEVELS + FRAMES)
def test_kernel_matches_packed_path(dev, rows, h, s, layout):
    q, k, v = _projections(dev, rows, h, s, seed=rows + h + s)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = counters["launches.frame_attn"]
    got = A.frame_attention(q, k, v, SCALE)
    want = A.attention_packed_heads(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert counters["launches.frame_attn"] == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("h", [2, 3])
def test_tensor_parallel_head_shard(dev, h):
    """A shard's heads: its own (rows, S, h 64) projection, and the same
    heads read out of the whole layer's (rows, S, 5 x 64) projection (row
    stride 5 x 64, the heads at an offset)."""
    for width, offset in ((None, 0), (5 * 64, 64)):
        q, k, v = _projections(dev, 1000, h, 25, width, offset, seed=h)
        _assert_close(A.frame_attention(q, k, v, SCALE),
                      A.attention_packed_heads(q, k, v, SCALE))


def test_fused_qkv_row_stride(dev):
    """q, k and v read out of one (rows, S, 3 C) tensor: a row stride of
    3 C, each view at its own column offset, read in place."""
    rows, h, s = 2000, 10, 25
    c = h * 64
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn((rows, s, 3 * c), generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c].unflatten(-1, (h, 64))
               .transpose(1, 2) for i in range(3))
    for t in (q, k, v):
        assert A.mapped(t, A.FRAME_ROWS)[0] is t
    _assert_close(A.frame_attention(q, k, v, SCALE),
                  A.attention_packed_heads(q, k, v, SCALE))


def test_output_merges_heads_without_a_copy(dev):
    rows, h, s = 432, 20, 25
    q, k, v = _projections(dev, rows, h, s)
    out = A.frame_attention(q, k, v, SCALE)
    assert out.transpose(1, 2).is_contiguous()
    merged = out.transpose(1, 2).reshape(rows, s, -1)
    assert merged.data_ptr() == out.data_ptr() and merged._is_view()


def test_deterministic(dev):
    q, k, v = _projections(dev, 3 * 2304, 10, 25, seed=3)
    a = A.frame_attention(q, k, v, SCALE)
    b = A.frame_attention(q, k, v, SCALE)
    assert torch.equal(a, b)


def test_dispatch(dev):
    """The short path of ``attention`` launches the kernel on CUDA tensors
    with heads of 64 and no gradient taken; with inputs that require grad
    under grad it takes the packed version under autograd; other head
    sizes take the packed version."""
    q, k, v = _projections(dev, 500, 5, 25, seed=4)
    n = counters["launches.frame_attn"]
    with torch.no_grad():
        got = A.attention(q, k, v, SCALE)
    assert counters["launches.frame_attn"] == n + 1
    assert torch.equal(got, A.frame_attention(q, k, v, SCALE))
    n = counters["launches.frame_attn"]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = A.attention(*leaves, SCALE)
    assert counters["launches.frame_attn"] == n
    assert out.requires_grad
    out.float().sum().backward()
    assert all(t.grad is not None for t in leaves)
    with torch.no_grad():
        A.attention(*leaves, SCALE)
    assert counters["launches.frame_attn"] == n + 1
    q32 = torch.zeros((4, 2, 25, 32), dtype=torch.bfloat16, device=dev)
    A.attention(q32, q32, q32, SCALE)
    assert counters["launches.frame_attn"] == n + 1


def test_refusals(dev):
    q, k, v = _projections(dev, 8, 2, 25)
    with pytest.raises(TypeError, match="bfloat16"):
        A.frame_attention(q.float(), k.float(), v.float(), SCALE)
    short = torch.zeros((8, 2, 25, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="d = 64"):
        A.frame_attention(short, short, short, SCALE)
    long = torch.zeros((8, 2, 33, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="S <= 32"):
        A.frame_attention(long, long, long, SCALE)
