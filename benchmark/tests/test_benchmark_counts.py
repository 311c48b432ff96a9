"""counts/: the bounds of PERF.md's kernel table at the batch-3 post
shapes, the batch-2 prob shapes by the same functions, and the census's
operations against torch's own count of the reference at a tiny size."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from counts.unet import (census, flash_bound_s, geglu_bound_s,
                         group_norm_bound_s, layer_norm_bound_s)
from harness import common
from harness.kind_denoise import counted
from harness.weights import seeded_weights
from reference.svd_unet import RefUNet, unet_param_shapes

UNET = json.loads((common.BENCH_DIR / "configs"
                   / "svd_xt_post_llff.json").read_text())["unet"]


def test_batch3_bounds_are_perf_md_kernel_table():
    c = census(UNET, 3, 25, 72, 128)
    assert len(c.geglu) == 48 and len(c.flash) == 15
    assert len(c.layer_norm) == 112 and len(c.group_norm) == 105
    assert geglu_bound_s(c.geglu) * 1e3 == pytest.approx(78.58, abs=0.005)
    assert flash_bound_s(c.flash) * 1e3 == pytest.approx(47.04, abs=0.005)
    assert layer_norm_bound_s(c.layer_norm) * 1e3 == pytest.approx(
        16.29, abs=0.005)
    assert group_norm_bound_s(c.group_norm) * 1e3 == pytest.approx(
        13.93, abs=0.005)


def test_batch2_by_the_same_functions():
    c3, c2 = census(UNET, 3, 25, 72, 128), census(UNET, 2, 25, 72, 128)
    assert [r * 3 for r, _ in c2.geglu] == [r * 2 for r, _ in c3.geglu]
    assert [bh * 3 for bh, _ in c2.flash] == [bh * 2 for bh, _ in c3.flash]
    assert geglu_bound_s(c2.geglu) / geglu_bound_s(c3.geglu) == \
        pytest.approx(2 / 3, rel=1e-3)
    assert c2.flops / c3.flops == pytest.approx(2 / 3, rel=1e-3)
    assert 230e12 < c3.flops < 233e12


def test_census_flops_against_torch_count_of_the_reference():
    """torch counts every product of the reference, whose one-token
    cross-attentions also project the queries and the key, take scores and
    probabilities against the token and apply to_out to every query row
    (the census counts to_v and to_out of the token alone: softmax over
    one key is 1); add that and the two agree."""
    ucfg = dict(UNET, block_out_channels=[32, 64, 64, 64],
                num_attention_heads=[1, 2, 2, 2],
                addition_time_embed_dim=16, cross_attention_dim=24,
                projection_class_embeddings_input_dim=48)
    b, f, h, w = 2, 3, 16, 24
    n, ctx = b * f, 24
    params = seeded_weights(unet_param_shapes(ucfg), 0, "cpu",
                            torch.float32)
    unet = RefUNet(params, ucfg)
    x = torch.randn(b, f, 8, h, w)
    with FlopCounterMode(display=False) as counter:
        unet(x, torch.tensor(0.3), torch.randn(b, 1, ctx),
             torch.ones(b, 3))
    c = census(ucfg, b, f, h, w)
    extra = 0
    # (channels, tokens, transformers) a level: 2 down + 3 up; 1 mid
    for ch, s, n_tf in ((32, 384, 5), (64, 96, 5), (64, 24, 5),
                        (64, 6, 1)):
        spatial = n * s * ch * ch + n * ctx * ch + 2 * n * s * ch \
            + n * (s - 1) * ch * ch
        temporal = n * s * ch * ch + b * s * ctx * ch + 2 * n * s * ch \
            + (n * s - b * s) * ch * ch
        extra += 2 * n_tf * (spatial + temporal)
    assert counter.get_total_flops() == pytest.approx(c.flops + extra,
                                                      rel=1e-9)


def test_counts_follow_the_logged_forward_shapes():
    """A post step logs two batch-3 forwards, a prob step two of batch 2:
    the counts are those of the census at each logged shape."""
    post = [[(3, 25, 72, 128, 8), 0.5, None, None]] * 2
    prob = [[(2, 25, 72, 128, 8), 0.5, None, None]] * 2
    c3, c2 = census(UNET, 3, 25, 72, 128), census(UNET, 2, 25, 72, 128)
    for entries, c in ((post, c3), (prob, c2)):
        got = counted(UNET, entries)
        assert got["flops"] == pytest.approx(2 * c.flops)
        assert got["geglu"] == pytest.approx(2 * geglu_bound_s(c.geglu))
        assert got["flash"] == pytest.approx(2 * flash_bound_s(c.flash))
        assert got["norm"] == pytest.approx(2 * (
            layer_norm_bound_s(c.layer_norm)
            + group_norm_bound_s(c.group_norm)))
    mixed = counted(UNET, post[:1] + prob[:1])
    assert mixed["flops"] == pytest.approx(c3.flops + c2.flops)
