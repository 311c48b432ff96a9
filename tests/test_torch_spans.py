"""The port's spans (``utils.profiling.span``) on the CPU: a tiny SVD UNet
of SVD-XT's depth (four levels, two layers a block) and a tiny guided
denoise, post and prob, run under ``torch.profiler``.

Checked: each span of the denoise step and of the UNet appears, a forward
has SVD-XT's 22 resnets, 16 transformers, 6 samplers and 12 skips and a
``unet.frame_attention`` span for each call of the short attention path, spans
nest, every aten op of a forward lies under exactly one of the forward's
block spans, no span is a user annotation (which would add an event to a
card's timeline), outputs are bit for bit those of a run without the
profiler, and with no profiler recording a span records nothing. The
direction-parallel denoise and the sequence-parallel forward run under the
profiler with the same outputs.
"""
import torch_threads  # noqa: F401  (torch's threads under xdist)

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                GuidedSVDPipeline, SVDModels,
                                                init_random_weights_)
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.parallel import mesh as TM
from syn3r_tpu_torch.parallel.sequence_parallel import make_sp_unet_forward
from syn3r_tpu_torch.utils import profiling

F, LH, LW, CLIP = 3, 8, 16, 32
STEPS = 2
UNET_KW = dict(block_out_channels=(32, 64, 64, 64),
               num_attention_heads=(1, 2, 2, 2), addition_time_embed_dim=16,
               cross_attention_dim=CLIP)
# the forward's block spans: each aten op of a forward is under one
BLOCKS = ("unet.embed", "unet.resnet", "unet.transformer", "unet.sample",
          "unet.skip", "unet.out")
PER_FORWARD = {"unet.embed": 1, "unet.resnet": 22, "unet.resnet.spatial": 22,
               "unet.resnet.temporal": 22, "unet.transformer": 16,
               "unet.transformer.spatial": 16,
               "unet.transformer.temporal": 16, "unet.sample": 6,
               "unet.skip": 12, "unet.out": 1,
               # the short attention path (S <= 32, more than one head):
               # the temporal self-attention of the 11 transformers with 2
               # heads, and at these tiny latents their spatial one too
               # (8x16 pixels: 32 tokens at the second level, fewer below)
               "unet.frame_attention": 22}
PARENT = {"unet.resnet.spatial": "unet.resnet",
          "unet.resnet.temporal": "unet.resnet",
          "unet.transformer.spatial": "unet.transformer",
          "unet.transformer.temporal": "unet.transformer",
          "denoise.step": "denoise.call"}


@pytest.fixture(scope="module")
def unet():
    u = UNetSpatioTemporalConditionModel(**UNET_KW)
    init_random_weights_(u, torch.Generator().manual_seed(0))
    return u.eval()


def _forward_args(b=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, F, LH, LW, 8), generator=g), 0.7,
            torch.randn((b, 1, CLIP), generator=g),
            torch.tensor([[6.0, 127.0, 0.02]] * b))


def _denoise_args(seed=2):
    g = torch.Generator().manual_seed(seed)
    clip = [torch.cat([torch.zeros((1, 1, CLIP)),
                       torch.randn((1, 1, CLIP), generator=g)])
            for _ in "se"]
    return (torch.randn((1, F, LH, LW, 4), generator=g), *clip,
            torch.rand((F, LH, LW, 4), generator=g) * 2 - 1,
            torch.rand((F - 2, LH, LW), generator=g),
            (torch.rand((STEPS, F), generator=g) > 0.4).float())


def _traced(fn):
    """fn() under the profiler and without it: (traced output, untraced
    output, the trace's events)."""
    with torch.no_grad():
        plain = fn()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = fn()
    return traced, plain, list(prof.events())


def _spans(events):
    return [e for e in events if e.name.startswith(("unet.", "denoise."))]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p)
        p = p.cpu_parent
    return out


def _counts(events) -> dict:
    out = {}
    for e in _spans(events):
        out[e.name] = out.get(e.name, 0) + 1
    return out


def _assert_sound_spans(events):
    """Spans nest in time under their parents, children under the span
    the table names, and none is a user annotation."""
    for e in _spans(events):
        assert not e.is_user_annotation, e.name
        p = e.cpu_parent
        if p is not None:
            assert (p.time_range.start <= e.time_range.start
                    and e.time_range.end <= p.time_range.end), e.name
        if e.name in PARENT:
            assert p is not None and p.name == PARENT[e.name], e.name
        if e.name in BLOCKS:
            assert p is not None and p.name == "unet.forward", e.name


def _assert_forward_ops_in_blocks(events):
    """Every aten op inside a forward lies under exactly one block
    span."""
    ops = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        names = [a.name for a in _ancestors(e)]
        if "unet.forward" in names:
            assert sum(n in BLOCKS for n in names) == 1, (e.name, names)
            ops += 1
    assert ops > 0


def test_unet_forward_spans(unet):
    traced, plain, events = _traced(lambda: unet(*_forward_args()))
    assert torch.equal(traced, plain)
    counts = _counts(events)
    assert counts.pop("unet.forward") == 1
    assert counts == PER_FORWARD
    _assert_sound_spans(events)
    _assert_forward_ops_in_blocks(events)


@pytest.mark.parametrize("variant, unets_a_step, guidance", [
    ("post", 2, 2), ("prob", 2, 0)])
def test_denoise_spans(unet, variant, unets_a_step, guidance):
    pipe = GuidedSVDPipeline(SVDModels(unet=unet, vae=None, clip=None),
                             GuidedSVDConfig(num_inference_steps=STEPS,
                                             num_frames=F, variant=variant,
                                             compute_dtype=torch.float32))
    args = _denoise_args()
    traced, plain, events = _traced(lambda: pipe.denoise(*args))
    assert torch.equal(traced, plain)
    counts = _counts(events)
    forwards = STEPS * unets_a_step
    assert counts["unet.forward"] == counts["denoise.unet"] == forwards
    assert {k: counts[k] for k in PER_FORWARD} == {
        k: n * forwards for k, n in PER_FORWARD.items()}
    assert counts["denoise.call"] == 1
    assert counts["denoise.step"] == counts["denoise.merge"] == STEPS
    assert counts["denoise.update"] == 2 * STEPS
    assert counts.get("denoise.guidance", 0) == guidance * STEPS
    _assert_sound_spans(events)
    _assert_forward_ops_in_blocks(events)
    for e in _spans(events):
        if e.name == "unet.forward":
            assert e.cpu_parent.name == "denoise.unet"
        elif e.name.startswith("denoise.") and e.name not in (
                "denoise.call", "denoise.step"):
            assert "denoise.step" in [a.name for a in _ancestors(e)], e.name


def test_direction_parallel_spans(unet):
    """Both directions of a step in one forward: one denoise.unet a step,
    the same latents as without the profiler."""
    pipe = GuidedSVDPipeline(SVDModels(unet=unet, vae=None, clip=None),
                             GuidedSVDConfig(num_inference_steps=STEPS,
                                             num_frames=F,
                                             direction_parallel=True,
                                             compute_dtype=torch.float32))
    args = _denoise_args(seed=3)
    traced, plain, events = _traced(lambda: pipe.denoise(*args))
    assert torch.equal(traced, plain)
    counts = _counts(events)
    assert counts["denoise.unet"] == counts["unet.forward"] == STEPS
    assert counts["unet.resnet"] == 22 * STEPS
    _assert_sound_spans(events)


def test_sequence_parallel_forward_under_the_profiler(unet):
    """The frame-sharded forward's shards run their generators in
    lock-step, so their spans overlap; it runs under the profiler with
    the outputs it gives without one."""
    run = make_sp_unet_forward(TM.make_mesh(2, "seq", devices=["cpu"] * 2),
                               unet)
    args = _forward_args(b=1, seed=4)
    traced, plain, events = _traced(lambda: run(*args))
    assert torch.equal(traced, plain)
    counts = _counts(events)
    assert counts["unet.forward"] == 2
    assert counts["unet.resnet"] == 2 * 22


def test_span_off_the_profiler_records_nothing(unet, monkeypatch):
    made = []

    def fast(name, *a):
        made.append(name)
        return profiling.contextlib.nullcontext()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    with torch.no_grad():
        unet(*_forward_args(b=1))
    assert made == []
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("unet.forward"):
            pass
    assert made == ["unet.forward"]


def test_phase_timer_phases_are_spans():
    timer = profiling.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("refine"):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.events() if e.name == "refine"]
    assert not ev.is_user_annotation
    assert [c.name for c in ev.cpu_children] == ["aten::ones", "aten::sum"]
    assert timer.counts["refine"] == 1
