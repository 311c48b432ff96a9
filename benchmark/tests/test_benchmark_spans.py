"""``harness/spans.py`` and the readers of the span metrics on a synthetic
trace: a call of two steps, a UNet forward each, with kernels linked to
aten ops and, as the ctypes entry points' are, to a span itself, markers
that repeat an op's kernels under its id, device operations with known
gaps, and one kernel launched outside every span."""

import types

import pytest
from torch.autograd import DeviceType

from harness import common, spans

SPAN_METRICS = ("denoise.resnet_ms", "denoise.transformer_ms",
                "denoise.elementwise_ms", "denoise.step_own_ms",
                "denoise.step_idle_ms")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
GEMM32 = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"
GEMM16 = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
ELEM = ("void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl<at::native::CUDAFunctor_add<c10::BFloat16>>>")


class Trace:
    """Host ops (name, start, end, parent, kernels) and device
    operations, as the profiler's events."""

    def __init__(self):
        self.events = []

    def host(self, name, start, end, parent=None, kernels=(), id=None):
        ev = types.SimpleNamespace(
            id=len(self.events) + 1 if id is None else id,
            name=name, device_type=DeviceType.CPU,
            time_range=types.SimpleNamespace(start=start, end=end),
            cpu_parent=parent,
            kernels=[types.SimpleNamespace(name=k, duration=us)
                     for k, us in kernels])
        self.events.append(ev)
        return ev

    def device(self, start, end, name="kernel"):
        self.events.append(types.SimpleNamespace(
            id=0, name=name, device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(start=start, end=end),
            cpu_parent=None, kernels=[]))

    def forward(self, t, parent):
        """A UNet forward from t to t + 100 under ``parent``: conv 5,
        elementwise 10 + 3 + 1, fp32 GEMM 20, bf16 GEMM 6 us, and flash 40
        and GEGLU 30 us linked to a span itself (ctypes launches)."""
        f = self.host("unet.forward", t, t + 100, parent)
        emb = self.host("unet.embed", t + 1, t + 10, f)
        self.host("aten::convolution", t + 2, t + 3, emb, [(CONV, 5)])
        res = self.host("unet.resnet", t + 10, t + 40, f)
        sp = self.host("unet.resnet.spatial", t + 11, t + 20, res)
        add = self.host("aten::add", t + 12, t + 13, sp, [(ELEM, 10)])
        # the profiler's markers inside an op hold its kernels again
        self.host("Command Buffer Full", t + 12.5, t + 12.5, add,
                  [(ELEM, 10)], id=add.id)
        tm = self.host("unet.resnet.temporal", t + 20, t + 30, res)
        self.host("aten::mm", t + 21, t + 22, tm, [(GEMM32, 20)])
        self.host("aten::mul", t + 31, t + 32, res, [(ELEM, 3)])
        tr = self.host("unet.transformer", t + 40, t + 90, f)
        self.host("unet.transformer.spatial", t + 41, t + 60, tr,
                  [("flash_wgmma_kernel", 40)])
        tt = self.host("unet.transformer.temporal", t + 60, t + 80, tr,
                       [("ffn_wgmma_kernel", 30)])
        self.host("aten::addmm", t + 61, t + 62, tt, [(GEMM16, 6)])
        skip = self.host("unet.skip", t + 90, t + 95, f)
        self.host("aten::cat", t + 91, t + 92, skip,
                  [("CatArrayBatchedCopy", 1)])
        return f


def call_trace(device=True) -> Trace:
    """denoise.call 0-1000: steps at 0 and 500, each a denoise.unet around
    a forward, a guidance (elementwise 7) and a merge (elementwise 2); a
    kernel of 4 us launched outside every span."""
    tr = Trace()
    call = tr.host("denoise.call", 0, 1000)
    for t in (0, 500):
        step = tr.host("denoise.step", t + 1, t + 400, call)
        unet = tr.host("denoise.unet", t + 5, t + 200, step)
        tr.host("aten::cat", t + 6, t + 7, unet, [(ELEM, 2)])
        tr.forward(t + 10, unet)
        g = tr.host("denoise.guidance", t + 200, t + 300, step)
        tr.host("aten::sub", t + 201, t + 202, g, [(ELEM, 7)])
        m = tr.host("denoise.merge", t + 300, t + 400, step)
        tr.host("aten::add", t + 301, t + 302, m, [(ELEM, 2)])
    tr.host("aten::zeros", 1100, 1101, None, [(ELEM, 4)])
    if device:
        # gaps: 45-50 (forward), 150-160 (pipeline), 600-620 (forward),
        # 900-1005 (pipeline), 1010-1020 (outside the call)
        for s, e in ((20, 45), (50, 150), (160, 600), (620, 900),
                     (1005, 1010), (1020, 1030)):
            tr.device(s, e)
    return tr


@pytest.mark.parametrize("name, fam", [
    (CONV, "conv"), ("cudnn::conv2d_grouped_direct_kernel", "conv"),
    (GEMM32, "gemm_f32"), (GEMM16, "gemm"),
    ("nvjet_tst_160x128_64x5_1x2_h_bz_TNN", "gemm"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16>", "elementwise"),
    ("cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64", "gemm"),
    (ELEM, "elementwise"), ("elementwise_kernel_128", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "elementwise"),
    ("flash_wgmma_kernel", "flash"), ("flash_bwd_dq_kernel", "flash"),
    ("ffn_wgmma_kernel", "geglu"), ("gn_stats_kernel", "norm"),
    ("gn_apply_kernel", "norm"), ("layer_norm_kernel", "norm")])
def test_kernel_families(name, fam):
    assert spans.family(name) == fam


def test_kernel_time_by_span():
    s = spans.Spans(call_trace().events)
    assert s.counts["unet.forward"] == 2 and s.counts["denoise.step"] == 2
    # a span holds its children's kernels: the resnet's self time is its
    # time less its two children's
    assert s.under("unet.resnet") == 2 * (10 + 20 + 3)
    assert (s.under("unet.resnet") - s.under("unet.resnet.spatial")
            - s.under("unet.resnet.temporal")) == 2 * 3
    assert s.under("unet.resnet.temporal", {"gemm_f32"}) == 2 * 20
    assert s.under("unet.transformer") == 2 * (40 + 6 + 30)
    assert s.under("unet.transformer", {"flash"}) == 2 * 40
    assert s.under("unet.transformer.temporal", {"gemm", "geglu"}) == 72
    assert s.kernel_us[(), "elementwise"] == 4
    assert s.under("unet.forward") == 2 * (5 + 33 + 76 + 1)
    assert s.under("denoise.step", without="denoise.unet") == 2 * (7 + 2)
    assert sum(s.kernel_us.values()) == 2 * (2 + 115 + 9) + 4


def test_gaps_by_host_span():
    s = spans.Spans(call_trace().events)
    assert s.idle_us == {"forward": 5 + 20, "pipeline": 10 + 105,
                         "outside": 10}
    assert s.device_us == 25 + 100 + 440 + 280 + 5 + 10


class FakeProfile:
    def __init__(self, events):
        self.prof = types.SimpleNamespace(events=lambda: events)


def read_all(events) -> dict:
    ctx = {"kind": "denoise", "profile": FakeProfile(events)}
    return {m: common.load_reader(m)(ctx) for m in SPAN_METRICS}


def test_readers_divide_by_forwards_and_steps():
    got = read_all(call_trace().events)
    assert got == pytest.approx({
        "denoise.resnet_ms": 33 / 1e3, "denoise.transformer_ms": 76 / 1e3,
        "denoise.elementwise_ms": (10 + 3 + 1) / 1e3,
        "denoise.step_own_ms": 9 / 1e3,
        "denoise.step_idle_ms": 115 / 2 / 1e3})


def test_no_spans_read_none_no_device_time_reads_zero():
    """A program without spans (a parent checkout) gives the readers
    nothing; a run without a card (a tiny CPU run) has spans and no
    device time."""
    bare = [e for e in call_trace().events
            if not spans._is_span(e.name)]
    assert set(read_all(bare).values()) == {None}
    cpu = call_trace(device=False).events
    for e in cpu:
        e.kernels = []
    assert set(read_all(cpu).values()) == {0.0}


def test_profile_read_once():
    prof = FakeProfile(call_trace().events)
    assert spans.of(prof) is spans.of(prof)
