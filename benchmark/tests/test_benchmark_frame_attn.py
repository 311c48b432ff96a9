"""The reader of ``denoise.frame_attn_ms`` on the synthetic trace of
``test_benchmark_spans.py``, with a ``unet.frame_attention`` span inside
each forward's temporal transformer: the frame-attention kernel's time per
forward; None for a program without the span; 0 without a card."""

import pytest

from harness import common, spans
from test_benchmark_spans import FakeProfile, call_trace

METRIC = "denoise.frame_attn_ms"
KERNEL = "frame_attention_kernel"


def frame_trace(device=True):
    """call_trace with, in each forward's ``unet.transformer.temporal``,
    a ``unet.frame_attention`` span that launched the kernel (8 us)."""
    tr = call_trace(device)
    for tt in [e for e in tr.events
               if e.name == "unet.transformer.temporal"]:
        t = tt.time_range.start
        tr.host("unet.frame_attention", t + 2, t + 3, tt, [(KERNEL, 8)])
    return tr.events


def read(events):
    return common.load_reader(METRIC)(
        {"kind": "denoise", "profile": FakeProfile(events)})


def test_kernel_time_per_forward():
    assert read(frame_trace()) == pytest.approx(8 / 1e3)
    s = spans.Spans(frame_trace())
    # under the temporal transformer's span, and no family of its own yet
    assert s.under("unet.transformer.temporal", {spans.ELEMENTWISE}) \
        == 2 * 8
    assert spans.family(KERNEL) == spans.ELEMENTWISE


def test_no_span_reads_none_no_device_time_reads_zero():
    assert read(call_trace().events) is None
    cpu = frame_trace(device=False)
    for e in cpu:
        e.kernels = []
    assert read(cpu) == 0.0
