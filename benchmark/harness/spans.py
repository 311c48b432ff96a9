"""The program's spans in a traced call: kernel time by span and kernel
family, and the device's idle time by the host span open at its start.

The port marks its layers with spans (``syn3r_tpu_torch.utils.profiling
.span``): host ops named ``denoise.*`` and ``unet.*`` in the profiler's
session, on the device trace's clock, with no event of their own on the
device. The profiler links each kernel, memory copy and memset to the
innermost host op open when its launch call ran (by the launch's
correlation id: the op's ``kernels``), ops of the ctypes entry points
that launch the hand-written kernels included, where that innermost op
is a span itself. The profiler also hands an op's kernels to the marker
events it records inside the op under the op's id ("Command Buffer Full",
"Activity Buffer Request", ...): each id's kernels count once, from its
longest event, the op. ``Spans`` puts each kernel's device time under
that op's chain of enclosing spans, innermost first, and under its family
by name.
A checkout whose program has no spans reads no span instances, and every
reader that divides by them returns None.
"""

from __future__ import annotations

import bisect
import collections
import weakref

# the program's span names start so
PREFIXES = ("denoise.", "unet.")
# kernel families by name fragment, tested in this order: the hand-written
# kernels, cuDNN convolutions (before the GEMMs: their implicit-GEMM names
# hold "gemm" too), float32 GEMMs, the other GEMMs (cuBLAS on the H100
# names most of them nvjet_*); the rest is "elementwise" (elementwise,
# reduction, softmax, copy, memset and layout work)
FAMILIES = (
    ("flash", ("flash_wgmma_kernel", "flash_bwd_")),
    ("geglu", ("ffn_wgmma_kernel",)),
    ("norm", ("gn_stats_kernel", "gn_apply_kernel", "layer_norm_kernel")),
    ("conv", ("fprop", "conv")),
    ("gemm_f32", ("f32f32_f32f32", "sgemm")),
    ("gemm", ("gemm", "cutlass", "nvjet", "cublas")),
)
ELEMENTWISE = "elementwise"

_READ = weakref.WeakKeyDictionary()


def family(name: str) -> str:
    """The family of a kernel by its name (``FAMILIES``)."""
    for fam, fragments in FAMILIES:
        if any(f in name for f in fragments):
            return fam
    return ELEMENTWISE


def _is_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _chain(ev) -> tuple:
    """The names of the spans enclosing host op ``ev`` (itself where it is
    one), innermost first."""
    out = []
    while ev is not None:
        if _is_span(ev.name):
            out.append(ev.name)
        ev = ev.cpu_parent
    return tuple(out)


def _length(ev) -> float:
    return ev.time_range.end - ev.time_range.start


def _inside(intervals, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t < intervals[i][1]


class Spans:
    """One traced call's spans, from the profiler's events (FunctionEvent
    or anything with ``id``, ``name``, ``device_type``, ``time_range``,
    ``cpu_parent`` and ``kernels``; times in microseconds).

    - ``counts``: span name -> instances;
    - ``kernel_us``: (chain of enclosing spans, innermost first; family)
      -> device microseconds of the kernels launched there (chain () for
      those launched outside every span);
    - ``device_us``: every device operation's time;
    - ``idle_us``: the device's idle gaps by the host at their start:
      "forward" (inside a ``unet.forward``), "pipeline" (inside
      ``denoise.call``, outside every ``unet.forward``) and "outside"."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        self.counts = collections.Counter()
        self.kernel_us = collections.Counter()
        self.device_us = 0.0
        device, host = [], {"denoise.call": [], "unet.forward": []}
        linked = {}             # op id -> its longest event with kernels
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                device.append((ev.time_range.start, ev.time_range.end))
                self.device_us += ev.time_range.end - ev.time_range.start
                continue
            if _is_span(ev.name):
                self.counts[ev.name] += 1
                if ev.name in host:
                    host[ev.name].append((ev.time_range.start,
                                          ev.time_range.end))
            if ev.kernels:
                held = linked.get(ev.id)
                if held is None or _length(ev) > _length(held):
                    linked[ev.id] = ev
        for ev in linked.values():
            chain = _chain(ev)
            for k in ev.kernels:
                self.kernel_us[chain, family(k.name)] += k.duration
        for v in host.values():
            v.sort()
        self.idle_us = collections.Counter(forward=0.0, pipeline=0.0,
                                           outside=0.0)
        for start, length in _gaps(device):
            if _inside(host["unet.forward"], start):
                self.idle_us["forward"] += length
            elif _inside(host["denoise.call"], start):
                self.idle_us["pipeline"] += length
            else:
                self.idle_us["outside"] += length

    def under(self, name: str, families=None, without=None) -> float:
        """Device microseconds of the kernels launched inside span
        ``name`` (and outside span ``without``), of ``families`` (all
        where None)."""
        return sum(us for (chain, fam), us in self.kernel_us.items()
                   if name in chain and (without is None
                                         or without not in chain)
                   and (families is None or fam in families))

    def per(self, us: float, span: str):
        """``us`` in milliseconds per instance of span ``span``; None
        where the call has none."""
        n = self.counts[span]
        return us / n / 1e3 if n else None


def _gaps(intervals):
    """(start, length) of each stretch in which none of the device
    operations ``intervals`` ran, between the first start and the last
    end."""
    out, end = [], None
    for s, t in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s - end))
        end = t if end is None else max(end, t)
    return out


def of(profile) -> Spans:
    """The ``Spans`` of a read ``harness.common.Profile`` (computed once a
    profile)."""
    spans = _READ.get(profile)
    if spans is None:
        spans = _READ[profile] = Spans(profile.prof.events())
    return spans
