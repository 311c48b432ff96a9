"""LPIPS perceptual metric and loss, VGG variant.

Counterpart of ``syn3r_tpu/models/lpips.py``: VGG16 features after
relu1_2/2_2/3_3/4_3/5_3, each unit-normalized over its channels, squared
differences, learned 1x1 convolutions without bias, a spatial mean and a
sum over the five layers. It is the eval metric of ``cli/metrics.py`` and
the refine loss of ``GSTrainer.set_lpips`` (``--lpips_weights``).

The state-dict names are those of the ``lpips`` package's
``LPIPS(net='vgg')`` (``scaling_layer.shift``, ``net.sliceK.IDX.weight``,
``linK.model.1.weight``), so such a state dict loads as it is; the JAX
package's converted ``.npz`` goes through
``models.convert.lpips_state_from_flax`` (``load_lpips_fn``), and
``convert_lpips_torch`` writes that tree from an ``lpips`` state dict. The module
computes in float32, as the JAX module declares; its convolutions are
cuDNN's, in full float32 once ``device.resolve_device`` has turned TF32
off.

Spans (``utils.profiling.span``): ``lpips.forward`` around a distance's
forward (the gradient path's and the no-grad path's), ``lpips.backward``
around the gradient path's backward; the counter ``lpips.calls`` counts
the calls that take a gradient (a captured train step's share is added on
each replay, ``gs/step_graph.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..utils.profiling import counters, span

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
# indices of torchvision's vgg16().features at which the lpips package
# cuts its five slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_SLICE_STARTS = (0, 4, 9, 16, 23, 30)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_CHANNELS = (64, 128, 256, 512, 512)


def _vgg_layers() -> list[nn.Module]:
    """torchvision's vgg16().features up to relu5_3 (30 modules)."""
    layers, c_in = [], 3
    for c in _VGG_CFG:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, c, 3, padding=1), nn.ReLU()]
            c_in = c
    return layers


def vgg_conv_keys() -> list[str]:
    """State-dict prefixes (``net.sliceK.IDX``) of the 13 convolutions in
    order, the JAX module's ``conv_0`` .. ``conv_12``."""
    keys = []
    for idx, layer in enumerate(_vgg_layers()):
        if isinstance(layer, nn.Conv2d):
            k = sum(idx >= s for s in _SLICE_STARTS[1:]) + 1
            keys.append(f"net.slice{k}.{idx}")
    return keys


def convert_lpips_torch(state_dict) -> dict:
    """An ``lpips.LPIPS(net='vgg')`` state dict (numpy arrays or tensors)
    -> the JAX package's flax tree (``net/conv_i/{kernel,bias}`` in HWIO,
    ``lin_i/kernel``), as its ``convert_lpips_torch``."""
    import numpy as np
    out = {"net": {}}
    for i, key in enumerate(vgg_conv_keys()):
        out["net"][f"conv_{i}"] = {
            "kernel": np.asarray(state_dict[f"{key}.weight"]).transpose(
                2, 3, 1, 0).astype(np.float32),
            "bias": np.asarray(state_dict[f"{key}.bias"]).astype(np.float32)}
    for i in range(len(_CHANNELS)):
        w = np.asarray(state_dict[f"lin{i}.model.1.weight"])
        out[f"lin_{i}"] = {"kernel": w.transpose(2, 3, 1, 0).astype(
            np.float32)}
    return out


class VGG16Features(nn.Module):
    """The five slices; ``forward`` returns the feature map after each."""

    def __init__(self):
        super().__init__()
        layers = _vgg_layers()
        for k in range(5):
            s = nn.Sequential()
            for idx in range(_SLICE_STARTS[k], _SLICE_STARTS[k + 1]):
                s.add_module(str(idx), layers[idx])
            self.add_module(f"slice{k + 1}", s)

    def forward(self, x):
        feats = []
        for k in range(5):
            x = getattr(self, f"slice{k + 1}")(x)
            feats.append(x)
        return feats


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                            None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                            None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class _NetLinLayer(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        # index 0 is the lpips package's dropout, identity at eval
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(c_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = VGG16Features()
        for i, c in enumerate(_CHANNELS):
            self.add_module(f"lin{i}", _NetLinLayer(c))

    def forward(self, a, b):
        """a, b: (H, W, 3) or (B, H, W, 3) in [0, 1]. Returns a scalar or
        (B,). Where a gradient is taken, ``distance`` and its backward run
        under cuDNN's deterministic algorithms (``_Deterministic``): cuDNN's
        default input-gradient algorithms for these convolutions are not
        deterministic, and a CUDA-graph replay of a train step must agree
        with the same step run eagerly bit for bit."""
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            counters["lpips.calls"] += 1
            return _Deterministic.apply(self, a, b)
        with span("lpips.forward"):
            return self.distance(a, b)

    def distance(self, a, b):
        """LPIPS(a, b) with cuDNN's default algorithms."""
        if a.dim() == 3:
            a, b = a[None], b[None]

        def features(x):
            # two forwards, as JAX's: the target's takes no backward
            x = x.permute(0, 3, 1, 2).contiguous()
            return self.net(self.scaling_layer(x * 2.0 - 1.0))
        fa, fb = features(a), features(b)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            xa = xa / torch.sqrt((xa ** 2).sum(1, keepdim=True) + 1e-10)
            xb = xb / torch.sqrt((xb ** 2).sum(1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}")((xa - xb) ** 2)
            total = total + w.mean(dim=(2, 3))[:, 0]
        return total.squeeze()


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms inside the block only (free of
    atomics); the flag is restored after, so other modules' convolutions
    keep theirs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


class _Deterministic(torch.autograd.Function):
    """``module.distance(a, b)`` with its forward and its gradient issued
    inside ``deterministic_convs``: the forward keeps its own graph, and
    the backward differentiates that graph inside the block (cuDNN reads
    the flag when an operation is issued, so the block must hold the
    backward too)."""

    @staticmethod
    def forward(ctx, module, a, b):
        with torch.enable_grad(), deterministic_convs(), \
                span("lpips.forward"):
            xs = [t.detach().requires_grad_(t.requires_grad) for t in (a, b)]
            value = module.distance(*xs)
        ctx.graph = xs, value
        return value.detach()

    @staticmethod
    def backward(ctx, grad):
        xs, value = ctx.graph
        with deterministic_convs(), span("lpips.backward"):
            got = iter(torch.autograd.grad(
                value, [x for x in xs if x.requires_grad], grad))
        return (None,) + tuple(next(got) if x.requires_grad else None
                               for x in xs)


def lpips_module(params: dict, device) -> LPIPS:
    """An eval-mode LPIPS on ``device`` holding the JAX package's param
    tree ``params`` (``utils.params.load_params`` of its converted
    ``.npz``); its weights take no gradient."""
    from .convert import lpips_state_from_flax
    with torch.device(device):
        m = LPIPS()
    m.load_state_dict(lpips_state_from_flax(params))
    return m.eval().requires_grad_(False)


def load_lpips_fn(weights_path: str, device="cuda"):
    """lpips(a, b) on ``device`` from a converted ``.npz`` weights file;
    a and b are (H, W, 3) or (B, H, W, 3) in [0, 1], tensors or arrays."""
    from ..device import resolve_device
    from ..utils.params import load_params
    dev = resolve_device(device)
    model = lpips_module(load_params(weights_path), dev)

    @torch.no_grad()
    def fn(a, b):
        return model(torch.as_tensor(a, dtype=torch.float32, device=dev),
                     torch.as_tensor(b, dtype=torch.float32, device=dev))
    return fn
