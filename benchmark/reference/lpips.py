"""Plain float32 LPIPS with VGG-16, the GS refine's perceptual loss term.

LPIPS version 0.1 with ``net='vgg'`` (Zhang et al., "The Unreasonable
Effectiveness of Deep Features as a Perceptual Metric", CVPR 2018;
https://github.com/richzhang/PerceptualSimilarity, the ``lpips`` package
0.1.4), written from that description. Nothing here imports the program
under test. An image is (H, W, 3) in [0, 1], mapped to [-1, 1] (the
package's ``normalize=True``), then:

  - the scaling layer: (x - shift) / scale by channel;
  - VGG-16's ``features`` up to relu5_3: conv1_1 to conv5_3, 3x3 with
    padding 1 and bias, each followed by a ReLU, a 2x2 max-pool of stride
    2 (floor) before conv2_1, conv3_1, conv4_1 and conv5_1; taps at relu1_2,
    relu2_2, relu3_3, relu4_3 and relu5_3;
  - each tap unit-normalised over its channels, the squared difference of
    the two images' taps, a 1x1 ``lin`` convolution without bias to one
    channel (the package's dropout before it is the identity at eval), the
    spatial mean; the distance is the sum over the five taps.

The weights are a state dict under the package's names: the convolutions
``net.slice{k}.{i}.weight`` (out, in, 3, 3) and ``.bias``, ``i`` the
layer's index in torchvision's ``vgg16().features`` and ``k`` the slice
that holds it (slices cut at 4, 9, 16 and 23), and ``lin{t}.model.1.weight``
(1, C, 1, 1) of tap ``t``. The scaling layer's shift and scale are the
package's constants, not read from the state dict.

Departure from the published package, the one the port and the JAX
package share: a tap is divided by sqrt(sum of squares + 1e-10), eps inside
the square root, where the package divides by sqrt(sum of squares) + 1e-10.
The two differ by about 1e-10 over a tap's norm.

Every convolution's operands go through the caller's ``Precision`` (see
``reference/gs.py``), so its TF32 control reaches this term too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
EPS = 1e-10
# torchvision's vgg16 configuration up to conv5_3: output channels of each
# 3x3 convolution (each followed by a ReLU), "M" a 2x2 max-pool
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512)
# where the package cuts ``features`` into its five slices; each slice
# ends at a tap
SLICE_STARTS = (0, 4, 9, 16, 23, 30)
TAP_CHANNELS = (64, 128, 256, 512, 512)


def layers() -> list:
    """``features`` up to relu5_3 as (index, kind, in, out): kind "conv"
    (a ReLU follows at index + 1) or "pool"."""
    out, idx, c_in = [], 0, 3
    for c in VGG16:
        if c == "M":
            out.append((idx, "pool", c_in, c_in))
            idx += 1
        else:
            out.append((idx, "conv", c_in, c))
            idx += 2
            c_in = c
    return out


def conv_key(idx: int) -> str:
    """The state-dict prefix of the convolution at ``features[idx]``."""
    k = sum(idx >= s for s in SLICE_STARTS[1:]) + 1
    return f"net.slice{k}.{idx}"


def shapes() -> dict:
    """{name: shape} of the state dict ``distance`` reads."""
    out = {}
    for idx, kind, c_in, c_out in layers():
        if kind == "conv":
            out[f"{conv_key(idx)}.weight"] = (c_out, c_in, 3, 3)
            out[f"{conv_key(idx)}.bias"] = (c_out,)
    for t, c in enumerate(TAP_CHANNELS):
        out[f"lin{t}.model.1.weight"] = (1, c, 1, 1)
    return out


def taps(weights: dict, x: torch.Tensor, prec) -> list:
    """The five taps (B, C, h, w) of scaled images ``x`` (B, 3, H, W)."""
    out = []
    for idx, kind, _, _ in layers():
        if kind == "pool":
            x = F.max_pool2d(x, 2, 2)
            continue
        key = conv_key(idx)
        x = torch.relu(F.conv2d(prec(x), prec(weights[f"{key}.weight"]),
                                weights[f"{key}.bias"], padding=1))
        if idx + 2 in SLICE_STARTS[1:]:          # relu{k}_{last}
            out.append(x)
    return out


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(1, keepdim=True) + EPS)


def features(weights: dict, img: torch.Tensor, prec) -> list:
    """The unit-normalised taps of one image (H, W, 3) in [0, 1]."""
    shift = img.new_tensor(SHIFT).view(1, 3, 1, 1)
    scale = img.new_tensor(SCALE).view(1, 3, 1, 1)
    x = (img.permute(2, 0, 1)[None] * 2.0 - 1.0 - shift) / scale
    return [unit(t) for t in taps(weights, x, prec)]


def tap_distances(weights: dict, a: torch.Tensor, b: torch.Tensor,
                  prec) -> list:
    """Each tap's share of LPIPS(a, b): five scalars."""
    out = []
    for t, (fa, fb) in enumerate(zip(features(weights, a, prec),
                                     features(weights, b, prec))):
        w = weights[f"lin{t}.model.1.weight"]
        out.append(F.conv2d(prec((fa - fb) ** 2), prec(w)).mean())
    return out


def distance(weights: dict, a: torch.Tensor, b: torch.Tensor,
             prec) -> torch.Tensor:
    """LPIPS(a, b) of two images (H, W, 3) in [0, 1]: a scalar."""
    return sum(tap_distances(weights, a, b, prec))
