"""Operations and bytes of one SVD UNet forward, as plain functions of the
configuration's widths and the call's shapes.

``census`` walks diffusers' UNetSpatioTemporalConditionModel at batch B,
F frames and an h x w latent grid and lists every matrix product the
forward needs (convolutions, linear layers, the GEGLU feed-forwards,
attention) and every norm call; the per-kernel helpers pick out the calls
that the hand-written kernels serve:

  - GEGLU feed-forward (``ops/geglu_ffn.py``): every transformer's three
    feed-forwards, x (rows, C) -> 8C -> 4C -> C: 24 rows C^2 operations;
    bytes x read and y written (bf16) and both weights read once.
  - flash attention (``ops/attention.py``): the spatial self-attentions of
    at least 512 tokens, head size 64: 4 BH S^2 64 operations; bytes q, k
    and v read and o written once.
  - the norms (``ops/norm.py``): LayerNorm and GroupNorm read x once and
    write y once; a second read for the statistics is not work a norm needs.

Cross-attention to one context token counts what it needs: to_v and
to_out of the token (softmax over one key is 1). Nothing here reads a plan
or a tile list of the program.
"""

from __future__ import annotations

from typing import NamedTuple

from .peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

BF16 = 2


class Census(NamedTuple):
    flops: float           # all matrix products of the forward
    geglu: list            # (rows, C) a call
    flash: list            # (batch x heads, tokens) a call
    layer_norm: list       # (rows, C) a call
    group_norm: list       # (elements, C) a call


def census(ucfg: dict, batch: int, frames: int, h: int, w: int) -> Census:
    ch = list(ucfg["block_out_channels"])
    heads = list(ucfg["num_attention_heads"])
    layers = ucfg["layers_per_block"]
    ctx = ucfg["cross_attention_dim"]
    temb = 4 * ch[0]
    n = batch * frames
    macs = [0.0]
    geglu, flash, ln, gn = [], [], [], []

    def mm(m):
        macs[0] += m

    def resnet(s, cin, cout):
        gn.extend([(n * s * cin, cin), (n * s * cout, cout)])
        mm(n * s * cin * cout * 9 + n * temb * cout + n * s * cout * cout * 9)
        if cin != cout:
            mm(n * s * cin * cout)
        # temporal: (3, 1, 1) convolutions
        gn.extend([(n * s * cout, cout)] * 2)
        mm(2 * n * s * cout * cout * 3 + n * temb * cout)

    def transformer(s, c, hd):
        gn.append((n * s * c, c))
        mm(2 * n * s * c * c + n * (4 * c * c + 4 * c * c))
        for _ in range(3):
            geglu.append((n * s, c))
            mm(12 * n * s * c * c)
        ln.extend([(n * s, c)] * 7)
        # spatial self-attention over s tokens, temporal over the frames
        mm(4 * n * s * c * c + 2 * n * s * s * c)
        mm(4 * n * s * c * c + 2 * batch * s * frames * frames * c)
        if s >= 512:
            flash.append((n * hd, s))
        # the two cross-attentions to one context token
        mm(n * (ctx * c + c * c) + batch * s * (ctx * c + c * c))

    levels = [(h, w)]
    for _ in ch[1:]:
        hh, ww = levels[-1]
        levels.append((-(-hh // 2), -(-ww // 2)))
    sizes = [a * b for a, b in levels]

    # the timestep and added-time-id embeddings, once a batch element
    mm(batch * (ch[0] * temb + 3 * ucfg["addition_time_embed_dim"] * temb
                + 2 * temb * temb))
    mm(n * sizes[0] * ucfg["in_channels"] * ch[0] * 9)
    skips, prev = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        for j in range(layers):
            resnet(sizes[i], prev if j == 0 else c, c)
            if i < len(ch) - 1:
                transformer(sizes[i], c, heads[i])
            skips.append(c)
            prev = c
        if i < len(ch) - 1:
            mm(n * sizes[i + 1] * c * c * 9)
            skips.append(c)
    resnet(sizes[-1], ch[-1], ch[-1])
    transformer(sizes[-1], ch[-1], heads[-1])
    resnet(sizes[-1], ch[-1], ch[-1])
    for i, c in enumerate(ch[::-1]):
        lvl = len(ch) - 1 - i
        for j in range(layers + 1):
            resnet(sizes[lvl], prev + skips.pop(), c)
            if i > 0:
                transformer(sizes[lvl], c, heads[::-1][i])
            prev = c
        if i < len(ch) - 1:
            mm(n * sizes[lvl - 1] * c * c * 9)
    gn.append((n * sizes[0] * ch[0], ch[0]))
    mm(n * sizes[0] * ch[0] * ucfg["out_channels"] * 9)
    return Census(2.0 * macs[0], geglu, flash, ln, gn)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time a call can take on the card: the larger of its
    operations over the bf16 peak and its bytes over the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def geglu_bound_s(calls) -> float:
    return sum(bound_s(24.0 * r * c * c,
                       BF16 * (2 * r * c + 12 * c * c + 9 * c))
               for r, c in calls)


def flash_bound_s(calls, head_dim: int = 64) -> float:
    return sum(bound_s(4.0 * bh * s * s * head_dim,
                       BF16 * 4 * bh * s * head_dim) for bh, s in calls)


def layer_norm_bound_s(calls) -> float:
    return sum(bound_s(0.0, BF16 * (2 * r * c + 2 * c)) for r, c in calls)


def group_norm_bound_s(calls) -> float:
    return sum(bound_s(0.0, BF16 * (2 * e + 2 * c)) for e, c in calls)
