"""Plain float32 reference of the SVD-XT denoiser.

diffusers' ``UNetSpatioTemporalConditionModel`` (the version SYN3R runs,
whose temporal cross-attention context is laid out pixel-major while the
attention rows are batch-major: pixel row r of a batch of B takes the first
frame's context of batch element r % B), written from its published
description as functions of a flat dict of tensors with diffusers'
state-dict names. Tensors are channel-first as in diffusers: the sample is
(B, F, C, H, W).

Nothing here imports the program under test. Large products run in blocks
so that a full-size forward fits one card: spatial attention over a few
(frame, head) slices at a time, feed-forwards over row blocks.

``Precision`` rounds the operands of every matrix product and convolution
(weights and activations), and the attention probabilities, before the
product; the default rounds nothing (float32). ``Precision("fp8")`` is the
control: per-tensor scaled float8 e4m3, accumulated in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# attention scores a block: (frame x head) slices are taken together up to
# 2^28 float32 scores (1 GiB)
ATTN_SCORES = 1 << 28
# feed-forward rows a block (the 8C pre-activation of 2^16 rows at C = 320
# is 0.7 GB in float32)
FF_ROWS = 1 << 16


class Precision:
    """Rounding applied to matrix-product operands. ``None``: float32 as
    it is; ``"fp8"``: float8 e4m3 with a per-tensor scale to its largest
    finite value, back to float32."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return t
        amax = t.abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


# the keys of diffusers' unet/config.json that this denoiser reads
READS = ("in_channels", "out_channels", "block_out_channels",
         "layers_per_block", "num_attention_heads", "addition_time_embed_dim",
         "cross_attention_dim")
# keys that change nothing here: the default frame count and latent size
# (a call's sample sets both)
DEFAULTS = ("num_frames", "sample_size")


def implied(cfg: dict) -> dict:
    """The values that this denoiser's structure gives the published
    config's other keys."""
    n = len(cfg["block_out_channels"])
    return {"_class_name": "UNetSpatioTemporalConditionModel",
            "down_block_types": ["CrossAttnDownBlockSpatioTemporal"] * (n - 1)
            + ["DownBlockSpatioTemporal"],
            "up_block_types": ["UpBlockSpatioTemporal"]
            + ["CrossAttnUpBlockSpatioTemporal"] * (n - 1),
            "transformer_layers_per_block": 1,
            "projection_class_embeddings_input_dim":
                3 * cfg["addition_time_embed_dim"]}


def refuse_unknown(cfg: dict) -> None:
    """Raises ValueError on a key of ``cfg`` that this denoiser does not
    implement, or implements with another value."""
    fixed = implied(cfg)
    for key, value in cfg.items():
        if key in READS or key in DEFAULTS:
            continue
        if key not in fixed:
            raise ValueError(f"the reference UNet does not implement {key!r}")
        if value != fixed[key]:
            raise ValueError(f"the reference UNet implements {key!r} = "
                             f"{fixed[key]!r}, not {value!r}")


def unet_param_shapes(cfg: dict) -> dict:
    """{diffusers state-dict name: shape} of the denoiser with ``cfg``'s
    widths (the keys of diffusers' unet/config.json)."""
    refuse_unknown(cfg)
    ch = list(cfg["block_out_channels"])
    heads = list(cfg["num_attention_heads"])
    layers = cfg["layers_per_block"]
    ctx = cfg["cross_attention_dim"]
    temb = ch[0] * 4
    add_dim = cfg["addition_time_embed_dim"]
    shapes: dict = {}

    def lin(name, i, o, bias=True):
        shapes[name + ".weight"] = (o, i)
        if bias:
            shapes[name + ".bias"] = (o,)

    def conv(name, i, o, k):
        shapes[name + ".weight"] = (o, i) + tuple(k)
        shapes[name + ".bias"] = (o,)

    def norm(name, c):
        shapes[name + ".weight"] = (c,)
        shapes[name + ".bias"] = (c,)

    def temb_mlp(name, i, hidden, o=None):
        lin(name + ".linear_1", i, hidden)
        lin(name + ".linear_2", hidden, o or hidden)

    def resnet(name, i, o):
        for part, k in (("spatial_res_block", (3, 3)),
                        ("temporal_res_block", (3, 1, 1))):
            p = f"{name}.{part}"
            c_in = i if part == "spatial_res_block" else o
            norm(p + ".norm1", c_in)
            conv(p + ".conv1", c_in, o, k)
            lin(p + ".time_emb_proj", temb, o)
            norm(p + ".norm2", o)
            conv(p + ".conv2", o, o, k)
            if c_in != o:
                conv(p + ".conv_shortcut", c_in, o, (1,) * len(k))
        shapes[name + ".time_mixer.mix_factor"] = (1,)

    def attn(name, dim, context):
        lin(name + ".to_q", dim, dim, bias=False)
        lin(name + ".to_k", context, dim, bias=False)
        lin(name + ".to_v", context, dim, bias=False)
        lin(name + ".to_out.0", dim, dim)

    def ff(name, dim):
        lin(name + ".net.0.proj", dim, dim * 8)
        lin(name + ".net.2", dim * 4, dim)

    def transformer(name, c):
        norm(name + ".norm", c)
        lin(name + ".proj_in", c, c)
        temb_mlp(name + ".time_pos_embed", c, c * 4, c)
        b = name + ".transformer_blocks.0"
        norm(b + ".norm1", c)
        attn(b + ".attn1", c, c)
        norm(b + ".norm2", c)
        attn(b + ".attn2", c, ctx)
        norm(b + ".norm3", c)
        ff(b + ".ff", c)
        t = name + ".temporal_transformer_blocks.0"
        norm(t + ".norm_in", c)
        ff(t + ".ff_in", c)
        norm(t + ".norm1", c)
        attn(t + ".attn1", c, c)
        norm(t + ".norm2", c)
        attn(t + ".attn2", c, ctx)
        norm(t + ".norm3", c)
        ff(t + ".ff", c)
        shapes[name + ".time_mixer.mix_factor"] = (1,)
        lin(name + ".proj_out", c, c)

    temb_mlp("time_embedding", ch[0], temb)
    temb_mlp("add_embedding", 3 * add_dim, temb)
    conv("conv_in", cfg["in_channels"], ch[0], (3, 3))
    skips, prev = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        for j in range(layers):
            resnet(f"down_blocks.{i}.resnets.{j}", prev if j == 0 else c, c)
            if i < len(ch) - 1:
                transformer(f"down_blocks.{i}.attentions.{j}", c)
            skips.append(c)
        if i < len(ch) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", c, c, (3, 3))
            skips.append(c)
        prev = c
    resnet("mid_block.resnets.0", ch[-1], ch[-1])
    transformer("mid_block.attentions.0", ch[-1])
    resnet("mid_block.resnets.1", ch[-1], ch[-1])
    for i, c in enumerate(ch[::-1]):
        for j in range(layers + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", prev + skips.pop(), c)
            if i > 0:
                transformer(f"up_blocks.{i}.attentions.{j}", c)
            prev = c
        if i < len(ch) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", c, c, (3, 3))
    norm("conv_norm_out", ch[0])
    conv("conv_out", ch[0], cfg["out_channels"], (3, 3))
    return shapes


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos=True and
    downscale_freq_shift=0."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1)


class RefUNet:
    """The denoiser over ``params`` (float32 tensors by diffusers name)."""

    def __init__(self, params: dict, cfg: dict,
                 precision: Precision | None = None):
        refuse_unknown(cfg)
        self.p, self.cfg = params, cfg
        self.q = precision or Precision()

    # -- primitives -----------------------------------------------------

    def linear(self, x, name, bias=True):
        w = self.q(self.p[name + ".weight"])
        y = torch.matmul(self.q(x), w.t())
        return y + self.p[name + ".bias"] if bias else y

    def conv(self, x, name, stride=1):
        w = self.q(self.p[name + ".weight"])
        pad = tuple(k // 2 for k in w.shape[2:])
        fn = F.conv2d if w.dim() == 4 else F.conv3d
        return fn(self.q(x), w, self.p[name + ".bias"], stride=stride,
                  padding=pad)

    def group_norm(self, x, name, eps):
        return F.group_norm(x, 32, self.p[name + ".weight"],
                            self.p[name + ".bias"], eps)

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.p[name + ".weight"],
                            self.p[name + ".bias"], 1e-5)

    def mlp(self, x, name):
        h = F.silu(self.linear(x, name + ".linear_1"))
        return self.linear(h, name + ".linear_2")

    def ff(self, x, name):
        """GEGLU feed-forward over row blocks of x (..., C)."""
        shape = x.shape
        rows = x.reshape(-1, shape[-1])
        out = []
        for r in range(0, rows.shape[0], FF_ROWS):
            h = self.linear(rows[r:r + FF_ROWS], name + ".net.0.proj")
            a, gate = h.chunk(2, dim=-1)
            out.append(self.linear(a * F.gelu(gate), name + ".net.2"))
        return torch.cat(out).reshape(shape)

    def attention(self, x, name, context=None):
        """diffusers ``Attention``: x (N, S, C), context (N, S', D)."""
        heads = self.heads
        ctx = x if context is None else context
        n, s, c = x.shape
        d = c // heads
        q = self.linear(x, name + ".to_q", bias=False)
        k = self.linear(ctx, name + ".to_k", bias=False)
        v = self.linear(ctx, name + ".to_v", bias=False)
        q, k, v = (t.reshape(n, -1, heads, d).transpose(1, 2)
                   .reshape(n * heads, -1, d) for t in (q, k, v))
        scale = 1.0 / math.sqrt(d)
        step = max(1, ATTN_SCORES // (s * k.shape[1]))
        out = []
        for i in range(0, q.shape[0], step):
            sc = torch.matmul(self.q(q[i:i + step]),
                              self.q(k[i:i + step]).transpose(1, 2)) * scale
            pr = torch.softmax(sc, dim=-1)
            out.append(torch.matmul(self.q(pr), self.q(v[i:i + step])))
        o = torch.cat(out).reshape(n, heads, s, d).transpose(1, 2)
        return self.linear(o.reshape(n, s, c), name + ".to_out.0")

    def mix(self, x_spatial, x_temporal, name):
        alpha = torch.sigmoid(self.p[name + ".mix_factor"][0])
        return alpha * x_spatial + (1.0 - alpha) * x_temporal

    # -- blocks ---------------------------------------------------------

    def resnet(self, x, temb, name, eps, num_frames):
        """SpatioTemporalResBlock: x (B*F, C, H, W), temb (B*F, D)."""
        s = name + ".spatial_res_block"
        h = self.conv(F.silu(self.group_norm(x, s + ".norm1", eps)),
                      s + ".conv1")
        h = h + self.linear(F.silu(temb), s + ".time_emb_proj")[:, :, None,
                                                                 None]
        h = self.conv(F.silu(self.group_norm(h, s + ".norm2", eps)),
                      s + ".conv2")
        if s + ".conv_shortcut.weight" in self.p:
            x = self.conv(x, s + ".conv_shortcut")
        x = x + h
        bf, c, hh, ww = x.shape
        b = bf // num_frames
        x5 = x.reshape(b, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        t = name + ".temporal_res_block"
        h = self.conv(F.silu(self.group_norm(x5, t + ".norm1", eps)),
                      t + ".conv1")
        tp = self.linear(F.silu(temb), t + ".time_emb_proj")
        h = h + tp.reshape(b, num_frames, -1).permute(0, 2, 1)[..., None,
                                                               None]
        h = self.conv(F.silu(self.group_norm(h, t + ".norm2", eps)),
                      t + ".conv2")
        xt = x5 + h
        out = self.mix(x5, xt, name + ".time_mixer")
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)

    def transformer(self, x, context, name, heads, num_frames):
        """TransformerSpatioTemporalModel: x (B*F, C, H, W), context
        (B*F, 1, D)."""
        self.heads = heads
        bf, c, hh, ww = x.shape
        b, s = bf // num_frames, hh * ww
        tc_first = context.reshape(b, num_frames, -1, context.shape[-1])[:, 0]
        time_context = tc_first[None].broadcast_to(
            s, b, tc_first.shape[1], tc_first.shape[2]).reshape(
            s * b, tc_first.shape[1], tc_first.shape[2])
        residual = x
        h = self.group_norm(x, name + ".norm", 1e-6)
        h = h.permute(0, 2, 3, 1).reshape(bf, s, c)
        h = self.linear(h, name + ".proj_in")
        ids = torch.arange(num_frames, device=x.device).repeat(b)
        emb = self.mlp(timestep_embedding(ids, c), name + ".time_pos_embed")
        blk = name + ".transformer_blocks.0"
        h = self.attention(self.layer_norm(h, blk + ".norm1"),
                           blk + ".attn1") + h
        h = self.attention(self.layer_norm(h, blk + ".norm2"),
                           blk + ".attn2", context) + h
        h = self.ff(self.layer_norm(h, blk + ".norm3"), blk + ".ff") + h
        tb = name + ".temporal_transformer_blocks.0"
        m = (h + emb[:, None, :]).reshape(b, num_frames, s, c)
        m = m.permute(0, 2, 1, 3).reshape(b * s, num_frames, c)
        m = self.ff(self.layer_norm(m, tb + ".norm_in"), tb + ".ff_in") + m
        m = self.attention(self.layer_norm(m, tb + ".norm1"),
                           tb + ".attn1") + m
        m = self.attention(self.layer_norm(m, tb + ".norm2"),
                           tb + ".attn2", time_context) + m
        m = self.ff(self.layer_norm(m, tb + ".norm3"), tb + ".ff") + m
        m = m.reshape(b, s, num_frames, c).permute(0, 2, 1, 3)
        h = self.mix(h, m.reshape(bf, s, c), name + ".time_mixer")
        h = self.linear(h, name + ".proj_out")
        return h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2) + residual

    # -- the forward ----------------------------------------------------

    @torch.no_grad()
    def __call__(self, sample, timestep, encoder_hidden_states,
                 added_time_ids):
        """sample (B, F, C, H, W), timestep scalar, encoder_hidden_states
        (B, 1, D), added_time_ids (B, 3); returns (B, F, 4, H, W)."""
        cfg = self.cfg
        ch = list(cfg["block_out_channels"])
        heads = list(cfg["num_attention_heads"])
        layers = cfg["layers_per_block"]
        b, f = sample.shape[:2]
        ts = torch.as_tensor(timestep, dtype=torch.float32,
                             device=sample.device).reshape(()).expand(b)
        emb = self.mlp(timestep_embedding(ts, ch[0]), "time_embedding")
        add = timestep_embedding(added_time_ids.flatten(),
                                 cfg["addition_time_embed_dim"])
        emb = emb + self.mlp(add.reshape(b, -1), "add_embedding")
        emb = emb.repeat_interleave(f, dim=0)
        context = encoder_hidden_states.repeat_interleave(f, dim=0)
        x = self.conv(sample.flatten(0, 1), "conv_in")
        skips = [x]
        for i in range(len(ch)):
            cross = i < len(ch) - 1
            eps = 1e-6 if cross else 1e-5
            for j in range(layers):
                x = self.resnet(x, emb, f"down_blocks.{i}.resnets.{j}", eps, f)
                if cross:
                    x = self.transformer(x, context,
                                         f"down_blocks.{i}.attentions.{j}",
                                         heads[i], f)
                skips.append(x)
            if cross:
                x = self.conv(x, f"down_blocks.{i}.downsamplers.0.conv",
                              stride=2)
                skips.append(x)
        x = self.resnet(x, emb, "mid_block.resnets.0", 1e-5, f)
        x = self.transformer(x, context, "mid_block.attentions.0",
                             heads[-1], f)
        x = self.resnet(x, emb, "mid_block.resnets.1", 1e-5, f)
        for i in range(len(ch)):
            for j in range(layers + 1):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self.resnet(x, emb, f"up_blocks.{i}.resnets.{j}", 1e-6, f)
                if i > 0:
                    x = self.transformer(x, context,
                                         f"up_blocks.{i}.attentions.{j}",
                                         heads[::-1][i], f)
            if i < len(ch) - 1:
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = self.conv(x, f"up_blocks.{i}.upsamplers.0.conv")
        x = F.silu(self.group_norm(x, "conv_norm_out", 1e-5))
        x = self.conv(x, "conv_out")
        return x.reshape(b, f, *x.shape[1:])
