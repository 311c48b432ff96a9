"""Random DUSt3R and GMFlow weights in the JAX package's flax layout.

Test and chip-run fixtures, not product code: ``random_dust3r_params``
and ``random_gmflow_params`` give numpy param trees (under "params") with
the structure and shapes of ``syn3r_tpu/vision/dust3r.py:Dust3R`` and
``syn3r_tpu/vision/gmflow_public.py:GMFlowPublic`` at the given widths
(ViT-L/512 and the public gmflow by default), drawn from ``seed``;
``syn3r_tpu_torch.utils.params.save_params`` writes one as the flat npz that
``--dust3r_weights`` / ``--gmflow_weights`` read. Linear and conv weights
are N(0, 0.02) (0.05 for the instance-normed convolutions), norms near
(1, 0); the two head norms of DUSt3R are one draw, as a flax init makes
them.
"""

from __future__ import annotations

import numpy as np


class _Draw:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape, std):
        return self.rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(std)

    def dense(self, i, o, bias=True, std=0.02):
        node = {"kernel": self.normal((i, o), std)}
        if bias:
            node["bias"] = self.normal((o,), std)
        return node

    def conv(self, k, i, o, bias=True, std=0.05):
        node = {"kernel": self.normal((k, k, i, o), std)}
        if bias:
            node["bias"] = self.normal((o,), std)
        return node

    def norm(self, d):
        return {"scale": 1.0 + self.normal((d,), 0.05),
                "bias": self.normal((d,), 0.02)}


def random_dust3r_params(seed: int, patch: int = 16, enc_dim: int = 1024,
                         enc_depth: int = 24, dec_dim: int = 768,
                         dec_depth: int = 12) -> dict:
    """A Dust3R flax tree (ViT-L/512 widths by default)."""
    r = _Draw(seed)

    def attn(d):
        return {n: r.dense(d, d) for n in ("q", "k", "v", "proj")}

    def mlp(d):
        return {"fc1": r.dense(d, 4 * d), "fc2": r.dense(4 * d, d)}

    tree = {"patch_embed": r.conv(patch, 3, enc_dim, std=0.02)}
    for i in range(enc_depth):
        tree[f"enc_{i}"] = {"norm1": r.norm(enc_dim), "attn": attn(enc_dim),
                            "norm2": r.norm(enc_dim), "mlp": mlp(enc_dim)}
    tree["enc_norm"] = r.norm(enc_dim)
    tree["decoder_embed"] = r.dense(enc_dim, dec_dim)
    for prefix in ("dec1", "dec2"):
        for i in range(dec_depth):
            tree[f"{prefix}_{i}"] = {
                "norm1": r.norm(dec_dim), "attn": attn(dec_dim),
                "norm2": r.norm(dec_dim), "norm_y": r.norm(dec_dim),
                "cross_attn": attn(dec_dim), "norm3": r.norm(dec_dim),
                "mlp": mlp(dec_dim)}
    tree["head1_norm"] = tree["head2_norm"] = r.norm(dec_dim)
    for i in (1, 2):
        tree[f"head{i}_proj"] = r.dense(dec_dim, 4 * patch * patch)
    return {"params": tree}


def random_gmflow_params(seed: int, channels: int = 128, layers: int = 6,
                         factor: int = 8) -> dict:
    """A GMFlowPublic flax tree (the public 128 channels, 6 layers, x8 by
    default)."""
    r = _Draw(seed)
    bb = {"conv1": r.conv(7, 3, 64, bias=False)}
    cin = 64
    for stage, planes in ((1, 64), (2, 96), (3, 128)):
        for blk in (0, 1):
            node = {"conv1": r.conv(3, cin, planes, bias=False),
                    "conv2": r.conv(3, planes, planes, bias=False)}
            if cin != planes:
                node["downsample"] = r.conv(1, cin, planes, bias=False)
            bb[f"layer{stage}_{blk}"] = node
            cin = planes
    bb["conv2"] = r.conv(1, 128, channels)
    d = channels
    tr = {}
    for i in range(layers):
        tr[f"layers_{i}"] = {}
        for sub in ("self_attn", "cross_attn_ffn"):
            node = {n: r.dense(d, d)
                    for n in ("q_proj", "k_proj", "v_proj", "merge")}
            node["norm1"] = r.norm(d)
            if sub == "cross_attn_ffn":
                node["norm2"] = r.norm(d)
                node["mlp_0"] = r.dense(2 * d, 8 * d, bias=False)
                node["mlp_2"] = r.dense(8 * d, d, bias=False)
            tr[f"layers_{i}"][sub] = node
    return {"params": {
        "backbone": bb, "transformer": tr,
        "feature_flow_attn": {"q_proj": r.dense(d, d),
                              "k_proj": r.dense(d, d)},
        "upsampler_0": r.conv(3, 2 + d, 256),
        "upsampler_2": r.conv(1, 256, 9 * factor ** 2)}}
