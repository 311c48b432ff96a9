"""CLIP vision encoder with projection (HF CLIPVisionModelWithProjection).

Counterpart of ``syn3r_tpu/models/clip.py``, with HF's state-dict names
(``vision_model.encoder.layers.{i}.mlp.fc1`` ...). ViT-H/14 as SVD uses it:
hidden 1280, 32 layers, 16 heads, MLP 5120, patch 14, image 224,
projection 1024, exact gelu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_dense
from .layers import Conv2d, LayerNorm, Linear

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] (..., 3) -> CLIP-normalized."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=img01.dtype,
                        device=img01.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=img01.dtype, device=img01.device)
    return (img01 - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(hidden, hidden)
        self.k_proj = Linear(hidden, hidden)
        self.v_proj = Linear(hidden, hidden)
        self.out_proj = Linear(hidden, hidden)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.view(b, s, self.heads, hd).transpose(1, 2)

        out = attention_dense(split(self.q_proj(x)), split(self.k_proj(x)),
                              split(self.v_proj(x)), hd ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = Linear(hidden, mlp_dim)
        self.fc2 = Linear(mlp_dim, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = LayerNorm(hidden)
        self.mlp = CLIPMLP(hidden, mlp_dim)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, hidden, layers, heads, mlp_dim):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(hidden, heads, mlp_dim) for _ in range(layers)])


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, image_size: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(hidden))
        self.patch_embedding = Conv2d(3, hidden, patch, stride=patch,
                                      bias=False)
        self.position_embedding = nn.Embedding(
            (image_size // patch) ** 2 + 1, hidden)

    def forward(self, pixels):
        b = pixels.shape[0]
        patches = self.patch_embedding(pixels).reshape(b, -1,
                                                       self.class_embedding
                                                       .shape[0])
        cls = self.class_embedding.to(pixels.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight[:x.shape[1]].to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, hidden, layers, heads, mlp_dim, patch, image_size):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(hidden, patch, image_size)
        self.pre_layrnorm = LayerNorm(hidden)
        self.encoder = CLIPEncoder(hidden, layers, heads, mlp_dim)
        self.post_layernorm = LayerNorm(hidden)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, hidden: int = 1280, layers: int = 32, heads: int = 16,
                 mlp_dim: int = 5120, patch: int = 14, image_size: int = 224,
                 projection_dim: int = 1024):
        super().__init__()
        self.vision_model = CLIPVisionTransformer(hidden, layers, heads,
                                                  mlp_dim, patch, image_size)
        self.visual_projection = Linear(hidden, projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, 224, 224, 3) CLIP-normalized, in the compute dtype ->
        image embeddings (B, projection_dim)."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels))
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
