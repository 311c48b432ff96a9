"""DUSt3R: two-view pointmap regression and known-pose global alignment.

Counterpart of ``syn3r_tpu/vision/dust3r.py``, in float32 (as JAX's
``Dust3R``) with TF32 off (``device.resolve_device``). The module keeps the
public checkpoint's state-dict names (``DUSt3R_ViTLarge_BaseDecoder_512_
linear``: ``patch_embed.proj``, ``enc_blocks.i.attn.qkv`` fused,
``enc_norm``, ``decoder_embed``, ``dec_blocks`` / ``dec_blocks2`` with
``cross_attn.projq/projk/projv``, one shared ``dec_norm``,
``downstream_head{1,2}.proj`` in ``pixel_shuffle`` order), so a real
checkpoint loads with no conversion; ``models/convert.dust3r_state_from_
flax`` bridges the JAX package's flax tree.

The forward: one shared ViT encoder for both views (2D RoPE, rotate-half
within each positional half, base 100) on ``img * 2 - 1`` cut into
patches, two intertwined decoders (block i of each stream reads both
streams' previous tokens; the other view's tokens get ``norm_y``), and a
linear head per view whose output ``pixel_shuffle`` lays out as
(3 + 1) x H x W: points ``p / |p| * expm1(|p|)`` in view 1's frame and
confidence ``1 + exp(min(c, 30))``.

``global_align_known_poses`` fits per-view log-depths and per-edge
log-scales with the poses fixed: 300 Adam steps (optax's arithmetic,
``gs/trainer.adam_update``) on one batched loss over all edges.
``make_dust3r_fn`` runs the pair loop and the alignment and fuses the
depths into one coloured cloud (``fuse_point_cloud``).
"""

from __future__ import annotations

import itertools
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..gs.trainer import AdamState, adam_update
from ..utils.camera import unproject
from ..utils.profiling import PhaseTimer

_EPS = 1e-6          # flax nn.LayerNorm epsilon, as JAX's blocks set it
HEAD_DIM = 64        # CroCo's head width: heads = width // 64


def rope_2d(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
            base: float = 100.0):
    """2D RoPE of q, k (B, heads, N, D) at ``positions`` (B, N, 2) as
    (y, x): the first half of D rotates with y, the second with x, each in
    the rotate-half form (x cos + [-x2, x1] sin, the angle table repeated
    over both sub-halves), not interleaved pairs."""
    half = q.shape[-1] // 2

    def rot(x, pos):
        dd = x.shape[-1]
        inv = 1.0 / (base ** (torch.arange(0, dd, 2, dtype=torch.float32,
                                           device=x.device) / dd))
        ang = pos[..., None] * inv                       # (B, N, dd / 2)
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
        x1, x2 = x[..., :dd // 2], x[..., dd // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def apply(x):
        return torch.cat([rot(x[..., :half], positions[..., 0]),
                          rot(x[..., half:], positions[..., 1])], -1)

    return apply(q), apply(k)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def _attend(q, k, v, pos_q, pos_k):
    """Softmax attention of (B, heads, N, hd) after RoPE; (B, N, D)."""
    q, _ = rope_2d(q, q, pos_q)
    k, _ = rope_2d(k, k, pos_k)
    b, h, n, hd = q.shape
    attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, -1)
    return (attn @ v).transpose(1, 2).reshape(b, n, h * hd)


class RopeAttention(nn.Module):
    """Self-attention with a fused ``qkv`` projection ((3, heads, hd)
    output order) and RoPE on q and k."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads) \
            .permute(2, 0, 3, 1, 4)
        return self.proj(_attend(q, k, v, pos, pos))


class RopeCrossAttention(nn.Module):
    """Cross-attention with separate ``projq/projk/projv`` projections."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context, pos_q, pos_k):
        q = _heads(self.projq(x), self.heads)
        k = _heads(self.projk(context), self.heads)
        v = _heads(self.projv(context), self.heads)
        return self.proj(_attend(q, k, v, pos_q, pos_k))


class Mlp(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * mult)
        self.fc2 = nn.Linear(dim * mult, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))             # exact (erf) GELU


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = RopeAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = Mlp(dim)

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = RopeAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.norm_y = nn.LayerNorm(dim, eps=_EPS)
        self.cross_attn = RopeCrossAttention(dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=_EPS)
        self.mlp = Mlp(dim)

    def forward(self, x, other, pos, pos_other):
        x = x + self.attn(self.norm1(x), pos)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(other), pos,
                                pos_other)
        return x + self.mlp(self.norm3(x))


class _Proj(nn.Module):
    """A holder of one ``proj`` (the checkpoint's patch_embed and head
    names)."""

    def __init__(self, proj: nn.Module):
        super().__init__()
        self.proj = proj


class Dust3R(nn.Module):
    """Two-view pointmap network: ``forward(img1, img2)`` on (B, H, W, 3)
    in [0, 1], H and W multiples of ``patch`` -> dict of ``pts1``, ``pts2``
    (B, H, W, 3), both in view 1's frame, and ``conf1``, ``conf2``
    (B, H, W). The defaults are ViT-L/512's widths."""

    def __init__(self, patch: int = 16, enc_dim: int = 1024,
                 enc_depth: int = 24, enc_heads: int = 16,
                 dec_dim: int = 768, dec_depth: int = 12,
                 dec_heads: int = 12):
        super().__init__()
        self.patch = patch
        self.patch_embed = _Proj(nn.Conv2d(3, enc_dim, patch, stride=patch))
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(enc_dim, enc_heads) for _ in range(enc_depth))
        self.enc_norm = nn.LayerNorm(enc_dim, eps=_EPS)
        self.decoder_embed = nn.Linear(enc_dim, dec_dim)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(dec_dim, dec_heads) for _ in range(dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(dec_dim, dec_heads) for _ in range(dec_depth))
        self.dec_norm = nn.LayerNorm(dec_dim, eps=_EPS)
        self.downstream_head1 = _Proj(nn.Linear(dec_dim, 4 * patch ** 2))
        self.downstream_head2 = _Proj(nn.Linear(dec_dim, 4 * patch ** 2))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> dict:
        b, h, w, _ = img1.shape
        p = self.patch
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} is not a multiple of the "
                             f"patch {p}")
        gh, gw = h // p, w // p
        dev = img1.device
        ys = torch.arange(gh, device=dev).repeat_interleave(gw)
        xs = torch.arange(gw, device=dev).repeat(gh)
        pos = torch.stack([ys, xs], -1).float()[None].expand(b, gh * gw, 2)

        # the shared encoder, both views in one batch
        x = torch.cat([img1, img2]) * 2.0 - 1.0
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2) \
            .transpose(1, 2)
        pos2 = torch.cat([pos, pos])
        for blk in self.enc_blocks:
            x = blk(x, pos2)
        d1, d2 = self.decoder_embed(self.enc_norm(x)).split(b)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            d1, d2 = blk1(d1, d2, pos, pos), blk2(d2, d1, pos, pos)

        def head(tokens, mod):
            out = mod.proj(self.dec_norm(tokens))        # (B, N, 4 p^2)
            out = F.pixel_shuffle(out.transpose(1, 2).reshape(b, -1, gh, gw),
                                  p).permute(0, 2, 3, 1)  # (B, H, W, 4)
            pts, conf = out[..., :3], out[..., 3]
            norm = torch.linalg.norm(pts, dim=-1, keepdim=True)
            pts = pts / norm.clamp(min=1e-8) * torch.expm1(norm)
            return pts, 1.0 + torch.exp(conf.clamp(max=30.0))

        pts1, conf1 = head(d1, self.downstream_head1)
        pts2, conf2 = head(d2, self.downstream_head2)
        return {"pts1": pts1, "conf1": conf1, "pts2": pts2, "conf2": conf2}


def dust3r_config(params: dict) -> dict:
    """``Dust3R`` arguments of a flax param tree (the JAX package's
    ``Dust3R`` names): widths and depths from the shapes, heads of
    HEAD_DIM (at least one)."""
    tree = params.get("params", params)
    kernel = np.shape(tree["patch_embed"]["kernel"])     # (p, p, 3, D)
    dec_dim = np.shape(tree["decoder_embed"]["kernel"])[1]

    def depth(prefix):
        return sum(1 for k in tree if re.fullmatch(prefix + r"_\d+", k))

    return dict(patch=kernel[0], enc_dim=kernel[3], enc_depth=depth("enc"),
                enc_heads=max(1, kernel[3] // HEAD_DIM), dec_dim=dec_dim,
                dec_depth=depth("dec1"),
                dec_heads=max(1, dec_dim // HEAD_DIM))


def load_dust3r(params: dict, device="cuda") -> Dust3R:
    """The ``Dust3R`` of a flax param tree (``utils.params.load_params`` of
    the JAX package's npz), in float32 on ``device``, in eval mode."""
    from ..models.convert import dust3r_state_from_flax
    model = Dust3R(**dust3r_config(params))
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                           for k, v in dust3r_state_from_flax(params).items()})
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# pairs and known-pose global alignment
# ---------------------------------------------------------------------------

def make_pairs(n_images: int, scene_graph: str = "complete") -> list:
    """Pair index list: every pair ("complete") or (ref, j) for j != ref
    ("oneref-<ref>")."""
    if scene_graph == "complete":
        return list(itertools.combinations(range(n_images), 2))
    if scene_graph.startswith("oneref-"):
        ref = int(scene_graph.split("-")[1])
        return [(ref, j) for j in range(n_images) if j != ref]
    raise ValueError(scene_graph)


def global_align_known_poses(pair_pts, pair_conf, pair_view_idx, c2w, K,
                             init_depths, iters: int = 300,
                             lr: float = 1e-2):
    """Align pair pointmaps into one scene with the camera poses FIXED.

    pair_pts (E, H, W, 3): edge e's points of view ``pair_view_idx[e, 0]``
    in the frame of camera ``pair_view_idx[e, 1]``; pair_conf (E, H, W);
    c2w (V, 4, 4); K (3, 3); init_depths (V, H, W). Minimizes the mean over
    edges of the mean over pixels of conf |s_e R_r pred + t_r - X_v(d)|^2
    over per-view log-depths and per-edge log-scales with Adam (optax's
    b1 0.9, b2 0.999, eps 1e-8 outside the square root), all edges in one
    loss. Returns (depths (V, H, W), scales (E,), the last step's loss).
    """
    v_idx = pair_view_idx[:, 0].long()
    r_idx = pair_view_idx[:, 1].long()
    rot, trans = c2w[:, :3, :3], c2w[:, :3, 3]

    def loss_fn(p):
        pred = pair_pts * torch.exp(p["log_scales"])[:, None, None, None]
        pred_w = torch.einsum("ehwj,eij->ehwi", pred, rot[r_idx]) \
            + trans[r_idx][:, None, None]
        cam = unproject(torch.exp(p["log_depths"]), K)
        mine = torch.einsum("vhwj,vij->vhwi", cam, rot) + trans[:, None, None]
        err = ((pred_w - mine[v_idx]) ** 2).sum(-1)
        return (pair_conf * err).mean((1, 2)).mean()

    params = {"log_depths": torch.log(init_depths.clamp(min=1e-3)),
              "log_scales": torch.zeros((pair_pts.shape[0],),
                                        device=pair_pts.device)}
    st = AdamState.init(params)
    lrs = {k: lr for k in params}
    loss = None
    for _ in range(iters):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        params, st = adam_update({k: v.detach() for k, v in p.items()},
                                 grads, st, lrs, eps=1e-8)
    return (torch.exp(params["log_depths"]), torch.exp(params["log_scales"]),
            loss.detach())


def fuse_point_cloud(depths, images, c2w, K, conf=None,
                     conf_thresh: float = 1.5, stride: int = 2):
    """Depths (V, H, W) -> one world point cloud (xyz, rgb) as numpy: every
    stride-th pixel (K scaled by 1 / stride), kept where the depth exceeds
    1e-4 and, with ``conf``, the confidence exceeds ``conf_thresh``."""
    pts_all, rgb_all = [], []
    Ks = K.clone()
    Ks[:2] *= 1.0 / stride
    for v in range(depths.shape[0]):
        d = depths[v, ::stride, ::stride]
        pw = unproject(d, Ks) @ c2w[v, :3, :3].T + c2w[v, :3, 3]
        keep = d > 1e-4
        if conf is not None:
            keep = keep & (conf[v, ::stride, ::stride] > conf_thresh)
        pts_all.append(pw[keep].cpu().numpy())
        rgb_all.append(images[v, ::stride, ::stride][keep].cpu().numpy())
    return np.concatenate(pts_all), np.concatenate(rgb_all)


def make_dust3r_fn(model: Dust3R, align_iters: int = 300,
                   scene_graph: str = "complete", conf_thresh: float = 1.5,
                   stride: int = 2):
    """The orchestrator's ``dust3r_fn(frames (V, H, W, 3) in [0, 1],
    c2w (V, 4, 4), K (3, 3)) -> (xyz (N, 3), rgb (N, 3))`` numpy: the
    network on each pair (i, j) (edges (i, i) and (j, i): both pointmaps
    in view i's frame), the alignment from depth 1, the per-view
    confidence as the mean over the edges that own the view, and the
    fused cloud. Runs on the model's device; ``fn.timer`` sums the
    seconds of the forwards ("dust3r_forward") and the alignment
    ("dust3r_align")."""
    timer = PhaseTimer()

    def fn(frames, c2w, K):
        dev = next(model.parameters()).device

        frames, c2w, K = (torch.as_tensor(x, dtype=torch.float32,
                                          device=dev)
                          for x in (frames, c2w, K))
        v, h, w = frames.shape[:3]
        pairs = make_pairs(v, scene_graph)
        pair_pts = torch.empty((2 * len(pairs), h, w, 3), device=dev)
        pair_conf = torch.empty((2 * len(pairs), h, w), device=dev)
        pv = []
        with timer.phase("dust3r_forward", sync=True), torch.no_grad():
            for e, (i, j) in enumerate(pairs):
                out = model(frames[i:i + 1], frames[j:j + 1])
                pair_pts[2 * e], pair_conf[2 * e] = out["pts1"][0], \
                    out["conf1"][0]
                pair_pts[2 * e + 1], pair_conf[2 * e + 1] = out["pts2"][0], \
                    out["conf2"][0]
                pv += [(i, i), (j, i)]
        with timer.phase("dust3r_align", sync=True):
            depths, _, _ = global_align_known_poses(
                pair_pts, pair_conf, torch.tensor(pv, device=dev), c2w, K,
                torch.ones((v, h, w), device=dev), iters=align_iters)
        # the edges' confidences summed in edge order, as JAX's numpy loop
        conf = torch.zeros((v, h, w), device=dev)
        cnt = np.zeros(v)
        for e, (view, _) in enumerate(pv):
            conf[view] += pair_conf[e]
            cnt[view] += 1
        conf /= torch.as_tensor(np.maximum(cnt, 1), dtype=torch.float32,
                                device=dev)[:, None, None]
        return fuse_point_cloud(depths.detach(), frames, c2w, K, conf=conf,
                                conf_thresh=conf_thresh, stride=stride)

    fn.timer = timer
    return fn
