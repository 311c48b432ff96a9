"""Bridge from the JAX package's flax param trees to the torch modules.

The flax modules name their submodules after the diffusers / HF state-dict
layout, so every key of a torch module's ``state_dict()`` has one flax
path, found by the forward rule the JAX package converts checkpoints with
(``syn3r_tpu/models/convert.py`` for the UNet and VAE: numeric segments
merge into their parent, ``weight`` becomes ``kernel`` or ``scale``;
``syn3r_tpu/models/clip.py:convert_clip_torch`` for CLIP). The array at
that path is transposed back (HWIO -> OIHW, (kt,kh,kw,I,O) -> OIDHW,
IO -> OI) and loaded. Flax names are never inverted textually:
``linear_1``, ``to_out_0`` and ``down_blocks_0`` look alike. LPIPS has
its own map (``lpips_state_from_flax``): the flax module numbers its
convolutions, the ``lpips`` package names them by slice and index. DUSt3R
and the public GMFlow have theirs too (``dust3r_state_from_flax``,
``gmflow_state_from_flax``): the inverses of the JAX package's converters
from the public checkpoints, which fuse, split and permute weights.

The other way, ``torch_to_flax`` (UNet, VAE), ``clip.convert_clip_torch``
and ``lpips.convert_lpips_torch`` turn a checkpoint's torch state dict
into the flax tree the JAX package writes as ``.npz``
(``cli/convert_weights.py``), with the same forward rules.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _merge_numeric(parts: list[str]) -> list[str]:
    out: list[str] = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def _leaf(leaf: str, ndim: int, is_embedding: bool = False) -> str:
    if leaf != "weight":
        return leaf
    if is_embedding:
        return "embedding"
    return "scale" if ndim == 1 else "kernel"


def diffusers_flax_path(key: str, ndim: int) -> tuple[str, ...]:
    """Flax path of a diffusers-named torch state-dict key."""
    parts = _merge_numeric(key.split("."))
    return tuple(parts[:-1]) + (_leaf(parts[-1], ndim),)


def clip_flax_path(key: str, ndim: int) -> tuple[str, ...]:
    """Flax path of an HF CLIPVisionModelWithProjection key."""
    parts = key.split(".")
    if "layers" in parts:
        i = parts.index("layers")
        parts[i] = f"layers_{parts[i + 1]}"
        del parts[i + 1]
    if "mlp" in parts:
        i = parts.index("mlp")
        parts[i] = f"mlp_{parts[i + 1]}"
        del parts[i + 1]
    leaf = parts[-1]
    if "encoder" in parts:
        i = parts.index("encoder")
        mod = [".".join(parts[:i + 2])] + parts[i + 2:-1]
    elif parts[0] == "vision_model":
        mod = [".".join(parts[:2])] + parts[2:-1]
    else:
        mod = parts[:-1]
    return tuple(mod) + (_leaf(leaf, ndim, "position_embedding" in parts),)


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 5:        # (kt, kh, kw, I, O) -> (O, I, kt, kh, kw)
        return arr.transpose(4, 3, 0, 1, 2)
    if arr.ndim == 4:        # (kh, kw, I, O) -> (O, I, kh, kw)
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:        # (I, O) -> (O, I)
        return arr.transpose(1, 0)
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def _to_flax_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    """The inverse of ``_to_torch_layout``."""
    if leaf != "kernel":
        return arr
    if arr.ndim == 5:        # (O, I, kt, kh, kw) -> (kt, kh, kw, I, O)
        return arr.transpose(2, 3, 4, 1, 0)
    if arr.ndim == 4:        # (O, I, kh, kw) -> (kh, kw, I, O)
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:        # (O, I) -> (I, O)
        return arr.transpose(1, 0)
    raise ValueError(f"unexpected weight rank {arr.ndim}")


def flax_tree(state_dict: dict, rule: str = "diffusers") -> dict:
    """A torch state dict (numpy arrays or tensors) as the nested flax
    param tree, float32, by ``rule`` ("diffusers" or "clip"): the JAX
    package's ``torch_to_flax`` and ``convert_clip_torch``, in numpy."""
    path_of = {"diffusers": diffusers_flax_path, "clip": clip_flax_path}[rule]
    params: dict = {}
    for key, arr in state_dict.items():
        arr = np.asarray(arr)
        path = path_of(key, arr.ndim)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax_layout(arr, path[-1]).astype(np.float32)
    return params


def torch_to_flax(state_dict: dict) -> dict:
    """A diffusers state dict (UNet, VAE) as the flax param tree."""
    return flax_tree(state_dict, "diffusers")


def _flat_leaves(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_flax_params(module: nn.Module, params: dict,
                     rule: str = "diffusers") -> nn.Module:
    """Copy a flax param tree (nested dict of arrays, optionally under a
    top-level "params") into ``module`` in place, each tensor keeping its
    dtype and device. ``rule`` is "diffusers" (UNet, VAE) or "clip".
    Raises unless every state-dict key finds a flax leaf of its shape and
    every flax leaf is used."""
    path_of = {"diffusers": diffusers_flax_path, "clip": clip_flax_path}[rule]
    leaves = _flat_leaves(params.get("params", params))
    used = set()
    missing, mismatched = [], []
    state = module.state_dict()
    for key, tensor in state.items():
        path = path_of(key, tensor.dim())
        if path not in leaves:
            missing.append(f"{key} -> {'/'.join(path)}")
            continue
        used.add(path)
        arr = _to_torch_layout(np.asarray(leaves[path], np.float32), path[-1])
        if tuple(arr.shape) != tuple(tensor.shape):
            mismatched.append(f"{key}: flax {arr.shape} vs torch "
                              f"{tuple(tensor.shape)}")
            continue
        with torch.no_grad():
            tensor.copy_(torch.tensor(arr))
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if missing or extra or mismatched:
        raise ValueError(
            f"flax tree does not match the torch module: missing "
            f"({len(missing)}) {missing[:8]}; unused flax leaves "
            f"({len(extra)}) {extra[:8]}; shape ({len(mismatched)}) "
            f"{mismatched[:8]}")
    return module


def lpips_state_from_flax(params: dict) -> dict:
    """The JAX package's LPIPS param tree (``net/conv_i/{kernel,bias}`` in
    HWIO, ``lin_i/kernel``; optionally under a top-level "params") as the
    state dict of ``models.lpips.LPIPS``, the ``lpips`` package's names
    (the inverse of ``syn3r_tpu/models/lpips.py:convert_lpips_torch``)."""
    from .lpips import _CHANNELS, _SCALE, _SHIFT, vgg_conv_keys
    tree = params.get("params", params)
    keys = vgg_conv_keys()
    if (sorted(tree) != sorted(["net"] + [f"lin_{i}" for i in range(5)])
            or len(tree["net"]) != len(keys)):
        raise ValueError(f"not an LPIPS param tree: {sorted(tree)}")
    state = {"scaling_layer.shift": torch.tensor(_SHIFT)[None, :, None, None],
             "scaling_layer.scale": torch.tensor(_SCALE)[None, :, None, None]}
    for i, key in enumerate(keys):
        conv = tree["net"][f"conv_{i}"]
        state[f"{key}.weight"] = torch.tensor(_to_torch_layout(
            np.asarray(conv["kernel"], np.float32), "kernel"))
        state[f"{key}.bias"] = torch.tensor(np.asarray(conv["bias"],
                                                       np.float32))
    for i, c in enumerate(_CHANNELS):
        w = _to_torch_layout(np.asarray(tree[f"lin_{i}"]["kernel"],
                                        np.float32), "kernel")
        if w.shape != (1, c, 1, 1):
            raise ValueError(f"lin_{i}: kernel {w.shape}")
        state[f"lin{i}.model.1.weight"] = torch.tensor(w)
    return state


def _tree(params: dict) -> dict:
    return params.get("params", params)


def _dense(node: dict, out: dict, key: str) -> None:
    """A flax Dense (kernel (I, O)) as torch ``key.weight`` (O, I) and
    ``key.bias`` when it has one."""
    out[f"{key}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        out[f"{key}.bias"] = np.asarray(node["bias"])


def _norm(node: dict, out: dict, key: str) -> None:
    out[f"{key}.weight"] = np.asarray(node["scale"])
    out[f"{key}.bias"] = np.asarray(node["bias"])


def _conv(node: dict, out: dict, key: str) -> None:
    """A flax Conv (kernel HWIO) as torch ``key.weight`` (OIHW)."""
    out[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        out[f"{key}.bias"] = np.asarray(node["bias"])


def _numbered(tree: dict, prefix: str) -> int:
    return sum(1 for k in tree if re.fullmatch(prefix + r"_\d+", k))


def dust3r_state_from_flax(params: dict) -> dict:
    """The JAX package's ``Dust3R`` param tree (optionally under "params")
    as the public DUSt3R checkpoint's state dict (numpy values), the names
    of ``vision.dust3r.Dust3R``: the inverse of ``syn3r_tpu/vision/
    dust3r.py:convert_dust3r_torch``. q, k and v concatenate into ``qkv``;
    the kernels transpose (the patch embedding back from HWIO); the heads'
    output features return from flax's (p, p, 4) order to
    ``pixel_shuffle``'s (4, p, p). The checkpoint has one ``dec_norm``
    where the flax tree has ``head1_norm`` and ``head2_norm``: they must be
    equal, else this raises."""
    tree = _tree(params)
    out: dict = {}
    _conv(tree["patch_embed"], out, "patch_embed.proj")

    def attn(node, key):
        out[f"{key}.qkv.weight"] = np.concatenate(
            [np.asarray(node[n]["kernel"]).T for n in "qkv"])
        out[f"{key}.qkv.bias"] = np.concatenate(
            [np.asarray(node[n]["bias"]) for n in "qkv"])
        _dense(node["proj"], out, f"{key}.proj")

    def mlp(node, key):
        _dense(node["fc1"], out, f"{key}.fc1")
        _dense(node["fc2"], out, f"{key}.fc2")

    for i in range(_numbered(tree, "enc")):
        node, key = tree[f"enc_{i}"], f"enc_blocks.{i}"
        _norm(node["norm1"], out, f"{key}.norm1")
        attn(node["attn"], f"{key}.attn")
        _norm(node["norm2"], out, f"{key}.norm2")
        mlp(node["mlp"], f"{key}.mlp")
    _norm(tree["enc_norm"], out, "enc_norm")
    _dense(tree["decoder_embed"], out, "decoder_embed")
    for stream, prefix in (("dec_blocks", "dec1"), ("dec_blocks2", "dec2")):
        for i in range(_numbered(tree, prefix)):
            node, key = tree[f"{prefix}_{i}"], f"{stream}.{i}"
            _norm(node["norm1"], out, f"{key}.norm1")
            attn(node["attn"], f"{key}.attn")
            _norm(node["norm2"], out, f"{key}.norm2")
            _norm(node["norm_y"], out, f"{key}.norm_y")
            for n in "qkv":
                _dense(node["cross_attn"][n], out, f"{key}.cross_attn.proj{n}")
            _dense(node["cross_attn"]["proj"], out, f"{key}.cross_attn.proj")
            _norm(node["norm3"], out, f"{key}.norm3")
            mlp(node["mlp"], f"{key}.mlp")
    n1, n2 = tree["head1_norm"], tree["head2_norm"]
    if not all(np.array_equal(n1[k], n2[k]) for k in ("scale", "bias")):
        raise ValueError("head1_norm and head2_norm differ: the public "
                         "checkpoint has one dec_norm for both heads")
    _norm(n1, out, "dec_norm")
    for i in (1, 2):
        node = tree[f"head{i}_proj"]
        kernel = np.asarray(node["kernel"])             # (D, 4 p^2)
        p = int(round((kernel.shape[1] // 4) ** 0.5))
        # flax feature a*4p + b*4 + c is pixel_shuffle's c*p^2 + a*p + b
        perm = (np.arange(4)[None, None, :] * p * p
                + np.arange(p)[:, None, None] * p
                + np.arange(p)[None, :, None]).reshape(-1)
        inv = np.argsort(perm)
        out[f"downstream_head{i}.proj.weight"] = kernel.T[inv]
        out[f"downstream_head{i}.proj.bias"] = np.asarray(node["bias"])[inv]
    return out


def gmflow_state_from_flax(params: dict) -> dict:
    """The JAX package's ``GMFlowPublic`` param tree (optionally under
    "params") as the public gmflow checkpoint's state dict (numpy values),
    the names of ``vision.gmflow_public.GMFlowPublic``: the inverse of
    ``syn3r_tpu/vision/gmflow_public.py:convert_gmflow_torch`` (its
    instance norms carry no weights)."""
    tree = _tree(params)
    out: dict = {}
    bb = tree["backbone"]
    _conv(bb["conv1"], out, "backbone.conv1")
    for stage in (1, 2, 3):
        for blk in (0, 1):
            node, key = bb[f"layer{stage}_{blk}"], f"backbone.layer{stage}.{blk}"
            _conv(node["conv1"], out, f"{key}.conv1")
            _conv(node["conv2"], out, f"{key}.conv2")
            if "downsample" in node:
                _conv(node["downsample"], out, f"{key}.downsample.0")
    _conv(bb["conv2"], out, "backbone.conv2")
    tr = tree["transformer"]
    for i in range(_numbered(tr, "layers")):
        for sub in ("self_attn", "cross_attn_ffn"):
            node, key = tr[f"layers_{i}"][sub], f"transformer.layers.{i}.{sub}"
            for n in ("q_proj", "k_proj", "v_proj", "merge"):
                _dense(node[n], out, f"{key}.{n}")
            _norm(node["norm1"], out, f"{key}.norm1")
            if "norm2" in node:
                _norm(node["norm2"], out, f"{key}.norm2")
                _dense(node["mlp_0"], out, f"{key}.mlp.0")
                _dense(node["mlp_2"], out, f"{key}.mlp.2")
    for n in ("q_proj", "k_proj"):
        _dense(tree["feature_flow_attn"][n], out, f"feature_flow_attn.{n}")
    _conv(tree["upsampler_0"], out, "upsampler.0")
    _conv(tree["upsampler_2"], out, "upsampler.2")
    return out
