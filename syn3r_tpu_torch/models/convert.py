"""Bridge from the JAX package's flax param trees to the torch modules.

The flax modules name their submodules after the diffusers / HF state-dict
layout, so every key of a torch module's ``state_dict()`` has one flax
path, found by the forward rule the JAX package converts checkpoints with
(``syn3r_tpu/models/convert.py`` for the UNet and VAE: numeric segments
merge into their parent, ``weight`` becomes ``kernel`` or ``scale``;
``syn3r_tpu/models/clip.py:convert_clip_torch`` for CLIP). The array at
that path is transposed back (HWIO -> OIHW, (kt,kh,kw,I,O) -> OIDHW,
IO -> OI) and loaded. Flax names are never inverted textually:
``linear_1``, ``to_out_0`` and ``down_blocks_0`` look alike.
"""

from __future__ import annotations

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
