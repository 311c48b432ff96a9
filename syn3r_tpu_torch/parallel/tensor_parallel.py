"""Tensor-parallel (Megatron pattern) SVD UNet over the cards of one mesh
axis.

Counterpart of ``syn3r_tpu/parallel/tensor_parallel.py``, with the same
rule over the port's diffusers state-dict names (torch Linear weights are
(out, in)):

  - column-parallel (output features split): ``to_q``, ``to_k``, ``to_v``
    and the FF in-projection (``ff.net.0.proj`` and ``ff_in.net.0.proj``,
    with its bias): each device computes a disjoint set of heads or GEGLU
    units, no communication;
  - row-parallel (input features split): ``to_out.0`` and the FF
    out-projection (``net.2``): each device contracts its slice, the
    partial sums are added on the first device in device order (the
    all-reduce) and the bias once;
  - replicated: convolutions, norms, embeddings and the rest. They run on
    the first device, where the UNet module itself lives.

JAX splits each axis evenly (GSPMD pads). Here attention splits by whole
heads, the first shards one head larger where they do not divide (SVD-XT's
level 1 has 5: 3 + 2 over 2, 2 + 1 + 1 + 1 over 4), and the out-projection
by the same heads. The GEGLU in-projection's value and gate halves are
split by the same unit ranges, so each shard's fused GEGLU kernel computes
whole units (JAX's straight split of the 2 inner axis crosses the halves
and costs a collective-permute); units go in groups of 8, the kernel's
width rule (``ops/geglu_ffn.check_geglu_args``; a UNet's 4C units are a
multiple of 128), so SVD-XT's 1280 / 2560 / 5120 units split 2- and
4-way into shards it takes. The numbers are JAX's.
Cross-attention (``attn2``, one key token) keeps its plain path, per shard.
"""

from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

from ..models import layers as L
from .mesh import Mesh, Placement, split_sizes, sum_in_order, to_device

_COL = (".to_q.weight", ".to_k.weight", ".to_v.weight")
_FF = (".ff.", ".ff_in.")


def unet_tp_shardings(module: nn.Module, mesh: Mesh,
                      axis: str = "model") -> dict[str, Placement]:
    """{parameter name: Placement} of the Megatron rule for a UNet's
    state dict: ``(axis, None)`` column-parallel, ``(None, axis)``
    row-parallel, ``(axis,)`` the column-parallel FF bias, ``()``
    replicated."""
    mesh.axis_index(axis)
    params = module.state_dict()
    col, row = Placement(mesh, (axis, None)), Placement(mesh, (None, axis))
    out = {}
    for name, t in params.items():
        n = "." + name
        spec = Placement(mesh, ())
        ff = any(f in n for f in _FF)
        if t.dim() == 2:
            if n.endswith(_COL) or (ff and n.endswith(".proj.weight")):
                spec = col
            elif n.endswith(".to_out.0.weight") or (
                    ff and n.endswith(".net.2.weight")):
                spec = row
        elif t.dim() == 1 and ff and n.endswith(".proj.bias"):
            spec = Placement(mesh, (axis,))
        out[name] = spec
    return out


def _ranges(sizes: list, unit: int = 1) -> list:
    out, a = [], 0
    for n in sizes:
        out.append((a * unit, (a + n) * unit))
        a += n
    return out


def _head_ranges(heads: int, dim_head: int, parts: int) -> list:
    return _ranges(split_sizes(heads, parts), dim_head)


def _unit_ranges(inner: int, parts: int) -> list:
    return _ranges(split_sizes(inner // 8, parts), 8)


def _attention_shards(mod: L.Attention, devices) -> list:
    """Per device, ``Attention.attend``'s shard: its heads' to_q / to_k /
    to_v rows, to_out columns."""
    out = []
    for dev, (a, b) in zip(devices, _head_ranges(mod.heads, mod.dim_head,
                                                 len(devices))):
        sh = {"heads": (b - a) // mod.dim_head}
        for name in ("to_q", "to_k", "to_v"):
            lin = getattr(mod, name)
            sh[name] = (lin.weight.detach()[a:b].to(dev),
                        None if lin.bias is None
                        else lin.bias.detach()[a:b].to(dev))
        sh["to_out"] = (mod.to_out[0].weight.detach()[:, a:b].contiguous()
                        .to(dev), None)
        out.append(sh)
    return out


def _ff_shards(mod: L.FeedForward, devices) -> list:
    """Per device: its GEGLU units' value and gate rows of the
    in-projection (and bias), the out-projection's columns."""
    p1, p2 = mod.net[0].proj, mod.net[2]
    inner = p2.in_features
    out = []
    for dev, (a, b) in zip(devices, _unit_ranges(inner, len(devices))):
        rows = torch.cat([torch.arange(a, b), inner + torch.arange(a, b)])
        rows = rows.to(p1.weight.device)
        out.append({"w1": p1.weight.detach()[rows].to(dev),
                    "b1": p1.bias.detach()[rows].to(dev),
                    "w2": p2.weight.detach()[:, a:b].contiguous().to(dev),
                    "b2": torch.zeros_like(p2.bias.detach()).to(dev)})
    return out


def _attend_split(mod: L.Attention, shards, devices, home):
    """``Attention.attend`` with its heads split over ``devices``: each
    device's partial, summed in device order, to_out's bias added once."""
    def attend(x, context=None):
        parts = [L.Attention.attend(
            mod, to_device(x, dev),
            None if context is None else to_device(context, dev), sh)
            for dev, sh in zip(devices, shards)]
        out = sum_in_order(parts, home)
        return out + mod.to_out[0].bias.to(out.dtype)
    return attend


def _ff_split(mod: L.FeedForward, shards, devices, home):
    """``FeedForward.forward`` with its GEGLU units split over
    ``devices``: one GEGLU launch a shard (zero bias), the partials summed
    in device order, the out-projection's bias added once."""
    def forward(x):
        c = x.shape[-1]
        x2 = x.reshape(-1, c)
        parts = [L.geglu_ffn(to_device(x2, dev), sh["w1"], sh["b1"],
                             sh["w2"], sh["b2"])
                 for dev, sh in zip(devices, shards)]
        y = sum_in_order(parts, home)
        y = y + mod.net[2].bias.to(y.dtype)
        return y.reshape(x.shape[:-1] + (c,))
    return forward


class TensorParallelUNet(nn.Module):
    """A UNet whose attention and FF weights are split over the devices
    of ``mesh``'s ``axis``; called as the UNet is. ``self.unet`` is a copy
    of the UNet's module tree that shares its tensors (the UNet itself is
    left as it is): it runs the replicated rest on the first device, and
    its Attention and FeedForward modules sum their shards' partials
    (``Attention.attend`` over each shard's heads; the GEGLU kernel over
    each shard's units). Each shard is a copy of its slice on its device
    (``params_tp``)."""

    def __init__(self, mesh: Mesh, unet: nn.Module, axis: str = "model"):
        super().__init__()
        self.devices = mesh.along(axis)
        self.home = self.devices[0]
        if next(unet.parameters()).device != self.home:
            raise ValueError(f"the UNet lives on "
                             f"{next(unet.parameters()).device}, the mesh's "
                             f"first device is {self.home}")
        shared = {id(t): t for t in itertools.chain(unet.parameters(),
                                                    unet.buffers())}
        self.unet = copy.deepcopy(unet, shared)
        self.params_tp = {}
        for name, mod in self.unet.named_modules():
            if isinstance(mod, L.Attention):
                shards = _attention_shards(mod, self.devices)
                mod.attend = _attend_split(mod, shards, self.devices,
                                           self.home)
                for k in ("to_q", "to_k", "to_v", "to_out"):
                    key = "to_out.0" if k == "to_out" else k
                    self.params_tp[f"{name}.{key}.weight"] = [
                        sh[k][0] for sh in shards]
            elif isinstance(mod, L.FeedForward):
                shards = _ff_shards(mod, self.devices)
                mod.forward = _ff_split(mod, shards, self.devices, self.home)
                for key, k in (("net.0.proj.weight", "w1"),
                               ("net.0.proj.bias", "b1"),
                               ("net.2.weight", "w2")):
                    self.params_tp[f"{name}.{key}"] = [sh[k] for sh in shards]
        for name, t in unet.state_dict().items():
            self.params_tp.setdefault(name, t)

    def forward(self, *args, **kwargs):
        if kwargs.get("remat_blocks"):
            raise ValueError("the tensor-parallel UNet runs forwards only; "
                             "guidance_through_unet needs the whole UNet "
                             "on one card")
        return self.unet(*args, **kwargs)


def make_tp_unet_forward(mesh: Mesh, unet: nn.Module, params=None,
                         axis: str = "model"):
    """A tensor-parallel UNet forward over ``mesh``'s ``axis``. Returns
    (run, params_tp): ``run(sample, t, ehs, tids, batch_groups=None)`` is
    the UNet's call with its attention and FF weights split (output on
    the first device), ``params_tp`` {name: the per-device shards of a
    split weight, or the replicated tensor}. ``params`` (a state dict) is
    loaded into ``unet`` first; the module holds its weights."""
    if params is not None:
        unet.load_state_dict(params)
    run = TensorParallelUNet(mesh, unet, axis)
    return run, run.params_tp
