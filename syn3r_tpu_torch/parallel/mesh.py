"""Device meshes and placements for one process that drives several cards.

Counterpart of ``syn3r_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process holds a mesh of devices and a sharding
places work on it. So is the port: a ``Mesh`` is a numpy array of
``torch.device`` entries with axis names, a ``Placement`` (JAX's
``NamedSharding``) names the mesh axis each tensor dimension is split
over, and a collective is a stream-ordered copy between cards
(``Tensor.to(device, non_blocking=True)``) followed by a sum in a fixed
order. Every card's work is issued from the one host thread, so all of a
card's kernels stay on its current stream.

A mesh may name one device more than once: N entries of ``cpu`` run the
N-way code on the CPU (the tests), N entries of ``cuda:0`` run it on one
card. With ``devices=None`` the devices are the visible cards.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def visible_devices() -> list[torch.device]:
    """The visible cards, in ordinal order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices) -> list[torch.device]:
    return [torch.device(d) for d in (visible_devices() if devices is None
                                      else devices)]


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(arr[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {arr.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: extent}, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        return self.axis_names.index(axis)

    def along(self, axis: str, at: Optional[dict] = None
              ) -> list[torch.device]:
        """The devices along ``axis``, the other axes at the indices ``at``
        gives ({name: index}, 0 where it gives none)."""
        self.axis_index(axis)
        at = at or {}
        idx = tuple(slice(None) if name == axis else at.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh (JAX's ``NamedSharding``): ``spec`` has
    one entry per leading tensor dimension, the mesh axis that dimension is
    split over or None; an empty spec is replicated."""
    mesh: Mesh
    spec: tuple = ()

    @property
    def leading_axis(self) -> Optional[str]:
        return self.spec[0] if self.spec else None

    @property
    def shards(self) -> int:
        """The pieces the leading dimension is split into (1 when it is
        not split): ``orchestrator._leading_axis_shards`` of JAX."""
        axis = self.leading_axis
        return 1 if axis is None else self.mesh.shape[axis]

    def slot_devices(self, slot: int) -> list[torch.device]:
        """The devices that hold slot ``slot`` of the leading dimension:
        the mesh at that index of the leading axis, flattened in mesh
        order (one row of a (pair, dir) mesh for the pair placement)."""
        axis = self.leading_axis
        if axis is None:
            return list(self.mesh.devices.flat)
        return list(np.take(self.mesh.devices, [slot],
                            axis=self.mesh.axis_index(axis)).flat)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              devices=None) -> Mesh:
    """A 1-d mesh over ``devices`` (the visible cards by default), the
    first ``n_devices`` of them."""
    devs = _device_list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


def make_mesh_2d(n_a: int, n_b: int, axes=("dir", "model"),
                 devices=None) -> Mesh:
    """A 2-d mesh for composed parallelism, e.g. (dir=2, model=4): the
    guided denoise's directions over ``axes[0]``, each direction's UNet
    tensor-parallel over ``axes[1]`` (``diffusion/pipeline.py``)."""
    devs = _device_list(devices)
    if len(devs) < n_a * n_b:
        raise ValueError(f"a ({n_a}, {n_b}) mesh needs {n_a * n_b} devices, "
                         f"got {len(devs)}")
    arr = np.empty((n_a, n_b), dtype=object)
    for i, d in enumerate(devs[:n_a * n_b]):
        arr[i // n_b, i % n_b] = d
    return Mesh(arr, axes)


def make_scene_topology(devices=None):
    """The within-scene placement of ``--scene_parallel``: a (pair, dir)
    mesh where each (view pair, direction) of a completion wave runs on
    its own device. With fewer than 2 devices (None, None); else
    ``pairs = d // 2`` rows when d >= 4 (1 otherwise) of 2 devices, and
    the pair placement (``DiffusionGSConfig.pair_sharding``) and the dir
    placement (``GuidedSVDConfig.direction_sharding``) on it."""
    devs = _device_list(devices)
    d = len(devs)
    if d < 2:
        return None, None
    pairs = d // 2 if d >= 4 else 1
    arr = np.empty((pairs, 2), dtype=object)
    for i, dev in enumerate(devs[:pairs * 2]):
        arr[i // 2, i % 2] = dev
    mesh = Mesh(arr, ("pair", "dir"))
    return sharded(mesh, "pair"), sharded(mesh, "dir")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def sharded(mesh: Mesh, axis_name: str = "data") -> Placement:
    """The leading dimension split over ``axis_name``."""
    mesh.axis_index(axis_name)
    return Placement(mesh, (axis_name,))


def module_replicas(module: torch.nn.Module,
                    devices) -> dict[torch.device, torch.nn.Module]:
    """{device: module}: ``module`` itself on its own device, a copy of it
    (the same weights) on each other device of ``devices``, one a device
    however often the list names it."""
    home = next(module.parameters()).device
    out = {}
    for dev in devices:
        dev = torch.device(dev)
        if dev not in out:
            out[dev] = (module if dev == home
                        else copy.deepcopy(module).to(dev))
    return out


def split_sizes(n: int, parts: int) -> list[int]:
    """``n`` items over ``parts`` pieces, the first ``n % parts`` one
    larger: 25 frames over 2 are 13 + 12, 5 heads over 4 are 2 + 1 + 1 +
    1."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (``x`` itself when it is there already). A copy
    to a card is stream-ordered and does not block the host; a copy to the
    host waits for it, so the result can be read at once."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


def sum_in_order(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in list order: the port's
    all-reduce, the same order on every run."""
    total = to_device(parts[0], device)
    for p in parts[1:]:
        total = total + to_device(p, device)
    return total
