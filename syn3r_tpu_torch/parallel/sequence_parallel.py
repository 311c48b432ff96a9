"""Sequence-parallel (frame-axis) SVD UNet over the cards of one mesh axis.

Counterpart of ``syn3r_tpu/parallel/sequence_parallel.py``. The SVD
"sequence" is the 25-frame axis. Each device holds a replica of the UNet
and a contiguous run of frames (F need not divide the extent: 25 over 2 is
13 + 12, the first shards one frame larger; JAX pads instead, the numbers
are the same).

Each shard runs the UNet's own forward on its frames: the generator
``UNetSpatioTemporalConditionModel.steps`` of its replica, all shards in
lock-step from the one host thread. Frame-local work (conv_in and
conv_out, the spatial resnets, the 2D convolutions, down- and upsampling,
the spatial transformer blocks, every FF) runs as it is. The forward
yields its frame-coupled calls (``layers.run_local``), and this module
makes each across the shards:

  - the temporal resnet's GroupNorms reduce over F x H x W: each shard's
    per-(B, C) sums of x and x^2 (the stats kernel's sums launch,
    ``ops/norm.group_norm_sums``) are added on the first device in shard
    order and folded once to the affine, which the apply kernel takes on
    each shard;
  - its (3, 1, 1) convolutions read one halo frame from each neighbouring
    shard (zeros at the clip's ends);
  - the temporal transformer's self-attention takes each shard's queries
    against all shards' frames (the normalized inputs of every shard as
    its context);
  - the frame ids of the temporal position embedding are global.

The temporal cross-attention's context is frame 0's, the CLIP embedding
every shard holds, and frame shards of a batch element stay in its (B, F)
order, so ``batch_groups``' time-context quirk is each shard's as in the
whole forward.

The forward's spans (``utils.profiling.span``) open and close inside the
shards' generators, so under a profiler the shards' spans overlap instead
of nesting, and a call made across the shards is linked to the last
shard's innermost span.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import layers as L
from ..models import svd_unet as U
from ..ops import norm as N
from .mesh import Mesh, module_replicas, split_sizes, sum_in_order, to_device


def _gn_sharded(norms, xs):
    """GroupNorm over (B, F, H, W, C) shards with the statistics of all
    frames: each shard's sums, added in shard order on the first device
    and folded; the apply kernel on each shard."""
    gn = norms[0]
    b, c = xs[0].shape[0], xs[0].shape[-1]
    x3s = [N.contiguous_counted(x).view(b, -1, c) for x in xs]
    sums = sum_in_order([N.group_norm_sums(x3) for x3 in x3s], xs[0].device)
    a, shift = N.group_norm_affine_from_sums(
        sums, sum(x3.shape[1] for x3 in x3s), gn.weight, gn.bias,
        gn.num_groups, gn.eps)
    return [N.group_norm_apply(x3, to_device(a, x3.device),
                               to_device(shift, x3.device),
                               gn.silu).view(x.shape)
            for x3, x in zip(x3s, xs)]


def _tconv_sharded(convs, xs):
    """A (3, 1, 1) convolution over (B, F, H, W, C) shards, each shard
    padded with its neighbours' edge frames (zeros at the clip's ends)."""
    out = []
    for k, (conv, x) in enumerate(zip(convs, xs)):
        left = (to_device(xs[k - 1][:, -1:], x.device) if k > 0
                else torch.zeros_like(x[:, :1]))
        right = (to_device(xs[k + 1][:, :1], x.device) if k + 1 < len(xs)
                 else torch.zeros_like(x[:, :1]))
        xp = torch.cat([left, x, right], dim=1).permute(0, 4, 1, 2, 3)
        b = None if conv.bias is None else conv.bias.to(x.dtype)
        y = F.conv3d(xp, conv.weight.to(x.dtype), b, conv.stride,
                     (0,) + tuple(conv.padding[1:]), conv.dilation,
                     conv.groups)
        out.append(y.permute(0, 2, 3, 4, 1))
    return out


def _across_shards(calls, offsets):
    """The results, one a shard, of one frame-coupled call that every
    shard's forward yielded as ``(fn, *args)``."""
    fn = calls[0][0]
    mods = [c[0] for c in calls]
    xs = [c[1] for c in calls]
    if fn is L.frame_ids:
        return [torch.arange(f0, f0 + f, device=dev).repeat(b)
                for (_, f, b, dev), f0 in zip(calls, offsets)]
    if isinstance(fn, L.GroupNorm):
        return _gn_sharded(mods, xs)
    if isinstance(fn, L.Conv3d):
        return _tconv_sharded(mods, xs)
    if isinstance(fn, L.Attention):
        return [m(x, torch.cat([to_device(t, x.device) for t in xs], dim=1))
                for m, x in zip(mods, xs)]
    raise TypeError(f"no frame-sharded form of {fn!r}")


def _lockstep(gens, offsets):
    """Runs the shards' forward generators together, each frame-coupled
    call made across the shards; returns their results."""
    sent = [None] * len(gens)
    while True:
        calls, done = [], []
        for g, v in zip(gens, sent):
            try:
                calls.append(g.send(v))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if calls:
                raise RuntimeError("frame shards left the forward at "
                                   "different calls")
            return done
        sent = _across_shards(calls, offsets)


class SequenceParallelUNet:
    """A UNet forward with the frame axis split over the devices of
    ``mesh``'s ``axis``: a replica of the UNet on each device (the module
    itself on its own), one run of frames each. Called as the UNet is;
    returns (B, F, H, W, 4) on the first device."""

    def __init__(self, mesh: Mesh, unet: U.UNetSpatioTemporalConditionModel,
                 axis: str = "seq"):
        self.devices = mesh.along(axis)
        reps = module_replicas(unet, self.devices)
        self.replicas = [reps[d] for d in self.devices]

    def __call__(self, sample, timestep, encoder_hidden_states,
                 added_time_ids, batch_groups=None):
        n = len(self.replicas)
        f = sample.shape[1]
        if f < n:
            raise ValueError(f"{f} frames over {n} devices")
        frames = split_sizes(f, n)
        offsets = [sum(frames[:k]) for k in range(n)]
        gens = [u.steps(to_device(sample[:, f0:f0 + fk], dev), timestep,
                        to_device(encoder_hidden_states, dev),
                        to_device(added_time_ids, dev), batch_groups)
                for u, dev, f0, fk in zip(self.replicas, self.devices,
                                          offsets, frames)]
        outs = _lockstep(gens, offsets)
        home = self.devices[0]
        return torch.cat([to_device(o, home) for o in outs], dim=1)


def make_sp_unet_forward(mesh: Mesh, unet, params=None, axis: str = "seq"):
    """A frame-sharded UNet forward over ``mesh``'s ``axis``:
    ``run(sample, t, ehs, tids, batch_groups=None)``, sample (B, F, H, W,
    C) split over F (F at least the extent), the output gathered on the
    first device. ``params`` (a state dict) is loaded into ``unet`` first;
    the replicas are copies of it."""
    if params is not None:
        unet.load_state_dict(params)
    return SequenceParallelUNet(mesh, unet, axis)
