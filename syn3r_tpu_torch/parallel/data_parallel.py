"""Data-parallel steps over the devices of a mesh axis.

Counterpart of ``syn3r_tpu/parallel/data_parallel.py``:

  - ``make_dp_gs_train_step``: one 3DGS train step over a batch of views.
    The Gaussian state is replicated, the views are split over the data
    axis; each replica renders its views through the trainer's route
    (``TrainConfig.rasterizer``: the composite kernels on the card) and
    takes the gradient of its views' losses summed over V; the gradients
    are summed on the first device in device order (the all-reduce), Adam
    steps once there with the trainer's ``adam_update`` and
    ``position_lr``, and the new parameters are copied back to every
    replica. JAX's step renders with the dense rasterizer whatever the
    config says; the two agree where the config asks for ``"dense"``.
  - ``make_dp_unet_forward``: the UNet's batch split over replicas, the
    outputs concatenated in order. The temporal cross-attention's
    time-context quirk couples the batch's elements; each replica takes
    its rows' contexts from the whole batch (``svd_unet.BatchWindow``),
    as JAX's partitioned program does. JAX traces its plain GEGLU there
    only because GSPMD cannot partition a custom call; a replica takes
    whole rows, so the port keeps the GEGLU kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..gs import losses
from ..gs.trainer import (TrainConfig, TrainState, adam_lrs, adam_update,
                          position_lr)
from ..models import gaussians as G
from ..models.svd_unet import BatchWindow
from ..ops import rasterize as rz
from ..utils.camera import Camera
from .mesh import Mesh, module_replicas, split_sizes, sum_in_order, to_device


def _camera_rows(cams: Camera, a: int, b: int) -> Camera:
    return dataclasses.replace(cams, K=cams.K[a:b], w2c=cams.w2c[a:b],
                               confidence=cams.confidence[a:b])


def _state_to(ts: TrainState, device) -> TrainState:
    return dataclasses.replace(ts, gaussians=ts.gaussians.to(device))


def make_dp_gs_train_step(mesh: Mesh, cfg: TrainConfig, extent: float,
                          axis: str = "data"):
    """A data-parallel GS train step over ``mesh``'s ``axis``. Returns
    (step, prepare):

      - ``prepare(ts, cameras, images)``: the state replicated (a list,
        one ``TrainState`` a device, its Adam state on the first) and the
        views split over the devices (lists of ``Camera`` rows and image
        stacks; V a multiple of the extent, as JAX requires);
      - ``step(ts, cameras, images) -> (ts, loss)``: one Adam step on the
        mean loss over all V views, on prepared operands or, as the
        one-replica step, on a plain ``TrainState``, a stacked ``Camera``
        and (V, H, W, 3) images.
    """
    devices = mesh.along(axis)

    def prepare(ts: TrainState, cameras: Camera, images: torch.Tensor):
        v = images.shape[0]
        if v % len(devices):
            raise ValueError(f"{v} views over {len(devices)} devices")
        bounds = [0]
        for n in split_sizes(v, len(devices)):
            bounds.append(bounds[-1] + n)
        return ([_state_to(ts, d) for d in devices],
                [_camera_rows(cameras, a, b).to(d)
                 for a, b, d in zip(bounds, bounds[1:], devices)],
                [to_device(images[a:b], d)
                 for a, b, d in zip(bounds, bounds[1:], devices)])

    def step(ts, cameras, images):
        if isinstance(ts, TrainState):           # one replica
            ts, cameras, images = [ts], [cameras], [images]
        v = sum(im.shape[0] for im in images)
        home = ts[0].gaussians.means.device
        names = None
        grads, losses_ = [], []
        # every replica's forward and backward, issued in device order
        for rep, cams, imgs in zip(ts, cameras, images):
            dev = imgs.device
            params = {k: p.detach().requires_grad_(True)
                      for k, p in G.get_params(rep.gaussians).items()}
            names = list(params)
            st = G.with_params(rep.gaussians, params)
            bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
            loss = 0.0
            for i in range(imgs.shape[0]):
                cam = cams.at(i)
                out = rz.render(st, cam, sh_degree=cfg.sh_degree, bg=bg,
                                chunk=cfg.chunk, method=cfg.rasterizer,
                                tile_cap=cfg.tile_cap)
                loss = loss + losses.photometric_loss(
                    out.rgb, imgs[i], lambda_dssim=cfg.lambda_dssim,
                    confidence=cam.confidence)
            loss = loss / v
            grads.append(torch.autograd.grad(loss,
                                             [params[k] for k in names]))
            losses_.append(loss.detach())
        total = {k: sum_in_order([g[i] for g in grads], home)
                 for i, k in enumerate(names)}
        lr = adam_lrs(cfg, position_lr(cfg, extent, ts[0].step))
        with torch.no_grad():
            new_params, new_adam = adam_update(
                G.get_params(ts[0].gaussians), total, ts[0].adam, lr)
        new = []
        for rep in ts:
            dev = rep.gaussians.means.device
            g = G.with_params(rep.gaussians, {
                k: to_device(p, dev) for k, p in new_params.items()})
            new.append(TrainState(gaussians=g, adam=new_adam,
                                  stats=rep.stats, step=rep.step + 1))
        loss = sum_in_order(losses_, home)
        return (new[0] if len(new) == 1 else new), loss

    return step, prepare


def make_dp_unet_forward(mesh: Mesh, unet, params=None, axis: str = "data"):
    """A batch-split UNet forward over ``mesh``'s ``axis``: ``run(sample,
    t, ehs, tids, batch_groups=None)`` with sample (B, F, h, w, 8), B
    split over replicas of
    ``unet`` (the first ones one row larger where B does not divide), the
    outputs concatenated on the first device. ``params`` (a state dict) is
    loaded into ``unet`` first; the replicas are copies of it."""
    if params is not None:
        unet.load_state_dict(params)
    devices = mesh.along(axis)
    reps = module_replicas(unet, devices)

    def run(sample, t, ehs, tids, batch_groups=None):
        b = sample.shape[0]
        groups = tuple(batch_groups) if batch_groups is not None else (b,)
        outs, a = [], 0
        for dev, n in zip(devices, split_sizes(b, len(devices))):
            if n:
                # the rows' time context is the whole batch's
                window = BatchWindow(groups, a, to_device(ehs, dev))
                outs.append(reps[dev](to_device(sample[a:a + n], dev), t,
                                      to_device(ehs[a:a + n], dev),
                                      to_device(tids[a:a + n], dev),
                                      window))
            a += n
        return torch.cat([to_device(o, devices[0]) for o in outs])

    return run
