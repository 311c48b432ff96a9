"""The generator of the GS refine's traffic: a mix's parameters
(``traffic/<name>.json`` of kind ``gs``), the configuration's ``scene``
and a seed in; the views, targets and start cloud of one run out.

- **Truth scene**: ``scene.truth_gaussians`` Gaussians on surfaces in front
  of a forward-facing rig: a back wall (a height field across the rig's
  view, ``wall_share`` of them) and ``objects`` spheres, each Gaussian a
  flat disc tangent to its surface (tangential scale from the surface area
  over its count, normal scale ``thickness`` of it), with a smooth random
  texture, SH rest N(0, ``sh_rest_std``^2) and opacity logits
  N(``opacity_logit``).
- **Train views**: ``scene.train_views`` cameras on an ellipse of radius
  ``rig_radius`` in the plane z = 0, each looking at a jittered point
  ``rig_depth`` ahead (LLFF's forward-facing layout), focal
  ``scene.focal`` pixels.
- **Pseudo views**: for each of the wrap-around pairs of train cameras in
  nearest-neighbour order, ``scene.frames`` look-at cameras whose eye and
  target move in a straight line from one to the other; each pair's last
  frame (the next pair's first) is dropped.
- **Targets**: the train views rendered from the truth, the pseudo views
  from a perturbed copy of it (colours N(0, ``pseudo_colour_std``^2),
  centres N(0, (``pseudo_position_std`` x tangential scale)^2)), which
  stands in for the diffused frames' disagreement with the inputs; both by
  the reference's renderer (``reference/gs.py``), never the program's.
- **Start cloud**: ``sparse_points`` truth centres, each moved by
  N(0, (``sparse_noise`` x its tangential scale)^2), with the truth's DC
  colour: an SfM-like sparse cloud.

The layout (the wall's shape, the objects' places and sizes, the colours'
bases and texture waves, the rig's angles and jitter) is drawn from the
mix's ``layout_seed``: a fixed scene, like the cell's frame size. Every
Gaussian, its texture samples and perturbations and the start cloud are
drawn from the run's seed. Every draw is made on the device by a
``torch.Generator``, in a few large calls; every seed gives the same
counts and the same scene, so seeds change values and not the work.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from reference import gs as ref

from .weights import sub_seed


@dataclasses.dataclass
class Scene:
    truth: dict            # reference state fields: params, active
    train_cams: list       # reference camera dicts
    pseudo_cams: list
    train_images: torch.Tensor    # (V, H, W, 3)
    pseudo_images: torch.Tensor   # (P, H, W, 3)
    cloud_xyz: torch.Tensor       # (S, 3)
    cloud_rgb: torch.Tensor       # (S, 3)


def look_at(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """w2c (4, 4) of a camera at ``eye`` looking at ``target``: +z forward,
    +y down (OpenCV), world -y up."""
    fwd = target - eye
    fwd = fwd / fwd.norm()
    up = torch.tensor([0.0, -1.0, 0.0], device=eye.device)
    right = -torch.linalg.cross(up, fwd)
    right = right / right.norm()
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd])
    w2c = torch.eye(4, device=eye.device)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def camera(scene: dict, w2c: torch.Tensor, confidence: float) -> dict:
    f = scene["focal"]
    w, h = scene["width"], scene["height"]
    K = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]],
                     device=w2c.device)
    return {"K": K, "w2c": w2c, "width": w, "height": h,
            "confidence": torch.tensor(float(confidence), device=w2c.device)}


def nearest_neighbour_order(eyes: torch.Tensor) -> list:
    """Greedy nearest-neighbour tour of the camera centres from camera 0."""
    order, todo = [0], set(range(1, len(eyes)))
    while todo:
        cur = eyes[order[-1]]
        nxt = min(todo, key=lambda j: float((eyes[j] - cur).norm()))
        order.append(nxt)
        todo.remove(nxt)
    return order


def _quat_mul(a, b):
    aw, av = a[:, :1], a[:, 1:]
    bw, bv = b[:, :1], b[:, 1:]
    return torch.cat([aw * bw - (av * bv).sum(-1, keepdim=True),
                      aw * bv + bw * av + torch.linalg.cross(av, bv)], -1)


def _discs(gen, normal, tangential, thickness):
    """Raw quaternions and log-scales of discs with these unit normals
    (N, 3; n_z < 1) and tangential scales (N,): the rotation taking -z to
    the normal, turned about it by a random angle."""
    n = normal
    align = torch.stack([1.0 - n[:, 2], n[:, 1], -n[:, 0],
                         torch.zeros_like(n[:, 0])], -1)
    align = align / align.norm(dim=-1, keepdim=True)
    psi = torch.rand(len(n), generator=gen, device=n.device) * math.pi
    spin = torch.stack([torch.cos(psi), torch.zeros_like(psi),
                        torch.zeros_like(psi), torch.sin(psi)], -1)
    quats = _quat_mul(align, spin)
    s = tangential[:, None] * torch.stack(
        [torch.ones_like(tangential), torch.ones_like(tangential),
         torch.full_like(tangential, thickness)], -1)
    return quats, torch.log(s)


def truth_scene(traffic: dict, scene: dict, sh_degree: int, gen, lay,
                device) -> tuple:
    """(params of the truth, tangential scales (N,)): the layout (the
    wall's shape, the objects' places and sizes, the colours' bases and
    textures) drawn from ``lay``, every Gaussian from ``gen``."""
    n = scene["truth_gaussians"]
    f, w, h = scene["focal"], scene["width"], scene["height"]
    n_wall = int(round(traffic["wall_share"] * n))
    m = traffic["objects"]
    per = [(n - n_wall) // m] * m
    per[-1] += n - n_wall - sum(per)

    def uniform(lo, hi, *shape, g=gen):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    # the back wall: a height field over 1.3x the rig's view
    d0, d1 = traffic["wall_depth"]
    span_x, span_y = 1.3 * 0.5 * w / f, 1.3 * 0.5 * h / f
    u, v = uniform(-span_x, span_x, n_wall), uniform(-span_y, span_y, n_wall)
    ku, kv, ph = uniform(1.0, 3.0, 3, g=lay), uniform(1.0, 3.0, 3, g=lay), \
        uniform(0.0, 2 * math.pi, 3, g=lay)
    depth = 0.5 * (d0 + d1) + 0.5 * (d1 - d0) * torch.sin(
        ku[0] * u + kv[0] * v + ph[0])
    wall = torch.stack([u * depth, v * depth, depth], -1)
    # normal of the surface z = depth(x/z, y/z), near -z
    g = 0.5 * (d1 - d0) * torch.cos(ku[0] * u + kv[0] * v + ph[0])
    wall_n = torch.stack([g * ku[0] / depth, g * kv[0] / depth,
                          -torch.ones_like(u)], -1)
    wall_n = wall_n / wall_n.norm(dim=-1, keepdim=True)
    area = (2 * span_x * d1) * (2 * span_y * d1)
    wall_t = math.sqrt(area / max(n_wall, 1)) * uniform(0.6, 1.2, n_wall)
    # the objects: front hemispheres (normals with n_z <= 0.2)
    o0, o1 = traffic["object_depth"]
    r0, r1 = traffic["object_radius"]
    zc = uniform(o0, o1, m, g=lay)
    centres = torch.stack([uniform(-0.8, 0.8, m, g=lay) * span_x * zc / 1.3,
                           uniform(-0.8, 0.8, m, g=lay) * span_y * zc / 1.3,
                           zc], -1)
    radii = uniform(r0, r1, m, g=lay)
    k = sum(per)
    owner = torch.repeat_interleave(torch.arange(m, device=device),
                                    torch.tensor(per, device=device))
    dirs = torch.randn((k, 3), generator=gen, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    dirs = torch.where(dirs[:, 2:3] > 0.2,
                       dirs * torch.tensor([1.0, 1.0, -1.0], device=device),
                       dirs)
    obj = centres[owner] + radii[owner, None] * dirs
    counts = torch.tensor(per, device=device, dtype=torch.float32)
    obj_t = torch.sqrt(2 * math.pi * radii ** 2 / counts)[owner] \
        * uniform(0.6, 1.2, k)
    means = torch.cat([wall, obj])
    normals = torch.cat([wall_n, dirs])
    tangential = torch.cat([wall_t, obj_t])
    quats, log_scales = _discs(gen, normals, tangential, traffic["thickness"])
    # colour: a per-surface base and two sinusoidal textures in space
    base = uniform(0.15, 0.85, m + 1, 3, g=lay)
    owner_all = torch.cat([torch.full((n_wall,), m, device=device), owner])
    k1, k2 = (uniform(-1.0, 1.0, 2, 3, 3, g=lay)
              * traffic["texture_frequency"]).unbind(0)
    p1, p2 = uniform(0.0, 2 * math.pi, 2, 3, g=lay).unbind(0)
    rgb = (base[owner_all] + 0.25 * torch.sin(means @ k1 + p1)
           + 0.12 * torch.sin(means @ k2 + p2)).clamp(0.02, 0.98)
    mu, sd = traffic["opacity_logit"]
    params = {
        "means": means, "quats": quats, "log_scales": log_scales,
        "opacity_logits": mu + sd * torch.randn((n, 1), generator=gen,
                                                device=device),
        "sh_dc": ((rgb - 0.5) / ref.SH_C0)[:, None, :],
        "sh_rest": traffic["sh_rest_std"] * torch.randn(
            (n, 3 * ((sh_degree + 1) ** 2 - 1)), generator=gen,
            device=device),
    }
    return params, tangential


def rig(traffic: dict, scene: dict, lay, device) -> tuple:
    """(train camera dicts, pseudo camera dicts), drawn from ``lay``."""
    v = scene["train_views"]
    ang = (2 * math.pi * torch.arange(v, device=device) / v
           + 0.3 * torch.randn(v, generator=lay, device=device))
    rad = traffic["rig_radius"]
    eyes = torch.stack([rad * torch.cos(ang), 0.75 * rad * torch.sin(ang),
                        torch.zeros_like(ang)], -1)
    jit = traffic["rig_jitter"] * torch.randn((v, 2), generator=lay,
                                              device=device)
    targets = torch.stack([jit[:, 0], jit[:, 1],
                           torch.full_like(ang, traffic["rig_depth"])], -1)
    train = [camera(scene, look_at(eyes[i], targets[i]), 1.0)
             for i in range(v)]
    order = nearest_neighbour_order(eyes)
    fr = scene["frames"]
    s = torch.linspace(0.0, 1.0, fr, device=device)[:-1, None]
    pseudo = []
    for a, b in zip(order, order[1:] + order[:1]):
        e = (1 - s) * eyes[a] + s * eyes[b]
        t = (1 - s) * targets[a] + s * targets[b]
        pseudo += [camera(scene, look_at(e[i], t[i]),
                          scene["cam_confidence"]) for i in range(fr - 1)]
    return train, pseudo


def make_scene(traffic: dict, scene: dict, train: dict, seed: int,
               device) -> Scene:
    """The run's views, targets and start cloud (see the module
    docstring)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "gs_scene"))
    lay = torch.Generator(device=device).manual_seed(sub_seed(
        traffic["layout_seed"], "gs_layout"))
    params, tangential = truth_scene(traffic, scene, train["sh_degree"],
                                     gen, lay, device)
    n = params["means"].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=device)
    train_cams, pseudo_cams = rig(traffic, scene, lay, device)
    perturbed = dict(params)
    perturbed["sh_dc"] = params["sh_dc"] + traffic["pseudo_colour_std"] \
        / ref.SH_C0 * torch.randn((n, 1, 3), generator=gen, device=device)
    perturbed["means"] = params["means"] + traffic["pseudo_position_std"] \
        * tangential[:, None] * torch.randn((n, 3), generator=gen,
                                            device=device)
    pick = torch.randperm(n, generator=gen, device=device)[
        :traffic["sparse_points"]]
    xyz = params["means"][pick] + traffic["sparse_noise"] \
        * tangential[pick, None] * torch.randn((len(pick), 3), generator=gen,
                                               device=device)
    rgb = (ref.SH_C0 * params["sh_dc"][pick, 0] + 0.5).clamp(0.0, 1.0)

    def images(p, cams):
        return torch.stack([ref.render(p, active, c, train)["rgb"]
                            for c in cams])
    return Scene(truth=dict(params=params, active=active),
                 train_cams=train_cams, pseudo_cams=pseudo_cams,
                 train_images=images(params, train_cams),
                 pseudo_images=images(perturbed, pseudo_cams),
                 cloud_xyz=xyz, cloud_rgb=rgb)
