"""Faults planted in the GS program for the check to catch: each is a
function of the original method or function (a ``GSTrainer`` method, a
loss of ``gs.losses``, ``ops.rasterize.rasterize_tiled``, a method of the
LPIPS module) that returns the faulty replacement. The first four are the
cell's own (Adam's moments, the depth term, the densify statistics, the
growth); the next three are the faults any training cell can have (a step
that returns its state unchanged, half the batch left out with the mean
over the rest, an answer altered where it is made); one card, so no
exchange between cards can be left out. The last two (``LPIPS_FAULTS``)
are the LPIPS term's, and only a configuration with an ``lpips_weight``
above 0 runs the code they sit in.
``planted(name)`` puts one on the class for the length of a ``with``
block; a fault inside the captured step (all but the densify and growth
ones) reaches the card only once a trainer captures again
(``_segments = None``)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def stale_adam_moments(orig):
    """Densify rewrites slots but keeps every Adam moment as it was."""
    def faulty(self, ts):
        return dataclasses.replace(orig(self, ts), adam=ts.adam)
    return faulty


def previous_boundary_stats(orig):
    """Densify reads the statistics the previous boundary read (zeros at
    the first boundary a trainer sees)."""
    def faulty(self, ts):
        from syn3r_tpu_torch.gs.densify import DensifyStats
        prev = getattr(self, "_fault_prev_stats", None)
        self._fault_prev_stats = ts.stats
        if prev is None or prev.grad_accum.shape != ts.stats.grad_accum.shape:
            prev = DensifyStats.zeros(ts.stats.grad_accum.shape[0],
                                      ts.stats.grad_accum.device)
        return orig(self, dataclasses.replace(ts, stats=prev))
    return faulty


def growth_resets_count(orig):
    """Capacity growth starts Adam's count again from 0."""
    def faulty(self):
        before = self.state
        orig(self)
        if self.state is not before:
            self.state = dataclasses.replace(
                self.state, adam=dataclasses.replace(self.state.adam,
                                                     count=0))
    return faulty


def depth_term_dropped(orig):
    """The Pearson depth term of the pseudo views reads 0."""
    def faulty(pred, target, valid=None):
        return torch.zeros((), device=pred.device)
    return faulty


def state_unchanged(orig):
    """The captured step returns its state unchanged (it only moves to the
    next pick)."""
    def faulty(self, b, use_depth, use_lpips):
        b["j"].add_(1)
    return faulty


def half_batch(orig):
    """The photometric loss leaves out half the frame's rows and takes its
    mean over the rest."""
    def faulty(pred, target, lambda_dssim=0.2, confidence=1.0):
        h = pred.shape[0] // 2
        return orig(pred[:h], target[:h], lambda_dssim=lambda_dssim,
                    confidence=confidence)
    return faulty


def render_altered(orig):
    """The rasterizer's answer is altered where it is made: green reads
    blue."""
    def faulty(*args, **kw):
        out = orig(*args, **kw)
        rgb = out.rgb
        return out._replace(rgb=torch.cat([rgb[..., :1], rgb[..., 2:3],
                                           rgb[..., 2:3]], -1))
    return faulty


def lpips_term_dropped(orig):
    """The LPIPS term reads 0."""
    def faulty(self, a, b):
        return a.new_zeros(())
    return faulty


def lpips_tap_dropped(orig):
    """The relu5_3 tap's distance is left out: that tap reads zero in both
    images, so its normalised difference is zero."""
    def faulty(self, x):
        feats = orig(self, x)
        return feats[:-1] + [torch.zeros_like(feats[-1])]
    return faulty


# fault -> (module path of the owner, attribute)
TARGETS = {
    "stale_adam_moments": ("syn3r_tpu_torch.gs.trainer:GSTrainer",
                           "_densify_step"),
    "previous_boundary_stats": ("syn3r_tpu_torch.gs.trainer:GSTrainer",
                                "_densify_step"),
    "growth_resets_count": ("syn3r_tpu_torch.gs.trainer:GSTrainer",
                            "_maybe_grow"),
    "depth_term_dropped": ("syn3r_tpu_torch.gs.losses",
                           "pearson_depth_loss"),
    "state_unchanged": ("syn3r_tpu_torch.gs.trainer:GSTrainer",
                        "_static_step"),
    "half_batch": ("syn3r_tpu_torch.gs.losses", "photometric_loss"),
    "render_altered": ("syn3r_tpu_torch.ops.rasterize", "rasterize_tiled"),
    "lpips_term_dropped": ("syn3r_tpu_torch.models.lpips:LPIPS", "forward"),
    "lpips_tap_dropped": ("syn3r_tpu_torch.models.lpips:VGG16Features",
                          "forward"),
}
FAULTS = {f.__name__: f for f in (stale_adam_moments,
                                  previous_boundary_stats,
                                  growth_resets_count, depth_term_dropped,
                                  state_unchanged, half_batch,
                                  render_altered, lpips_term_dropped,
                                  lpips_tap_dropped)}
LPIPS_FAULTS = ("lpips_term_dropped", "lpips_tap_dropped")


def applicable(train: dict) -> list:
    """The faults whose code a configuration's ``train`` runs."""
    lpips = train.get("lpips_weight", 0) > 0
    return [n for n in FAULTS if lpips or n not in LPIPS_FAULTS]


def owner(name: str):
    import importlib
    path, attr = TARGETS[name]
    module, _, cls = path.partition(":")
    obj = importlib.import_module(module)
    return (getattr(obj, cls) if cls else obj), attr


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place on its owner for the block."""
    obj, attr = owner(name)
    orig = getattr(obj, attr)
    setattr(obj, attr, FAULTS[name](orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)
