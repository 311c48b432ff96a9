"""Cells of the GS refine: ``GSTrainer``'s loop over whole episodes of the
refine, each the same stretch of iterations from the same start.

Set-up (``setup_s``): the traffic's truth scene, views, targets and
sparse cloud (``gs_traffic.make_scene``); a ``GSTrainer`` on the train
views and the cloud, with the configuration's ``train`` handed whole to
``TrainConfig`` (a key that the port or the reference does not implement
stops the run); the fit, the port's own loop over iterations 0 to
``start_sample_svd_iter`` with densify on and its capacity ceiling at the
traffic's ``fit_capacity``, so that every seed's fit fills it; the start,
its ``start_live`` most opaque live Gaussians (the rest pruned), its
view-pick stream and its split-noise generator; the pseudo
views installed as ``refine_GS`` installs them (confidence
``scene.cam_confidence``, depth targets rendered from the start by
``render_views_batch``); then warm episodes: each restores the start,
padded to the capacity reached so far, and runs the episode, iterations
``start_sample_svd_iter`` to ``iterations``, through ``_run_loop`` (the
loop ``finetune`` runs, without its checkpoint). The first captures the
segment graphs and, where the scene grows past the occupancy limit, the
capacity doubles; warm episodes go on until one ends at the capacity it
began with, or grew, ran segments at the new capacity (their capture
made) and ends with at most ``SETTLED`` of it live. Every episode of the
window restores the start at that capacity, so the window holds no
capture and no growth.

Where ``train`` has an ``lpips_weight`` above 0, set-up draws LPIPS
weights from the seed (``lpips_weights``) before the fit, installs them
through the port's ``set_lpips`` and keeps ``use_lpips_loss`` on for the
fit and every episode, as ``refine_GS`` keeps it on for its whole
``finetune``; the reference is handed the same weights. Without the key
nothing is installed and the step has no LPIPS term.

The window (``gs_step_ms``): episodes back to back until ``seconds`` have
passed, ending with the episode in which they passed; its whole time
(every segment's replays, densify, opacity reset, segment upload and
restore) over its train steps. With ``trace`` a stretch after the window,
the first two densify intervals of one more episode, runs under the
profiler; the composite bounds are counted on the views its steps picked,
from the state each segment began with.

The check (``check``) reads what the timed path made: in every episode
``Recorder`` keeps, from the program's own state, the three steps from
the first pseudo pick of a segment that starts at or after an iteration
of the episode's second half drawn from the seed (single-step calls of
``_run_segment``, the segment's own replays), the state entering and
leaving the densify boundary drawn from the seed and the split-noise
generator's state before it; set-up keeps the first growth of the warm
episodes (the fit's last where they have none). Once the window has
closed, the memory peak has been read and the program is freed, the
float32 reference (``reference/gs.py``) follows those steps from the
program's state, redoes that densify with the program's split noise
(drawn again from the generator's state) and that growth, and the
numbers compared are:

  - ``loss_rel``: the worst of the three steps' |loss - reference| over
    the reference's;
  - ``grad_rel``: the first step's gradient as Adam got it (from the
    program's first moments before and after), by the worst leaf: the gap
    of its norm to the reference's over the larger of that leaf's and the
    median leaf's reference norm;
  - ``change_rel``: as ``grad_rel``, of each parameter's and densify
    statistic's change over the three steps;
  - ``densify_rows_off``: slots whose live flag differs from the
    reference's, slots rewritten where the reference writes none or not
    rewritten where it writes, and statistics left nonzero (exact: 0);
  - ``densify_rel``: the rewritten slots' parameters against the
    reference's, relative RMS, the worst field;
  - ``adam_written_off``: rewritten slots whose moments are not zero and
    other slots whose moments moved, plus 1 if Adam's count moved
    (exact: 0);
  - ``growth_rows_off``: slots of the grown state that differ from the
    reference's growth of the state before it (live rows, moments,
    padding), plus 1 for Adam's count and for the step if either moved
    (exact: 0).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from counts import composite as cc
from counts.gs_step import step_ops
from reference import gs as ref
from reference import lpips as ref_lpips

from . import common
from .gs_traffic import make_scene
from .weights import sub_seed

B1 = ref.ADAM_B1
# the traced stretch: this many densify intervals of one more episode
TRACED_INTERVALS = 2
# warm episodes before set-up gives up on a capacity that keeps growing
WARM_EPISODES = 4
# a warm episode that grew and ends with at most this share of its new
# capacity live is the last: an episode from the start at that capacity
# stays below the growth limit (0.85) too
SETTLED = 0.75
# the seeded LPIPS weights: biases N(0, BIAS_STD^2), lin weights
# |N(0, LIN_STD^2)|. At a lin std of 0.1 the distance of the tiny scene's
# start renders to their targets read 0.02-0.05 (L1 0.05-0.12, 1 - SSIM
# 0.17-0.32), a tenth of the 0.2-0.3 that sparse-view papers report for
# LPIPS-VGG at such errors (FSGS, LLFF at 3 views: 0.248 at SSIM 0.682);
# at 1 it reads 0.2-0.5, so the term weighs in the loss as in the refine
LPIPS_BIAS_STD = 0.01
LPIPS_LIN_STD = 1.0


def model_dir() -> Path:
    """The trainer's model directory, inside the checkout (nothing is
    written there: the loop saves no checkpoint)."""
    return common.BENCH_DIR.parent / "build" / "gs_refine_model"


def train_config(config: dict):
    """The port's TrainConfig from the configuration's ``train``: a key
    that the reference or the port does not implement raises ValueError."""
    from syn3r_tpu_torch.gs.trainer import TrainConfig
    train = config["train"]
    ref.refuse_unknown(train)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    for key in train:
        if key not in fields:
            raise ValueError(f"the port's TrainConfig has no {key}")
    kw = dict(train)
    kw["bg_color"] = tuple(kw["bg_color"])
    return TrainConfig(**kw)


def lpips_weights(seed: int, device) -> dict:
    """LPIPS weights drawn from the run's seed, on ``device`` in one call:
    a state dict under the ``lpips`` package's names
    (``reference/lpips.shapes``), its convolutions He-normal (std sqrt(2 /
    fan in)), biases small, ``lin`` weights non-negative, as the released
    ones are."""
    shapes = ref_lpips.shapes()
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "lpips"))
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        w = flat[off:off + math.prod(shape)].view(shape)
        off += w.numel()
        if name.startswith("lin"):
            w.abs_().mul_(LPIPS_LIN_STD)
        elif name.endswith(".bias"):
            w.mul_(LPIPS_BIAS_STD)
        else:
            w.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        out[name] = w
    return out


def port_cameras(cams: list, device):
    from syn3r_tpu_torch.utils.camera import make_camera, stack_cameras
    return stack_cameras([make_camera(c["K"], c["w2c"], c["width"],
                                      c["height"], c["confidence"], device)
                          for c in cams])


def as_state(ts) -> dict:
    """A reference state dict of the program's ``TrainState`` (its
    tensors, not copies)."""
    g = ts.gaussians
    return {"params": {f: getattr(g, f) for f in ref.FIELDS},
            "active": g.active, "mu": dict(ts.adam.mu),
            "nu": dict(ts.adam.nu), "count": ts.adam.count,
            "step": ts.step,
            "stats": {k: getattr(ts.stats, k) for k in ref.STATS}}


@dataclasses.dataclass
class Start:
    """The fitted state, its view-pick stream and split-noise generator."""
    state: object          # the program's TrainState (device tensors)
    rng: object
    gen_state: torch.Tensor

    def restore(self, trainer, capacity: int):
        """Installs the start in ``trainer``, padded with zero rows to
        ``capacity``, with fresh tensors."""
        from syn3r_tpu_torch.gs.densify import DensifyStats
        from syn3r_tpu_torch.gs.trainer import AdamState, TrainState
        from syn3r_tpu_torch.models.gaussians import GaussianState
        ts = self.state
        extra = capacity - ts.gaussians.capacity

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
        g = ts.gaussians
        trainer.state = TrainState(
            gaussians=GaussianState(**{f: pad(getattr(g, f))
                                       for f in ref.FIELDS + ("active",)}),
            adam=AdamState(mu={k: pad(v) for k, v in ts.adam.mu.items()},
                           nu={k: pad(v) for k, v in ts.adam.nu.items()},
                           count=ts.adam.count),
            stats=DensifyStats(**{k: pad(getattr(ts.stats, k))
                                  for k in ref.STATS}),
            step=ts.step)
        trainer._rng = copy.deepcopy(self.rng)
        trainer._gen.set_state(self.gen_state)


@dataclasses.dataclass
class Followed:
    """The three steps the check follows: the state before them, their
    picks (merged view index, depth flag), losses and states after."""
    before: object = None
    picks: list = dataclasses.field(default_factory=list)  # (index, flag)
    losses: list = dataclasses.field(default_factory=list)
    after: list = dataclasses.field(default_factory=list)


class Recorder:
    """Wraps the trainer's ``_run_segment``, ``_densify_step`` and
    ``_maybe_grow`` (instance attributes that call the class's methods as
    they stand at each call: the class is untouched) to keep what the
    check follows, episode by episode. ``keep`` False sends the records of
    an episode nowhere (the traced stretch does the same work without
    overwriting the window's)."""

    def __init__(self, trainer, boundary: int, follow_from: int):
        self.tr = trainer
        self.boundary = boundary
        self.follow_from = follow_from
        self.keep = True
        self.phase = "fit"
        self.follow = None         # Followed being filled, this episode
        self.steps = None          # the latest episode's Followed
        self.densify = None        # (state before, gen state, state after)
        self.growths = []          # (phase, state before, state after)
        self.segments = []         # (state at entry, picks) while tracing
        self.tracing = False
        self.densified = []        # live slots after each densify (device)
        trainer._run_segment = self.run_segment
        trainer._densify_step = self.densify_step
        trainer._maybe_grow = self.maybe_grow

    def _call(self, name: str, *args):
        return getattr(type(self.tr), name)(self.tr, *args)

    def episode(self):
        """Called before each episode."""
        self.follow = Followed()
        if self.keep:
            self.densified = []

    def run_segment(self, merged, idx, flags, use_depth, use_lpips):
        if self.tracing:
            self.segments.append((self.tr.state, idx.copy()))

        def part(a, b=None):
            return self._call("_run_segment", merged, idx[a:b], flags[a:b],
                              use_depth, use_lpips)
        f = self.follow
        first = np.flatnonzero(flags)
        if f is None or f.before is not None or not len(first) \
                or first[0] > len(idx) - 3 \
                or self.tr.state.step < self.follow_from:
            return part(0)
        m = int(first[0])
        if m:
            part(0, m)
        f.before = self.tr.state
        for j in range(m, m + 3):
            loss = part(j, j + 1)
            f.picks.append((int(idx[j]), float(flags[j])))
            f.losses.append(loss)
            f.after.append(self.tr.state)
        if m + 3 < len(idx):
            loss = part(m + 3)
        if self.keep:
            self.steps = f
        return loss

    def densify_step(self, ts):
        gen_state = self.tr._gen.get_state()
        out = self._call("_densify_step", ts)
        if self.keep:
            self.densified.append(out.gaussians.active.sum())
            if ts.step - 1 == self.boundary:
                self.densify = (ts, gen_state, out)
        return out

    def maybe_grow(self):
        before = self.tr.state
        self._call("_maybe_grow")
        after = self.tr.state
        if after is not before:
            self.growths.append((self.phase, before, after))

    def growth(self):
        """The growth the check follows: the warm episodes' first, else
        the fit's last; None where set-up grew nothing."""
        warm = [g for g in self.growths if g[0] == "warm"]
        fit = [g for g in self.growths if g[0] == "fit"]
        return warm[0] if warm else (fit[-1] if fit else None)


def trim(trainer, live: int):
    """Keeps the ``live`` most opaque live slots of the trainer's state
    live; the others are pruned as densify prunes (their flag cleared)."""
    g = trainer.state.gaussians
    score = torch.where(g.active, g.opacity_logits[:, 0], -math.inf)
    keep = torch.zeros_like(g.active)
    keep[torch.topk(score, min(live, g.num_active)).indices] = True
    trainer.state = dataclasses.replace(trainer.state,
                                        gaussians=g.replace(active=keep))


def densify_boundaries(train: dict) -> list:
    """The iterations of the episode after which the loop densifies."""
    iv = train["densification_interval"]
    lo, hi = train["start_sample_svd_iter"], train["iterations"]
    return [b for b in range(lo, hi) if (b + 1) % iv == 0
            and train["densify_from_iter"] <= b < train["densify_until_iter"]]


def followed_boundary(train: dict, seed: int) -> int:
    """The densify boundary the check follows, drawn from the seed."""
    bs = densify_boundaries(train)
    return bs[sub_seed(seed, "densify_boundary") % len(bs)]


def follow_from(train: dict, seed: int) -> int:
    """The iteration from which the check follows three steps (from the
    first pseudo pick of a segment that starts there or later), drawn from
    the seed among the segment starts of the episode's second half: the
    depth targets are the start's renders, so the depth term only weighs
    once the scene has moved from the start."""
    lo, hi = train["start_sample_svd_iter"], train["iterations"]
    starts = [b + 1 for b in densify_boundaries(train)
              if (lo + hi) / 2 <= b + 1 < hi]
    return starts[sub_seed(seed, "follow_from") % len(starts)]


@dataclasses.dataclass
class Program:
    """The program's trainer and what set-up made for the window."""
    trainer: object
    rec: Recorder
    start: Start
    capacity: int
    scene: object
    active: dict           # live counts and capacities, for the log
    lpips: dict | None     # the LPIPS weights, where the step has the term


def build(run: common.Run) -> Program:
    """Set-up: the scene, the trainer, the fit, the pseudo views and the
    warm episodes (see the module docstring)."""
    from syn3r_tpu_torch.gs.trainer import GSTrainer, ViewSet
    from syn3r_tpu_torch.models.gaussians import from_points
    dev = run.device
    ref.Precision().switches()
    tcfg = train_config(run.config)
    train, scene_cfg = run.config["train"], run.config["scene"]
    clock = [common.now(dev)]

    def lap():
        clock.append(common.now(dev))
        return round(clock[-1] - clock[-2], 3)
    scene = make_scene(run.traffic, scene_cfg, train, run.seed, dev)
    laps = {"scene_s": lap()}
    views = ViewSet(cameras=port_cameras(scene.train_cams, dev),
                    images=scene.train_images)
    init = from_points(scene.cloud_xyz, scene.cloud_rgb,
                       sh_degree=train["sh_degree"])
    model_dir().mkdir(parents=True, exist_ok=True)
    trainer = GSTrainer(views, tcfg, init, model_path=str(model_dir()),
                        device=dev)
    lpips = None
    if train.get("lpips_weight", 0) > 0:
        from syn3r_tpu_torch.models.lpips import convert_lpips_torch
        lpips = lpips_weights(run.seed, dev)
        trainer.set_lpips(convert_lpips_torch({k: v.cpu()
                                               for k, v in lpips.items()}))
        trainer.use_lpips_loss = True
    rec = Recorder(trainer, followed_boundary(train, run.seed),
                   follow_from(train, run.seed))
    lo, hi = train["start_sample_svd_iter"], train["iterations"]
    ceiling = tcfg.max_capacity
    tcfg.max_capacity = run.traffic["fit_capacity"]
    trainer._run_loop(0, lo, densify=True)
    tcfg.max_capacity = ceiling
    fitted = trainer.state.gaussians.num_active
    trim(trainer, run.traffic["start_live"])
    laps["fit_s"] = lap()
    start = Start(state=trainer.state, rng=copy.deepcopy(trainer._rng),
                  gen_state=trainer._gen.get_state())
    pseudo = port_cameras(scene.pseudo_cams, dev)
    depths = trainer.render_views_batch(pseudo)[1]
    trainer.update_cameras(scene.pseudo_images.cpu().numpy(),
                           pseudo.w2c.cpu().numpy(),
                           pseudo.K[0].cpu().numpy(),
                           cam_confidences=scene_cfg["cam_confidence"],
                           append=False, depths=depths.cpu().numpy())
    laps["pseudo_s"] = lap()
    laps["warm_s"] = []
    rec.phase = "warm"
    capacity = start.state.gaussians.capacity
    for _ in range(WARM_EPISODES):
        start.restore(trainer, capacity)
        rec.episode()
        trainer._run_loop(lo, hi, densify=True)
        laps["warm_s"].append(lap())
        g = trainer.state.gaussians
        if g.capacity == capacity:
            break
        capacity = g.capacity
        if g.num_active / capacity <= SETTLED \
                and trainer._segments.key[0] == capacity:
            break
    else:
        raise RuntimeError("the warm episodes kept growing the capacity")
    print(f"gs set-up: {laps}", file=sys.stderr, flush=True)
    rec.phase = "window"
    active = {"fit": fitted, "start": start.state.gaussians.num_active,
              "start_capacity": start.state.gaussians.capacity,
              "capacity": capacity}
    return Program(trainer=trainer, rec=rec, start=start, capacity=capacity,
                   scene=scene, active=active, lpips=lpips)


def episode(prog: Program, end: int | None = None):
    train = prog.trainer.cfg
    prog.start.restore(prog.trainer, prog.capacity)
    prog.rec.episode()
    prog.trainer._run_loop(train.start_sample_svd_iter,
                           end or train.iterations, densify=True)


def captures(trainer) -> int:
    return sum(trainer.graph_builds.values())


def run(run: common.Run) -> dict:
    dev = run.device
    prog = build(run)
    train = run.config["train"]
    steps_a = train["iterations"] - train["start_sample_svd_iter"]
    built = captures(prog.trainer)

    t_window = common.now(dev)
    setup_s = t_window - run.t0
    ends = []
    while True:
        episode(prog)
        ends.append(common.now(dev) - t_window)
        if ends[-1] >= run.seconds:
            break
    window_s = time.perf_counter() - t_window
    episodes = len(ends)
    n_steps = episodes * steps_a
    window_captures = captures(prog.trainer) - built
    prog.active["window_end"] = prog.trainer.state.gaussians.num_active

    out = {"attempted": n_steps, "device": common.device_facts(dev)}
    if run.trace:
        rec = prog.rec
        rec.keep, rec.tracing = False, True
        end = train["start_sample_svd_iter"] \
            + TRACED_INTERVALS * train["densification_interval"]
        with common.Profile(dev) as prof:
            episode(prog, end)
        rec.tracing = False
        prof.read()
    out["device"]["memory_peak_bytes"] = common.memory_peak(dev)
    if run.trace:
        out["device"]["busy_s"] = prof.busy_s
        out["device"]["window_s"] = prof.wall_s
        out["breakdown"] = prof.breakdown()
        ctx = trace_context(run, prog, prof, window_captures,
                            end - train["start_sample_svd_iter"])
        out["metrics"] = common.read_per_layer(run, ctx)
        print(f"gs: composite bounds {ctx['composite_bound']}",
              file=sys.stderr, flush=True)
    else:
        out["metrics"] = {
            "gs_step_ms": {"value": 1e3 * window_s / n_steps,
                           "unit": "ms/step"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    kept = Kept.of(prog)
    print(f"gs: episodes {episodes} ending at {[round(t, 3) for t in ends]} "
          f"s, window captures {window_captures}, "
          f"active {prog.active}, active after each densify of the last "
          f"episode {[int(n) for n in prog.rec.densified]}", file=sys.stderr,
          flush=True)
    free(prog)
    out["check"] = check(run, kept)
    return out


def free(prog: Program):
    """Drops the trainer, its captures and the recorder's hold on it."""
    prog.trainer._segments = None
    prog.trainer._renders.clear()
    prog.trainer = prog.rec = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def traced_counts(run: common.Run, prog: Program) -> dict:
    """The composite bounds (seconds) and the counted operations of the
    traced stretch's steps: each step's view binned from the state its
    segment began with by the reference's projection and tile rules, its
    live entries and hit pairs counted (``counts/composite.py``), the rest
    of the step by ``counts/gs_step.py``, its LPIPS term with it where the
    step has one."""
    train = run.config["train"]
    scene = prog.scene
    cams = scene.train_cams + scene.pseudo_cams
    h, w = cams[0]["height"], cams[0]["width"]
    ty, tx = ref.tile_grid(h, w)
    px = ref.TILE_H * ref.TILE_W
    P = ref.pixel_features(run.device)
    prec = ref.Precision()
    fwd_s = bwd_s = ops = 0.0
    bound_by = set()
    with torch.no_grad():
        for ts, idx in prog.rec.segments:
            st = as_state(ts)
            # the port's lists: min(tile_cap, slots) entries in chunks of
            # K = min(chunk, that, 128), ltc a row a chunk
            cap = min(train["tile_cap"], st["active"].shape[0])
            chunks = -(-cap // max(1, min(train["chunk"], cap, 128)))
            for view, n in zip(*np.unique(idx, return_counts=True)):
                proj = ref.project(st["params"], st["active"],
                                   cams[int(view)], train["sh_degree"], prec)
                ids, counts = ref.tile_lists(proj, h, w, train["tile_cap"])
                live, hits = [], []
                for blk in ref.blocks(ty * tx):
                    G, o, _ = ref.tile_features(proj, ids, counts, blk, tx)
                    lv, ht = cc.pairs(P, G, o)
                    live += lv.tolist()
                    hits += ht.tolist()
                f_ops, f_bytes = cc.fwd_cost(px, chunks, live, hits)
                b_ops, b_bytes = cc.bwd_cost(px, chunks, live, hits)
                f_s, f_by = cc.bound_s(f_ops, f_bytes)
                b_s, b_by = cc.bound_s(b_ops, b_bytes)
                fwd_s += int(n) * f_s
                bwd_s += int(n) * b_s
                ops += int(n) * (f_ops + b_ops + step_ops(
                    st["active"].shape[0], h, w, prog.lpips is not None))
                bound_by |= {("fwd", f_by), ("bwd", b_by)}
    return {"fwd_s": fwd_s, "bwd_s": bwd_s, "ops": ops,
            "bound_by": sorted(bound_by)}


def trace_context(run, prog, prof, window_captures, steps) -> dict:
    """What the per-layer readers read: the traced stretch's profile and
    step count, the composite bounds of its steps, the window's graph
    captures."""
    return {"kind": "gs", "profile": prof, "steps": steps,
            "traced_wall_s": prof.wall_s, "busy_s": prof.busy_s,
            "window_captures": window_captures,
            "composite_bound": traced_counts(run, prog)}


# -- the check ---------------------------------------------------------------

@dataclasses.dataclass
class Kept:
    """What the check reads, as reference state dicts."""
    steps: Followed
    densify: tuple
    growth: tuple
    start: dict            # the start (the pseudo depth targets' source)
    scene: object
    lpips: dict | None     # the LPIPS weights both sides were given

    @staticmethod
    def of(prog: Program) -> "Kept":
        return Kept(steps=prog.rec.steps, densify=prog.rec.densify,
                    growth=prog.rec.growth(),
                    start=as_state(prog.start.state), scene=prog.scene,
                    lpips=prog.lpips)


def reference_view(run: common.Run, kept: Kept, index: int, flag: float,
                   depths: dict, prec=None) -> dict:
    """Merged view ``index`` (train views first) as the reference takes
    it; a pseudo pick (flag 1) with its depth target, rendered by the
    reference from the start."""
    scene, train = kept.scene, run.config["train"]
    n_train = len(scene.train_cams)
    if index < n_train:
        return {"cam": scene.train_cams[index],
                "image": scene.train_images[index], "depth": None}
    cam = scene.pseudo_cams[index - n_train]
    depth = None
    if flag and train["svd_depth_warmup"] > 0:
        if index not in depths:
            depths[index] = ref.render(kept.start["params"],
                                       kept.start["active"], cam, train,
                                       prec)["depth"]
        depth = depths[index]
    return {"cam": cam, "image": scene.pseudo_images[index - n_train],
            "depth": depth}


def reference_steps(run: common.Run, kept: Kept, prec=None) -> Followed:
    """The reference's three steps from the program's state before the
    followed ones, on the same picks."""
    train = run.config["train"]
    extent = ref.scene_extent(kept.scene.train_cams)
    state = as_state(kept.steps.before)
    out = Followed(before=kept.steps.before, picks=kept.steps.picks)
    depths = {}
    for index, flag in kept.steps.picks:
        view = reference_view(run, kept, index, flag, depths, prec)
        state, loss, _ = ref.train_step(state, view, train, extent, prec,
                                        kept.lpips)
        out.losses.append(loss)
        out.after.append(state)
    return out


def _norm(x) -> float:
    return float(x.double().norm())


def _leaf_gaps(ours: dict, theirs: dict) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    leaf's and the median leaf's reference norm."""
    ref_n = {k: _norm(v) for k, v in theirs.items()}
    floor = statistics.median(ref_n.values())
    return max(abs(_norm(ours[k]) - ref_n[k]) / max(ref_n[k], floor, 1e-30)
               for k in theirs)


def _state_dict(s) -> dict:
    return s if isinstance(s, dict) else as_state(s)


def first_gradient(before: dict, after: dict) -> dict:
    """The first step's gradient as Adam got it: (mu1 - b1 mu0) / (1 - b1)
    by field."""
    return {k: (after["mu"][k].double() - B1 * before["mu"][k].double())
            / (1 - B1) for k in ref.FIELDS}


def changes(before: dict, after: dict) -> dict:
    out = {k: after["params"][k].double() - before["params"][k].double()
           for k in ref.FIELDS}
    out.update({f"stats.{k}": after["stats"][k].double()
                - before["stats"][k].double() for k in ref.STATS})
    return out


def step_numbers(ours: Followed, theirs: Followed) -> dict:
    """loss_rel, grad_rel and change_rel of ``ours`` (the program's three
    steps, or a stand-in's) against ``theirs`` (the reference's)."""
    b = _state_dict(ours.before)
    mine = [_state_dict(s) for s in ours.after]
    refs = [_state_dict(s) for s in theirs.after]
    loss = max(abs(float(a) - float(r)) / max(abs(float(r)), 1e-30)
               for a, r in zip(ours.losses, theirs.losses))
    return {"loss_rel": loss,
            "grad_rel": _leaf_gaps(first_gradient(b, mine[0]),
                                   first_gradient(b, refs[0])),
            "change_rel": _leaf_gaps(changes(b, mine[-1]),
                                     changes(b, refs[-1]))}


def split_noise(gen_state: torch.Tensor, capacity: int, device) -> tuple:
    """The two (capacity, 3) standard-normal draws that ``densify_and_prune``
    makes from its generator, drawn again from the generator's state."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    return tuple(torch.randn((capacity, 3), generator=gen, device=device)
                 for _ in range(2))


def densify_numbers(before: dict, after: dict, expect: dict,
                    written: torch.Tensor) -> dict:
    """densify_rows_off, densify_rel and adam_written_off of ``after`` (the
    program's state after the densify, or a stand-in's) against the
    reference's ``expect`` and its rewritten slots ``written``."""
    changed = torch.zeros_like(written)
    for k in ref.FIELDS:
        d = (after["params"][k] != before["params"][k])
        changed |= d.reshape(len(d), -1).any(-1)
    rows_off = int((after["active"] != expect["active"]).sum()
                   + (changed != written).sum()
                   + sum(int((v != 0).sum()) for v in after["stats"].values()))
    rel = 0.0
    for k in ref.FIELDS:
        r = expect["params"][k][written].double()
        if r.numel():
            gap = _norm(after["params"][k][written].double() - r)
            rel = max(rel, gap / max(_norm(r), 1e-30))
    moved = torch.zeros_like(written)
    nonzero = torch.zeros_like(written)
    for k in ref.FIELDS:
        for m in ("mu", "nu"):
            a, b = after[m][k], before[m][k]
            moved |= (a != b).reshape(len(a), -1).any(-1)
            nonzero |= (a != 0).reshape(len(a), -1).any(-1)
    adam_off = int((written & nonzero).sum() + (~written & moved).sum()) \
        + int(after["count"] != before["count"])
    return {"densify_rows_off": rows_off, "densify_rel": rel,
            "adam_written_off": adam_off}


def reference_densify(run: common.Run, kept: Kept, prec=None) -> tuple:
    """(state before, the reference's state after, its written slots) at
    the followed boundary, with the program's split noise."""
    train = run.config["train"]
    before_ts, gen_state, _ = kept.densify
    before = as_state(before_ts)
    noise = split_noise(gen_state, before["active"].shape[0], run.device)
    extent = ref.scene_extent(kept.scene.train_cams)
    params, active, written = ref.densify(before, noise, train, extent, prec)
    return before, ref.after_densify(before, params, active, written), \
        written


def growth_rows_off(before: dict, after: dict, train: dict) -> float:
    """Slots of ``after`` unlike the reference's growth of ``before``, plus
    1 for each of Adam's count and the step that moved; inf where the
    capacities differ."""
    expect = ref.grow(before, train)
    if after["active"].shape != expect["active"].shape:
        return math.inf
    rows = after["active"] != expect["active"]
    for group in ("params", "mu", "nu"):
        for k in ref.FIELDS:
            d = after[group][k] != expect[group][k]
            rows |= d.reshape(len(d), -1).any(-1)
    for k in ref.STATS:
        rows |= after["stats"][k] != expect["stats"][k]
    return float(int(rows.sum()) + int(after["count"] != before["count"])
                 + int(after["step"] != before["step"]))


def check(run: common.Run, kept: Kept) -> dict:
    """{number: {"value", "limit"}} of the kept records against the
    float32 reference (see the module docstring)."""
    ref.Precision().switches()
    limits = run.config["check"]
    out = {}
    if kept.steps is None or kept.steps.before is None:
        out.update({k: math.inf for k in ("loss_rel", "grad_rel",
                                          "change_rel")})
    else:
        out.update(step_numbers(kept.steps, reference_steps(run, kept)))
    if kept.densify is None:
        out.update({k: math.inf for k in ("densify_rows_off", "densify_rel",
                                          "adam_written_off")})
    else:
        before, expect, written = reference_densify(run, kept)
        out.update(densify_numbers(before, as_state(kept.densify[2]),
                                   expect, written))
    growth = kept.growth
    out["growth_rows_off"] = math.inf if growth is None else growth_rows_off(
        as_state(growth[1]), as_state(growth[2]), run.config["train"])
    return {k: {"value": float(v), "limit": limits[k]}
            for k, v in out.items()}
