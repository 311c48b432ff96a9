"""Cells of the guided denoise loop: ``GuidedSVDPipeline.denoise`` called
again and again, each call one pair's ``num_inference_steps`` steps.

Set-up: the UNet's weights drawn on the card from the seed, the port's
UNet built on the meta device and given them, the pipeline, and one call
of one step through a pipeline on the same networks (every shape of the
window: its kernels built or loaded, its plans made). The configuration's
``unet`` and ``pipeline`` go to the port whole, less the frame size in
pixels, which the traffic reads: a key that the port or the reference does
not implement stops the run before the window. The window then calls
``denoise`` on pair 0, 1, ... (``traffic.denoise_pair``) until ``seconds``
have passed, and ends at the end of that call: ``denoise_step_s`` is the
window's time over all its steps. A forward pre-hook on the UNet logs
each forward's sample shape and timestep; with ``trace`` CUDA events time
each forward of the window, and one more call after the window runs under
the profiler; the operation and byte counts of the per-layer metrics are
taken at the shapes the log saw.

The check follows the program one step, from its own state: the step is
drawn from the seed among the configuration's ``check.steps``, whose
limits were set from readings at that step. In every call the latents
entering and leaving that step and the UNet's outputs in it are kept, and
once the window has closed, the memory peak has been read and the program
freed, the float32 reference (``reference/``) runs that step of the last
call from the kept latents on the same inputs and weights, drawn again
from the seed. Compared, each against its limit:

  - ``unet_rel``: the UNet outputs' relative RMS gap to the reference's
    (all rows of both directions);
  - ``step_rel``: the gap of the step's result to the reference's, over
    the reference's change of the latents in that step;
  - ``unet_rows_off``: over every step of the last call, the UNet rows
    that the log saw at each step's timestep less the rows the reference
    step sends, in absolute value, plus rows at a timestep of no step
    (exact: limit 0).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import time

import torch

from counts.unet import (census, flash_bound_s, geglu_bound_s,
                         group_norm_bound_s, layer_norm_bound_s)
from reference import scheduler, svd_unet
from reference.svd_unet import RefUNet, unet_param_shapes

from . import common
from .traffic import denoise_pair
from .weights import seeded_weights, sub_seed

# a timestep further than this from every step's is no step's
TIMESTEP_TOL = 1e-4
# the most UNet rows of a step that gaps() pairs (8! pairings)
MAX_PAIRED_ROWS = 8


@dataclasses.dataclass
class Step:
    """A kept step: latents in and out, the UNet's outputs (float32)."""
    x_in: torch.Tensor
    x_out: torch.Tensor = None
    eps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Kept:
    """The steps ``steps`` of the latest call, and that call's inputs."""
    steps: tuple
    records: dict = dataclasses.field(default_factory=dict)
    current: Step = None
    inputs: dict = None


def build_program(run: common.Run, steps: int):
    """The port's UNet with the seed's weights, and its pipeline."""
    from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                    GuidedSVDPipeline,
                                                    SVDModels)
    from syn3r_tpu_torch.models.svd_unet import \
        UNetSpatioTemporalConditionModel
    ucfg, pcfg = run.config["unet"], run.config["pipeline"]
    scheduler.refuse_unknown(pcfg)
    dtype = getattr(torch, pcfg["compute_dtype"])
    weights = seeded_weights(unet_param_shapes(ucfg), run.seed, run.device,
                             dtype)
    # every other key is the published structure, which the port's UNet
    # builds as the reference does (unet_param_shapes refused the rest)
    skip = set(svd_unet.implied(ucfg)) | set(svd_unet.DEFAULTS)
    with torch.device("meta"):
        unet = UNetSpatioTemporalConditionModel(
            **{k: v for k, v in ucfg.items() if k not in skip})
    unet.load_state_dict(weights, strict=True, assign=True)
    unet.eval()
    models = SVDModels(unet=unet, vae=None, clip=None)
    kw = {k: v for k, v in pcfg.items() if k not in scheduler.SIZES}

    def pipeline(n):
        return GuidedSVDPipeline(models, GuidedSVDConfig(
            **dict(kw, num_inference_steps=n, compute_dtype=dtype)))
    return unet, pipeline(steps), pipeline(1)


def keep_steps(pipe, unet, kept: Kept):
    """Wraps the pipeline's per-step method and hooks the UNet so that the
    steps ``kept.steps`` of each call are kept."""
    advance = pipe._advance

    def kept_advance(states, lats, step_i, stack_pairs=False):
        if step_i not in kept.steps:
            return advance(states, lats, step_i, stack_pairs)
        kept.current = Step(x_in=lats[0].clone())
        out = advance(states, lats, step_i, stack_pairs)
        kept.current.x_out = out[0].clone()
        kept.records[step_i], kept.current = kept.current, None
        return out

    def hook(module, args, output):
        if kept.current is not None:
            kept.current.eps.append(output.detach().float())

    pipe._advance = kept_advance
    return unet.register_forward_hook(hook)


class ForwardLog:
    """Each UNet forward's sample shape and timestep (kept as given: no
    copy to the host inside the window), from a pre-hook; while ``timed``,
    CUDA events (host clock on the CPU) around it."""

    def __init__(self, unet, device):
        self.device, self.timed, self.entries = device, False, []
        self.handles = [
            unet.register_forward_pre_hook(self._pre, with_kwargs=True),
            unet.register_forward_hook(self._post)]

    def _stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _pre(self, module, args, kwargs):
        sample = args[0] if args else kwargs["sample"]
        t = args[1] if len(args) > 1 else kwargs["timestep"]
        t = t.detach() if torch.is_tensor(t) else t
        self.entries.append([tuple(sample.shape), t,
                             self._stamp() if self.timed else None, None])

    def _post(self, module, args, output):
        if self.timed:
            self.entries[-1][3] = self._stamp()

    def take(self) -> list:
        """The entries since the last take."""
        entries, self.entries = self.entries, []
        return entries

    def seconds(self, entries) -> list:
        common.sync(self.device)
        if self.device.type == "cuda":
            return [a.elapsed_time(b) / 1e3 for _, _, a, b in entries]
        return [b - a for _, _, a, b in entries]

    def remove(self):
        for h in self.handles:
            h.remove()


def followed_step(config: dict, seed: int) -> int:
    """The step the check follows: one of ``check.steps``, drawn from the
    seed."""
    steps = sorted(int(k) for k in config["check"]["steps"])
    return steps[sub_seed(seed, "check_step") % len(steps)]


def run(run: common.Run) -> dict:
    pcfg, traffic = run.config["pipeline"], run.traffic
    dev = run.device
    steps = pcfg["num_inference_steps"]
    unet, pipe, warm = build_program(run, steps)
    step = followed_step(run.config, run.seed)
    kept = Kept(steps=(step,))
    hook = keep_steps(pipe, unet, kept)
    log = ForwardLog(unet, dev)

    warm.denoise(**denoise_pair(traffic, pcfg, run.seed, "warm", dev))
    del warm
    log.take()
    log.timed = run.trace

    t_window = common.now(dev)
    setup_s = t_window - run.t0
    calls, window = 0, []
    while True:
        inputs = denoise_pair(traffic, pcfg, run.seed, calls, dev)
        pipe.denoise(**inputs)
        kept.inputs, last = inputs, log.take()
        window += last
        calls += 1
        if common.now(dev) - t_window >= run.seconds:
            break
    window_s = time.perf_counter() - t_window
    n_steps = calls * steps

    out = {"attempted": n_steps, "device": common.device_facts(dev)}
    if run.trace:
        log.timed = False
        inputs = denoise_pair(traffic, pcfg, run.seed, calls, dev)
        with common.Profile(dev) as prof:
            pipe.denoise(**inputs)
        kept.inputs, last = inputs, log.take()
        prof.read()
    out["device"]["memory_peak_bytes"] = common.memory_peak(dev)
    if run.trace:
        out["device"]["busy_s"] = prof.busy_s
        out["device"]["window_s"] = prof.wall_s
        out["breakdown"] = prof.breakdown()
        ctx = trace_context(run, prof, log.seconds(window), window, last,
                            window_s, n_steps)
        out["metrics"] = common.read_per_layer(run, ctx)
    else:
        out["metrics"] = {
            "denoise_step_s": {"value": window_s / n_steps,
                               "unit": "s/step"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    log.remove()
    hook.remove()
    del unet, pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["check"] = check(run, kept, step, last)
    return out


def counted(ucfg: dict, entries: list) -> dict:
    """The forwards of ``entries`` counted at their sample shapes: matrix
    operations, and each kernel family's roofline bound in seconds."""
    out = {"flops": 0.0, "geglu": 0.0, "flash": 0.0, "norm": 0.0}
    for shape, n in collections.Counter(e[0] for e in entries).items():
        b, f, h, w = shape[:4]
        c = census(ucfg, b, f, h, w)
        out["flops"] += n * c.flops
        out["geglu"] += n * geglu_bound_s(c.geglu)
        out["flash"] += n * flash_bound_s(c.flash)
        out["norm"] += n * (layer_norm_bound_s(c.layer_norm)
                            + group_norm_bound_s(c.group_norm))
    return out


def trace_context(run, prof, fwd_s, window, traced, window_s,
                  n_steps) -> dict:
    """What the per-layer readers read: the window's time, steps, forward
    times and counts; the traced call's profile and counts."""
    ucfg = run.config["unet"]
    return {
        "kind": "denoise",
        "steps": n_steps, "window_s": window_s,
        "forward_s": fwd_s,
        "window_flops": counted(ucfg, window)["flops"],
        "traced_wall_s": prof.wall_s, "busy_s": prof.busy_s,
        "profile": prof,
        "traced_bound_s": counted(ucfg, traced),
    }


def reference_step(run: common.Run, kept: Kept, step: int, precision=None,
                   params=None):
    """The reference's step ``step`` from the kept latents: (next latents
    (T, h, w, 4), [each direction's eps rows (B, T, h, w, 4)])."""
    ucfg, pcfg = run.config["unet"], run.config["pipeline"]
    if params is None:
        params = reference_params(run)
    unet = RefUNet(params, ucfg, precision)
    inp, rec = kept.inputs, kept.records[step]
    cf = lambda t: t.permute(0, 3, 1, 2)     # (T, h, w, C) -> (T, C, h, w)
    x_next, eps = scheduler.denoise_step(
        unet, pcfg, step, cf(rec.x_in.float()), inp["clip_start"],
        inp["clip_end"], cf(inp["cond_latents"]), inp["mask"],
        inp["lambda_ts"])
    return (x_next.permute(0, 2, 3, 1),
            [e.permute(0, 1, 3, 4, 2) for e in eps])


def reference_params(run: common.Run) -> dict:
    """The seed's weights drawn again, in float32, with TF32 off."""
    dev = run.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ucfg, pcfg = run.config["unet"], run.config["pipeline"]
    drawn = seeded_weights(unet_param_shapes(ucfg), run.seed, dev,
                           getattr(torch, pcfg["compute_dtype"]))
    return {k: v.float() for k, v in drawn.items()}


def gaps(rec: Step, x_next, eps) -> dict:
    """unet_rel and step_rel of ``rec`` (the program's, or a stand-in's)
    against the reference's x_next and eps. The UNet's rows are paired
    with the reference's as they match best, since the program may batch
    a step's passes and directions in another order; a step that kept
    another number of UNet rows than the reference made has an infinite
    unet_rel."""
    change = float((x_next - rec.x_in.float()).norm())
    out = {"unet_rel": float("inf"),
           "step_rel": float((rec.x_out.float() - x_next).norm()) / change}
    ours, ref = torch.cat(rec.eps), torch.cat(eps)
    if ours.shape == ref.shape and len(ref) <= MAX_PAIRED_ROWS:
        cost = [[float((a - b).square().sum()) for b in ref] for a in ours]
        num = min(sum(cost[i][j] for i, j in enumerate(perm))
                  for perm in itertools.permutations(range(len(ref))))
        out["unet_rel"] = (num / float(ref.square().sum())) ** 0.5
    return out


def rows_off(pcfg: dict, entries: list) -> int:
    """The call's UNet rows at each step's timestep less the reference
    step's rows, in absolute value, summed over the steps; plus the rows
    at a timestep of no step."""
    ts = scheduler.timesteps(pcfg["num_inference_steps"]).double()
    got, stray = [0] * len(ts), 0
    for shape, t, *_ in entries:
        gap = (ts - float(t)).abs()
        i = int(gap.argmin())
        if float(gap[i]) > TIMESTEP_TOL:
            stray += shape[0]
        else:
            got[i] += shape[0]
    want = scheduler.unet_rows(pcfg)
    return stray + sum(abs(g - want) for g in got)


def check(run: common.Run, kept: Kept, step: int, last: list) -> dict:
    """{number: {"value", "limit"}}: kept step ``step`` against the
    float32 reference, and the rows of the call ``last`` logged."""
    x_next, eps = reference_step(run, kept, step)
    limits = run.config["check"]
    out = {f"{k}.step{step}": {"value": v, "limit": limits["steps"][
        str(step)][k]} for k, v in gaps(kept.records[step], x_next,
                                        eps).items()}
    out["unet_rows_off"] = {"value": rows_off(run.config["pipeline"], last),
                            "limit": limits["unet_rows_off"]}
    return out
