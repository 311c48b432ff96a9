"""The main path's kernel call shapes (the UNet's GEGLU-FFN,
flash-attention, LayerNorm and GroupNorm calls, the GS scene whose tile
lists feed the composite kernels) and the timing helpers shared by
chip_smoke.py and scripts/time_kernels.py.

At import it loads torch and numpy only, so that time_kernels.py can take
it from this checkout and the kernels from another; ``gs_scene`` imports
syn3r_tpu_torch when called, from whichever checkout is first on sys.path
(the one being timed; its projection and binning build the lists).
"""

import math
import subprocess
import threading
import time

import numpy as np
import torch

# rows = batch 3 x 25 frames x tokens; C = channels: (rows, C, calls per
# batch-3 UNet forward). 16 transformers x (ff, ff_in, ff) = 48 calls.
FFN_SHAPES = [(75 * 9216, 320, 15), (75 * 2304, 640, 15),
              (75 * 576, 1280, 15), (75 * 144, 1280, 3)]
# (batch*heads, tokens, calls per forward): spatial self-attention at the
# three levels with >= 512 tokens, 5 transformers each.
ATTN_SHAPES = [(75 * 5, 9216, 5), (75 * 10, 2304, 5), (75 * 20, 576, 5)]
# (B, H, tokens, calls per grad pass) of the grad-through-UNet guidance's
# batch-1 forward (B = 25 frames): the same 15 spatial self-attention calls,
# each with a backward.
GRAD_ATTN_SHAPES = [(25, 5, 9216, 5), (25, 10, 2304, 5), (25, 20, 576, 5)]
# (rows, C, calls per forward) of the UNet's LayerNorms (bf16, bf16
# weights): 5 transformers a level (2 down, 3 up; 1 in the mid block), 7
# LayerNorms each (3 in the spatial block, 4 in the temporal one) = 112.
LN_SHAPES = [(75 * 9216, 320, 35), (75 * 2304, 640, 35),
             (75 * 576, 1280, 35), (75 * 144, 1280, 7)]
# (B, S, C, calls, of them with SiLU) of the UNet's GroupNorms per batch-3
# forward (bf16, bf16 weights, 32 groups): 61 spatial calls (B = 3 x 25
# frames, S = H x W; the 16 transformers' norms have no SiLU) and 44
# temporal ones (B = 3, S = 25 x H x W) = 105.
GN_SHAPES = [
    (75, 9216, 320, 13, 8), (75, 9216, 640, 2, 2), (75, 9216, 960, 1, 1),
    (75, 2304, 320, 1, 1), (75, 2304, 640, 11, 6), (75, 2304, 960, 1, 1),
    (75, 2304, 1280, 1, 1), (75, 2304, 1920, 1, 1),
    (75, 576, 640, 1, 1), (75, 576, 1280, 11, 6), (75, 576, 1920, 1, 1),
    (75, 576, 2560, 2, 2),
    (75, 144, 1280, 12, 11), (75, 144, 2560, 3, 3),
    (3, 230400, 320, 10, 10), (3, 57600, 640, 10, 10),
    (3, 14400, 1280, 10, 10), (3, 3600, 1280, 14, 14)]
# GS main path: bench.py's GS configuration, the CLI's --tile_cap 1024
GS_W, GS_H, GS_N, GS_CAP = 504, 378, 65_536, 1024
# shortest timing window, so that it holds several nvidia-smi samples
WINDOW_MS = 250.0


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=5):
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed, so that the host's time to issue a call is not in
    it (``cuda_ms`` of a call shorter than its issue times the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def gs_replays(tr):
    """n -> n replays of a GS trainer's captured step (``tr._segments``),
    back to back: its step time on the graph path with nothing of the
    host's segment around it. Every entry of the upload is made entry 0
    of the last one (a real view, position lr and bias corrections), so
    any run of replays from j = 0 reads valid values."""
    seg = tr._segments
    b = seg.bufs
    b["idx"].fill_(int(b["idx"][0]))
    b["scalars"].copy_(b["scalars"][:1].clone().expand_as(b["scalars"]))

    def run(n):
        b["j"].zero_()
        seg.run(n)
    return run


def window_iters(*fns):
    """Calls a timing window needs to last ~WINDOW_MS for the slowest of
    ``fns`` (at least 3)."""
    est = max(cuda_ms(fn, 1) for fn in fns)
    return max(3, math.ceil(WINDOW_MS / est))


class SmiSampler:
    """nvidia-smi's SM clock and power draw every 20 ms in the background,
    stamped with the host clock as the lines arrive; ``window(t0, t1)``
    gives their medians over a timing window."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.time(), mhz, watts))

    def window(self, t0, t1):
        got = [s for s in self.samples if t0 <= s[0] <= t1]
        if not got and self.samples:   # the sample nearest the window
            got = [min(self.samples, key=lambda s: abs(s[0] - t1))]
        if not got:
            return None, None
        return (float(np.median([s[1] for s in got])),
                float(np.median([s[2] for s in got])))

    def timed(self, fn, iters):
        """(ms a call, median SM MHz, median W) over one window of
        ``iters`` calls."""
        t0 = time.time()
        ms = cuda_ms(fn, iters)
        return (ms, *self.window(t0, time.time()))

    def close(self):
        self.proc.terminate()
        self.proc.wait()
        self.thread.join(timeout=5)


def gs_points(n=GS_N):
    """bench.py's GS layout: n points from numpy seed 0 in a slab in front
    of the cameras, and the generator after the draws."""
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                          rng.uniform(1.5, 4.0, (n, 1))], 1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return xyz, rgb, rng


def gs_scene(dev, n=GS_N, width=GS_W, height=GS_H):
    """bench.py's GS scene: n Gaussians in front of one camera; (state,
    camera, the generator after the draws)."""
    from syn3r_tpu_torch.models import gaussians as GM
    from syn3r_tpu_torch.utils.camera import camera_from_fov, look_at_w2c
    xyz, rgb, rng = gs_points(n)
    state = GM.from_points(torch.from_numpy(xyz).to(dev),
                           torch.from_numpy(rgb).to(dev), capacity=n)
    cam = camera_from_fov(0.9, 0.7, width, height,
                          look_at_w2c([0.0, 0.0, 0.0], [0.0, 0.0, 2.5]),
                          device=dev)
    return state, cam, rng


def gs_tile_lists(dev):
    """The composite kernels' inputs on the GS main path: ``gs_scene``
    projected and binned (T 96 tiles, px 2048, cap 1024, K 128)."""
    from syn3r_tpu_torch.ops import rasterize as RZ
    state, cam, _ = gs_scene(dev)
    with torch.no_grad():
        sg = RZ.project_gaussians(state, cam)
        return RZ.bin_tiles(sg, cam.height, cam.width, cap=GS_CAP, chunk=256)


def random_lpips_params(seed: int) -> dict:
    """A random LPIPS param tree in the JAX package's flax layout, as numpy
    arrays from ``seed``: He-normal 3x3 kernels (the features keep their
    scale through 13 layers), small biases, non-negative 1x1 heads (as
    trained heads are)."""
    from syn3r_tpu_torch.models.lpips import _CHANNELS, _VGG_CFG
    rng = np.random.default_rng(seed)
    net, c_in = {}, 3
    for i, c in enumerate(c for c in _VGG_CFG if c != "M"):
        net[f"conv_{i}"] = {
            "kernel": (rng.normal(size=(3, 3, c_in, c))
                       * np.sqrt(2.0 / (9 * c_in))).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, c).astype(np.float32)}
        c_in = c
    tree = {"net": net}
    for i, c in enumerate(_CHANNELS):
        tree[f"lin_{i}"] = {"kernel": rng.uniform(0, 0.1, (1, 1, c, 1))
                            .astype(np.float32)}
    return {"params": tree}


def save_params(params: dict, path) -> None:
    """A param tree (under a top-level "params") as the flat npz that
    ``syn3r_tpu_torch.utils.params.load_params`` reads: keys are the
    '/'-joined paths."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(params["params"], "")
    np.savez(path, **flat)
