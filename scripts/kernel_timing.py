"""The UNet's GEGLU-FFN and flash-attention call shapes and the timing
helpers shared by chip_smoke.py and scripts/time_unet_kernels.py.

Imports torch and numpy only (nothing of syn3r_tpu_torch), so that
time_unet_kernels.py can take it from this checkout and the kernels from
another.
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
