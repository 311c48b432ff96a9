"""Per-pair debug artifacts of the refine loop (``--save_debug``).

Counterpart of ``syn3r_tpu/utils/debug_dump.py`` (the reference dumps
per-pair uncertainty, cond and warp PNGs, ``model/diffusionGS.py:871-884``,
the lambda-schedule heatmap, ``:1201-1202``, and the generated frames as
an mp4, ``:1106-1109``). The orchestrator writes the set under
``<save_dir>/debug/cyc{c}_pair{p}/``; the video is a GIF (PIL only).
Arrays may be numpy or tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _to_u8(img) -> np.ndarray:
    a = _np(img)
    if a.ndim == 2:
        a = a[..., None].repeat(3, axis=-1)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img) -> None:
    """img: (H, W, 3) or (H, W) float in [0, 1]."""
    from PIL import Image
    Image.fromarray(_to_u8(img)).save(path, compress_level=1)


def save_heatmap_png(path: str, mat, upscale: int = 4) -> None:
    """(rows, cols) float matrix -> blue-to-red heatmap PNG, nearest-
    upscaled so latent-resolution masks and the (steps, frames) lambda
    schedule are legible."""
    from PIL import Image
    a = _np(mat)
    lo, hi = float(a.min()), float(a.max())
    t = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    rgb = np.stack([t, 0.25 + 0.0 * t, 1.0 - t], axis=-1)
    im = Image.fromarray(_to_u8(rgb))
    if upscale > 1:
        im = im.resize((im.width * upscale, im.height * upscale),
                       resample=0)  # NEAREST
    im.save(path)


def save_gif(path: str, frames, fps: float = 7.0, pool=None) -> None:
    """frames: (F, H, W, 3) float in [0, 1] -> animated GIF. Each frame is
    quantized to its adaptive palette as the GIF writer would do it (the
    same pixels), on ``pool`` (an executor) when given."""
    from PIL import Image

    def paletted(f):
        return Image.fromarray(_to_u8(f)).convert(
            "P", palette=Image.Palette.ADAPTIVE)
    frames = _np(frames)
    ims = list(pool.map(paletted, frames) if pool else map(paletted, frames))
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)


def dump_pair_debug(out_dir: str, cond, frames) -> list[str]:
    """The per-pair artifact set: the endpoint and cond images, the
    latent-resolution uncertainty masks (heatmaps), the lambda schedule
    heatmap, and the completed frames as PNGs and ``completion.gif``.
    ``cond`` is a ``completion.PairConditioning``; ``frames`` the
    completion output at the diffusion resolution. The files are encoded
    on a pool of threads (the encoders release the interpreter lock).
    Returns the written paths."""
    from concurrent.futures import ThreadPoolExecutor
    os.makedirs(out_dir, exist_ok=True)
    cond_images = _np(cond.cond_images)
    masks = _np(cond.masks)
    frames = _np(frames)
    jobs = [("endpoint_start.png", save_png, cond.image_start),
            ("endpoint_end.png", save_png, cond.image_end)]
    for i in range(cond_images.shape[0]):
        jobs += [(f"cond_{i:02d}.png", save_png, cond_images[i]),
                 (f"uncertainty_{i:02d}.png", save_heatmap_png, masks[i])]
    jobs.append(("lambda_ts.png", save_heatmap_png, cond.lambda_ts))
    jobs += [(f"generated_{i:02d}.png", save_png, frames[i])
             for i in range(frames.shape[0])]
    written = [os.path.join(out_dir, name) for name, _, _ in jobs]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        futures = [pool.submit(fn, path, a)
                   for path, (_, fn, a) in zip(written, jobs)]
        gif = os.path.join(out_dir, "completion.gif")
        save_gif(gif, frames, pool=pool)
        for f in futures:
            f.result()
    return written + [gif]
