"""Metrics entry point: PSNR, SSIM and (with ``--lpips_weights``) LPIPS of
every ``test/ours_*/renders`` folder against its ``gt`` folder.

Counterpart of ``syn3r_tpu/cli/metrics.py`` with the same flags, plus
``--device`` (``cuda`` by default; ``cpu`` for the CPU)::

    python -m syn3r_tpu_torch.cli.metrics -m <model dir> [--masks <dir>]

It appends to ``<model dir>/eval_res.txt`` one block a folder, the format
``cli/summarize.py`` parses:

    ours_chkpnt10000.pth
      SSIM : 0.8123000
      PSNR : 24.5500000
      LPIPS: 0.1712000

``--masks <dir>`` is the DTU protocol: per-view masks named as the
renders, and both images set to 0 where the mask is at or under 0.5.
"""

from __future__ import annotations

import argparse
import glob
import os


def build_parser():
    p = argparse.ArgumentParser("syn3r-tpu-torch metrics")
    p.add_argument("--model_path", "-m", required=True)
    # unused: taken so that the command line of syn3r_tpu's metrics parses
    p.add_argument("--source_path", "-s", default=None)
    p.add_argument("--masks", default=None,
                   help="dir of per-view masks (DTU protocol)")
    p.add_argument("--lpips_weights", default=None,
                   help="converted LPIPS params (.npz); omit to skip LPIPS")
    p.add_argument("--device", default="cuda",
                   help="cuda or cpu, where the metrics are computed")
    return p


def evaluate_dirs(render_dir: str, gt_dir: str, masks_dir=None,
                  lpips_fn=None, device="cuda") -> dict:
    """Mean PSNR, SSIM and LPIPS (nan without ``lpips_fn``) over the
    images of ``render_dir`` and their namesakes in ``gt_dir``."""
    import numpy as np
    import torch
    from PIL import Image

    from ..device import resolve_device
    from ..utils.image import psnr, ssim

    dev = resolve_device(device)
    names = sorted(os.listdir(render_dir))
    ps, ss, lp = [], [], []
    for n in names:
        r = np.asarray(Image.open(os.path.join(render_dir, n)),
                       np.float32) / 255.0
        g = np.asarray(Image.open(os.path.join(gt_dir, n)),
                       np.float32) / 255.0
        if masks_dir:
            mpath = os.path.join(masks_dir, n)
            if os.path.exists(mpath):
                m = np.asarray(Image.open(mpath).convert("L"),
                               np.float32) / 255.0
                m = (m > 0.5)[..., None]
                r = np.where(m, r, np.float32(0.0))
                g = np.where(m, g, np.float32(0.0))
        r, g = torch.as_tensor(r, device=dev), torch.as_tensor(g, device=dev)
        ps.append(float(psnr(r, g)))
        ss.append(float(ssim(r, g)))
        if lpips_fn is not None:
            lp.append(float(lpips_fn(r, g)))
    out = {"PSNR": float(np.mean(ps)), "SSIM": float(np.mean(ss))}
    out["LPIPS"] = float(np.mean(lp)) if lp else float("nan")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    lpips_fn = None
    if args.lpips_weights:
        from ..models.lpips import load_lpips_fn
        lpips_fn = load_lpips_fn(args.lpips_weights, args.device)

    res_path = os.path.join(args.model_path, "eval_res.txt")
    blocks = []
    for method_dir in sorted(glob.glob(os.path.join(args.model_path, "test",
                                                    "ours_*"))):
        rdir = os.path.join(method_dir, "renders")
        gdir = os.path.join(method_dir, "gt")
        if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
            continue
        stats = evaluate_dirs(rdir, gdir, masks_dir=args.masks,
                              lpips_fn=lpips_fn, device=args.device)
        name = os.path.basename(method_dir).replace("ours_", "")
        # the reference's eval_res.txt keeps the torch extension
        block = (f"ours_{name}.pth\n"
                 f"  SSIM : {stats['SSIM']:.7f}\n"
                 f"  PSNR : {stats['PSNR']:.7f}\n"
                 f"  LPIPS: {stats['LPIPS']:.7f}\n")
        blocks.append(block)
        print(block, end="")
    with open(res_path, "a") as f:
        f.writelines(blocks)
    print(f"[metrics] appended to {res_path}")
    return res_path


if __name__ == "__main__":
    main()
