"""Results summarizer — the reference's ``scripts/summarize_dl3dv.py``
surface: aggregate per-scene eval_res.txt blocks per checkpoint name and
print a table (no tabulate/fire dependency).

A copy of ``syn3r_tpu/cli/summarize.py`` (pure Python), whose table it
prints string for string::

    python -m syn3r_tpu_torch.cli.summarize <dir of scene model dirs>
"""

from __future__ import annotations

import argparse
import os

CHECKPOINTS = ["ours_chkpnt10000.pth", "ours_refine_0_chkpnt10000.pth",
               "ours_refine_1_chkpnt10000.pth"]


def parse_eval_res(path: str) -> dict:
    """-> {checkpoint_name: {SSIM, PSNR, LPIPS}}"""
    with open(path) as f:
        lines = f.readlines()
    out = {}
    for i, line in enumerate(lines):
        name = line.strip()
        if name.startswith("ours_"):
            stats = {}
            for sub in lines[i + 1:i + 4]:
                for key in ("SSIM", "PSNR", "LPIPS"):
                    if key in sub:
                        stats[key] = float(sub.split(":")[1].strip())
            out[name] = stats
    return out


def summarize(root: str, checkpoints=None) -> str:
    checkpoints = checkpoints or CHECKPOINTS
    scenes = sorted(d for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d)))
    rows = []
    for ck in checkpoints:
        rows.append([ck, "SSIM", "PSNR", "LPIPS"])
        acc = {"SSIM": 0.0, "PSNR": 0.0, "LPIPS": 0.0}
        cnt = 0
        for scene in scenes:
            path = os.path.join(root, scene, "eval_res.txt")
            if not os.path.exists(path):
                continue
            stats = parse_eval_res(path).get(ck)
            if not stats:
                continue
            rows.append([scene] + [f"{stats[k]:.4f}"
                                   for k in ("SSIM", "PSNR", "LPIPS")])
            for k in acc:
                acc[k] += stats.get(k, float("nan"))
            cnt += 1
        if cnt:
            rows.append([f"AVG({cnt} scenes)"] +
                        [f"{acc[k] / cnt:.4f}"
                         for k in ("SSIM", "PSNR", "LPIPS")])
    widths = [max(len(str(r[i])) for r in rows if len(r) > i)
              for i in range(4)]
    lines = ["  ".join(str(c).ljust(widths[i]) for i, c in enumerate(r))
             for r in rows]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser("syn3r-tpu-torch summarize")
    p.add_argument("dir")
    args = p.parse_args(argv)
    print(summarize(args.dir))


if __name__ == "__main__":
    main()
