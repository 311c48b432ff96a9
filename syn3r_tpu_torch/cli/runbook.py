"""One-command weights runbook: convert, GS-only baseline, full run,
report.

Counterpart of ``syn3r_tpu/cli/runbook.py``. Takes a local snapshot of
stable-video-diffusion-img2vid-xt, converts it (``cli/convert_weights``),
runs one scene twice with a ``cli/batch`` preset's flags (the GS-only
baseline, ``--refine_cycle_num 0``, and the full guided loop with
``--svd_weights``), evaluates both and writes the PSNR/SSIM/LPIPS delta to
``runbook_report.json``::

    python -m syn3r_tpu_torch.cli.runbook --hf_snapshot <snapshot> \\
        --scene <colmap scene> --out <dir>

Stages are selectable (``--stages convert,baseline,full,report``) and
resume from existing outputs. ``--device`` goes to the train, render and
metrics stages.
"""

from __future__ import annotations

import argparse
import json
import os


def _parse_eval(model_dir: str) -> dict:
    """The eval_res.txt blocks cli.metrics writes: {block: {metric: v}}."""
    from .summarize import parse_eval_res
    return parse_eval_res(os.path.join(model_dir, "eval_res.txt"))


def _best_block(res: dict) -> tuple[str, dict]:
    """The last refine checkpoint's block, else the first."""
    for name in sorted(res, reverse=True):
        if name.startswith("ours_refine"):
            return name, res[name]
    name = next(iter(res))
    return name, res[name]


def main(argv=None):
    p = argparse.ArgumentParser("syn3r-tpu-torch runbook")
    p.add_argument("--hf_snapshot", required=True,
                   help="local stable-video-diffusion-img2vid-xt dir "
                        "(unet/ vae/ image_encoder/ subdirs)")
    p.add_argument("--scene", required=True, help="COLMAP scene dir")
    p.add_argument("--out", required=True)
    p.add_argument("--n_views", type=int, default=3)
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--iterations", type=int, default=10_000)
    p.add_argument("--refine_cycle_num", type=int, default=2)
    p.add_argument("--lpips", default=None,
                   help="optional torch lpips vgg state dict for the "
                        "refine loss + LPIPS eval")
    p.add_argument("--stages", default="convert,baseline,full,report",
                   help="comma list of: convert baseline full report")
    p.add_argument("--preset", default="llff",
                   choices=["llff", "dtu", "dl3dv", "none"],
                   help="cli.batch preset whose train flags seed the run; "
                        "'none' for bare defaults")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain torch path)")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra flags forwarded to cli.train (they win over "
                        "the preset: argparse keeps the last occurrence)")
    args = p.parse_args(argv)
    stages = set(args.stages.split(","))
    os.makedirs(args.out, exist_ok=True)
    weights_dir = os.path.join(args.out, "weights")

    from . import convert_weights as convert_cli
    from . import metrics as metrics_cli
    from . import render as render_cli
    from . import train as train_cli
    from .batch import PRESETS

    # 1. convert
    if "convert" in stages:
        if all(os.path.exists(os.path.join(weights_dir, f))
               for f in ("unet.npz", "vae.npz", "clip.npz")):
            print(f"[runbook] convert: {weights_dir} already populated")
        else:
            cargv = ["--svd_dir", args.hf_snapshot, "--out_dir", weights_dir]
            if args.lpips:
                cargv += ["--lpips", args.lpips]
            convert_cli.main(cargv)

    preset = [] if args.preset == "none" else list(PRESETS[args.preset])
    device = ["--device", args.device]
    common = preset + ["-s", args.scene, "--n_views", str(args.n_views),
                       "--llffhold", str(args.llffhold),
                       "--iterations", str(args.iterations)] \
        + device + list(args.extra)
    lpips_npz = os.path.join(weights_dir, "lpips.npz")

    def run_and_eval(model_dir, extra):
        if os.path.exists(os.path.join(model_dir, "eval_res.txt")):
            print(f"[runbook] {model_dir}: eval_res.txt exists, skipping")
            return
        train_cli.main(["-m", model_dir] + common + extra)
        render_cli.main(["-s", args.scene, "-m", model_dir] + device)
        margv = ["-m", model_dir] + device
        if args.lpips:
            margv += ["--lpips_weights", lpips_npz]
        metrics_cli.main(margv)

    # 2. GS-only baseline
    base_dir = os.path.join(args.out, "gs_only")
    if "baseline" in stages:
        run_and_eval(base_dir, ["--refine_cycle_num", "0"])

    # 3. the full guided run
    full_dir = os.path.join(args.out, "full")
    if "full" in stages:
        extra = ["--refine_cycle_num", str(args.refine_cycle_num),
                 "--svd_weights", weights_dir]
        if args.lpips:
            extra += ["--lpips_weights", lpips_npz]
        run_and_eval(full_dir, extra)

    # 4. report
    if "report" in stages:
        bname, bm = _best_block(_parse_eval(base_dir))
        print(f"[runbook] GS-only   ({bname}): "
              + " ".join(f"{k}={v:.3f}" for k, v in bm.items()))
        report = {"gs_only": bm}
        if os.path.exists(os.path.join(full_dir, "eval_res.txt")):
            fname, fm = _best_block(_parse_eval(full_dir))
            print(f"[runbook] guided    ({fname}): "
                  + " ".join(f"{k}={v:.3f}" for k, v in fm.items()))
            delta = {k: fm[k] - bm[k] for k in fm if k in bm}
            print("[runbook] delta     : "
                  + " ".join(f"{k}={v:+.3f}" for k, v in delta.items()))
            report.update(full=fm, delta=delta)
        with open(os.path.join(args.out, "runbook_report.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(f"[runbook] report -> {args.out}/runbook_report.json")


if __name__ == "__main__":
    main()
