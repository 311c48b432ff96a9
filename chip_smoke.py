#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (syn3r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the exit code is not 0:
  1. device   the card's name and power limit (nvidia-smi), torch version.
  2. build    nvcc builds every kernel of the path from csrc/ (in parallel).
  3. kernels  each kernel's wrapper against its plain torch version at the
              main path's shapes, in bf16: max-abs and rel-RMS error, kernel,
              plain and library (one PyTorch call) times.
  4. small    a small bf16 UNet (widths 64/128, d = 64, 1024 tokens) on the
              card, through the kernels, against the same UNet in float32 on
              the CPU (the plain path).
  5. unit     the completion unit at SVD-XT / CLIP ViT-H / VAE full widths
              with random weights from a seed: 25 frames at 576x1024, post
              variant, fused batch-3 forward, num_inference_steps=2 (the one
              cut from 100). Launch counts are zeroed just before and read
              just after; each kernel must have launched.
The line before the last is the JSON kernel table, after it the
nvidia-smi line, and the last line is {"ok": true, "device": {...}}.
Details also go to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.diffusion.pipeline import (init_random_weights_,
                                                load_svd_completion)
from syn3r_tpu_torch.kernels import build
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel
from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops.geglu_ffn import geglu_ffn, geglu_ffn_reference
from syn3r_tpu_torch.pipeline.completion import search_hypers_v2

# Published dense peaks of one H100 SXM (data sheet), for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
STEPS = 2
FRAMES, HEIGHT, WIDTH = 25, 576, 1024
# rows = batch 3 x 25 frames x tokens; C = channels: (rows, C, calls per
# batch-3 UNet forward). 16 transformers x (ff, ff_in, ff) = 48 calls.
FFN_SHAPES = [(75 * 9216, 320, 15), (75 * 2304, 640, 15),
              (75 * 576, 1280, 15), (75 * 144, 1280, 3)]
# (batch*heads, tokens, calls per forward): spatial self-attention at the
# three levels with >= 512 tokens, 5 transformers each.
ATTN_SHAPES = [(75 * 5, 9216, 5), (75 * 10, 2304, 5), (75 * 20, 576, 5)]
# Kernel vs plain tolerance in bf16. GEGLU: both round the products to bf16,
# but their f32 sums run in another order, so a bf16 pre-activation may land
# one ulp (2^-8 relative) apart and move through the second product.
# Attention: the kernel rounds exp(s - running max) to bf16 before the
# rescale, the plain version the normalized probabilities.
TOL = {"geglu_ffn": (5e-2, 1e-2), "flash_attention": (2e-2, 1e-2)}
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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


def errors(got, want):
    d = (got.float() - want.float())
    rel_rms = (d.pow(2).mean().sqrt()
               / want.float().pow(2).mean().sqrt().clamp_min(1e-30))
    return d.abs().max().item(), rel_rms.item()


def check(name, got, want):
    max_abs, rel_rms = errors(got, want)
    tol_abs, tol_rel = TOL[name]
    if not (np.isfinite(max_abs) and max_abs <= tol_abs
            and rel_rms <= tol_rel):
        raise AssertionError(f"{name}: max_abs {max_abs} rel_rms {rel_rms} "
                             f"beyond tolerance ({tol_abs}, {tol_rel})")
    return max_abs, rel_rms


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_geglu(gen, dev):
    rows_out = []
    for r, c, calls in FFN_SHAPES:
        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=gen, device=dev)
                    * std).to(torch.bfloat16)
        x = rnd(r, c)
        w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1)
        w2, b2 = rnd(c, 4 * c, std=(4 * c) ** -0.5), rnd(c, std=0.1)
        got = geglu_ffn(x, w1, b1, w2, b2)
        want = geglu_ffn_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        max_abs, rel_rms = check("geglu_ffn", got, want)
        del got, want
        iters = 3 if r > 100_000 else 10

        def library():
            a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(a * F.gelu(g), w2, b2)

        ms = cuda_ms(lambda: geglu_ffn(x, w1, b1, w2, b2), iters)
        plain = cuda_ms(lambda: geglu_ffn_reference(x, w1, b1, w2, b2), iters)
        lib = cuda_ms(library, iters)
        flops = 24 * r * c * c
        nbytes = 2 * (2 * r * c + 12 * c * c + 9 * c)
        bms, by = bound_ms(flops, nbytes)
        row = dict(rows=r, c=c, calls_per_forward=calls, max_abs_err=max_abs,
                   rel_rms_err=rel_rms, ms=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9)
        say("kernels", name="geglu_ffn", **row)
        rows_out.append(row)
        del x, w1, b1, w2, b2
        torch.cuda.empty_cache()
    return rows_out


def check_attention(gen, dev):
    rows_out = []
    for bh, s, calls in ATTN_SHAPES:
        b, h = 75, bh // 75
        # (B, S, H, D) projections viewed as (B, H, S, D), as the UNet does
        q, k, v = (torch.randn((b, s, h, 64), generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        got = A.flash_attention(q, k, v, 0.125)
        want = A.attention_chunked(q, k, v, 0.125)
        torch.cuda.synchronize()
        max_abs, rel_rms = check("flash_attention", got, want)
        del got, want
        ms = cuda_ms(lambda: A.flash_attention(q, k, v, 0.125), 3)
        plain = cuda_ms(lambda: A.attention_chunked(q, k, v, 0.125), 1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=0.125), 3)
        flops = 4 * bh * s * s * 64
        nbytes = 4 * bh * s * 64 * 2
        bms, by = bound_ms(flops, nbytes)
        row = dict(bh=bh, tokens=s, calls_per_forward=calls,
                   max_abs_err=max_abs, rel_rms_err=rel_rms, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                   tflops=flops / ms / 1e9)
        say("kernels", name="flash_attention", **row)
        rows_out.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows_out


def check_small_unet(dev):
    """A small UNet through the kernels (bf16, card) against the plain path
    (float32, CPU): the kernels as the modules call them."""
    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              layers_per_block=1, addition_time_embed_dim=32)
    cpu = UNetSpatioTemporalConditionModel(**kw).eval()
    init_random_weights_(cpu, torch.Generator().manual_seed(1))
    card = UNetSpatioTemporalConditionModel(**kw).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    sample = torch.randn((3, 5, 32, 32, 8), generator=g)
    ehs = torch.randn((3, 1, 1024), generator=g)
    tids = torch.tensor([[6.0, 127.0, 0.02]]).repeat(3, 1)
    n_ffn, n_attn = geglu_ffn.launches, A.flash_attention.launches
    with torch.no_grad():
        want = cpu(sample, torch.tensor(1.3), ehs, tids, (1, 2))
        got = card(sample.to(dev, torch.bfloat16), torch.tensor(1.3),
                   ehs.to(dev, torch.bfloat16), tids.to(dev), (1, 2))
    torch.cuda.synchronize()
    max_abs, rel_rms = errors(got.cpu(), want)
    used = (geglu_ffn.launches - n_ffn, A.flash_attention.launches - n_attn)
    say("small", what="bf16 UNet on card vs f32 on CPU", max_abs=max_abs,
        rel_rms=rel_rms, launches=used)
    # bf16 activations and weights through ~40 layers against float32
    if not (rel_rms < 5e-2 and min(used) > 0):
        raise AssertionError(f"small UNet: rel_rms {rel_rms}, launches {used}")
    return dict(max_abs=max_abs, rel_rms=rel_rms)


def run_unit(dev):
    t0 = time.perf_counter()
    pipe = load_svd_completion(None, dev, seed=0, num_inference_steps=STEPS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.rand((FRAMES, HEIGHT, WIDTH, 3), generator=g, device=dev)
    mask = torch.rand((FRAMES - 2, HEIGHT // 8, WIDTH // 8), generator=g,
                      device=dev)
    lam = search_hypers_v2(mask, STEPS)
    say("unit", what="load", seconds=load_s,
        num_inference_steps=f"{STEPS} (cut from 100)")

    torch.cuda.reset_peak_memory_stats()
    geglu_ffn.launches = 0
    A.flash_attention.launches = 0
    stage = {}
    t0 = time.perf_counter()
    clip_s, clip_e, cond, _, _ = pipe.encode_conditioning(
        imgs[0], list(imgs[1:-1]), imgs[-1], g)
    torch.cuda.synchronize()
    stage["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    latents = torch.randn((1, FRAMES, HEIGHT // 8, WIDTH // 8, 4),
                          generator=g, device=dev)
    out = pipe.denoise(latents, clip_s, clip_e, cond, mask, lam)
    torch.cuda.synchronize()
    stage["denoise_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = pipe.decode(out)
    torch.cuda.synchronize()
    stage["decode_s"] = time.perf_counter() - t0
    launches = {"geglu_ffn": geglu_ffn.launches,
                "flash_attention": A.flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if tuple(frames.shape) != (FRAMES, HEIGHT, WIDTH, 3):
        raise AssertionError(f"frames shape {tuple(frames.shape)}")
    if not bool(torch.isfinite(frames).all()):
        raise AssertionError("frames not finite")
    lo, hi = frames.min().item(), frames.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"frames outside [0, 1]: {lo} {hi}")
    # 2 directions per step, one batch-3 forward each
    want = {"geglu_ffn": 48 * 2 * STEPS, "flash_attention": 15 * 2 * STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    # stage split of the encode (outside the counted run): CLIP of both
    # endpoints and the f32 VAE encode of all frames
    noise = torch.randn((HEIGHT, WIDTH, 3), generator=g, device=dev)
    t0 = time.perf_counter()
    pipe.clip_embed(imgs[0])
    pipe.clip_embed(imgs[-1])
    torch.cuda.synchronize()
    stage["clip_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.vae_encode_mode_batch(imgs, noise)
    torch.cuda.synchronize()
    stage["vae_encode_s"] = time.perf_counter() - t0
    stage["s_per_denoise_step"] = stage["denoise_s"] / STEPS
    say("unit", frames=tuple(frames.shape), min=lo, max=hi,
        peak_mem_gb=peak_gb, launches=launches, **stage)
    return dict(stage, peak_mem_gb=peak_gb, launches=launches,
                frame_range=[lo, hi], load_s=load_s)


def kernel_entry(name, source, replaces, rows, launches):
    """Sums over one batch-3 UNet forward's calls of this kernel."""
    def tot(key):
        return sum(r[key] * r["calls_per_forward"] for r in rows)
    bms = tot("bound_ms")
    by = max(rows, key=lambda r: r["bound_ms"] * r["calls_per_forward"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": bms,
            "bound_by": by["bound_by"], "library_ms": tot("library_ms"),
            "per": "one batch-3 UNet forward "
                   f"({sum(r['calls_per_forward'] for r in rows)} calls)"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, name=repr(torch.cuda.get_device_name(0)),
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    logs = build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", kernel=name, ptxas=repr(line.strip()))
    say("build", seconds=time.perf_counter() - t0, built=sorted(logs))

    gen = torch.Generator(device=dev).manual_seed(0)
    ffn_rows = check_geglu(gen, dev)
    attn_rows = check_attention(gen, dev)
    small = check_small_unet(dev)
    unit = run_unit(dev)

    kernels = [
        kernel_entry("geglu_ffn", "syn3r_tpu_torch/csrc/geglu_ffn.cu",
                     "syn3r_tpu/ops/pallas_ffn.py:63", ffn_rows,
                     unit["launches"]["geglu_ffn"]),
        kernel_entry("flash_attention",
                     "syn3r_tpu_torch/csrc/flash_attention.cu",
                     "syn3r_tpu/models/layers.py:185", attn_rows,
                     unit["launches"]["flash_attention"]),
    ]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "geglu_ffn": ffn_rows, "flash_attention": attn_rows,
                   "small_unet": small, "unit": unit, "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
