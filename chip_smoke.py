#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (syn3r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--geglu-parent DIR]

Phases, one result line each; any failure raises and the exit code is not 0:
  1. device   the card's name and power limit (nvidia-smi), torch version.
  2. build    nvcc builds every kernel of the path from csrc/ (in parallel);
              ptxas registers and spills, and the HGMMA (wgmma) count in
              the SASS of the GEGLU, flash and flash backward libraries
              (cuobjdump), none of which may be 0.
  3. kernels  each kernel's wrapper against its plain torch version at the
              main path's shapes, in bf16: max-abs and rel-RMS error, plain
              time, and the kernel and its library call (one PyTorch call)
              timed in turns (kernel, library, library, kernel) with the SM
              clock and power draw (nvidia-smi, sampled every 20 ms) of
              each timing window; GEGLU also at the small UNet's C = 64
              and 128 (GEMM-2's 128-column tile), at an inner width off
              GEMM-1's 64-column tile and at the UNet FFs' tensor-parallel
              shards (inner 4C / 2 and 4C / 4), untimed; with
              --geglu-parent DIR, GEGLU's output at FFN_SHAPES against the
              kernel of the checkout at DIR (built from its csrc/ and
              called through its C entry) on the same inputs, max-abs
              difference per shape (0 where the two agree bit for bit).
              The frame-
              attention kernel at the temporal self-attention's shapes
              (FRAME_ATTN_SHAPES, split projection views) against the
              packed version, SDPA on the same views its library call.
  4. small    a small bf16 UNet (widths 64/128, d = 64, 1024 tokens) on the
              card, through the kernels, against the same UNet in float32 on
              the CPU (the plain path); one GroupNorm and LayerNorm launch
              per norm module of its tree.
  5. unit     the completion unit at SVD-XT / CLIP ViT-H / VAE full widths
              with random weights from a seed: 25 frames at 576x1024, post
              variant, fused batch-3 forward, num_inference_steps=2 (the one
              cut from 100). Launch counts are zeroed just before and read
              just after and must be exact: GEGLU and flash per forward,
              16 frame-attention launches per forward, the
              norms one per call of a norm module, 105 GroupNorms and 112
              LayerNorms per UNet forward (the module tree). Forward
              pre-hooks record every norm call's shape (the census).
              The UNet's LayerNorm and GroupNorm calls must be LN_SHAPES
              and GN_SHAPES of scripts/kernel_timing.py (GroupNorm with its
              SiLU count), bf16 with bf16 weights.
  5a. guided  the grad-through-UNet guidance (GuidedSVDConfig(
              guidance_through_unet=True)) on the unit's networks, in three
              parts. (1) At each grad-pass shape (B 25 frames; H 5, 10, 20;
              S 9216, 2304, 576): the forward kernel's lse against
              attention_lse_reference (LSE_TOL), dq, dk and dv of the dkv
              and dq kernels against flash_attention_bwd_reference and
              against autograd through attention_chunked (b = 0 only at
              S 9216) at BWD_TOL, the D that the dq kernel writes against
              the torch reduction (D_TOL), two backward calls bit for bit,
              the whole backward timed in turns against the backward of
              F.scaled_dot_product_attention (with the SM clock and power),
              each kernel alone against its bound, the torch reduction of D
              alone, the forward with and without lse; then the backward
              off those shapes (BWD_LAYOUTS: ragged S 200 and 1000 at small
              B*H, a contiguous input, a misaligned view that the wrapper
              copies) against the plain version, one dq and one dkv launch
              a call. (2) The small UNet with its blocks checkpointed:
              d guidance_loss / d sample, bf16 on the card through the
              kernels against float32 on the CPU (SMALL_GRAD_TOL), flash
              forward, dkv and dq launched. (3) The full-width unit with the
              option: 25 frames at 576x1024, post, 2 steps. Exact launches
              per step and direction (the checkpoint's recompute runs every
              block's GEGLU, flash and norms twice, conv_norm_out once; one
              dkv and one dq launch per flash call; then the batch-2 CFG
              forward), s per denoise step beside the default variant's on
              the same inputs in the same phase, peak memory, finite
              latents apart from the default's and frames in [0, 1].
  5b. kernels the GroupNorm (stats and apply) and LayerNorm kernels against
              their plain versions at every shape of the census (UNet and
              CLIP in bf16, the VAE encode in float32, its decode in bf16;
              weights in the module's dtype), with F.group_norm /
              F.layer_norm as the library yardstick; two GroupNorm stats
              calls must agree bit for bit and leave the kernel's arrival
              counters at zero.
  5c. scene   the per-scene loop through the training entry point
              (cli/train.build_runner, then run) with the README's LLFF
              flags (--n_views 3 --refine_cycle_num 2): an in-memory
              scene (the gs phase's three views and points), the unit's
              completion. Cuts: --num_inference_steps 2 (from 100),
              --iterations 300 (from 10,000), --start_sample_svd_frame 100
              (from 2000, so the refine fits sample pseudo views). 6
              completion units, 6 caches, 72 pseudo views, a checkpoint;
              every kernel launched, the completion kernels 6 x the unit's;
              the GS steps and the batch renders replayed from CUDA graphs
              (their captures printed).
  5d. dtu     the DTU preset (cli/batch.py's flags: --diffusion_type
              2PassProbUncertain --densify_type interpolate_loop0_gs
              --lambda_dssim 0.5 --resolution 4 ...) with the scene phase's
              cuts, through cli/train.build_runner + run on a synthetic
              scan written as COLMAP (10 images of 1600x1200, loaded at
              400x300; 2 test views with elliptic masks), the prob
              completion on the unit's networks: 2 cycles x 2 chained
              pairs, 49 pseudo views. The prob unit's batch-2 forwards
              launch GEGLU, flash and the norms as often a forward as the
              post unit's (exact); its s per denoise step beside the post
              unit's. Then cli/render, cli/metrics (--masks, random LPIPS
              weights) and summarize on its model directory, all finite.
              Its batch-2 norm shapes go through the 5b check; every
              GEGLU and flash call of the run is recorded by shape
              (KernelShapes, which must account for every launch) and
              each shape (rows 50 x tokens, B = 50) held against the plain
              version at the kernels phase's tolerance; both composite
              kernels against their plain versions on one 400x300 test
              view's tile lists.
  5e. vision  DUSt3R ViT-L/512 and the public GMFlow (128 channels, 6
              layers) at full width with random float32 weights from seeds
              (scripts/vision_weights.py, saved as the npz the dl3dv phase
              loads), each on the card against the same weights on the CPU:
              one 288x512 pair (pts and conf: max-abs, rel-RMS, ms a pair,
              TFLOP/s, a kernel profile) and one 540x960 flow (544 rows, in
              pixels); the known-pose alignment card against CPU at a small
              size.
  5f. dl3dv   the DL3DV preset (cli/batch.py's flags: --n_views 9
              --cam_confidence 0.2 --rand_pcd --images images_4
              --num_views_for_pcd_densification 4 --fps_keyframe_sampling 1
              ..., --lpips_weight 1) with the scene phase's cuts, through
              cli/train.build_runner + run on a synthetic scan written as
              COLMAP under images_4/ at 960x540 (11 images, 2 test views),
              with --lpips_weights, --dust3r_weights and --gmflow_weights
              (random) and the unit's post completion: 2 cycles x 9 pairs.
              Launches exact as in the scene phase; densify_pcd in both
              cycles (keyframes, the frames the flow gate kept, pairs and
              edges, points fused, downsampled and kept, both ply files read
              back), the reset (cycle 0) and the append (cycle 1), every GS
              segment replaying a capture of its own capacity (a new capture
              at each capacity change), all finite; the densify_pcd time
              split into DUSt3R forwards, alignment, flow gate and outlier
              removal. Both composite kernels against their plain versions
              (and their skip bits) on a 960x540 test view's lists (T 255),
              with the tiles that overflow tile_cap counted.
  5g. optins  the unit's forward-only opt-ins on the unit's networks and
              inputs (2 steps each): direction_parallel (post: one batch-6
              forward a step, batch_groups (1, 2, 1, 2); prob: one batch-4
              (2, 2)), guidance_reuse_cfg_uncond (one batch-2 forward a
              direction and step) and fused_guidance_cfg=False (a batch-1
              and a batch-2 one). Exact launches; s per denoise step, the
              parallel step in turns with the default (default, parallel,
              parallel, default) and its peak memory (under 80 GB); the
              latents of each opt-in held to the path it must equal
              (OPTIN_TOL), the reuse step with random CLIP embeddings
              apart from the default (and, beside it, how far apart
              with zero embeddings). Every new GEGLU and flash shape (B up to
              150, the plain version on a first and a last slice of at most
              SLICE_ROWS rows / SLICE_B entries) and every new norm shape
              against its plain version, as in the dtu phase. The
              forward-warp conditioning of one 25-frame pair at 576x1024,
              card against CPU (FW_TOL).
  5h. slice   this slice through cli/train.build_runner + run:
              --interp_type forward_warp --save_debug
              --guidance_reuse_cfg_uncond 1 (the reuse unit on the unit's
              networks as completion_fn) on the scene phase's scene with
              its cuts and --refine_cycle_num 1: 3 pairs, each pair's debug
              set on disk (23 cond and 23 uncertainty PNGs, 25 generated,
              the endpoints, the lambda heatmap, the GIF), binary latent
              masks, every kernel of the path launched.
  6. kernels  the tile-composite forward and backward kernels against their
              plain versions at the GS main path's shapes (T 96 tiles,
              px 2048, cap 1024, K 128), on G/C/O from projecting and binning
              the full-size scene; two forward and two backward calls must
              agree bit for bit, and each kernel's skip bits must skip no
              (entry, warp rectangle) with a pixel whose alpha reaches 1/255,
              keep none below 1/255 opacity and equal the plain mirror
              reach_mask (the fraction removed is reported); the forward
              also on lists the path does not give it (K 24 in 42 chunks,
              px 1536, pixel features that turn the skip off), each held
              the same way; then the kernel route's parameter gradients
              against autograd through the plain composite. The
              projection kernels (csrc/project.cu) at the gs cell's
              131,072 slots and 504x378, SH degree 3: the forward's outputs
              and the backward's gradients against the plain versions
              (PROJECT_TOL), two calls of each bit for bit, and each timed
              against its bound (bytes), the plain versions and the route
              they replace (the plain forward under autograd).
  7. gs_small one GS train step on the card through the kernels against the
              same step on the CPU through the plain versions.
  8. gs       the GS trainer at full size: 504x378, 65,536 Gaussians in
              bench.py's seed-0 layout, tile_cap 1024, three views, 300
              iterations with densify/prune at 100 and 200 and an opacity
              reset at 200, fitting renders of a perturbed copy of the
              scene, on the trainer's default path (segments replayed from
              a captured CUDA graph). Launches counted over the run must
              equal the steps (backward) and the steps plus renders
              (forward), the projection's as the composite's. The
              per-step path from the same state and picks must agree with
              it bit for bit, over one 50-step segment
              (and with itself, run twice) and over the 300 iterations;
              render_views_batch (graph replays) must equal a loop of
              render_view bit for bit on 20 cameras. Prints the captures,
              and times both paths' steps in turns (eager, graph, graph,
              eager) and the batch render against the loop.
  9. lpips    the gs phase's trainer with the LPIPS refine loss (random
              VGG weights): LPIPS on the card against the CPU; one 100-step
              segment from graph replays held bit for bit to the per-step
              path, exact composite launches; the step's replay time with
              LPIPS off and on in turns (off, on, on, off).
  10. mono    the gs phase's trainer with a fixed depth estimator installed:
              100 iterations with sample_pseudo_interval 5, the graph
              segments held bit for bit to the per-step path, the
              composite kernels launched in each pseudo step; the pseudo
              step's ms.
  11. fleet   cli/batch.py --dataset llff --parallel 1 --eval on a
              synthetic COLMAP scan with the warp-only completion and the
              scene cuts: the worker subprocess pinned by
              CUDA_VISIBLE_DEVICES exits 0, every checkpoint rendered,
              PSNR and SSIM of the summary finite.
  12. parallel the parallel/ package at full width, on distinct cards
              where torch sees two or more, else on a mesh that names
              cuda:0 two or four times (printed; no speed-up is expected
              or claimed there). The unit's networks rebuilt from its seed.
              Direction sharding: the post unit, 2 steps, on a (1, 2)
              topology against the sequential unit, in turns (sequential,
              sharded, sharded, sequential): bit for bit on one card
              (OPTIN_TOL across cards), launches exact. Pair waves: the
              scene phase's build_runner + run with a (2, 2) (pair, dir)
              topology: 3 pairs in 2 waves a cycle, one slot padded;
              launches exactly 8 units' (2 cycles x 4 slots), 6 caches
              (a padded slot writes none), the cycle-0 caches bit for bit
              the scene phase's on one card. The TP and SP forwards: one
              batch-3 UNet forward (25 x 72 x 128 latents, groups (1, 2))
              2-way against the unsplit one (PAR_TOL), in turns, launches
              exact (GEGLU and flash twice a forward's, at inner / 2 and
              heads 3 + 2 (TP) or frames 13 + 12 (SP); the norms once (TP)
              or a shard each, the temporal GroupNorm's stats plain (SP)).
              GPipe: 4 stages of a level-1 BasicTransformerBlock (C 320, 5
              heads, 9216 tokens), 4 microbatches of 3, against the
              sequential tower (PAR_TOL). The DP GS step: the gs cell's
              65,536 Gaussians at 504x378, 4 views over 2 replicas against
              the one-replica step (DP_*), both composite and both
              projection kernels launched once a view. Every new GEGLU
              (with its shard width), flash and norm shape is then held
              against its plain version, as in the optins phase. Times of
              each path in turns with its one-card counterpart, peak
              memory per card.
The JSON kernel table takes its launches from the scene phase (the two
backward kernels', which only the guided option runs, from the guided
phase), and its launches_by_phase from the unit, guided, gs, scene, dtu,
dl3dv, lpips, optins, slice, mono and parallel phases.
The line before the last is the JSON kernel table, after it the
nvidia-smi line, and the last line is {"ok": true, "device": {...}}.
Details also go to chiprun_out/chip_smoke.json.
"""

import argparse
import ctypes
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from syn3r_tpu_torch.cli import batch as cli_batch
from syn3r_tpu_torch.cli import metrics as cli_metrics
from syn3r_tpu_torch.cli import render as cli_render
from syn3r_tpu_torch.cli import summarize as cli_summarize
from syn3r_tpu_torch.cli import train as cli_train
from syn3r_tpu_torch.device import resolve_device
from syn3r_tpu_torch.diffusion import scheduler as SCH
from syn3r_tpu_torch.diffusion.pipeline import (GuidedSVDConfig,
                                                GuidedSVDPipeline,
                                                init_random_weights_,
                                                load_svd_completion)
from syn3r_tpu_torch.gs import losses as gs_losses
from syn3r_tpu_torch.gs.densify import DensifyStats
from syn3r_tpu_torch.gs.scene import SceneData, load_colmap_scene
from syn3r_tpu_torch.gs.trainer import (AdamState, GSTrainer, TrainConfig,
                                        TrainState, make_viewset,
                                        position_lr, scene_extent)
from syn3r_tpu_torch.kernels import build
from syn3r_tpu_torch.models import gaussians as GM
from syn3r_tpu_torch.models import layers as L
from syn3r_tpu_torch.models.lpips import lpips_module
from syn3r_tpu_torch.models.svd_unet import (BasicTransformerBlock,
                                             UNetSpatioTemporalConditionModel)
from syn3r_tpu_torch.ops import attention as A
from syn3r_tpu_torch.ops import composite as TC
from syn3r_tpu_torch.ops import norm as N
from syn3r_tpu_torch.ops import rasterize as RZ
from syn3r_tpu_torch.ops.geglu_ffn import (geglu_ffn, geglu_ffn_reference,
                                          geglu_plan)
from syn3r_tpu_torch.parallel import sequence_parallel as SPM
from syn3r_tpu_torch.parallel.data_parallel import make_dp_gs_train_step
from syn3r_tpu_torch.parallel.mesh import (make_mesh, make_scene_topology,
                                           to_device)
from syn3r_tpu_torch.parallel.pipeline_parallel import make_gpipe
from syn3r_tpu_torch.parallel.sequence_parallel import make_sp_unet_forward
from syn3r_tpu_torch.parallel.tensor_parallel import make_tp_unet_forward
from syn3r_tpu_torch.pipeline import completion as TCP
from syn3r_tpu_torch.pipeline.completion import search_hypers_v2
from syn3r_tpu_torch.utils import colmap as CM
from syn3r_tpu_torch.utils.camera import (camera_from_fov, look_at_w2c,
                                          stack_cameras)
from syn3r_tpu_torch.utils.params import load_params, save_params
from syn3r_tpu_torch.utils.profiling import counters
from syn3r_tpu_torch.utils.ply import read_ply_points
from syn3r_tpu_torch.vision import dust3r as D3
from syn3r_tpu_torch.vision import gmflow_public as GF
from scripts.kernel_timing import (ATTN_SHAPES, FFN_SHAPES,
                                   FRAME_ATTN_SHAPES, GN_SHAPES,
                                   GRAD_ATTN_SHAPES, GS_CAP, GS_H, GS_W,
                                   LN_SHAPES,
                                   SmiSampler, cuda_ms, gs_points,
                                   graph_ms, gs_replays, gs_scene,
                                   gs_tile_lists,
                                   project_scene, random_lpips_params,
                                   window_iters)
from scripts.vision_weights import random_dust3r_params, random_gmflow_params

# Published dense peaks of one H100 SXM (data sheet), for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# exponentials a second on the special-function units (FlashAttention-3
# paper, section 3: ~3.9 TFLOP/s of exp on an H100 SXM): the flash rows'
# exp_ms in chiprun_out/chip_smoke.json, a second bound (not in bound_ms)
PEAK_MUFU_EXPS = 3.9e12
STEPS = 2
FRAMES, HEIGHT, WIDTH = 25, 576, 1024
# GEGLU widths off the main path, checked only against the plain version
# (rows, C, inner): the small UNet's C = 64 and 128 (rows 3 x 5 frames x
# 1024 and 256 tokens), which take GEMM-2's 128-column tile, and an inner
# width off GEMM-1's 64-column tile (a ragged column tile and a ragged row
# tile, both masked).
FFN_SMALL_SHAPES = [(15 * 1024, 64, 256), (15 * 256, 128, 512),
                    (1000, 64, 200)]
# The UNet FFs' tensor-parallel shards (parallel/tensor_parallel.py) at
# each width's rows: inner 4C / 2 and 4C / 4.
FFN_SHARD_SHAPES = [(r, c, 4 * c // parts) for r, c, _ in FFN_SHAPES[:3]
                    for parts in (2, 4)]
# Kernel vs plain tolerance in bf16. GEGLU: both round the products to bf16,
# but their f32 sums run in another order, so a bf16 pre-activation may land
# one ulp (2^-8 relative) apart and move through the second product.
# Attention: the kernel rounds exp(s - running max) to bf16 before the
# rescale, the plain version the normalized probabilities.
# The frame-attention kernel against the packed version: the same
# roundings (P normalised, then bf16; the output bf16), exp2 and f32 sums in
# another order: flash's tolerance.
TOL = {"geglu_ffn": (5e-2, 1e-2), "flash_attention": (2e-2, 1e-2),
       "frame_attention": (2e-2, 1e-2)}
# The guided phase. The forward's lse against the plain logsumexp, absolute:
# both f32 (the kernel's exp2.approx terms, relative error ~2^-22, summed in
# another order), on logits of O(10). The backward kernels against the plain
# version (f32 formulas on the same bf16 inputs, out and lse) and against
# autograd through attention_chunked: max-abs over max |want| and rel-RMS.
# The kernels round P and dS to bf16 before their products (2^-9 relative
# each) and their outputs to bf16, as the forward rounds P: the forward's
# (2e-2, 1e-2), with the max-abs relative to the gradient's scale (dq, dk
# and dv of O(1)-O(10) on these inputs).
LSE_TOL = 1e-4
BWD_TOL = (2e-2, 1e-2)
# D = rowsum(dO o O) as the dq kernel writes it against the torch reduction:
# f32 sums of the same 64 products of bf16 values in another order (max-abs
# over max |want| and rel-RMS).
D_TOL = 1e-5
# (B, H, S, layout) of the backward checked off the grad pass's shapes:
# ragged S (200: 1.56 tiles of 128, 3.1 stages of 64; 1000: 7.8 and 15.6)
# at small B*H, a contiguous input, a misaligned view (copied by the
# wrapper).
BWD_LAYOUTS = [(2, 3, 200, "projection"), (1, 2, 1000, "projection"),
               (2, 4, 576, "contiguous"), (2, 2, 640, "misaligned")]
# The small UNet's gradient, bf16 on the card against float32 on the CPU,
# rel-RMS: the forward alone is held to 5e-2 (check_small_unet), and the
# backward rounds each of its products to bf16 once more.
SMALL_GRAD_TOL = 1e-1
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
# trainer checkpoints of the GS phases (not brought back)
BUILD_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke")
# float32 outside the tensor cores (data sheet), for the composite bounds
PEAK_F32_FLOPS = 67e12
GS_ITERS = 300
# the gs phase's densify-free segment (graph against per-step) and the
# steps each path is timed over in each of its turns. Tolerance of graph
# against per-step: none, bit for bit. A replay runs the per-step path's
# kernels on the same float32 values (the position lr and Adam's bias
# corrections come from the same host code, and both paths multiply by
# them), and the step's kernels are deterministic: the per-step path run
# twice must agree bit for bit too. The batched render against
# render_view: bit for bit (the same forward kernels).
GS_SEGMENT, GS_TIMED_STEPS = 50, 30
# the cuts of every scene-level run (the scene, dtu, dl3dv and slice
# phases and the fleet step): 2 denoise steps (from 100), 300 GS
# iterations (from 10,000), pseudo views sampled from iteration 100 (from
# 2000, so that the refine samples them)
SCENE_CUTS = ["--num_inference_steps", str(STEPS),
              "--iterations", str(GS_ITERS), "--start_sample_svd_frame",
              "100"]
# the scene phase: the README's LLFF command with the cuts
SCENE_FLAGS = ["--n_views", "3", "--refine_cycle_num", "2"] + SCENE_CUTS
SCENE_PAIRS, SCENE_CYCLES = 3, 2
# The cached frames pass the antialiased Keys cubic (a = -0.5) resize back
# to the GS resolution, which is not clamped (as in JAX): its negative
# lobes hold 1/12 of the weight per axis, so a [0, 1] image may reach
# [-0.18, 1.18] over both axes.
CUBIC_RANGE = (-0.2, 1.2)
# Composite operations per (entry, pixel) pair, counted from the formulas
# (an exp, log1p or divide counts one): reaching alpha (6 multiplies,
# 5 adds, clamp, exp, multiply, clamp) for every entry with opacity >= 1/255;
# forward, where alpha passes 1/255: log1p, add, exp, multiply, 5
# multiply-adds (10), add = 15; backward there: T_in, w, gC (9), suffix (3),
# dalpha (4), dpower, the 12 products and their 12 sums over pixels, log1p
# and add = 45.
OPS_LIVE, OPS_FWD_HIT, OPS_BWD_HIT = 15, 15, 45
# Special-function operations (exp, log1p, reciprocal) per pair: an exp for
# every live pair; forward hit pairs an exp and a log1p, backward an exp, a
# log1p and a divide. Their rate: 16 a clock a SM (CUDA Programming Guide,
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz.
SFU_LIVE, SFU_FWD_HIT, SFU_BWD_HIT = 1, 2, 3
PEAK_SFU_OPS = 16 * 132 * 1.98e9
# Projection kernels vs plain versions, float32 on both sides with the
# same formulas (FMAs and another order of sums on the kernels' side): per
# slot, |got - want| <= tol (|want| + max |want| of the slot's row + 1e-6
# max |want| of the field), tests/test_torch_project.py's criterion.
PROJECT_TOL = {"fwd": 1e-4, "bwd": 1e-3}
# Composite kernel vs plain version, float32 on both sides, the same
# formulas in another summation order (and exp/log1p from another library):
# elementwise |got - want| <= atol + rtol |want| (allclose), as
# tests/test_pallas_rasterize.py holds the TPU kernels: forward (out and
# ltc; depth and logT rows reach ~1e1) atol 1e-4, rtol 1e-4; gradients
# atol 1e-6 + 1e-3 max|g|, rtol 2e-3.
COMPOSITE_TOL = {"fwd": (1e-4, 1e-4), "bwd": (1e-3, 2e-3)}
# Norm kernels vs plain versions, elementwise (allclose) on the same
# inputs. Both compute in float32 in another order (the GroupNorm kernel as
# x a + b, the plain version as (x - mean) rstd w + b; sums in another
# order), so a bf16 output may round to its neighbour: rtol 2^-7 (one bf16
# ulp at a binade's lower edge), atol 1e-5. Float32 outputs: atol and rtol
# 1e-4. The float32 per-(B, C) affine of the stats kernels: atol 1e-5,
# rtol 1e-4.
NORM_TOL = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float32: (1e-4, 1e-4)}
AFFINE_TOL = (1e-5, 1e-4)
# the GroupNorm sums launch (the frame-sharded GroupNorm's): |error| of a
# per-(B, C) sum against a float64 sum, over the float64 sum of the terms'
# magnitudes; float32 accumulation in chains of at most 512 terms
SUMS_RTOL = 2.0 ** -15
# the dtu phase: cli/batch.py's DTU preset with the scene phase's cuts, on
# a synthetic scan written as COLMAP: 10 images of 1600x1200 (DTU's size),
# loaded at --resolution 4 (400x300); llffhold 8 makes images 0 and 8 the
# test views, and --n_views 3 takes 3 of the other 8
DTU_FLAGS = cli_batch.PRESETS["dtu"] + SCENE_CUTS
DTU_IMAGES, DTU_W, DTU_H, DTU_SCALE = 10, 400, 300, 4
DTU_PAIRS, DTU_CYCLES, DTU_TEST = 2, 2, 2
# the lpips phase: one segment of the gs phase's trainer with the LPIPS
# loss. LPIPS on the card against the CPU, float32 on both sides with TF32
# off, 13 convolutions summed in another order: allclose atol 1e-6, rtol
# 1e-4. Graph against per-step: bit for bit, as in the gs phase (the step
# takes cuDNN's deterministic convolutions while LPIPS is on).
LPIPS_STEPS = 100
LPIPS_TOL = (1e-6, 1e-4)
# The optins phase. An opt-in's latents against the path it must equal
# (direction_parallel against the sequential directions, the unfused post
# step against the fused one, the reuse step with zero CLIP embeddings
# against the default): bf16 on both sides, but batches of another size,
# so other cuBLAS and cuDNN algorithms and GroupNorm fold orders (last-bit
# differences), which 2 steps of per-tile top-k masks and std
# normalization amplify: max-abs over max |want| 1e-1, rel-RMS 2e-2.
OPTIN_TOL = (1e-1, 2e-2)
# The forward-warp conditioning on the card against the CPU. The splat's
# float atomics sum in another order and the projection rounds
# differently (~6e-5 px at 1024 px): cond values move by less than 1e-3,
# except where a source position is integral on one side only. There the
# kept ceil quirk (ceil == floor) gives that source 2x its weight per
# axis, a jump of up to the colour difference it mixes with; per
# coordinate such a position occurs with a chance of ~6e-5 (float32's
# spacing there), and a source feeds 4 pixels: at most 2e-3 of the pixels
# without a hole may move by more than 1e-3 ("cond_moved"). A pixel
# reached only by a sliver of a source's weight may be a hole on one side
# only: at most 1e-4 of the pixels, and 1e-3 of the binary latent mask
# entries.
FW_TOL = {"cond": 1e-3, "cond_moved": 2e-3, "holes": 1e-4,
          "latent_masks": 1e-3}
# the slice phase: the training entry point with this slice's flags on
# the scene phase's scene and cuts, one refine cycle
SLICE_FLAGS = (["--n_views", "3", "--refine_cycle_num", "1"] + SCENE_CUTS
               + ["--interp_type", "forward_warp", "--save_debug",
                  "--guidance_reuse_cfg_uncond", "1"])
# the mono phase: iterations and sample_pseudo_interval
MONO_ITERS, MONO_INTERVAL = 100, 5
# the fleet step's scan: images at 504x378 (llffhold 8: 2 test views)
FLEET_IMAGES = 10
# the plain versions of GEGLU and flash run on at most this many rows (the
# dtu phase's batch-2 rows, 50 x 9216) or batch entries (its B = 50) of a
# shape; a larger shape is held on its first and its last such slice
SLICE_ROWS, SLICE_B = 50 * 9216, 50
# The parallel phase. One full-width batch-3 UNet forward split over 2
# devices (tensor-parallel: the row-parallel partials rounded to bf16 and
# added; sequence-parallel: the halo convolutions, the temporal
# attention's dense path against the packed one, the temporal GroupNorm's
# float32 sums in another order) and GPipe's 4 stages against the
# unsplit forward / the sequential tower: last-bit differences of bf16
# outputs (2^-9 relative) at every attention and FF output, which the
# residual stream of ~50 blocks carries to the output: max-abs over max
# |want| 1e-1, rel-RMS 5e-2. A wrong head, unit or frame split moves the
# output by O(1). Direction sharding and pair waves on a mesh that repeats one card
# run the sequential unit's own calls: bit for bit (OPTIN_TOL across
# distinct cards, whose kernels may pick other algorithms).
PAR_TOL = (1e-1, 5e-2)
# GPipe: stages and microbatches (of 3 rows each)
PAR_STAGES, PAR_MICRO = 4, 4
# The DP GS step (4 views over 2 replicas) against the one-replica step:
# float32, the views' gradients summed in another order. The loss within
# 1e-5 relative; Adam moves a mean by at most its learning rate, whatever
# the gradient's size, so a gradient at rounding level may flip a move:
# every mean within 2 lr, and at most 1e-3 of them beyond 1e-5.
DP_LOSS_RTOL, DP_MEANS_ATOL, DP_MEANS_FRACTION = 1e-5, 1e-5, 1e-3
# the vision phase: DUSt3R ViT-L/512 and the public GMFlow (128 channels,
# 6 layers) at full width with random float32 weights from seeds
# (scripts/vision_weights.py), saved as the npz trees that the dl3dv
# phase's --dust3r_weights / --gmflow_weights read; each network on the
# card against the same weights on the CPU, float32 on both sides with TF32
# off, sums in another order. DUSt3R: allclose atol 1e-4, rtol 1e-4 (its
# outputs are O(1), 36 blocks of float32 sums). GMFlow: 1e-2 px absolute:
# the flow is an expectation over the 8,160 cells of the 1/8 grid, up to
# ~120 cells (x8 px) apart, so a relative error of ~1e-5 in the softmax
# weights moves it by ~1e-3 px (and the propagation by as much again);
# the gate's threshold is 3 px. The alignment (VISION_ALIGN: views, pixels,
# steps) on a small input: depths and scales rtol 1e-3, as its CPU test.
VISION_SEEDS = {"dust3r": 21, "gmflow": 22}
DUST3R_TOL, GMFLOW_TOL_PX, ALIGN_RTOL = (1e-4, 1e-4), 1e-2, 1e-3
DUST3R_HW, GMFLOW_HW = (288, 512), (540, 960)
VISION_ALIGN = (4, (36, 64), 300)
# the dl3dv phase: cli/batch.py's DL3DV preset with --lpips_weight 1
# (SURVEY section 2.4, batch_dl3dv_train.sh) and the scene phase's cuts,
# on a synthetic scan
# written as COLMAP under images_4/ at 960x540 (the gs phase's truth from
# DL3DV_IMAGES cameras; llffhold 8 makes images 0 and 8 the test views and
# --n_views 9 takes the other 9), with random LPIPS, DUSt3R and GMFlow
# weights and the unit's post completion: 2 cycles x 9 wrap-around pairs.
DL3DV_FLAGS = (cli_batch.PRESETS["dl3dv"]
               + ["--lpips_weight", "1", "--dataset", "dl3dv"] + SCENE_CUTS)
DL3DV_IMAGES, DL3DV_W, DL3DV_H = 11, 960, 540
# 9 views, so 9 wrap-around pairs a cycle
DL3DV_VIEWS, DL3DV_CYCLES, DL3DV_TEST = 9, 2, 2
# elementwise operations per element, for the norm bounds (memory bounds
# them all): stats add + fma; apply fma (+ exp, add, divide for SiLU);
# LayerNorm add, fma, subtract, 2 multiplies, add
NORM_OPS = {"stats": 3, "apply": 2, "apply_silu": 5, "layer_norm": 6}
# the completion unit's kernels: the scene, dtu and dl3dv phases launch
# each n_units times as often as the unit phase (the backward none)
UNIT_KERNELS = ("geglu_ffn", "flash_attention", "flash_attention_bwd_dkv",
                "flash_attention_bwd_dq", "gn_stats", "gn_apply",
                "layer_norm")
# the kernels of a scene run's path (the flash backward runs only with
# guidance_through_unet)
PATH_KERNELS = ("geglu_ffn", "flash_attention", "gn_stats", "gn_apply",
                "layer_norm", "composite_fwd", "composite_bwd", "project_fwd",
                "project_bwd")


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# each kernel's key in the launch counters (utils.profiling.counters)
LAUNCH_KEYS = {"geglu_ffn": "launches.geglu_ffn",
               "flash_attention": "launches.flash",
               "flash_attention_bwd_dkv": "launches.flash_bwd.dkv",
               "flash_attention_bwd_dq": "launches.flash_bwd.dq",
               "composite_fwd": "launches.composite_fwd",
               "composite_bwd": "launches.composite_bwd",
               "project_fwd": "launches.project_fwd",
               "project_bwd": "launches.project_bwd",
               "gn_stats": "launches.gn_stats",
               "gn_apply": "launches.gn_apply",
               "layer_norm": "launches.layer_norm"}


def launch_counts():
    """Every kernel wrapper's launch count."""
    return {name: counters[key] for name, key in LAUNCH_KEYS.items()}


def zero_counts():
    for key in LAUNCH_KEYS.values():
        counters[key] = 0


GS_KERNELS = ("composite_fwd", "composite_bwd", "project_fwd", "project_bwd")


def gs_launches() -> dict:
    """The GS kernels' launches by name (``GS_KERNELS``)."""
    return {k: counters[LAUNCH_KEYS[k]] for k in GS_KERNELS}


def gs_want(fwd: int, bwd: int) -> dict:
    """``gs_launches`` of fwd renders of which bwd took a gradient: each
    render projects and composites once."""
    return {"composite_fwd": fwd, "composite_bwd": bwd, "project_fwd": fwd,
            "project_bwd": bwd}


def gs_path_ok(launches: dict, steps: int) -> bool:
    """A scene run's GS kernels: one backward of each a train step, more
    forwards (the renders), the projection's launches the composite's."""
    return (launches["composite_bwd"] == steps
            and launches["composite_fwd"] > steps
            and launches["project_fwd"] == launches["composite_fwd"]
            and launches["project_bwd"] == steps)


def zero_gs_launches():
    for k in GS_KERNELS:
        counters[LAUNCH_KEYS[k]] = 0


def norm_modules(module):
    """(GroupNorm, LayerNorm) modules in ``module``'s tree: each runs once
    a forward, one launch of each of its kernels."""
    mods = list(module.modules())
    return (sum(isinstance(m, L.GroupNorm) for m in mods),
            sum(isinstance(m, L.LayerNorm) for m in mods))


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


def bound_ms(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def timed_turns(kernel, library, smi):
    """The kernel and its library call in turns (kernel, library, library,
    kernel), each window at least ~0.25 s; per window ms, SM MHz and W."""
    iters = window_iters(kernel, library)
    out = {"ms": [], "library_ms": [], "sm_mhz": [], "power_w": []}
    for name, fn in (("ms", kernel), ("library_ms", library),
                     ("library_ms", library), ("ms", kernel)):
        ms, mhz, watts = smi.timed(fn, iters)
        out[name].append(ms)
        out["sm_mhz"].append(mhz)
        out["power_w"].append(watts)
    return out


def turns_row(turns):
    """Mean kernel and library times of the turns, and the turns."""
    return dict(ms=float(np.mean(turns["ms"])),
                library_ms=float(np.mean(turns["library_ms"])),
                turns_ms=[turns["ms"][0], turns["library_ms"][0],
                          turns["library_ms"][1], turns["ms"][1]],
                sm_mhz=turns["sm_mhz"], power_w=turns["power_w"])


def sass_count(name, opcode):
    """Instructions of ``opcode`` in kernel library ``name``'s SASS
    (cuobjdump), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sum(opcode in line for line in out.splitlines())


def geglu_inputs(gen, dev, r, c, inner=None):
    """bf16 x (r, c) and Linear-layout weights of width c and ``inner``
    GEGLU units (4c; a tensor-parallel shard's fewer), from ``gen``."""
    inner = 4 * c if inner is None else inner

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)
    return (rnd(r, c), rnd(2 * inner, c, std=c ** -0.5),
            rnd(2 * inner, std=0.1), rnd(c, inner, std=inner ** -0.5),
            rnd(c, std=0.1))


def check_geglu(gen, dev, smi):
    rows_out = []
    for r, c, calls in FFN_SHAPES:
        x, w1, b1, w2, b2 = geglu_inputs(gen, dev, r, c)
        got = geglu_ffn(x, w1, b1, w2, b2)
        want = geglu_ffn_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        max_abs, rel_rms = check("geglu_ffn", got, want)
        del got, want

        def library():
            a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(a * F.gelu(g), w2, b2)

        turns = timed_turns(lambda: geglu_ffn(x, w1, b1, w2, b2), library,
                            smi)
        plain = cuda_ms(lambda: geglu_ffn_reference(x, w1, b1, w2, b2), 3)
        flops = 24 * r * c * c
        nbytes = 2 * (2 * r * c + 12 * c * c + 9 * c)
        bms, by = bound_ms(flops, nbytes)
        row = dict(rows=r, c=c, calls_per_forward=calls, max_abs_err=max_abs,
                   rel_rms_err=rel_rms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, **turns_row(turns))
        row["tflops"] = flops / row["ms"] / 1e9
        say("kernels", name="geglu_ffn", **row)
        rows_out.append(row)
        del x, w1, b1, w2, b2
        torch.cuda.empty_cache()
    return rows_out


def check_geglu_small(gen, dev):
    """GEGLU against its plain version at FFN_SMALL_SHAPES (GEMM-2's
    128-column tile) and FFN_SHARD_SHAPES (not timed)."""
    rows_out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r, c, inner in FFN_SMALL_SHAPES + FFN_SHARD_SHAPES:
        bn2 = geglu_plan(r, c, sms, inner)["bn2"]
        args = geglu_inputs(gen, dev, r, c, inner)
        got = geglu_ffn(*args)
        want = geglu_ffn_reference(*args)
        torch.cuda.synchronize()
        max_abs, rel_rms = check("geglu_ffn", got, want)
        row = dict(rows=r, c=c, inner=inner, bn2=bn2, max_abs_err=max_abs,
                   rel_rms_err=rel_rms)
        say("kernels", name="geglu_ffn", what="off the main path", **row)
        if (r, c, inner) in FFN_SMALL_SHAPES and bn2 != 128:
            raise AssertionError(f"geglu_ffn at C={c} took bn2={bn2}")
        rows_out.append(row)
        del args, got, want
    return rows_out


def geglu_parity(root, gen, dev):
    """GEGLU's output at FFN_SHAPES against the kernel of the checkout at
    ``root`` (a ``git archive`` of another commit): its csrc/geglu_ffn.cu
    built as it stands there, with this checkout's flags, and called
    through its C entry (the same signature) with one block per SM for
    both GEMMs, which every version of the kernel takes (a block with no
    tile of its own does nothing); GEMM-2's tile from this checkout's
    plan. The max-abs difference per shape (0: bit for bit)."""
    src = os.path.join(os.path.abspath(root), "syn3r_tpu_torch", "csrc")
    out = build.BUILD_DIR / "other" / "geglu_ffn.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", src, "-o",
                    str(out), os.path.join(src, "geglu_ffn.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).syn3r_geglu_ffn
    fn.argtypes = build.SIGNATURES["geglu_ffn"]["syn3r_geglu_ffn"]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_out = []
    for r, c, _ in FFN_SHAPES:
        x, w1, b1, w2, b2 = geglu_inputs(gen, dev, r, c)
        got = geglu_ffn(x, w1, b1, w2, b2)
        h = torch.empty((r, 4 * c), dtype=torch.bfloat16, device=dev)
        y = torch.empty((r, c), dtype=torch.bfloat16, device=dev)
        err = fn(*(t.data_ptr() for t in (x, w1, b1, w2, b2)), h.data_ptr(),
                 y.data_ptr(), r, c, 4 * c, geglu_plan(r, c, sms)["bn2"],
                 sms, sms, torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"{root}'s geglu_ffn failed: cudaError {err}")
        row = dict(rows=r, c=c, max_abs_diff=float(
            (got.float() - y.float()).abs().max()))
        say("kernels", name="geglu_ffn", against=root, **row)
        rows_out.append(row)
        del x, w1, b1, w2, b2, got, h, y
        torch.cuda.empty_cache()
    return rows_out


def check_attention(gen, dev, smi):
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
        turns = timed_turns(
            lambda: A.flash_attention(q, k, v, 0.125),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125), smi)
        plain = cuda_ms(lambda: A.attention_chunked(q, k, v, 0.125), 1)
        flops = 4 * bh * s * s * 64
        nbytes = 4 * bh * s * 64 * 2
        bms, by = bound_ms(flops, nbytes)
        row = dict(bh=bh, tokens=s, calls_per_forward=calls,
                   max_abs_err=max_abs, rel_rms_err=rel_rms, plain_ms=plain,
                   bound_ms=bms, bound_by=by, exps=bh * s * s,
                   exp_ms=1e3 * bh * s * s / PEAK_MUFU_EXPS,
                   **turns_row(turns))
        row["tflops"] = flops / row["ms"] / 1e9
        say("kernels", name="flash_attention", **row)
        rows_out.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows_out


def check_frame_attention(gen, dev, smi):
    """The frame-attention kernel at the temporal self-attention's shapes
    (FRAME_ATTN_SHAPES: q, k, v split views of (rows, 25, C) projections,
    as the UNet's), against the packed version, timed in turns against
    SDPA on the same views (the yardstick; the port never calls it)."""
    rows_out = []
    for rows, h, s, calls in FRAME_ATTN_SHAPES:
        q, k, v = (torch.randn((rows, s, h * 64), generator=gen, device=dev)
                   .to(torch.bfloat16).unflatten(-1, (h, 64)).transpose(1, 2)
                   for _ in range(3))
        got = A.frame_attention(q, k, v, 0.125)
        want = A.attention_packed_heads(q, k, v, 0.125)
        torch.cuda.synchronize()
        max_abs, rel_rms = check("frame_attention", got, want)
        del got, want
        turns = timed_turns(
            lambda: A.frame_attention(q, k, v, 0.125),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125), smi)
        plain = cuda_ms(lambda: A.attention_packed_heads(q, k, v, 0.125), 3)
        flops = 4 * rows * h * s * s * 64
        nbytes = 4 * rows * h * s * 64 * 2
        bms, by = bound_ms(flops, nbytes)
        row = dict(rows=rows, heads=h, frames=s, calls_per_forward=calls,
                   max_abs_err=max_abs, rel_rms_err=rel_rms, plain_ms=plain,
                   bound_ms=bms, bound_by=by, **turns_row(turns))
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        say("kernels", name="frame_attention", **row)
        rows_out.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows_out


def check_small_unet(dev):
    """A small UNet through the kernels (bf16, card) against the plain path
    (float32, CPU): the kernels as the modules call them."""
    cpu, card = small_unet_pair(dev)
    g = torch.Generator().manual_seed(2)
    sample = torch.randn((3, 5, 32, 32, 8), generator=g)
    ehs = torch.randn((3, 1, 1024), generator=g)
    tids = torch.tensor([[6.0, 127.0, 0.02]]).repeat(3, 1)
    with torch.no_grad():
        want = cpu(sample, torch.tensor(1.3), ehs, tids, (1, 2))
        zero_counts()
        got = card(sample.to(dev, torch.bfloat16), torch.tensor(1.3),
                   ehs.to(dev, torch.bfloat16), tids.to(dev), (1, 2))
    torch.cuda.synchronize()
    used = launch_counts()
    max_abs, rel_rms = errors(got.cpu(), want)
    say("small", what="bf16 UNet on card vs f32 on CPU", max_abs=max_abs,
        rel_rms=rel_rms, launches=used)
    n_gn, n_ln = norm_modules(card)
    norms = {"gn_stats": n_gn, "gn_apply": n_gn, "layer_norm": n_ln}
    # bf16 activations and weights through ~40 layers against float32
    if not (rel_rms < 5e-2 and used["geglu_ffn"] > 0
            and used["flash_attention"] > 0
            and all(used[k] == v for k, v in norms.items())):
        raise AssertionError(f"small UNet: rel_rms {rel_rms}, launches "
                             f"{used}, norms expected {norms}")
    return dict(max_abs=max_abs, rel_rms=rel_rms, launches=used)


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

    census = NormCensus()
    census.watch(pipe.m.unet, "unet")
    census.watch(pipe.m.clip, "clip")
    census.watch(pipe.m.vae.encoder, "vae_encode")
    census.watch(pipe.m.vae.decoder, "vae_decode")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    counters["norm.copies"] = 0
    counters["launches.frame_attn"] = 0
    counters["launches.geglu_ffn.overlap"] = 0
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
    launches = launch_counts()
    norm_copies = counters["norm.copies"]
    frame_launches = counters["launches.frame_attn"]
    geglu_overlap = counters["launches.geglu_ffn.overlap"]
    census.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if tuple(frames.shape) != (FRAMES, HEIGHT, WIDTH, 3):
        raise AssertionError(f"frames shape {tuple(frames.shape)}")
    if not bool(torch.isfinite(frames).all()):
        raise AssertionError("frames not finite")
    lo, hi = frames.min().item(), frames.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"frames outside [0, 1]: {lo} {hi}")
    # 2 directions per step, one batch-3 forward each; every norm module
    # once a forward (the UNet's from its tree), one launch of each kernel
    # a norm call
    forwards = 2 * STEPS
    n_gn, n_ln = norm_modules(pipe.m.unet)
    unet_calls = census.totals("unet")
    if unet_calls != {"group_norm": n_gn * forwards,
                      "layer_norm": n_ln * forwards}:
        raise AssertionError(f"UNet norm calls {unet_calls}, expected "
                             f"{n_gn} GroupNorms and {n_ln} LayerNorms x "
                             f"{forwards} forwards")
    unet_ln = {key[2]: n / forwards for key, n in census.calls.items()
               if key[:2] == ("layer_norm", "unet")}
    if unet_ln != {(r, c): n for r, c, n in LN_SHAPES} or any(
            key[3] != torch.bfloat16 or key[7] != torch.bfloat16
            for key in census.calls if key[:2] == ("layer_norm", "unet")):
        raise AssertionError(f"UNet LayerNorm calls a forward {unet_ln}, "
                             f"expected LN_SHAPES in bf16: {LN_SHAPES}")
    unet_gn = {}
    for key, n in census.calls.items():
        if key[:2] == ("group_norm", "unet"):
            got = unet_gn.setdefault(key[2], [0, 0])
            got[0] += n / forwards
            got[1] += n / forwards if key[4] else 0
    if unet_gn != {(b, s, c): [n, n_silu] for b, s, c, n, n_silu
                   in GN_SHAPES} or any(
            key[3] != torch.bfloat16 or key[7] != torch.bfloat16
            or key[5] != 32
            for key in census.calls if key[:2] == ("group_norm", "unet")):
        raise AssertionError(f"UNet GroupNorm calls a forward {unet_gn}, "
                             f"expected GN_SHAPES in bf16: {GN_SHAPES}")
    calls = census.totals()
    want = {"geglu_ffn": 48 * forwards, "flash_attention": 15 * forwards,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            **gs_want(0, 0),
            "gn_stats": calls["group_norm"], "gn_apply": calls["group_norm"],
            "layer_norm": calls["layer_norm"]}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    # every GEGLU launch at the UNet's widths runs GEMM-1's epilogue under
    # the next tile's wgmmas
    if geglu_overlap != launches["geglu_ffn"]:
        raise AssertionError(f"launches.geglu_ffn.overlap {geglu_overlap}, "
                             f"expected {launches['geglu_ffn']}")
    # the temporal self-attention: the frame-attention kernel, 16 a forward
    frame_calls = sum(c for *_, c in FRAME_ATTN_SHAPES)
    if frame_launches != frame_calls * forwards:
        raise AssertionError(f"frame_attention launches {frame_launches}, "
                             f"expected {frame_calls} x {forwards}")

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
        peak_mem_gb=peak_gb, launches=launches,
        frame_attention_launches=frame_launches,
        geglu_overlap_launches=geglu_overlap,
        unet_norms_per_forward=(n_gn, n_ln), norm_input_copies=norm_copies,
        **stage)
    res = dict(stage, peak_mem_gb=peak_gb, launches=launches,
               frame_attention_launches=frame_launches,
               geglu_overlap_launches=geglu_overlap,
               frame_range=[lo, hi], load_s=load_s,
               unet_norms_per_forward=[n_gn, n_ln], forwards=forwards,
               norm_input_copies=norm_copies)
    return res, pipe, census.calls


def check_rel(name, got, want, tol=BWD_TOL):
    """max-abs over max |want| and rel-RMS within ``tol``; returns (max_abs,
    rel_rms, max_abs relative)."""
    max_abs, rel_rms = errors(got, want)
    rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    if not (np.isfinite(max_abs) and rel <= tol[0] and rel_rms <= tol[1]):
        raise AssertionError(f"{name}: max_abs {max_abs} ({rel} of max "
                             f"|want|) rel_rms {rel_rms} beyond {tol}")
    return max_abs, rel_rms, rel


def bwd_parts(q, k, v, out, lse, dout, scale):
    """The backward's operands as ``flash_attention_bwd`` prepares them,
    and a launch of each kernel alone (dq first: it writes the D that dkv
    reads), for timing them one by one."""
    b, h, s, _ = q.shape
    plan = A.flash_bwd_plan(b, h, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    views, lse_p, delta = A.flash_bwd_operands(q, k, v, out, dout, lse,
                                               plan["ld"])
    outs = {"dq": (A.like_projection(q),),
            "dkv": (A.like_projection(k), A.like_projection(v))}
    launch = {n: (lambda n=n: A.flash_bwd_launch(
        n, plan, views, lse_p, delta, outs[n], scale)) for n in outs}
    return plan, delta, launch


def check_attention_bwd(gen, dev, smi):
    """The guided phase's kernels at each grad-pass shape (B 25 frames):
    the forward's lse against attention_lse_reference; dq, dk and dv
    against flash_attention_bwd_reference (fed the kernel's out and lse)
    and against autograd through attention_chunked (on b = 0 at the top
    level, whose plain autograd would keep ~60 GB of probabilities); the D
    that the dq kernel writes against the torch reduction (D_TOL); two
    backward calls bit for bit; the whole backward in turns against
    F.scaled_dot_product_attention's backward (autograd.grad of its
    output, its forward not timed); each kernel alone, the torch reduction
    of D alone (delta_ms, the pass the dq kernel's prologue replaces), the
    plain version and the forward with and without lse."""
    names = ("dq", "dk", "dv")
    rows = []
    for b, h, s, calls in GRAD_ATTN_SHAPES:
        scale, bh = 0.125, b * h
        # (B, S, H, D) projections viewed as (B, H, S, D), as the UNet does
        q, k, v, dout = (torch.randn((b, s, h, 64), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         .transpose(1, 2) for _ in range(4))
        out, lse = A._flash_forward(q, k, v, scale, with_lse=True)
        lse_err = (lse - A.attention_lse_reference(q, k, scale)).abs().max()
        fwd_err = check("flash_attention", out,
                        A.attention_chunked(q, k, v, scale))
        if not float(lse_err) <= LSE_TOL:
            raise AssertionError(f"flash lse at {(b, h, s)}: max_abs "
                                 f"{float(lse_err)} > {LSE_TOL}")
        got = A.flash_attention_bwd(q, k, v, out, lse, dout, scale)
        again = A.flash_attention_bwd(q, k, v, out, lse, dout, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash backward at {(b, h, s)}: two "
                                 "calls differ")
        del again
        want = A.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                               scale)
        err = {n: check_rel(f"flash bwd {n} at {(b, h, s)}", g, w)
               for n, g, w in zip(names, got, want)}
        del want
        rows_b = slice(0, 1) if s > 4096 else slice(None)
        leaves = [t[rows_b].detach().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(A.attention_chunked(*leaves, scale),
                                   leaves, dout[rows_b])
        auto_err = {n: check_rel(f"flash bwd {n} vs autograd at "
                                 f"{(b, h, s)}", g[rows_b], w)
                    for n, g, w in zip(names, got, auto)}
        del auto, leaves, got
        torch.cuda.empty_cache()

        plan, delta, launch = bwd_parts(q, k, v, out, lse, dout, scale)
        launch["dq"]()
        torch.cuda.synchronize()
        delta_err = check_rel(f"flash bwd D at {(b, h, s)}",
                              delta[..., :s],
                              (dout.float() * out.float()).sum(-1),
                              (D_TOL, D_TOL))
        part_ms = {n: cuda_ms(launch[n], 5) for n in ("dq", "dkv")}
        delta_ms = cuda_ms(lambda: (dout.float() * out.float()).sum(-1), 5)
        fwd_ms = {str(w): cuda_ms(lambda w=w: A._flash_forward(
            q, k, v, scale, w), 5) for w in (False, True)}
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
        turns = timed_turns(
            lambda: A.flash_attention_bwd(q, k, v, out, lse, dout, scale),
            lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), dout,
                                        retain_graph=True), smi)
        plain = cuda_ms(lambda: A.flash_attention_bwd_reference(
            q, k, v, out, lse, dout, scale), 1)
        unit = bh * s * s * 64          # one (S x S x 64) product: 2 x this
        row_bytes = bh * s * 64 * 2     # one bf16 (B, H, S, 64) tensor
        # dkv: S^T, dP^T, dV, dK; reads q, k, v, dout, lse and D, writes dk
        # and dv. dq: S, dP, dQ; reads q, k, v, dout, out and lse, writes dq
        # and D.
        bounds = {n: bound_ms(2 * unit * prods,
                              n_rows * row_bytes + 2 * bh * s * 4)
                  for n, prods, n_rows in (("dkv", 4, 6), ("dq", 3, 6))}
        # the whole backward: five products, q, k, v, out, dout and lse
        # read, dq, dk, dv written
        fn_bound = bound_ms(10 * unit, 8 * row_bytes + bh * s * 4)
        row = dict(b=b, h=h, tokens=s, calls_per_grad_pass=calls,
                   lse_max_abs_err=float(lse_err),
                   fwd_max_abs_err=fwd_err[0],
                   errors={n: dict(zip(("max_abs", "rel_rms", "rel_max"),
                                       e)) for n, e in err.items()},
                   autograd_errors={n: dict(zip(("max_abs", "rel_rms",
                                                 "rel_max"), e))
                                    for n, e in auto_err.items()},
                   autograd_rows="b = 0" if s > 4096 else "all",
                   delta_errors=dict(zip(("max_abs", "rel_rms", "rel_max"),
                                         delta_err)),
                   plain_ms=plain, bound_ms=fn_bound[0],
                   bound_by=fn_bound[1], exps_per_kernel=bh * s * s,
                   exp_ms_per_kernel=1e3 * bh * s * s / PEAK_MUFU_EXPS,
                   delta_ms=delta_ms, plan={n: {x: plan[n][x] for x in (
                       "grid", "smem", "stages")} for n in ("dkv", "dq")},
                   fwd_ms_without_lse=fwd_ms["False"],
                   fwd_ms_with_lse=fwd_ms["True"], **turns_row(turns))
        for n in ("dkv", "dq"):
            row[n] = dict(ms=part_ms[n], bound_ms=bounds[n][0],
                          bound_by=bounds[n][1],
                          tflops=2 * unit * (4 if n == "dkv" else 3)
                          / part_ms[n] / 1e9)
        row["tflops"] = 10 * unit / row["ms"] / 1e9
        say("guided", what="flash backward kernels", **row)
        rows.append(row)
        del q, k, v, dout, out, lse, delta, launch, qs, ks, vs, o_sdpa
        torch.cuda.empty_cache()
    return rows


def bwd_layout_inputs(gen, dev, b, h, s, layout):
    """q, k, v, dout (B, H, S, 64) bf16 in ``layout``: "projection" (views
    of (B, S, H, 64) tensors, as the UNet's), "contiguous" ((B, H, S, 64)
    tensors) or "misaligned" (views of (B, S, H, 66) tensors sliced to 64:
    rows 132 bytes apart, which TMA cannot read, so the wrapper copies
    them)."""
    def one():
        if layout == "contiguous":
            return torch.randn((b, h, s, 64), generator=gen,
                               device=dev).to(torch.bfloat16)
        width = 66 if layout == "misaligned" else 64
        return (torch.randn((b, s, h, width), generator=gen, device=dev)
                .to(torch.bfloat16)[..., :64].transpose(1, 2))
    return [one() for _ in range(4)]


def check_bwd_layouts(gen, dev):
    """The backward kernels off the grad pass's shapes, against
    flash_attention_bwd_reference at BWD_TOL (each with the forward
    kernel's out and lse): ragged S at small B*H (the last 128-row tile
    and, at 200 and 1000, the last 64-row stage part filled), a contiguous
    (B, H, S, 64) input and a misaligned view that the wrapper copies.
    Launches are counted: one dq and one dkv a call."""
    rows = []
    for b, h, s, layout in BWD_LAYOUTS:
        q, k, v, dout = bwd_layout_inputs(gen, dev, b, h, s, layout)
        if layout == "misaligned" and A.flash_tensor_map(
                q.shape, q.stride(), q.data_ptr(), A.FLASH_BWD_ROWS):
            raise AssertionError("misaligned backward input maps as it is")
        out, lse = A._flash_forward(q, k, v, 0.125, with_lse=True)
        before = {n: counters[f"launches.flash_bwd.{n}"]
                  for n in ("dkv", "dq")}
        got = A.flash_attention_bwd(q, k, v, out, lse, dout, 0.125)
        torch.cuda.synchronize()
        launched = {n: counters[f"launches.flash_bwd.{n}"] - before[n]
                    for n in before}
        want = A.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                               0.125)
        err = {n: check_rel(f"flash bwd {n} at {(b, h, s)} {layout}", g, w)
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        if launched != {"dkv": 1, "dq": 1}:
            raise AssertionError(f"flash bwd at {(b, h, s)} {layout}: "
                                 f"launches {launched}")
        row = dict(b=b, h=h, tokens=s, layout=layout,
                   errors={n: dict(zip(("max_abs", "rel_rms", "rel_max"), e))
                           for n, e in err.items()})
        say("guided", what="flash backward off the grad pass", **row)
        rows.append(row)
    return rows


def small_unet_pair(dev):
    """check_small_unet's UNet: float32 on the CPU and bf16 on the card,
    the same weights, frozen."""
    kw = dict(block_out_channels=(64, 128), num_attention_heads=(1, 2),
              layers_per_block=1, addition_time_embed_dim=32)
    cpu = UNetSpatioTemporalConditionModel(**kw).eval()
    init_random_weights_(cpu, torch.Generator().manual_seed(1))
    card = UNetSpatioTemporalConditionModel(**kw).eval()
    card.load_state_dict(cpu.state_dict())
    return (cpu.requires_grad_(False),
            card.to(dev, torch.bfloat16).requires_grad_(False))


def check_small_unet_grad(dev):
    """d guidance_loss / d sample through the small UNet with its blocks
    checkpointed: bf16 on the card through the kernels (flash forward at
    S = 1024 and its backward) against float32 autograd on the CPU through
    the plain path, with the CPU's top-k masks on both sides."""
    cpu, card = small_unet_pair(dev)
    g = torch.Generator().manual_seed(4)
    sample = torch.randn((1, 5, 32, 32, 8), generator=g)
    cond = torch.randn((5, 4, 32, 32), generator=g) * 0.5
    mask = torch.rand((3, 32, 32), generator=g)
    lam = (torch.rand((5,), generator=g) > 0.4).float()
    tids = torch.tensor([[6.0, 127.0, 0.02]])
    sigma = torch.tensor(2.0)

    def grad(net, x, dtype, masks=None):
        d = x.device
        x = x.clone().requires_grad_(True)
        eps = net(x.to(dtype), torch.tensor(1.3),
                  torch.zeros((1, 1, 1024), dtype=dtype, device=d),
                  tids.to(d), remat_blocks=True)[0].float()
        x0 = SCH.pred_original_sample(eps, x[0, ..., :4],
                                      sigma.to(d)).permute(0, 3, 1, 2)
        if masks is None:
            masks = SCH.top_k_masks(x0.detach(), cond, mask, lam)
        loss = SCH.guidance_loss(x0, cond.to(d), masks.to(d))
        return torch.autograd.grad(loss, x)[0], masks

    want, masks = grad(cpu, sample, torch.float32)
    zero_counts()
    got, _ = grad(card, sample.to(dev), torch.bfloat16, masks)
    torch.cuda.synchronize()
    used = launch_counts()
    max_abs, rel_rms = errors(got.cpu(), want)
    say("guided", what="small UNet d loss/d sample, bf16 card vs f32 CPU",
        max_abs=max_abs, rel_rms=rel_rms, launches=used)
    # one flash call a transformer at the 1024-token level, run twice (the
    # checkpoint's recompute), one backward each
    if not (rel_rms < SMALL_GRAD_TOL and used["flash_attention_bwd_dkv"] > 0
            and used["flash_attention"] == 2 * used["flash_attention_bwd_dkv"]
            and used["flash_attention_bwd_dq"]
            == used["flash_attention_bwd_dkv"] and used["geglu_ffn"] > 0):
        raise AssertionError(f"small UNet gradient: rel_rms {rel_rms}, "
                             f"launches {used}")
    return dict(max_abs=max_abs, rel_rms=rel_rms, launches=used)


def run_guided(pipe, unit):
    """The full-width unit with guidance_through_unet=True on the unit
    phase's networks and inputs: 2 steps, post. Launch counts exact per
    step and direction: the batch-1 grad pass runs each block's forward
    twice (the checkpoint's recompute; conv_norm_out is in no block and
    runs once) and one flash backward per flash call, then the batch-2 CFG
    forward. Its s per denoise step beside the default variant's, run in
    this phase on the same inputs; the frames finite and apart from the
    default's."""
    dev = pipe.device
    guided = GuidedSVDPipeline(pipe.m, GuidedSVDConfig(
        num_inference_steps=STEPS, guidance_through_unet=True))
    g = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.rand((FRAMES, HEIGHT, WIDTH, 3), generator=g, device=dev)
    mask = torch.rand((FRAMES - 2, HEIGHT // 8, WIDTH // 8), generator=g,
                      device=dev)
    lam = search_hypers_v2(mask, STEPS)
    clip_s, clip_e, cond, _, _ = guided.encode_conditioning(
        imgs[0], list(imgs[1:-1]), imgs[-1], g)
    latents = torch.randn((1, FRAMES, HEIGHT // 8, WIDTH // 8, 4),
                          generator=g, device=dev)
    args = (latents, clip_s, clip_e, cond, mask, lam)
    out, seconds = {}, {}
    for name, p in (("default", pipe), ("guided", guided)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out[name] = p.denoise(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        if name == "guided":
            launches = launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = guided.decode(out["guided"])
    torch.cuda.synchronize()

    unet = pipe.m.unet
    blocks = (*unet.down_blocks, unet.mid_block, *unet.up_blocks)
    n_gn, n_ln = norm_modules(unet)
    gn_out = n_gn - sum(norm_modules(blk)[0] for blk in blocks)
    ln_out = n_ln - sum(norm_modules(blk)[1] for blk in blocks)
    per = {"geglu_ffn": 3 * 48, "flash_attention": 3 * 15,
           "flash_attention_bwd_dkv": 15, "flash_attention_bwd_dq": 15,
           "gn_stats": 3 * n_gn - gn_out, "gn_apply": 3 * n_gn - gn_out,
           "layer_norm": 3 * n_ln - ln_out, **gs_want(0, 0)}
    want = {k: 2 * STEPS * v for k, v in per.items()}
    diff = (out["guided"] - out["default"]).abs().max().item()
    lo, hi = frames.min().item(), frames.max().item()
    if (launches != want or not bool(torch.isfinite(out["guided"]).all())
            or not bool(torch.isfinite(frames).all()) or lo < 0 or hi > 1
            or not diff > 1e-3):
        raise AssertionError(f"guided unit: launches {launches} (expected "
                             f"{want}), latents apart from default by "
                             f"{diff}, frames in [{lo}, {hi}]")
    res = dict(launches=launches, per_step_and_direction=per,
               norms_outside_blocks=[gn_out, ln_out],
               s_per_denoise_step=seconds["guided"] / STEPS,
               default_s_per_denoise_step=seconds["default"] / STEPS,
               unit_phase_s_per_denoise_step=unit["s_per_denoise_step"],
               peak_mem_gb=peak_gb, latents_max_abs_diff_from_default=diff,
               frame_range=[lo, hi])
    say("guided", **res)
    return res


def run_guided_phase(pipe, unit, dev):
    """The guided phase: the backward kernels, the small UNet's gradient,
    the full-width guided unit."""
    smi = SmiSampler()
    try:
        rows = check_attention_bwd(torch.Generator(device=dev).manual_seed(5),
                                   dev, smi)
    finally:
        smi.close()
    layouts = check_bwd_layouts(torch.Generator(device=dev).manual_seed(6),
                                dev)
    small = check_small_unet_grad(dev)
    return dict(attention_bwd=rows, attention_bwd_layouts=layouts,
                small_unet_grad=small, unit=run_guided(pipe, unit))


def bwd_entries(guided, launches):
    """Kernel-line entries of the two backward kernels: sums over one
    batch-1 grad pass's 15 calls. plain_ms and library_ms are the whole
    backward's (dq, dk and dv: flash_attention_bwd_reference and SDPA's
    backward), the ms of both kernels summed set beside them."""
    rows = guided["attention_bwd"]
    out = []
    for name, part, line, errs in (
            ("flash_attention_bwd_dkv", "dkv", 1121, ("dk", "dv")),
            ("flash_attention_bwd_dq", "dq", 1456, ("dq",))):
        def tot(get):
            return sum(get(r) * r["calls_per_grad_pass"] for r in rows)
        by = max(rows, key=lambda r: r[part]["bound_ms"])
        out.append({
            "name": name, "route": "cuda",
            "source": "syn3r_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "syn3r_tpu/models/layers.py:185 (jax/experimental/"
                        f"pallas/ops/tpu/flash_attention.py:{line})",
            "launches": launches[name],
            "max_abs_err": max(r["errors"][e]["max_abs"] for r in rows
                               for e in errs),
            "ms": tot(lambda r: r[part]["ms"]),
            "plain_ms": tot(lambda r: r["plain_ms"]),
            "bound_ms": tot(lambda r: r[part]["bound_ms"]),
            "bound_by": by[part]["bound_by"],
            "library_ms": tot(lambda r: r["library_ms"]),
            "per": "one batch-1 grad pass (15 calls); plain_ms and "
                   "library_ms: the whole backward"})
    return out


def check_close(name, got, want, atol, rtol):
    """Elementwise |got - want| <= atol + rtol |want|; returns (max_abs,
    rel_rms)."""
    max_abs, rel_rms = errors(got, want)
    bad = int(((got - want).abs() > atol + rtol * want.abs()).sum())
    if bad or not np.isfinite(max_abs):
        raise AssertionError(f"{name}: {bad} elements beyond atol {atol} "
                             f"rtol {rtol}; max_abs {max_abs} rel_rms "
                             f"{rel_rms}")
    return max_abs, rel_rms


def check_grads(name, got, want):
    """The gradient tolerance of COMPOSITE_TOL, scaled by max |want|."""
    atol, rtol = COMPOSITE_TOL["bwd"]
    return check_close(name, got, want,
                       1e-6 + atol * want.abs().max().item(), rtol)


def gs_truth(dev):
    """The full-size scene, its camera and the truth the GS phases fit: a
    perturbed copy of it."""
    state, cam, rng = gs_scene(dev)
    n = state.capacity
    gt = state.replace(
        means=state.means + torch.from_numpy(
            rng.normal(0, 0.02, (n, 3)).astype(np.float32)).to(dev),
        sh_dc=GM.rgb_to_sh_dc(torch.from_numpy(
            rng.uniform(0, 1, (n, 1, 3)).astype(np.float32)).to(dev)),
        opacity_logits=torch.full_like(state.opacity_logits, 1.0))
    return state, gt, cam


def gs_views(dev):
    """The full-size scene, three cameras around it (the LLFF preset's view
    count) and their targets: renders of a perturbed copy."""
    state, gt, cam = gs_truth(dev)
    cams = [camera_from_fov(0.9, 0.7, cam.width, cam.height,
                            look_at_w2c([x, 0.0, 0.0], [0.0, 0.0, 2.5]),
                            device=dev) for x in (-0.3, 0.0, 0.3)]
    with torch.no_grad():
        targets = torch.stack([RZ.render(gt, c, method="kernel",
                                         tile_cap=GS_CAP).rgb for c in cams])
    return state, cams, targets


def composite_pairs(tl):
    """(entry, pixel) pairs whose entry has opacity >= 1/255, and those
    whose alpha passes 1/255: the work these inputs need."""
    live = hit = 0
    px = tl.P.shape[1]
    for c in range(tl.G.shape[2] // tl.K):
        sl = slice(c * tl.K, (c + 1) * tl.K)
        o = tl.O[:, :, sl]
        live += int((o >= TC.ALPHA_MIN).sum()) * px
        praw = torch.einsum("tfk,fp->tkp", tl.G[:, :, sl], tl.P)
        alpha = (o.transpose(1, 2) * torch.exp(praw.clamp(max=0.0))
                 ).clamp(max=TC.ALPHA_MAX)
        hit += int((alpha >= TC.ALPHA_MIN).sum())
    return live, hit


def skip_report(tl, keep, at_cut=None):
    """A composite kernel's keep bits ``keep`` (TC.keep_words_to_mask
    layout) on the tile lists ``tl``: (entry, warp rectangle) pairs with
    opacity >= 1/255, how many the kernel kept, how many it skipped though
    some pixel of the rectangle has alpha >= 1/255 (must be 0), and its
    disagreements with the plain mirror ``TC.reach_mask``. With ``at_cut``
    ((T, cap) bool, ``cutoff_pairs``), the skipped pairs with a hit are
    counted only on the other entries: at a cut the plain alpha may pass
    1/255 where the exact test does not."""
    T, _, cap = tl.G.shape
    pm = TC.bwd_pixel_map(tl.P.shape[1]).to(tl.G.device).reshape(-1, 128)
    live_rect = (pm >= 0).any(1)
    opaque = (tl.O[:, 0, None, :] >= TC.ALPHA_MIN) & live_rect[None, :, None]
    missed = 0
    for c in range(cap // tl.K):
        sl = slice(c * tl.K, (c + 1) * tl.K)
        praw = torch.einsum("tfk,fp->tkp", tl.G[:, :, sl], tl.P)
        alpha = (tl.O[:, :, sl].transpose(1, 2)
                 * torch.exp(praw.clamp(max=0.0))).clamp(max=TC.ALPHA_MAX)
        hit = (alpha >= TC.ALPHA_MIN)[:, :, pm.clamp_min(0)] & (pm >= 0)
        hit = hit.any(-1).transpose(1, 2)                  # (T, n_rect, K)
        if at_cut is not None:
            hit &= ~at_cut[:, None, sl]
        missed += int((hit & ~keep[:, :, sl]).sum())
    mirror = TC.reach_mask(tl.P, tl.G, tl.O, tl.K)
    pairs, kept = int(opaque.sum()), int((keep & opaque).sum())
    return dict(opaque_pairs=pairs, kept_pairs=kept,
                removed_fraction=1.0 - kept / max(pairs, 1),
                kept_outside_opaque=int((keep & ~opaque).sum()),
                skipped_with_hit=missed,
                mirror_disagreements=int((mirror != keep).sum()))


def param_grads(state, cam, target, composite, cap):
    """d loss / d every parameter field through rasterize_tiled."""
    params = {f: getattr(state, f).clone().requires_grad_(True)
              for f in GM.PARAM_FIELDS}
    sg = RZ.project_gaussians(state.replace(**params), cam)
    out = RZ.rasterize_tiled(sg, cam.height, cam.width, cap=cap,
                             composite=composite)
    loss = (gs_losses.photometric_loss(out.rgb, target)
            + 0.1 * out.alpha.mean() + 0.05 * out.depth.mean())
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def check_fwd_variants(state, cam, tl):
    """The forward kernel on lists the GS main path does not give it, each
    against the plain version within COMPOSITE_TOL["fwd"] and with the
    skip report of the main path: K 24 with lists padded to 42 chunks
    (1008 entries, not a multiple of 32), tiles of 24 x 64 (px 1536, a
    ragged last block of the backward's layout), and pixel features that
    are not [x^2, xy, y^2, x, y, 1] (the skip test off)."""
    with torch.no_grad():
        sg = RZ.project_gaussians(state, cam)
        lists = {
            "K 24, 42 chunks": RZ.bin_tiles(sg, cam.height, cam.width,
                                            cap=1000, chunk=24),
            "px 1536": RZ.bin_tiles(sg, cam.height, cam.width, tile_h=24,
                                    cap=GS_CAP, chunk=128)}
    P = tl.P.clone()
    P[0] += 1e-3
    lists["P not features"] = tl._replace(P=P)
    rows = {}
    for what, v in lists.items():
        args = (v.P, v.G, v.C, v.O)
        out, ltc, keep = TC.composite_fwd_launch(*args, v.K, keep_bits=True)
        out_ref, ltc_ref = TC.composite_fwd_reference(*args, v.K)
        torch.cuda.synchronize()
        errs = [check_close(f"composite_fwd ({what}) {n}", a, b,
                            *COMPOSITE_TOL["fwd"])
                for n, a, b in (("out", out, out_ref), ("ltc", ltc, ltc_ref))]
        skip = skip_report(v, TC.keep_words_to_mask(keep, v.K))
        if (skip["skipped_with_hit"] or skip["kept_outside_opaque"]
                or skip["mirror_disagreements"]):
            raise AssertionError(f"composite_fwd ({what}) skip test: {skip}")
        rows[what] = dict(shape=list(v.G.shape), px=v.P.shape[1], K=v.K,
                          max_abs_err=max(e[0] for e in errs),
                          removed_fraction=skip["removed_fraction"])
        say("kernels", name="composite_fwd", what=what, **rows[what])
    if rows["P not features"]["removed_fraction"] != 0.0:
        raise AssertionError("composite_fwd skipped entries at pixel "
                             "features that are not exact")
    return rows


def check_composite(dev):
    """Both composite kernels against their plain versions on the
    full-size scene's tile lists, then the kernel route's gradients against
    autograd through the plain composite."""
    state, cam, _ = gs_scene(dev)
    tl = gs_tile_lists(dev)
    T, _, cap = tl.G.shape
    px, K = tl.P.shape[1], tl.K
    if (T, px, cap, K) != (96, 2048, 1024, 128):
        raise AssertionError(f"composite shape {(T, px, cap, K)}")
    args = (tl.P, tl.G, tl.C, tl.O)
    out, ltc, keep_fwd = TC.composite_fwd_launch(*args, K, keep_bits=True)
    out_ref, ltc_ref = TC.composite_fwd_reference(*args, K)
    torch.cuda.synchronize()
    e_out = check_close("composite_fwd out", out, out_ref,
                        *COMPOSITE_TOL["fwd"])
    e_ltc = check_close("composite_fwd ltc", ltc, ltc_ref,
                        *COMPOSITE_TOL["fwd"])
    # deterministic: a second call on the same inputs, bit for bit
    again = TC.composite_fwd_launch(*args, K, keep_bits=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, ltc, keep_fwd),
                                                  again)):
        raise AssertionError("composite_fwd: two calls differ")
    # the autograd forward's call, which stores no keep bits
    if not all(torch.equal(a, b) for a, b in zip(
            (out, ltc), TC.composite_fwd(*args, K))):
        raise AssertionError("composite_fwd: differs without keep bits")
    skip_fwd = skip_report(tl, TC.keep_words_to_mask(keep_fwd, K))
    say("kernels", name="composite_fwd", what="skip test", **skip_fwd)
    if (skip_fwd["skipped_with_hit"] or skip_fwd["kept_outside_opaque"]
            or skip_fwd["mirror_disagreements"]):
        raise AssertionError(f"composite_fwd skip test: {skip_fwd}")
    variants = check_fwd_variants(state, cam, tl)
    del again
    g = torch.Generator(device=dev).manual_seed(5)
    dout = torch.randn((T, 6, px), generator=g, device=dev)
    got = TC.composite_bwd(*args, ltc_ref, dout, K)
    want = TC.composite_bwd_reference(*args, ltc_ref, dout, K)
    torch.cuda.synchronize()
    e_bwd = [check_grads(f"composite_bwd {n}", a, b)
             for n, a, b in zip(("dG", "dC", "dO"), got, want)]
    # deterministic: a second call on the same inputs, bit for bit
    *again, keep = TC.composite_bwd_launch(*args, ltc_ref, dout, K)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("composite_bwd: two calls differ")
    skip = skip_report(tl, TC.keep_words_to_mask(keep, K))
    say("kernels", name="composite_bwd", what="skip test", **skip)
    if (skip["skipped_with_hit"] or skip["kept_outside_opaque"]
            or skip["mirror_disagreements"]):
        raise AssertionError(f"composite_bwd skip test: {skip}")
    del again, keep

    live, hit = composite_pairs(tl)
    fwd_bytes = 4 * (6 * px + T * 12 * cap + T * 6 * px + T * (cap // K) * px)
    bwd_bytes = 4 * (6 * px + T * 24 * cap + T * (cap // K) * px
                     + T * 6 * px)
    rows = {}
    for name, fn, plain, ops, sfu, nbytes, errs in (
            ("composite_fwd", lambda: TC.composite_fwd(*args, K),
             lambda: TC.composite_fwd_reference(*args, K),
             OPS_LIVE * live + OPS_FWD_HIT * hit,
             SFU_LIVE * live + SFU_FWD_HIT * hit, fwd_bytes, [e_out, e_ltc]),
            ("composite_bwd", lambda: TC.composite_bwd(*args, ltc_ref, dout, K),
             lambda: TC.composite_bwd_reference(*args, ltc_ref, dout, K),
             OPS_LIVE * live + OPS_BWD_HIT * hit,
             SFU_LIVE * live + SFU_BWD_HIT * hit, bwd_bytes, e_bwd)):
        bms, by = bound_ms(ops, nbytes, PEAK_F32_FLOPS)
        ms = cuda_ms(fn, 20)
        rows[name] = dict(
            tiles=T, px=px, cap=cap, K=K, live_pairs=live, hit_pairs=hit,
            max_abs_err=max(e[0] for e in errs),
            rel_rms_err=max(e[1] for e in errs), ms=ms,
            plain_ms=cuda_ms(plain, 3), library_ms=None, bound_ms=bms,
            bound_by=by, gflops=ops / ms / 1e6, sfu_ops=sfu,
            sfu_ms=1e3 * sfu / PEAK_SFU_OPS)
        say("kernels", name=name, **rows[name])

    rows["composite_fwd"]["skip"] = skip_fwd
    rows["composite_bwd"]["skip"] = skip
    rows["composite_fwd"]["variants"] = variants

    # the kernel route's gradients against autograd through the plain
    # composite, every parameter field, on the same scene
    target = torch.rand((cam.height, cam.width, 3), generator=g, device=dev)
    got = param_grads(state, cam, target, "kernel", GS_CAP)
    want = param_grads(state, cam, target, "plain", GS_CAP)
    torch.cuda.synchronize()
    for f in GM.PARAM_FIELDS:
        max_abs, rel_rms = check_grads(f"grad {f}", got[f], want[f])
        rows.setdefault("grads", {})[f] = dict(max_abs=max_abs,
                                               rel_rms=rel_rms)
    say("kernels", what="kernel-route grads vs autograd through plain",
        **{f: "%.2e/%.2e" % (v["max_abs"], v["rel_rms"])
           for f, v in rows["grads"].items()})
    return rows


def slot_errors(name, got, want, tol):
    """A projection kernel's output against its plain version: the largest
    |got - want| over the per-slot bound of ``PROJECT_TOL`` (must be
    <= 1), the largest |got - want| and the rel-RMS error; raises beyond
    the bound."""
    got, want = got.detach().double(), want.detach().double()
    n = want.shape[0]
    w = want.reshape(n, -1)
    bound = tol * (w.abs() + w.abs().amax(1, keepdim=True)
                   + 1e-6 * w.abs().max())
    err = (got.reshape(n, -1) - w).abs()
    worst = float((err / bound.clamp_min(1e-300)).max())
    rel_rms = float((err.pow(2).mean().sqrt()
                     / w.pow(2).mean().sqrt().clamp_min(1e-30)))
    if not np.isfinite(worst) or worst > 1.0:
        raise AssertionError(f"{name}: {worst} of the tolerance, rel_rms "
                             f"{rel_rms}")
    return worst, float(err.max()), rel_rms


def check_project(dev):
    """The projection kernels at the gs cell's 131,072 slots, 504x378,
    SH degree 3 (``project_scene``): every output and gradient against the
    plain versions on the card, two calls of each bit for bit, one launch a
    call; each timed against its bound (bytes), the plain version and the
    route it replaced (the plain forward, and autograd through it). A
    kernel's ``ms`` is its device time (``graph_ms``: calls replayed from
    a CUDA graph, as the train step runs it) on four copies of the inputs
    in turn, 124 MB, so that L2 (50 MB) does not keep them between calls;
    ``call_ms`` is a call of the wrapper from the host, which issues it
    slower than the card runs it."""
    state, cam = project_scene(dev)
    n = state.capacity
    zero_gs_launches()
    sg = RZ.project_fwd_launch(state, cam)
    with torch.no_grad():
        ref = RZ.project_gaussians_reference(state, cam)
    torch.cuda.synchronize()
    if not torch.equal(sg.valid, ref.valid):
        raise AssertionError("project_fwd: valid differs")
    fwd_err = {f: slot_errors(f"project_fwd {f}", getattr(sg, f),
                              getattr(ref, f), PROJECT_TOL["fwd"])
               for f in ("center", "conic", "rgb", "depth", "opacity")}
    radius_off = int((sg.radius != ref.radius).sum())
    if (float((sg.radius - ref.radius).abs().max()) > 1
            or radius_off > n // 1000):
        raise AssertionError(f"project_fwd radius: {radius_off} differ")
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(getattr(sg, f).shape, generator=g, device=dev)
            for f in ("center", "conic", "rgb", "depth", "opacity")]
    grads = RZ.project_bwd_launch(state, cam, *cots)
    want = RZ.project_bwd_reference(state, cam, *cots)
    torch.cuda.synchronize()
    bwd_err = {f: slot_errors(f"project_bwd {f}", grads[f], want[f],
                              PROJECT_TOL["bwd"]) for f in GM.PARAM_FIELDS}
    again = RZ.project_fwd_launch(state, cam)
    again_g = RZ.project_bwd_launch(state, cam, *cots)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(sg, again))
            and all(torch.equal(grads[f], again_g[f])
                    for f in GM.PARAM_FIELDS)):
        raise AssertionError("project: two calls differ")
    if gs_launches() != dict(gs_want(0, 0), project_fwd=2, project_bwd=2):
        raise AssertionError(f"project launches {gs_launches()}")
    del again, again_g

    params = {f: getattr(state, f).clone().requires_grad_(True)
              for f in GM.PARAM_FIELDS}

    def autograd_route():
        out = RZ.project_gaussians_reference(state.replace(**params), cam)
        return torch.autograd.grad(
            [getattr(out, f) for f in ("center", "conic", "rgb", "depth",
                                       "opacity")],
            list(params.values()), cots)

    # bytes each way at degree 3 (no offset): the forward reads means 12,
    # quats 16, log-scales 12, logit 4, SH 192, active 1 and writes centre
    # 8, conic 12, rgb 12, depth, opacity and radius 4 each, valid 1; the
    # backward reads the same inputs and 36 B of output gradients and
    # writes the parameters' gradients (236 B)
    fwd_bytes = n * (237 + 45)
    bwd_bytes = n * (237 + 36 + 236)
    copies = [state] + [state.replace(**{f: getattr(state, f).clone()
                                         for f in GM.PARAM_FIELDS})
                        for _ in range(3)]
    turn = [0]

    def in_turn():
        turn[0] += 1
        return copies[turn[0] % len(copies)]

    rows = {}
    for name, fn, plain, nbytes, errs in (
            ("project_fwd", lambda: RZ.project_fwd_launch(in_turn(), cam),
             lambda: RZ.project_gaussians_reference(state, cam), fwd_bytes,
             fwd_err),
            ("project_bwd",
             lambda: RZ.project_bwd_launch(in_turn(), cam, *cots),
             lambda: RZ.project_bwd_reference(state, cam, *cots), bwd_bytes,
             bwd_err)):
        bms, by = bound_ms(0.0, nbytes)
        with torch.no_grad():
            ms, call_ms = graph_ms(fn), cuda_ms(fn, 50)
            plain_ms = cuda_ms(plain, 5)
        rows[name] = dict(
            slots=n, width=cam.width, height=cam.height, sh_degree=3,
            bytes=nbytes, worst_of_tol=max(e[0] for e in errs.values()),
            max_abs_err=max(e[1] for e in errs.values()),
            rel_rms_err=max(e[2] for e in errs.values()),
            errors=errs, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=None,
            bound_ms=bms, bound_by=by, gb_per_s=nbytes / ms / 1e6)
        say("kernels", name=name, **{k: v for k, v in rows[name].items()
                                     if k != "errors"})
    rows["project_fwd"]["radius_off_by_one"] = radius_off
    # the route the kernels replace: the plain forward and autograd's
    # backward through it (the forward recorded for autograd), from the host
    rows["autograd_route_ms"] = cuda_ms(autograd_route, 5)
    say("kernels", what="projection by autograd through the plain forward",
        ms=rows["autograd_route_ms"])
    zero_gs_launches()
    del copies
    return rows


def small_gs_state(dev, n=500, cap=512):
    """A small anisotropic scene (every gradient well away from 0, so one
    Adam step has no sign to lose) in front of a 128x64 camera."""
    rng = np.random.default_rng(3)
    xyz = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)),
                          rng.uniform(1.5, 3.5, (n, 1))], 1).astype(np.float32)
    st = GM.from_points(torch.from_numpy(xyz),
                        torch.from_numpy(rng.uniform(0, 1, (n, 3))
                                         .astype(np.float32)), capacity=cap)
    st = st.replace(
        log_scales=st.log_scales + torch.from_numpy(
            rng.uniform(0.2, 0.8, (cap, 3)).astype(np.float32)),
        quats=torch.from_numpy(rng.normal(0, 1, (cap, 4)).astype(np.float32)),
        sh_rest=torch.from_numpy(rng.normal(0, 0.05, (cap, 45))
                                 .astype(np.float32)),
        opacity_logits=torch.where(st.active[:, None], 1.0, -100.0))
    cam = camera_from_fov(0.9, 0.7, 128, 64,
                          look_at_w2c([0.1, 0.0, 0.0], [0.0, 0.0, 2.5]))
    target = torch.from_numpy(rng.uniform(0, 1, (64, 128, 3))
                              .astype(np.float32))
    return st, cam, target


def check_gs_small(dev):
    """One train step on the card through the kernels against the same
    step on the CPU through the plain versions: loss, the step's parameter
    gradients (Adam's first moment, 0.1 x grad: the updated parameters
    themselves move by about lr x sign(grad), which roundoff can flip where
    a gradient is ~0) and the densify statistics."""
    st, cam, target = small_gs_state("cpu")
    cfg = TrainConfig(tile_cap=256, chunk=128, densify_from_iter=10 ** 9)
    views = make_viewset([cam], target[None])
    zero_gs_launches()
    out = {}
    for d in ("cpu", dev):
        tr = GSTrainer(views, cfg, st, model_path=os.path.join(
            BUILD_OUT, "gs_small"), device=d)
        cam_d, img_d = tr.train_views.view(0)
        out[str(d)] = tr._train_step(tr.state, cam_d, img_d)
    launches = gs_launches()
    (ts_c, m_c), (ts_d, m_d) = out["cpu"], out[str(dev)]
    res = {"loss": check_close("gs_small loss", m_d["loss"].cpu(),
                               m_c["loss"], 0.0, 1e-5)}
    for f in GM.PARAM_FIELDS:
        res[f"grad_{f}"] = check_grads(f"gs_small grad {f}",
                                       ts_d.adam.mu[f].cpu(),
                                       ts_c.adam.mu[f])
    for f in ("grad_accum", "denom", "max_radii"):
        res[f] = check_grads(f"gs_small stats {f}",
                             getattr(ts_d.stats, f).cpu(),
                             getattr(ts_c.stats, f))
    if launches != gs_want(1, 1):
        raise AssertionError(f"gs_small launches {launches}")
    say("gs_small", loss_card=float(m_d["loss"]), loss_cpu=float(m_c["loss"]),
        launches=launches,
        worst=max(res.items(), key=lambda kv: kv[1][1]))
    return {k: list(v) for k, v in res.items()}


def from_start(tr, s0, per_step=False):
    """Put the trainer back at state s0 with fresh pick and densify
    streams; ``per_step`` forces the per-step path (``_merged_views`` None,
    as JAX's fallback), else its default, the graph replays."""
    tr.state = s0
    tr._rng = np.random.default_rng(tr.cfg.seed)
    tr._gen.manual_seed(tr.cfg.seed)
    tr.__dict__.pop("_merged_views", None)
    if per_step:
        tr._merged_views = lambda: None


def state_errors(got, want):
    """Per field of the parameters, Adam's moments and the densify
    statistics: max |got - want| / max |want|."""
    pairs = {f: (getattr(got.gaussians, f), getattr(want.gaussians, f))
             for f in GM.PARAM_FIELDS}
    pairs.update({f"mu_{f}": (got.adam.mu[f], want.adam.mu[f])
                  for f in GM.PARAM_FIELDS})
    pairs.update({f: (getattr(got.stats, f), getattr(want.stats, f))
                  for f in ("grad_accum", "denom", "max_radii")})
    return {k: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for k, (a, b) in pairs.items()}


def step_times(step, n):
    """ms of n calls of ``step``, each to its own synchronize."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def run_gs(dev, iters=GS_ITERS):
    """The GS trainer at full size on three views (the LLFF preset's view
    count): fit renders of a perturbed copy of the scene, with densify/prune
    at 100 and 200 and an opacity reset at 200. The Gaussians must grow.
    The trainer's default path (segments replayed from a CUDA graph) is
    held to its per-step path from the same state and picks: over one
    densify-free segment (and the per-step path against itself, the
    spread of its atomics) and over the whole run."""
    state, cams, targets = gs_views(dev)
    # densify at 100 (capacity full: nothing written, then it doubles) and
    # at 200 (clones and splits into the new slots, prune), reset at 200
    cfg = TrainConfig(iterations=iters, tile_cap=GS_CAP, densify_from_iter=50,
                      densify_until_iter=250, densification_interval=100,
                      opacity_reset_interval=200)
    tr = GSTrainer(make_viewset(cams, targets), cfg, state,
                   model_path=os.path.join(BUILD_OUT, "gs"), device=dev)
    s0 = tr.state

    def view_loss():
        return float(sum(gs_losses.photometric_loss(
            tr.render_view(c)["render"], t) for c, t in zip(cams, targets))
            / len(cams))

    segment = {}
    for name, per_step in (("graph", False), ("eager", True),
                           ("eager_again", True)):
        from_start(tr, s0, per_step)
        loss = tr._run_loop(0, GS_SEGMENT, densify=False,
                            log_every=GS_SEGMENT)
        segment[name] = (tr.state, loss)
    seg_err = {"graph": state_errors(segment["graph"][0],
                                     segment["eager"][0]),
               "eager_again": state_errors(segment["eager_again"][0],
                                           segment["eager"][0])}
    seg_loss = {k: v[1] for k, v in segment.items()}
    del segment
    bad = {f"{name} {k}": v for name, errs in seg_err.items()
           for k, v in errs.items() if v != 0}
    if bad or len(set(seg_loss.values())) != 1:
        raise AssertionError(f"gs segment: graph and per-step paths not "
                             f"bit for bit: {bad} {seg_loss}")

    from_start(tr, s0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    active0, cap0 = tr.gaussians.num_active, tr.gaussians.capacity
    builds0 = dict(tr.graph_builds)
    zero_gs_launches()
    loss0 = view_loss()
    t0 = time.perf_counter()
    last = tr.training(log_every=50)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    loss1 = view_loss()
    launches = gs_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    active1, cap1 = tr.gaussians.num_active, tr.gaussians.capacity
    captures = {k: tr.graph_builds[k] - builds0[k] for k in builds0}

    want = gs_want(iters + 2 * len(cams), iters)
    if launches != want:
        raise AssertionError(f"gs launches {launches}, expected {want}")
    if not active1 > active0:
        raise AssertionError(f"gs densify wrote nothing: {active0} active "
                             f"before, {active1} after")
    if not (np.isfinite(last) and np.isfinite(loss1) and loss1 < loss0):
        raise AssertionError(f"gs loss did not fall: {loss0} -> {loss1} "
                             f"(last step {last})")
    graph_state = tr.state

    from_start(tr, s0, per_step=True)
    t0 = time.perf_counter()
    last_eager = tr.training(log_every=50)
    torch.cuda.synchronize()
    train_s_eager = time.perf_counter() - t0
    full = dict(last_step_loss=[last, last_eager],
                active=[active1, tr.gaussians.num_active],
                capacity=[cap1, tr.gaussians.capacity],
                errors=state_errors(graph_state, tr.state))
    tr.__dict__.pop("_merged_views", None)
    bad = {k: v for k, v in full["errors"].items() if v != 0}
    if bad or any(a != b for a, b in (full["last_step_loss"],
                                      full["active"], full["capacity"])):
        raise AssertionError(f"gs run: graph and per-step paths not bit "
                             f"for bit: {full}")

    # the batched render (graph replays) against a loop of render_view
    many = stack_cameras([camera_from_fov(
        0.9, 0.7, GS_W, GS_H, look_at_w2c([x, y, 0.0], [0.0, 0.0, 2.5]),
        device=dev) for x in np.linspace(-0.4, 0.4, 5)
        for y in (-0.1, 0.0, 0.1, 0.2)])
    rgb, depth = tr.render_views_batch(many)
    loop = [tr.render_view(many.at(i)) for i in range(len(many))]
    batch_err = max(max(float((rgb[i] - o["render"]).abs().max()),
                        float((depth[i] - o["depth"]).abs().max()))
                    for i, o in enumerate(loop))
    if batch_err != 0:
        raise AssertionError(f"gs render_views_batch differs from "
                             f"render_view: {batch_err}")
    render_batch_ms = {
        "graph": step_times(lambda: tr.render_views_batch(many), 5),
        "loop": step_times(lambda: [tr.render_view(many.at(i))
                                    for i in range(len(many))], 5)}

    # per-step times of both paths in turns: eager, graph, graph, eager
    cam0, img0 = tr.train_views.view(0)

    def eager():
        tr.state, _ = tr._train_step(tr.state, cam0, img0)

    replays = gs_replays(tr)
    turns = [step_times(eager if k in (0, 3) else (lambda: replays(1)),
                        GS_TIMED_STEPS) for k in range(4)]
    step_ms = {"eager": [float(np.median(t)) for t in turns[::3]],
               "graph": [float(np.median(t)) for t in turns[1:3]]}
    res = dict(iterations=iters, views=len(cams), train_s=train_s,
               train_s_per_step_path=train_s_eager,
               loss_before=loss0, loss_after=loss1, last_step_loss=last,
               launches=launches, active_before=active0,
               capacity_before=cap0, active_after=active1,
               capacity_after=cap1, peak_mem_gb=peak_gb, captures=captures,
               segment_steps=GS_SEGMENT, segment_errors=seg_err,
               segment_loss=seg_loss, full_run=full,
               render_batch=dict(cameras=len(many), max_abs_err=batch_err,
                                 ms=render_batch_ms),
               step_ms_median=step_ms,
               step_ms_p10_p90={k: [float(np.percentile(turns[i], q))
                                    for q in (10, 90)]
                                for k, i in (("eager", 0), ("graph", 1))})
    say("gs", **res)
    return res


def scene_data(dev):
    """The scene phase's in-memory scene: the gs phase's three views and
    targets, bench.py's seed-0 points as the initial cloud."""
    _, cams, targets = gs_views(dev)
    xyz, rgb, _ = gs_points()
    return SceneData(train_cameras=[c.to("cpu") for c in cams],
                     train_images=targets.cpu().numpy(), test_cameras=[],
                     test_images=np.zeros((0, 1, 1, 3), np.float32),
                     points_xyz=xyz, points_rgb=rgb)


def run_scene(pipe, unit_launches):
    """The per-scene loop as a user runs it: cli/train's parser and
    build_runner on an in-memory scene with the unit's completion, then
    run (2 cycles x 3 wrap-around pairs)."""
    out = os.path.join(BUILD_OUT, "scene")
    shutil.rmtree(out, ignore_errors=True)   # no cache of an earlier run
    args = cli_train.build_parser().parse_args(
        ["-s", "(in memory)", "-m", out] + SCENE_FLAGS)
    units = []

    def completion(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = pipe(*a)
        torch.cuda.synchronize()
        units.append(dict(seconds=time.perf_counter() - t0,
                          lo=frames.min().item(), hi=frames.max().item(),
                          finite=bool(torch.isfinite(frames).all())))
        return frames

    runner = cli_train.build_runner(args, scene_data(args.device),
                                    completion_fn=completion)
    tr = runner.trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runner.run(log_every=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_units = SCENE_PAIRS * SCENE_CYCLES
    if len(units) != n_units:
        raise AssertionError(f"scene: {len(units)} completion units, "
                             f"expected {n_units}")
    bad = [u for u in units if not (u["finite"] and u["lo"] >= 0.0
                                    and u["hi"] <= 1.0)]
    if bad:
        raise AssertionError(f"scene: completion frames not finite in "
                             f"[0, 1]: {bad}")
    lo, hi = [], []
    for c in range(SCENE_CYCLES):
        for p in range(SCENE_PAIRS):
            path = os.path.join(runner.save_dir, f"interpolated_dense_views_"
                                f"cyc{c}_view{p}.npz")
            with np.load(path) as data:
                frames, poses = data["frames"], data["poses"]
            if frames.shape != (FRAMES, GS_H, GS_W, 3) or \
                    poses.shape != (FRAMES, 4, 4):
                raise AssertionError(f"scene cache {path}: {frames.shape} "
                                     f"{poses.shape}")
            if not np.isfinite(frames).all():
                raise AssertionError(f"scene cache {path} not finite")
            lo.append(float(frames.min()))
            hi.append(float(frames.max()))
    if min(lo) < CUBIC_RANGE[0] or max(hi) > CUBIC_RANGE[1]:
        raise AssertionError(f"scene caches outside {CUBIC_RANGE}: "
                             f"{min(lo)} {max(hi)}")
    n_pseudo = SCENE_PAIRS * (FRAMES - 1)
    conf = tr.pseudo_views.cameras.confidence
    if len(tr.pseudo_views) != n_pseudo or not bool((conf == 0.05).all()):
        raise AssertionError(f"scene: {len(tr.pseudo_views)} pseudo views "
                             f"(expected {n_pseudo}) at {conf.unique()}")
    ckpt = os.path.join(out, f"refine_{SCENE_CYCLES - 1}_chkpnt"
                        f"{GS_ITERS}.npz")
    if not os.path.exists(ckpt):
        raise AssertionError(f"scene: no checkpoint {ckpt}")
    want = {k: n_units * unit_launches[k] for k in UNIT_KERNELS}
    steps = GS_ITERS * (1 + SCENE_CYCLES)
    if any(launches[k] != v for k, v in want.items()) or \
            not gs_path_ok(launches, steps):
        raise AssertionError(f"scene launches {launches}: expected {want}, "
                             f"composite_bwd {steps}, composite_fwd more, the "
                             "projection alike")
    rgb = tr.render_view(tr.train_views.cameras.at(1))["render"]
    if not bool(torch.isfinite(rgb).all()):
        raise AssertionError("scene: final render not finite")
    if min(tr.graph_builds.values()) < 1:
        raise AssertionError(f"scene: the GS steps and batch renders did "
                             f"not run from CUDA graphs: {tr.graph_builds}")

    phases = {k: v["total_s"] for k, v in runner.timer.summary().items()}
    unit_s = [u["seconds"] for u in units]
    res = dict(flags=" ".join(SCENE_FLAGS), cuts="num_inference_steps 2 "
               "(from 100), iterations 300 (from 10000), "
               "start_sample_svd_frame 100 (from 2000)",
               total_s=total_s, phases_s=phases, completion_s=sum(unit_s),
               unit_s=unit_s, densify_other_s=phases["densify"] - sum(unit_s),
               cache_range=[min(lo), max(hi)], pseudo_views=n_pseudo,
               peak_mem_gb=peak_gb, launches=launches,
               active=tr.gaussians.num_active,
               captures=dict(tr.graph_builds))
    say("scene", **res)
    return res


def write_colmap_scan(dev, root, n_images, width, height, scale=1,
                      images_dir="images", fov_y=0.7):
    """A synthetic scan as COLMAP: the gs phase's truth rendered at
    width x height from n_images cameras in an arc (fov 0.9 x fov_y),
    saved ``scale`` times larger (bicubic upsample) under ``images_dir``
    with the intrinsics of that size; bench.py's points as the sparse
    cloud."""
    from PIL import Image
    _, gt, _ = gs_truth(dev)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, images_dir))
    big_w, big_h = width * scale, height * scale
    images = {}
    for i, x in enumerate(np.linspace(-0.45, 0.45, n_images)):
        cam = camera_from_fov(0.9, fov_y, width, height,
                              look_at_w2c([x, 0.03 * i, 0.0],
                                          [0.0, 0.0, 2.5]), device=dev)
        with torch.no_grad():
            rgb = RZ.render(gt, cam, method="kernel", tile_cap=GS_CAP).rgb
        img = Image.fromarray((rgb.clamp(0, 1) * 255).round().byte()
                              .cpu().numpy())
        name = f"{i:03d}.png"
        if scale != 1:
            img = img.resize((big_w, big_h), Image.BICUBIC)
        img.save(os.path.join(root, images_dir, name), compress_level=1)
        w2c = cam.w2c.cpu().numpy().astype(np.float64)
        images[i + 1] = CM.ColmapImage(
            i + 1, CM.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
    K = cam.K.cpu().numpy().astype(np.float64) * scale
    cams = {1: CM.ColmapCamera(1, "PINHOLE", big_w, big_h, np.array(
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    xyz, rgb, _ = gs_points()
    sparse = os.path.join(root, "sparse", "0")
    CM.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    CM.write_images_binary(images, os.path.join(sparse, "images.bin"))
    CM.write_points3d_binary(CM.ColmapPoints3D(
        xyz.astype(np.float64), np.round(rgb * 255).astype(np.uint8),
        np.zeros(len(xyz))), os.path.join(sparse, "points3D.bin"))


def write_dtu_scene(dev, root):
    """A synthetic DTU scan (``write_colmap_scan``: DTU_IMAGES renders at
    400x300 saved at 1600x1200) and, for the two test views, masks named
    as cli/render names its frames: an ellipse over the middle of the
    view."""
    from PIL import Image
    write_colmap_scan(dev, root, DTU_IMAGES, DTU_W, DTU_H, DTU_SCALE)
    os.makedirs(os.path.join(root, "mask"))
    yy, xx = np.mgrid[:DTU_H, :DTU_W]
    inside = (((xx - DTU_W / 2) / (0.35 * DTU_W)) ** 2
              + ((yy - DTU_H / 2) / (0.38 * DTU_H)) ** 2) <= 1.0
    for t in range(DTU_TEST):
        Image.fromarray((inside * 255).astype(np.uint8)).save(
            os.path.join(root, "mask", f"{t:05d}.png"))
    return os.path.join(root, "mask")


def run_dtu(pipe, unit, unit_census):
    """The DTU preset as a user runs it: cli/train's parser, the scan
    loaded by load_colmap_scene as cli/train.main loads it, build_runner
    with the prob completion that --diffusion_type 2PassProbUncertain
    selects (on the unit's networks), run; then cli/render, cli/metrics
    with the masks and random LPIPS weights, and summarize. Returns the
    phase's results and the norm census of its batch-2 UNet forwards that
    the unit's census lacks."""
    root = os.path.join(BUILD_OUT, "dtu")
    shutil.rmtree(root, ignore_errors=True)
    scan = os.path.join(BUILD_OUT, "dtu_scan")
    t0 = time.perf_counter()
    masks = write_dtu_scene(pipe.device, scan)
    out = os.path.join(root, "synthetic_scan")
    args = cli_train.build_parser().parse_args(["-s", scan, "-m", out]
                                               + DTU_FLAGS)
    scene = load_colmap_scene(args.source_path, images_dir=args.images,
                              resolution=args.resolution,
                              n_views=args.n_views, llffhold=args.llffhold,
                              rand_pcd=args.rand_pcd, seed=args.seed)
    write_s = time.perf_counter() - t0
    if (scene.train_images.shape != (3, DTU_H, DTU_W, 3)
            or len(scene.test_cameras) != DTU_TEST):
        raise AssertionError(f"dtu scan: train {scene.train_images.shape}, "
                             f"{len(scene.test_cameras)} test views")
    prob = GuidedSVDPipeline(pipe.m, GuidedSVDConfig(
        **cli_train.svd_config(args)))
    if prob.cfg.variant != "prob":
        raise AssertionError(f"dtu: variant {prob.cfg.variant}")
    units, denoise_s = [], []
    denoise = prob.denoise

    def timed_denoise(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lat = denoise(*a)
        torch.cuda.synchronize()
        denoise_s.append(time.perf_counter() - t)
        return lat
    prob.denoise = timed_denoise

    def completion(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = prob(*a)
        torch.cuda.synchronize()
        units.append(dict(seconds=time.perf_counter() - t,
                          lo=frames.min().item(), hi=frames.max().item(),
                          finite=bool(torch.isfinite(frames).all())))
        return frames

    runner = cli_train.build_runner(args, scene, completion_fn=completion)
    tr = runner.trainer
    census = NormCensus()
    census.watch(prob.m.unet, "unet_prob")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with KernelShapes() as shapes:
        runner.run(log_every=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    census.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_units = DTU_PAIRS * DTU_CYCLES
    if len(units) != n_units or not all(
            u["finite"] and u["lo"] >= 0.0 and u["hi"] <= 1.0 for u in units):
        raise AssertionError(f"dtu: completion units {units}, expected "
                             f"{n_units} finite in [0, 1]")
    lo, hi = [], []
    for c in range(DTU_CYCLES):
        for p in range(DTU_PAIRS):
            path = os.path.join(runner.save_dir, f"interpolated_dense_views_"
                                f"cyc{c}_view{p}.npz")
            with np.load(path) as data:
                frames = data["frames"]
            if frames.shape != (FRAMES, DTU_H, DTU_W, 3) or \
                    not np.isfinite(frames).all():
                raise AssertionError(f"dtu cache {path}: {frames.shape}")
            lo.append(float(frames.min()))
            hi.append(float(frames.max()))
    if min(lo) < CUBIC_RANGE[0] or max(hi) > CUBIC_RANGE[1]:
        raise AssertionError(f"dtu caches outside {CUBIC_RANGE}: "
                             f"{min(lo)} {max(hi)}")
    # the chain: each pair's frames but its last, and the last pair's last
    n_pseudo = DTU_PAIRS * (FRAMES - 1) + 1
    conf = tr.pseudo_views.cameras.confidence
    if len(tr.pseudo_views) != n_pseudo or not bool((conf == 0.05).all()):
        raise AssertionError(f"dtu: {len(tr.pseudo_views)} pseudo views "
                             f"(expected {n_pseudo}) at {conf.unique()}")
    # the prob unit: one batch-2 forward a direction and step, as many
    # forwards as the post unit's batch-3 ones, so the same launches a unit
    forwards = n_units * unit["forwards"]
    n_gn, n_ln = unit["unet_norms_per_forward"]
    per_forward = {k: launches[k] / forwards
                   for k in ("geglu_ffn", "flash_attention")}
    unit_per_forward = {k: unit["launches"][k] / unit["forwards"]
                        for k in per_forward}
    norm_calls = census.totals("unet_prob")
    want = {k: n_units * unit["launches"][k] for k in UNIT_KERNELS}
    steps = GS_ITERS * (1 + DTU_CYCLES)
    if (per_forward != unit_per_forward
            or norm_calls != {"group_norm": n_gn * forwards,
                              "layer_norm": n_ln * forwards}
            or any(launches[k] != v for k, v in want.items())
            or not gs_path_ok(launches, steps)):
        raise AssertionError(
            f"dtu launches {launches}: per forward {per_forward} (post unit "
            f"{unit_per_forward}), UNet norm calls {norm_calls} (expected "
            f"{n_gn}, {n_ln} x {forwards}); expected {want}, composite_bwd "
            f"{steps}, composite_fwd more, the projection alike")
    unet_shapes = {(k[0],) + k[2:] for k in unit_census if k[1] == "unet"}
    new_shapes = {k: n for k, n in census.calls.items()
                  if (k[0],) + k[2:] not in unet_shapes}
    if not new_shapes or any(k[0] == "group_norm"
                             and k[2][0] not in (2, 2 * FRAMES)
                             for k in new_shapes):
        raise AssertionError(f"dtu: batch-2 norm shapes {list(new_shapes)}")
    # every GEGLU and flash launch of the run recorded by shape: the
    # batch-2 rows (2 x 25 frames x tokens) and B = 50 that main holds
    # against the plain versions
    shape_calls = shapes.totals()
    if (any(shape_calls[k] != launches[k] for k in shape_calls)
            or any(s[0] % (2 * FRAMES) for (k, s) in shapes.calls)):
        raise AssertionError(f"dtu: GEGLU/flash shapes {shapes.calls} "
                             f"against launches {launches}")
    composite_view = check_composite_view(tr, scene.test_cameras[0])

    # the evaluation protocol on the trained scan
    t0 = time.perf_counter()
    weights = os.path.join(root, "lpips_vgg.npz")
    save_params(random_lpips_params(11), weights)
    rendered = cli_render.main(["-s", scan, "-m", out, "-r",
                                str(DTU_SCALE), "--n_views", "3"])
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_path = cli_metrics.main(["-m", out, "--masks", masks,
                                 "--lpips_weights", weights])
    metrics_s = time.perf_counter() - t0
    blocks = cli_summarize.parse_eval_res(res_path)
    name = os.path.basename(rendered) + ".pth"
    table = cli_summarize.summarize(root, checkpoints=[name])
    stats = blocks.get(name, {})
    if (name != f"ours_refine_{DTU_CYCLES - 1}_chkpnt{GS_ITERS}.pth"
            or sorted(stats) != ["LPIPS", "PSNR", "SSIM"]
            or not all(np.isfinite(v) for v in stats.values())
            or "synthetic_scan" not in table or "AVG(1 scenes)" not in table
            or len(os.listdir(os.path.join(rendered, "renders")))
            != DTU_TEST):
        raise AssertionError(f"dtu eval: {name} {blocks} {table!r}")
    res = dict(flags=" ".join(DTU_FLAGS),
               cuts="num_inference_steps 2 (from 100), iterations 300 "
                    "(from 10000), start_sample_svd_frame 100 (from 2000)",
               scan_write_load_s=write_s, total_s=total_s,
               phases_s={k: v["total_s"] for k, v in
                         runner.timer.summary().items()},
               unit_s=[u["seconds"] for u in units],
               s_per_denoise_step=dict(
                   prob=float(np.mean(denoise_s)) / STEPS,
                   post=unit["s_per_denoise_step"],
                   prob_each=[d / STEPS for d in denoise_s]),
               cache_range=[min(lo), max(hi)], pseudo_views=n_pseudo,
               peak_mem_gb=peak_gb, launches=launches,
               launches_per_forward=per_forward,
               unet_norm_calls=norm_calls,
               kernel_shapes={f"{k} {list(s)}": n
                              for (k, s), n in sorted(shapes.calls.items())},
               composite_view=composite_view, render_s=render_s,
               metrics_s=metrics_s, eval=stats, summary=table,
               captures=dict(tr.graph_builds))
    say("dtu", **{k: v for k, v in res.items() if k != "summary"})
    print(table, flush=True)
    return res, new_shapes, shapes.calls


def cutoff_pairs(tl):
    """The (tile, entry, pixel) pairs at a cut of alpha: where the plain
    alpha lies within twice the bound on the two versions' difference
    from 1/255 (below it alpha is cut to 0) or from 0.99 (above it the
    backward drops d alpha). There one version may fall on either side:
    the kernel sums the power G.P in another order (two float32 six-term
    sums differ by at most 2 gamma_6 sum_i |G_i P_i|) and takes ex2.approx
    and two float32 products (16 ulp of alpha, generously). Returns the
    pairs at 1/255 a pixel (T, px), the entries with a pair at either cut
    (T, cap), and the pairs at each cut."""
    T, _, cap = tl.G.shape
    gamma6 = 6 * 2.0 ** -24 / (1 - 6 * 2.0 ** -24)
    lo_px = torch.zeros((T, tl.P.shape[1]), device=tl.G.device)
    at_cut = torch.zeros((T, cap), dtype=torch.bool, device=tl.G.device)
    n_lo = n_hi = 0
    for c in range(cap // tl.K):
        sl = slice(c * tl.K, (c + 1) * tl.K)
        praw = torch.einsum("tfk,fp->tkp", tl.G[:, :, sl], tl.P)
        size = torch.einsum("tfk,fp->tkp", tl.G[:, :, sl].abs(), tl.P.abs())
        raw = tl.O[:, :, sl].transpose(1, 2) * torch.exp(praw.clamp(max=0.0))
        rel = 2 * (2 * gamma6 * size + 16 * 2.0 ** -23)
        lo = (raw - TC.ALPHA_MIN).abs() <= rel * TC.ALPHA_MIN
        hi = (raw - TC.ALPHA_MAX).abs() <= rel * TC.ALPHA_MAX
        lo_px += lo.sum(1)
        at_cut[:, sl] = (lo | hi).any(-1)
        n_lo, n_hi = n_lo + int(lo.sum()), n_hi + int(hi.sum())
    return lo_px, at_cut, n_lo, n_hi


def tile_overflow(sg, height, width, cap, tile_h=32, tile_w=64):
    """Tiles whose Gaussians (the 3-sigma boxes of ``RZ.bin_tiles``' hit
    test) outnumber ``cap``, which bin_tiles truncates to the nearest
    ``cap``, as JAX does; and the largest count."""
    ty, tx = -(-height // tile_h), -(-width // tile_w)
    tiles = torch.arange(ty * tx, device=sg.center.device)
    tx0 = ((tiles % tx) * tile_w).float()[:, None]
    ty0 = ((tiles // tx) * tile_h).float()[:, None]
    c, r = sg.center, torch.where(sg.valid, sg.radius, 0.0)
    ok = (sg.valid & (sg.opacity > 0))[None, :]
    counts = (ok & (c[:, 0] + r >= tx0) & (c[:, 0] - r < tx0 + tile_w)
              & (c[:, 1] + r >= ty0) & (c[:, 1] - r < ty0 + tile_h)).sum(1)
    return int((counts > cap).sum()), int(counts.max())


def check_composite_view(tr, cam, phase="dtu"):
    """Both composite kernels against their plain versions on the tile
    lists of one test view of a trained scan (400x300 in the dtu phase,
    960x540 in the dl3dv phase), binned as the trainer bins them.
    COMPOSITE_TOL everywhere, except where a pair lies at a cut of alpha
    (``cutoff_pairs``; a trained scene has such pairs, the gs cell's lists
    had none): the forward may differ at such a pixel by what the pairs
    there can move it, each at most 2 x 1.01/255 x the tile's largest |C|
    of the row (the pair's own weight, and the same share of the weights
    behind it), and -log(1 - 1.01/255) on logT; the gradients are held on
    every entry without such a pair (the gradient of a random output
    cotangent). Each kernel's skip bits as in the kernels phase
    (``skip_report``: no disagreement with the plain mirror, nothing kept
    below 1/255 opacity, no pair skipped with a hit off the cuts). Also
    counts the tiles whose lists overflow ``tile_cap``."""
    cfg, cam = tr.cfg, cam.to(tr.device)
    with torch.no_grad():
        sg = RZ.project_gaussians(tr.gaussians, cam, sh_degree=cfg.sh_degree)
        tl = RZ.bin_tiles(sg, cam.height, cam.width, cap=cfg.tile_cap,
                          chunk=min(cfg.chunk, cfg.tile_cap))
        overflow, most = tile_overflow(sg, cam.height, cam.width,
                                       cfg.tile_cap)
    args = (tl.P, tl.G, tl.C, tl.O)
    out, ltc, keep_fwd = TC.composite_fwd_launch(*args, tl.K, keep_bits=True)
    out_ref, ltc_ref = TC.composite_fwd_reference(*args, tl.K)
    g = torch.Generator(device=tr.device).manual_seed(6)
    dout = torch.randn(out_ref.shape, generator=g, device=tr.device)
    *got, keep_bwd = TC.composite_bwd_launch(*args, ltc_ref, dout, tl.K)
    want = TC.composite_bwd_reference(*args, ltc_ref, dout, tl.K)
    torch.cuda.synchronize()
    lo_px, at_cut, n_lo, n_hi = cutoff_pairs(tl)
    skips = {}
    for name, keep in (("composite_fwd", keep_fwd), ("composite_bwd",
                                                     keep_bwd)):
        skips[name] = skip_report(tl, TC.keep_words_to_mask(keep, tl.K),
                                  at_cut)
        if any(skips[name][k] for k in ("skipped_with_hit",
                                        "kept_outside_opaque",
                                        "mirror_disagreements")):
            raise AssertionError(f"{phase} view {name} skip test: "
                                 f"{skips[name]}")
    a_cut = 1.01 * TC.ALPHA_MIN
    log_jump = -math.log1p(-a_cut)
    jump = torch.cat([2 * a_cut * tl.C.abs().amax(2),
                      torch.full_like(tl.C[:, :1, 0], log_jump)], 1)
    atol, rtol = COMPOSITE_TOL["fwd"]
    off_cut = (lo_px == 0)[:, None, :]
    fwd, at, beyond = [], [0.0], 0
    for n, a, b, j in (("out", out, out_ref, jump[:, :, None]),
                       ("ltc", ltc, ltc_ref, log_jump)):
        err = (a - b).abs()
        tol = atol + rtol * b.abs()
        beyond += int((err > tol).sum())
        bad = int((err > tol + lo_px[:, None, :] * j).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{phase} view composite_fwd {n}: {bad} "
                                 "elements beyond tolerance and the cut's "
                                 f"allowance; max_abs {err.max().item()}")
        fwd.append(err.where(off_cut, 0.0).max().item())
        at.append(err.where(~off_cut, 0.0).max().item())
    keep = ~at_cut
    bwd = [check_grads(f"{phase} view composite_bwd {n}",
                       a.transpose(1, 2)[keep], b.transpose(1, 2)[keep])
           for n, a, b in zip(("dG", "dC", "dO"), got, want)]
    if not all(bool(torch.isfinite(a).all()) for a in got):
        raise AssertionError(f"{phase} view composite_bwd: not finite")
    T, _, cap = tl.G.shape
    res = dict(width=cam.width, height=cam.height, tiles=T,
               px=tl.P.shape[1], cap=cap, K=tl.K,
               gaussians=tr.gaussians.num_active,
               tiles_over_cap=overflow, most_in_a_tile=most,
               pairs_at_1_255=n_lo,
               pairs_at_0_99=n_hi, entries_at_a_cut=int(at_cut.sum()),
               fwd_elements_beyond_tol_at_a_cut=beyond,
               fwd_max_abs_err=max(fwd), fwd_max_abs_err_at_a_cut=max(at),
               bwd_max_abs_err=max(e[0] for e in bwd),
               bwd_rel_rms_err=max(e[1] for e in bwd),
               skip={k: {f: v[f] for f in ("removed_fraction",
                                           "skipped_with_hit",
                                           "mirror_disagreements")}
                     for k, v in skips.items()})
    say(phase, what="composite kernels vs plain on a test view", **res)
    return res


def dust3r_flops(model, n):
    """FLOPs (two a multiply-add) of one pair through ``model`` at n
    tokens a view: the patch embedding, the encoder blocks (24 n e^2 + 4 n^2
    e a view: projections, MLP, the two attention products), the decoder
    embedding, the decoder blocks (32 n d^2 + 8 n^2 d a stream: self- and
    cross-attention, MLP) and the heads."""
    p = model.patch
    e = model.enc_blocks[0].mlp.fc1.in_features
    d = model.dec_blocks[0].mlp.fc1.in_features
    enc = 24 * n * e * e + 4 * n * n * e             # a block, one view
    dec = 32 * n * d * d + 8 * n * n * d             # a block, one stream
    return 2 * (2 * n * 3 * p * p * e + len(model.enc_blocks) * enc
                + 2 * n * e * d + len(model.dec_blocks) * dec
                + 2 * n * d * 4 * p * p)


def kernel_profile(fn, top=8):
    """One call of ``fn`` under torch.profiler: its wall ms, the device's
    kernel ms and idle share, and the ``top`` kernels by device ms (with
    their launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = {ev.key: (ev.self_device_time_total / 1e3, ev.count)
               for ev in prof.key_averages()
               if ev.self_device_time_total and "CUDA" in str(ev.device_type)}
    busy = sum(ms for ms, _ in kernels.values())
    return dict(wall_ms=wall, kernel_ms=busy, idle_share=1 - busy / wall,
                launches=sum(n for _, n in kernels.values()),
                top=[dict(name=k[:90], ms=ms, launches=n) for k, (ms, n) in
                     sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]])


def vision_errors(name, got, want, atol, rtol):
    """allclose(got, want) or raise; (max-abs, rel-RMS)."""
    got, want = got.float().cpu(), want.float()
    max_abs, rel_rms = errors(got, want)
    if (got.shape != want.shape or not bool(torch.isfinite(got).all())
            or not torch.allclose(got, want, rtol=rtol, atol=atol)):
        raise AssertionError(f"vision {name}: card against CPU max_abs "
                             f"{max_abs} rel_rms {rel_rms} beyond ({atol}, "
                             f"{rtol}), shapes {got.shape} {want.shape}")
    return max_abs, rel_rms


def run_vision(dev):
    """DUSt3R ViT-L/512 and GMFlowPublic at full width, each on the card
    against the CPU on the same random weights (loaded on the card from
    the npz the dl3dv phase passes to cli/train), and the known-pose
    alignment card against CPU at a small size. Returns the results and
    the two npz paths."""
    root = os.path.join(BUILD_OUT, "vision")
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(23)
    res, paths = {}, {}
    for name, make, load in (("dust3r", random_dust3r_params, D3.load_dust3r),
                             ("gmflow", random_gmflow_params, GF.load_gmflow)):
        t0 = time.perf_counter()
        params = make(VISION_SEEDS[name])
        paths[name] = os.path.join(root, f"{name}.npz")
        save_params(params, paths[name])
        card = load(load_params(paths[name]), dev)
        cpu = load(params, "cpu")
        del params
        n_params = sum(t.numel() for t in card.parameters())
        h, w = DUST3R_HW if name == "dust3r" else GMFLOW_HW
        a, b = (torch.rand((1, h, w, 3), generator=gen) for _ in range(2))
        ad, bd = a.to(dev), b.to(dev)
        with torch.no_grad():
            t1 = time.perf_counter()
            want = cpu(a, b)
            cpu_s = time.perf_counter() - t1
            got = card(ad, bd)
            ms = cuda_ms(lambda: card(ad, bd), 5)
            prof = kernel_profile(lambda: card(ad, bd))
        torch.cuda.synchronize()
        row = dict(params=n_params, weights_s=t1 - t0, input=[h, w],
                   cpu_s=cpu_s, ms=ms, profile=prof)
        if name == "dust3r":
            row["errors"] = {k: vision_errors(k, got[k], want[k],
                                              *DUST3R_TOL) for k in want}
            flops = dust3r_flops(card, (h // card.patch) * (w // card.patch))
            row.update(tflop=flops / 1e12, tflop_per_s=flops / ms / 1e9,
                       share_of_f32_peak=flops / ms / 1e9 / (
                           PEAK_F32_FLOPS / 1e12))
        else:
            # the stride-2 stages round up (540 -> 270, 135, 68): 544 rows
            rows = h
            for _ in range(3):
                rows = -(-rows // 2)
            rows *= 8
            if got.shape != (1, rows, w, 2):
                raise AssertionError(f"vision gmflow: flow {got.shape}, "
                                     f"expected {rows} rows at {h}")
            row["errors"] = {"flow_px": vision_errors(
                "flow", got, want, GMFLOW_TOL_PX, 0.0)}
            row["flow_shape"] = list(got.shape)
            row["flow_abs_max"] = want.abs().max().item()
        res[name] = row
        say("vision", name=name, **row)
        del card, cpu, got, want
        torch.cuda.empty_cache()

    # the alignment: V views of (H, W), every pair's two edges, STEPS
    v, (h, w), steps = VISION_ALIGN
    pv = [(i, i) for i, j in D3.make_pairs(v)] + [
        (j, i) for i, j in D3.make_pairs(v)]
    e = len(pv)
    pts = torch.randn((e, h, w, 3), generator=gen) * 0.1 + torch.tensor(
        [0.0, 0.0, 2.0])
    conf = 1.0 + torch.rand((e, h, w), generator=gen)
    c2w = torch.eye(4).repeat(v, 1, 1)
    c2w[:, 0, 3] = torch.linspace(0.0, 0.3, v)
    K = torch.tensor([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]])
    init = torch.ones((v, h, w))
    args = (pts, conf, torch.tensor(pv), c2w, K, init)
    want = D3.global_align_known_poses(*args, iters=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = D3.global_align_known_poses(*(x.to(dev) for x in args),
                                      iters=steps)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    errs = {}
    for k, g, wt in zip(("depths", "scales", "loss"), got, want):
        g = g.cpu()
        if not torch.allclose(g, wt, rtol=ALIGN_RTOL, atol=0.0):
            raise AssertionError(f"vision alignment {k}: card against CPU "
                                 f"{errors(g, wt)} beyond rtol {ALIGN_RTOL}")
        errs[k] = errors(g, wt)
    res["align"] = dict(views=v, edges=e, pixels=[h, w], steps=steps,
                        seconds=align_s, errors=errs,
                        loss=float(want[2]))
    say("vision", name="align", **res["align"])
    return res, paths


def run_dl3dv(pipe, unit, weights):
    """The DL3DV preset as a user runs it: cli/train's parser with the
    preset's flags and the three weight files, the scan loaded by
    load_colmap_scene, build_runner with the unit's post completion, run.
    Checks the launches as the scene phase does, densify_pcd in both
    cycles (frames kept by the gate, pairs and edges, point counts, the
    ply files read back), the reset (cycle 0) and append (cycle 1), that
    every GS segment replays a capture of the capacity it runs at (a
    capture after each capacity change), everything finite; then both
    composite kernels against their plain versions on a 960x540 test
    view's lists (T 255)."""
    root = os.path.join(BUILD_OUT, "dl3dv")
    shutil.rmtree(root, ignore_errors=True)
    scan = os.path.join(BUILD_OUT, "dl3dv_scan")
    t0 = time.perf_counter()
    fov_y = 2 * math.atan(math.tan(0.45) * DL3DV_H / DL3DV_W)
    write_colmap_scan(pipe.device, scan, DL3DV_IMAGES, DL3DV_W, DL3DV_H,
                      images_dir="images_4", fov_y=fov_y)
    lpips_npz = os.path.join(BUILD_OUT, "vision", "lpips_vgg.npz")
    save_params(random_lpips_params(13), lpips_npz)
    out = os.path.join(root, "synthetic_scene")
    args = cli_train.build_parser().parse_args(
        ["-s", scan, "-m", out] + DL3DV_FLAGS
        + ["--lpips_weights", lpips_npz, "--dust3r_weights",
           weights["dust3r"], "--gmflow_weights", weights["gmflow"]])
    scene = load_colmap_scene(args.source_path, images_dir=args.images,
                              resolution=args.resolution,
                              n_views=args.n_views, llffhold=args.llffhold,
                              rand_pcd=args.rand_pcd, seed=args.seed)
    if (scene.train_images.shape != (DL3DV_VIEWS, DL3DV_H, DL3DV_W, 3)
            or len(scene.test_cameras) != DL3DV_TEST):
        raise AssertionError(f"dl3dv scan: train {scene.train_images.shape},"
                             f" {len(scene.test_cameras)} test views")
    units = []

    def completion(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = pipe(*a)
        torch.cuda.synchronize()
        units.append(dict(seconds=time.perf_counter() - t,
                          finite=bool(torch.isfinite(frames).all())))
        return frames

    runner = cli_train.build_runner(args, scene, completion_fn=completion)
    setup_s = time.perf_counter() - t0
    tr = runner.trainer
    segments, resets = [], []
    run_segment, reset = tr._run_segment, tr.reset_gaussians_from_pcd

    def recorded_segment(*a, **k):
        cap = tr.state.gaussians.capacity
        loss = run_segment(*a, **k)
        segments.append((cap, tr._segments.key[0], tr.graph_builds["step"]))
        return loss

    def recorded_reset(xyz, rgb, append_to_old_gaussians=False):
        before = tr.state.gaussians.capacity
        reset(xyz, rgb, append_to_old_gaussians)
        g = tr.state.gaussians
        resets.append(dict(points=len(xyz), append=append_to_old_gaussians,
                           capacity_before=before, capacity=g.capacity,
                           active=g.num_active))
    tr._run_segment, tr.reset_gaussians_from_pcd = (recorded_segment,
                                                    recorded_reset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runner.run(log_every=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tr._run_segment, tr.reset_gaussians_from_pcd

    n_units = DL3DV_VIEWS * DL3DV_CYCLES
    if len(units) != n_units or not all(u["finite"] for u in units):
        raise AssertionError(f"dl3dv: completion units {units}")
    want = {k: n_units * unit["launches"][k] for k in UNIT_KERNELS}
    steps = GS_ITERS * (1 + DL3DV_CYCLES)
    if any(launches[k] != v for k, v in want.items()) or \
            not gs_path_ok(launches, steps):
        raise AssertionError(f"dl3dv launches {launches}: expected {want}, "
                             f"composite_bwd {steps}, composite_fwd more, the "
                             "projection alike")
    # densify_pcd in both cycles: the gate, the pairs, the points, the ply
    pcd = {}
    for c in range(DL3DV_CYCLES):
        log = runner.pcd_logs.get(c)
        if log is None:
            raise AssertionError(f"dl3dv: no densify_pcd in cycle {c}")
        xyz, rgb = read_ply_points(os.path.join(
            runner.save_dir, f"dense_views_cyc{c}.ply"))
        n = log["frames"]
        if (len(log["key_idx"]) != DL3DV_VIEWS * 3 or len(xyz) != log["kept"]
                or not 0 < log["kept"] <= log["downsampled"] <= log["fused"]
                or not np.isfinite(xyz).all() or rgb.shape != xyz.shape):
            raise AssertionError(f"dl3dv densify_pcd cycle {c}: {log}, ply "
                                 f"{xyz.shape}")
        pcd[c] = dict(keyframes=len(log["key_idx"]), frames=n,
                      gate_kept=[i for i, k in enumerate(log["gate_keep"])
                                 if k and not log["input_flags"][i]],
                      gate_means=[m for m in log["gate_means"]
                                  if m is not None],
                      pairs=n * (n - 1) // 2, edges=n * (n - 1),
                      fused=log["fused"], every_k=log["every_k"],
                      downsampled=log["downsampled"], kept=log["kept"],
                      ply_points=len(xyz))
    if ([r["append"] for r in resets] != [False, True]
            or [r["points"] for r in resets] != [pcd[0]["kept"],
                                                 pcd[1]["kept"]]
            or resets[0]["active"] != pcd[0]["kept"]):
        raise AssertionError(f"dl3dv resets {resets}")
    # every replay of a capture made at the capacity it runs at, and a new
    # capture whenever the capacity changes
    stale = [s for s in segments if s[0] != s[1]]
    missed = [(a, b) for a, b in zip(segments, segments[1:])
              if b[0] != a[0] and b[2] != a[2] + 1]
    caps = {s[0] for s in segments}
    if stale or missed or any(r["capacity"] not in caps for r in resets):
        raise AssertionError(f"dl3dv captures: stale {stale}, no new "
                             f"capture {missed}, resets {resets}")
    rgb = tr.render_view(tr.train_views.cameras.at(0))["render"]
    if not bool(torch.isfinite(rgb).all()) or not bool(
            torch.isfinite(tr.gaussians.means).all()):
        raise AssertionError("dl3dv: final state not finite")
    composite_view = check_composite_view(tr, scene.test_cameras[0],
                                          "dl3dv")
    if composite_view["tiles"] != 255:
        raise AssertionError(f"dl3dv view: {composite_view['tiles']} tiles")

    phases = {k: v["total_s"] for k, v in runner.timer.summary().items()}
    split = dict(dust3r_forward_s=runner.dust3r_fn.timer.totals[
        "dust3r_forward"], dust3r_align_s=runner.dust3r_fn.timer.totals[
        "dust3r_align"], flow_gate_s=phases.get("pcd_flow_gate", 0.0),
        outliers_s=phases.get("pcd_outliers", 0.0))
    n_pairs = sum(p["pairs"] for p in pcd.values())
    res = dict(flags=" ".join(DL3DV_FLAGS),
               cuts="num_inference_steps 2 (from 100), iterations 300 "
                    "(from 10000), start_sample_svd_frame 100 (from 2000)",
               setup_s=setup_s, total_s=total_s, phases_s=phases,
               densify_pcd_split_s=split,
               dust3r_ms_per_pair=1e3 * split["dust3r_forward_s"] / n_pairs,
               unit_s=[u["seconds"] for u in units], pcd=pcd,
               resets=resets, segments=len(segments),
               captures=dict(tr.graph_builds),
               capacities=sorted(caps), peak_mem_gb=peak_gb,
               launches=launches, active=tr.gaussians.num_active,
               composite_view=composite_view)
    say("dl3dv", **res)
    return res


def check_unet_kernels(shapes, dev, phase="dtu"):
    """GEGLU and flash against their plain versions (TOL) at every shape
    of ``shapes`` (KernelShapes.calls of a phase), with the kernel's ms a
    call. The kernel runs on the whole shape; the plain version on at most
    SLICE_ROWS rows (GEGLU) or SLICE_B batch entries (flash), the first and
    the last such slice where the shape holds more."""
    gen = torch.Generator(device=dev).manual_seed(9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for (name, shape), calls in sorted(shapes.items()):
        if name == "geglu_ffn":
            args = geglu_inputs(gen, dev, *shape)
            fn, plain = geglu_ffn, geglu_ffn_reference
            extra = dict(plan=geglu_plan(shape[0], shape[1], sms,
                                         *shape[2:]))
            n = SLICE_ROWS
        else:
            b, h, s, d = shape
            # (B, S, H, D) projections viewed as (B, H, S, D), as the UNet
            args = tuple(torch.randn((b, s, h, d), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         .transpose(1, 2) for _ in range(3)) + (d ** -0.5,)
            fn, plain = A.flash_attention, A.attention_chunked
            extra = {}
            n = SLICE_B
        got = fn(*args)
        slices = ([slice(None)] if shape[0] <= n
                  else [slice(0, n), slice(shape[0] - n, shape[0])])
        errs = []
        for sl in slices:
            want = plain(args[0][sl], *args[1:]) if name == "geglu_ffn" \
                else plain(*(a[sl] for a in args[:3]), args[3])
            torch.cuda.synchronize()
            errs.append(check(name, got[sl], want))
            del want
        del got
        row = dict(name=name, shape=list(shape), calls=calls,
                   plain_rows=[[sl.start or 0, sl.stop or shape[0]]
                               for sl in slices],
                   max_abs_err=max(e[0] for e in errs),
                   rel_rms_err=max(e[1] for e in errs),
                   ms=cuda_ms(lambda: fn(*args), 5), **extra)
        say(phase, what="kernel vs plain at a new shape", **row)
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def run_lpips(dev):
    """The gs phase's trainer with the LPIPS refine loss: LPIPS on the
    card against the CPU on one (render, target) pair; one LPIPS_STEPS
    segment from graph replays against the per-step path from the same
    state and picks (bit for bit, exact composite launches); the step's
    replay time with LPIPS off and on in turns (off, on, on, off)."""
    state, cams, targets = gs_views(dev)
    cfg = TrainConfig(iterations=LPIPS_STEPS, tile_cap=GS_CAP,
                      densify_from_iter=10 ** 9)
    tr = GSTrainer(make_viewset(cams, targets), cfg, state,
                   model_path=os.path.join(BUILD_OUT, "lpips"), device=dev)
    params = random_lpips_params(12)
    tr.set_lpips(params)
    s0 = tr.state
    with torch.no_grad():
        rgb = tr.render_view(cams[0])["render"]
        card = tr._lpips(rgb, targets[0])
        cpu = lpips_module(params, "cpu")(rgb.cpu(), targets[0].cpu())
    err = check_close("lpips card vs cpu", card.cpu()[None], cpu[None],
                      *LPIPS_TOL)

    tr.use_lpips_loss = True
    runs = {}
    for name, per_step in (("graph", False), ("eager", True)):
        from_start(tr, s0, per_step)
        zero_gs_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr._run_loop(0, LPIPS_STEPS, densify=False,
                            log_every=LPIPS_STEPS)
        torch.cuda.synchronize()
        runs[name] = dict(state=tr.state, loss=loss,
                          seconds=time.perf_counter() - t0,
                          launches=gs_launches())
    tr.__dict__.pop("_merged_views", None)
    seg_on = tr._segments
    errs = state_errors(runs["graph"]["state"], runs["eager"]["state"])
    bad = {k: v for k, v in errs.items() if v != 0}
    want = gs_want(LPIPS_STEPS, LPIPS_STEPS)
    if (bad or runs["graph"]["loss"] != runs["eager"]["loss"]
            or seg_on.key[-1] is not True
            or any(r["launches"] != want for r in runs.values())):
        raise AssertionError(
            f"lpips segment: graph and per-step not bit for bit {bad}, "
            f"losses {[r['loss'] for r in runs.values()]}, launches "
            f"{[r['launches'] for r in runs.values()]} (expected {want})")

    tr.use_lpips_loss = False
    from_start(tr, s0)
    tr._run_loop(0, 2, densify=False)
    seg_off = tr._segments
    replays = {}
    for name, seg in (("off", seg_off), ("on", seg_on)):
        tr._segments = seg
        replays[name] = gs_replays(tr)
    turns = [step_times(lambda r=replays[k]: r(1), GS_TIMED_STEPS)
             for k in ("off", "on", "on", "off")]
    step_ms = {"off": [float(np.median(t)) for t in turns[::3]],
               "on": [float(np.median(t)) for t in turns[1:3]]}
    res = dict(steps=LPIPS_STEPS, lpips_card=float(card),
               lpips_cpu=float(cpu), lpips_max_abs_err=err[0],
               losses={k: r["loss"] for k, r in runs.items()},
               seconds={k: r["seconds"] for k, r in runs.items()},
               launches=runs["graph"]["launches"], step_ms_median=step_ms,
               step_ms_p10_p90={k: [float(np.percentile(turns[i], q))
                                    for q in (10, 90)]
                                for k, i in (("off", 0), ("on", 1))},
               captures=dict(tr.graph_builds))
    say("lpips", **res)
    return res


def optin_inputs(pipe, seed=3):
    """The unit phase's inputs (its seed): the denoise arguments of one
    pair at 576x1024, and the images."""
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.rand((FRAMES, HEIGHT, WIDTH, 3), generator=g, device=dev)
    mask = torch.rand((FRAMES - 2, HEIGHT // 8, WIDTH // 8), generator=g,
                      device=dev)
    lam = search_hypers_v2(mask, STEPS)
    clip_s, clip_e, cond, _, _ = pipe.encode_conditioning(
        imgs[0], list(imgs[1:-1]), imgs[-1], g)
    latents = torch.randn((1, FRAMES, HEIGHT // 8, WIDTH // 8, 4),
                          generator=g, device=dev)
    return (latents, clip_s, clip_e, cond, mask, lam), imgs


def run_optins(pipe, unit, args, known_shapes, known_norms):
    """The unit's forward-only opt-ins on its networks and inputs, 2 steps
    each: direction_parallel (post: one batch-6 forward a step; prob: one
    batch-4), guidance_reuse_cfg_uncond (one batch-2 forward a direction
    and step) and fused_guidance_cfg=False (a batch-1 and a batch-2 one).
    Launch counts exact (GEGLU and flash per forward as the unit's, the
    norms one a module call); each opt-in's latents held to the path it
    must equal (OPTIN_TOL); s per denoise step, the parallel step in turns
    with the default (default, parallel, parallel, default), with its peak
    memory. ``args``: the denoise inputs (``optin_inputs``). Every GEGLU
    and flash call recorded by shape and every UNet norm call by the
    census; returns the results, and the GEGLU/flash shapes and norm calls
    that neither the default's forwards nor ``known_shapes`` /
    ``known_norms`` (the dtu phase's, and the unit's census keys without
    their module name) hold."""
    zero = torch.zeros_like(args[1])
    zero_args = (args[0], zero, zero) + args[3:]
    n_gn, n_ln = unit["unet_norms_per_forward"]

    def make(**kw):
        return GuidedSVDPipeline(pipe.m, GuidedSVDConfig(
            num_inference_steps=STEPS, **kw))
    pipes = {"default": pipe, "parallel": make(direction_parallel=True),
             "prob": make(variant="prob"),
             "prob_parallel": make(variant="prob", direction_parallel=True),
             "reuse": make(guidance_reuse_cfg_uncond=True),
             "unfused": make(fused_guidance_cfg=False)}
    # UNet forwards of one denoise
    forwards = {"default": 2 * STEPS, "parallel": STEPS, "prob": 2 * STEPS,
                "prob_parallel": STEPS, "reuse": 2 * STEPS,
                "unfused": 4 * STEPS}
    runs = [("default", args), ("parallel", args), ("parallel", args),
            ("default", args), ("prob", args), ("prob_parallel", args),
            ("reuse", args), ("unfused", args),
            ("default_zero_clip", zero_args), ("reuse_zero_clip", zero_args)]
    census = NormCensus()
    census.watch(pipe.m.unet, "unet_optins")
    out, seconds, launches, peak = {}, {}, {}, {}
    with KernelShapes() as shapes:
        for name, a in runs:
            p = pipes[name.replace("_zero_clip", "")]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            out[name] = p.denoise(*a)
            torch.cuda.synchronize()
            seconds.setdefault(name, []).append(time.perf_counter() - t0)
            launches[name] = launch_counts()
            peak[name] = torch.cuda.max_memory_allocated() / 1e9
            if len(out) == 1:        # the default's batch-3 shapes
                known_shapes = set(known_shapes) | set(shapes.calls)
    census.close()

    # GEGLU and flash a forward as the unit's (48 and 15), the norms one
    # launch of each kernel a module
    per = {k: unit["launches"][k] // unit["forwards"]
           for k in ("geglu_ffn", "flash_attention")}
    for name, n in forwards.items():
        want = {"geglu_ffn": per["geglu_ffn"] * n,
                "flash_attention": per["flash_attention"] * n,
                "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
                **gs_want(0, 0),
                "gn_stats": n_gn * n, "gn_apply": n_gn * n,
                "layer_norm": n_ln * n}
        if launches[name] != want:
            raise AssertionError(f"optins {name}: launches "
                                 f"{launches[name]}, expected {want}")
    if peak["parallel"] >= 80.0:
        raise AssertionError(f"optins: batch-6 peak {peak['parallel']} GB")
    # every opt-in against the path it must equal; the reuse step with
    # random CLIP embeddings must differ from the default (the documented
    # divergence, by more than 1e-3 as the guided phase holds its option)
    # and stay finite. Beside it, how far the two are apart with zero
    # embeddings, where only the batch size parts them (bf16 noise).
    held = {}
    for got, want in (("parallel", "default"), ("prob_parallel", "prob"),
                      ("unfused", "default"),
                      ("reuse_zero_clip", "default_zero_clip")):
        held[f"{got} vs {want}"] = check_rel(
            f"optins {got} vs {want}", out[got], out[want], OPTIN_TOL)
    reuse_diff = errors(out["reuse"], out["default"])
    noise = held["reuse_zero_clip vs default_zero_clip"]
    if not (bool(torch.isfinite(out["reuse"]).all())
            and reuse_diff[0] > 1e-3):
        raise AssertionError(f"optins reuse: latents apart from default by "
                             f"{reuse_diff} (max-abs, rel-RMS)")
    new_shapes = {k: n for k, n in shapes.calls.items()
                  if k not in known_shapes}
    new_norms = {k: n for k, n in census.calls.items()
                 if (k[0],) + k[2:] not in known_norms}
    shape_calls = shapes.totals()
    total = {k: sum(launches[n][k] for n, _ in runs) for k in shape_calls}
    if shape_calls != total or not new_shapes or not new_norms:
        raise AssertionError(f"optins: GEGLU/flash shapes {shapes.calls} "
                             f"against launches {total}")
    per_step = {name: [t / STEPS for t in ts]
                for name, ts in seconds.items()}
    res = dict(s_per_denoise_step=per_step,
               s_per_denoise_step_mean={k: float(np.mean(v))
                                        for k, v in per_step.items()},
               turns_default_parallel=[per_step["default"][0],
                                       per_step["parallel"][0],
                                       per_step["parallel"][1],
                                       per_step["default"][1]],
               forwards_per_denoise=forwards, peak_mem_gb=peak,
               launches={k: launches[k] for k in forwards},
               held={k: dict(max_abs=v[0], rel_rms=v[1], max_abs_rel=v[2])
                     for k, v in held.items()},
               tolerance=dict(max_abs_rel=OPTIN_TOL[0],
                              rel_rms=OPTIN_TOL[1]),
               reuse_vs_default=dict(max_abs=reuse_diff[0],
                                     rel_rms=reuse_diff[1]),
               reuse_vs_default_zero_clip=dict(max_abs=noise[0],
                                               rel_rms=noise[1]),
               kernel_shapes={f"{k} {list(sh)}": n
                              for (k, sh), n in sorted(shapes.calls.items())})
    say("optins", **res)
    launches_all = {k: sum(launches[n][k] for n, _ in runs)
                    for k in launches["default"]}
    res["launches_all"] = launches_all
    return res, new_norms, new_shapes


def check_forward_warp(imgs):
    """The forward-warp conditioning of one pair at 576x1024 on the card
    against the CPU: the unit's endpoint images ``imgs`` (on the card),
    smooth depths, 25 poses interpolated between two cameras. Tolerance
    FW_TOL."""
    dev = imgs.device
    yy, xx = torch.meshgrid(torch.linspace(0, 1, HEIGHT, device=dev),
                            torch.linspace(0, 1, WIDTH, device=dev),
                            indexing="ij")
    depth_l = 2.0 + 0.8 * yy + 0.3 * torch.sin(6.0 * xx)
    depth_r = 2.2 + 0.6 * xx + 0.2 * torch.cos(5.0 * yy)
    K = torch.tensor([[900.0, 0.0, WIDTH / 2], [0.0, 900.0, HEIGHT / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    poses = TCP.interpolate_pair_poses(
        look_at_w2c([-0.25, 0.0, 0.0], [0.0, 0.0, 2.5]).numpy(),
        look_at_w2c([0.25, 0.05, 0.0], [0.0, 0.0, 2.5]).numpy(), FRAMES)
    inputs = (K, poses, imgs[0], depth_l, imgs[-1], depth_r)
    t0 = time.perf_counter()
    card = TCP.prepare_pair_conditioning(None, *inputs, num_steps=STEPS,
                                         warp_mode="forward_warp")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = TCP.prepare_pair_conditioning(
        None, *(x.cpu() if isinstance(x, torch.Tensor) else x
                for x in inputs), num_steps=STEPS, warp_mode="forward_warp")
    hole_card = (card.cond_images == 0).all(-1).cpu()
    hole_cpu = (cpu.cond_images == 0).all(-1)
    hole_diff = float((hole_card != hole_cpu).float().mean())
    both = ~(hole_card | hole_cpu)
    diff = (card.cond_images.cpu() - cpu.cond_images).abs().amax(-1)[both]
    cond_err = float(diff.max())
    moved = float((diff > FW_TOL["cond"]).float().mean())
    mask_diff = float((card.masks.cpu() != cpu.masks).float().mean())
    binary = bool(((card.masks == 0) | (card.masks == 1)).all())
    res = dict(frames=FRAMES - 2, hole_fraction=float(hole_cpu.float().mean()),
               hole_pixels_differing=hole_diff, cond_max_abs=cond_err,
               cond_moved_beyond_tol=moved,
               latent_masks_differing=mask_diff, binary_masks=binary,
               lambda_equal=bool(torch.equal(card.lambda_ts.cpu(),
                                             cpu.lambda_ts)),
               card_s=card_s, tolerance=FW_TOL)
    if (not binary or hole_diff > FW_TOL["holes"]
            or mask_diff > FW_TOL["latent_masks"]
            or not moved <= FW_TOL["cond_moved"]):
        raise AssertionError(f"forward warp card vs cpu: {res}")
    say("optins", what="forward-warp conditioning card vs cpu", **res)
    return res


def run_slice(pipe, unit):
    """This slice through the training entry point: cli/train's parser and
    build_runner with --interp_type forward_warp --save_debug and
    --guidance_reuse_cfg_uncond 1 (the unit configured by svd_config, on
    the unit's networks, as completion_fn) on the scene phase's in-memory
    scene with its cuts and --refine_cycle_num 1, then run: 3 pairs, each
    pair's debug set on disk, binary latent masks, every kernel of the
    path launched (the completion's exactly as the unit's)."""
    out = os.path.join(BUILD_OUT, "slice")
    shutil.rmtree(out, ignore_errors=True)
    args = cli_train.build_parser().parse_args(
        ["-s", "(in memory)", "-m", out] + SLICE_FLAGS)
    reuse = GuidedSVDPipeline(pipe.m, GuidedSVDConfig(
        **cli_train.svd_config(args)))
    if not reuse.cfg.guidance_reuse_cfg_uncond:
        raise AssertionError("slice: the unit is not the reuse one")
    units, masks = [], []

    def completion(*a):
        masks.append(a[3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = reuse(*a)
        torch.cuda.synchronize()
        units.append(dict(seconds=time.perf_counter() - t0,
                          lo=frames.min().item(), hi=frames.max().item(),
                          finite=bool(torch.isfinite(frames).all())))
        return frames

    runner = cli_train.build_runner(args, scene_data(args.device),
                                    completion_fn=completion)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runner.run(log_every=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(units) != SCENE_PAIRS or not all(
            u["finite"] and u["lo"] >= 0.0 and u["hi"] <= 1.0 for u in units):
        raise AssertionError(f"slice: completion units {units}")
    binary = all(bool(((m == 0) | (m == 1)).all()) for m in masks)
    debug = os.path.join(runner.save_dir, "debug")
    want_files = ({"endpoint_start.png", "endpoint_end.png",
                   "lambda_ts.png", "completion.gif"}
                  | {f"cond_{i:02d}.png" for i in range(FRAMES - 2)}
                  | {f"uncertainty_{i:02d}.png" for i in range(FRAMES - 2)}
                  | {f"generated_{i:02d}.png" for i in range(FRAMES)})
    pairs = sorted(os.listdir(debug))
    files_ok = pairs == [f"cyc0_pair{p}" for p in range(SCENE_PAIRS)] and \
        all(set(os.listdir(os.path.join(debug, d))) == want_files
            for d in pairs)
    want = {k: SCENE_PAIRS * unit["launches"][k] for k in UNIT_KERNELS}
    steps = 2 * GS_ITERS
    if (not binary or not files_ok
            or any(launches[k] != v for k, v in want.items())
            or not gs_path_ok(launches, steps)
            or not all(launches[k] for k in PATH_KERNELS)):
        raise AssertionError(
            f"slice: binary masks {binary}, debug sets {pairs} complete "
            f"{files_ok}; launches {launches}, expected {want}, "
            f"composite_bwd {steps}, composite_fwd more, the "
                             "projection alike")
    res = dict(flags=" ".join(SLICE_FLAGS), total_s=total_s,
               phases_s={k: v["total_s"] for k, v in
                         runner.timer.summary().items()},
               unit_s=[u["seconds"] for u in units],
               debug_files_per_pair=len(want_files),
               binary_latent_masks=binary, peak_mem_gb=peak_gb,
               launches=launches, captures=dict(runner.trainer.graph_builds))
    say("slice", **res)
    return res


def run_mono(dev):
    """The gs phase's trainer with a fixed depth estimator installed (a
    ramp, 2.0 to 3.0 down the rows): MONO_ITERS iterations with
    sample_pseudo_interval MONO_INTERVAL, the segments from graph replays
    against the per-step path from the same state and picks (bit for
    bit; the composite forward twice and the backward once more in each
    pseudo step: the estimate's render, the loss's render and its
    gradient); then the pseudo step's ms (render, estimate, step)."""
    state, cams, targets = gs_views(dev)
    cfg = TrainConfig(iterations=MONO_ITERS, tile_cap=GS_CAP,
                      densify_from_iter=10 ** 9,
                      sample_pseudo_interval=MONO_INTERVAL,
                      start_sample_pseudo=0)
    tr = GSTrainer(make_viewset(cams, targets), cfg, state,
                   model_path=os.path.join(BUILD_OUT, "mono"), device=dev)
    ramp = (2.0 + torch.linspace(0, 1, GS_H, device=dev)[:, None]
            .expand(GS_H, GS_W)).contiguous()
    calls = []

    def estimator(rgb):
        calls.append(tuple(rgb.shape))
        return ramp
    tr.set_mono_depth_fn(estimator)
    s0 = tr.state
    runs = {}
    for name, per_step in (("graph", False), ("eager", True)):
        from_start(tr, s0, per_step)
        calls.clear()
        zero_gs_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr._run_loop(0, MONO_ITERS, densify=False,
                            log_every=MONO_ITERS)
        torch.cuda.synchronize()
        runs[name] = dict(state=tr.state, loss=loss,
                          seconds=time.perf_counter() - t0,
                          launches=gs_launches(),
                          pseudo_steps=len(calls))
    tr.__dict__.pop("_merged_views", None)
    n_pseudo = MONO_ITERS // MONO_INTERVAL
    errs = state_errors(runs["graph"]["state"], runs["eager"]["state"])
    bad = {k: v for k, v in errs.items() if v != 0}
    want = gs_want(MONO_ITERS + 2 * n_pseudo, MONO_ITERS + n_pseudo)
    if (bad or runs["graph"]["loss"] != runs["eager"]["loss"]
            or any(r["launches"] != want or r["pseudo_steps"] != n_pseudo
                   for r in runs.values())
            or tr.graph_builds["step"] < 1
            or runs["graph"]["state"].adam.count != MONO_ITERS + n_pseudo):
        raise AssertionError(
            f"mono: graph and per-step not bit for bit {bad}, losses "
            f"{[r['loss'] for r in runs.values()]}, launches "
            f"{[r['launches'] for r in runs.values()]} (expected {want}), "
            f"pseudo steps {[r['pseudo_steps'] for r in runs.values()]}")
    moved = float((runs["graph"]["state"].gaussians.means
                   - s0.gaussians.means).abs().max())
    pseudo_ms = step_times(lambda: tr._maybe_mono_pseudo(MONO_INTERVAL),
                           GS_TIMED_STEPS)
    res = dict(iterations=MONO_ITERS, interval=MONO_INTERVAL,
               pseudo_steps=n_pseudo, launches=runs["graph"]["launches"],
               losses={k: r["loss"] for k, r in runs.items()},
               seconds={k: r["seconds"] for k, r in runs.items()},
               means_moved=moved,
               pseudo_step_ms_median=float(np.median(pseudo_ms)),
               pseudo_step_ms_p10_p90=[float(np.percentile(pseudo_ms, q))
                                       for q in (10, 90)],
               captures=dict(tr.graph_builds))
    say("mono", **res)
    return res


def run_fleet(dev):
    """cli/batch.py --dataset llff --parallel 1 --eval on one synthetic
    COLMAP scan (the gs phase's truth from FLEET_IMAGES cameras at 504x378)
    with the warp-only completion and the scene cuts: the worker
    subprocess gets its card by CUDA_VISIBLE_DEVICES and exits 0, every
    checkpoint is rendered, and the summary's PSNR and SSIM are finite
    (the batch eval runs cli/metrics without LPIPS weights, so LPIPS is
    nan, as in the JAX package)."""
    root = os.path.join(BUILD_OUT, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_colmap_scan(dev, os.path.join(root, "data", "scan"), FLEET_IMAGES,
                      GS_W, GS_H)
    envs = []
    popen = cli_batch.subprocess.Popen

    def spy(argv, **kw):
        envs.append(kw.get("env", {}).get("CUDA_VISIBLE_DEVICES"))
        return popen(argv, **kw)
    cli_batch.subprocess.Popen = spy
    try:
        cli_batch.main(["--dataset", "llff", "--data_root",
                        os.path.join(root, "data"), "--out_root",
                        os.path.join(root, "out"), "--scenes", "scan",
                        "--parallel", "1",
                        "--eval", "--extra"] + SCENE_CUTS
                       + ["--log_every", "0"])
    finally:
        cli_batch.subprocess.Popen = popen
    seconds = time.perf_counter() - t0
    out = os.path.join(root, "out", "scan")
    rendered = sorted(os.listdir(os.path.join(out, "test")))
    blocks = cli_summarize.parse_eval_res(os.path.join(out, "eval_res.txt"))
    cycles = int(cli_batch.PRESETS["llff"][
        cli_batch.PRESETS["llff"].index("--refine_cycle_num") + 1])
    want = [f"ours_chkpnt{GS_ITERS}"] + [f"ours_refine_{c}_chkpnt{GS_ITERS}"
                                         for c in range(cycles)]
    table = cli_summarize.summarize(os.path.join(root, "out"),
                                    checkpoints=sorted(blocks))
    finite = all(np.isfinite(b[k]) for b in blocks.values()
                 for k in ("PSNR", "SSIM"))
    expect_env = cli_batch._worker_devices(1)
    if (envs != expect_env or rendered != want
            or sorted(blocks) != [w + ".pth" for w in want] or not finite):
        raise AssertionError(f"fleet: worker CUDA_VISIBLE_DEVICES {envs} "
                             f"(expected {expect_env}), rendered {rendered}, "
                             f"eval {blocks}")
    res = dict(seconds=seconds, worker_cuda_visible_devices=envs,
               rendered=rendered, eval=blocks)
    say("fleet", **res)
    print(table, flush=True)
    return res


def parallel_devices(n):
    """``n`` mesh entries: the visible cards in turn (distinct where there
    are n of them), or cuda:0 n times on one card."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def sync_all(devices):
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def peak_gb(devices):
    return {str(d): torch.cuda.max_memory_allocated(d) / 1e9
            for d in dict.fromkeys(devices)}


def reset_peaks(devices):
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def timed_run(fn, devices):
    """(result, seconds, launches, peak GB by device) of one call of
    ``fn``: the counts zeroed just before and read just after."""
    sync_all(devices)
    reset_peaks(devices)
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    sync_all(devices)
    return (out, time.perf_counter() - t0, launch_counts(),
            peak_gb(devices))


def in_turns(plain, path, devices, value=lambda out: out):
    """plain, path, path, plain: ((outputs), seconds of each, launches and
    peak memory of the path's first call, and whether each repeat gave
    the same ``value`` of its output bit for bit)."""
    a0, ta0, _, _ = timed_run(plain, devices)
    b0, tb0, launches, peak = timed_run(path, devices)
    b1, tb1, _, _ = timed_run(path, devices)
    a1, ta1, _, _ = timed_run(plain, devices)
    same = all(torch.equal(value(x), value(y))
               for x, y in ((a0, a1), (b0, b1)))
    return (a0, b0), dict(turns_s=[ta0, tb0, tb1, ta1], plain_s=[ta0, ta1],
                          path_s=[tb0, tb1], repeat_bit_equal=same,
                          launches=launches, peak_mem_gb=peak)


def want_launches(**kw):
    out = {k: 0 for k in launch_counts()}
    out.update(kw)
    return out


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"parallel {name}: launches {got}, expected "
                             f"{want}")


def temporal_gn_recorder(census, where):
    """Records, while installed, each frame shard's temporal GroupNorm
    (``sequence_parallel._gn_sharded``: the sums launch and the apply
    kernel on each shard) in ``census`` under ``where``, keyed as
    NormCensus keys its calls but of kind "gn_sums"."""
    orig = SPM._gn_sharded

    def rec(norms, xs):
        gn = norms[0]
        for x in xs:
            c = x.shape[-1]
            key = ("gn_sums", where,
                   (x.shape[0], x.numel() // (x.shape[0] * c), c), x.dtype,
                   gn.silu, gn.num_groups, gn.eps, gn.weight.dtype)
            census.calls[key] = census.calls.get(key, 0) + 1
        return orig(norms, xs)
    SPM._gn_sharded = rec
    return lambda: setattr(SPM, "_gn_sharded", orig)


def run_parallel(dev, unit, scene_total_s, known_shapes, known_norms):
    """The parallel/ package on the card, at full width: direction
    sharding, pair waves, the TP and SP forwards, the DP GS step, GPipe
    (see the module docstring). Returns the record, the new norm calls
    and the new GEGLU/flash shapes (to be held against their plain
    versions)."""
    distinct = torch.cuda.device_count() >= 2
    devs2, devs4 = parallel_devices(2), parallel_devices(4)
    say("parallel", mesh="distinct cards" if distinct else
        "cuda:0 repeated (one card)", devices2=[str(d) for d in devs2],
        devices4=[str(d) for d in devs4])
    pipe = load_svd_completion(None, dev, seed=0, num_inference_steps=STEPS)
    per = {k: unit["launches"][k] // unit["forwards"]
           for k in ("geglu_ffn", "flash_attention")}
    n_gn, n_ln = unit["unet_norms_per_forward"]
    tol = OPTIN_TOL if distinct else None     # None: bit for bit
    res = {"mesh": "distinct" if distinct else "repeated cuda:0"}

    def held(name, got, want):
        if tol is None:
            if not torch.equal(got, want):
                raise AssertionError(f"parallel {name}: not bit for bit "
                                     f"{errors(got, want)}")
            return dict(bit_equal=True)
        e = check_rel(f"parallel {name}", got, want, tol)
        return dict(max_abs=e[0], rel_rms=e[1], max_abs_rel=e[2])

    # -- direction sharding: the post unit on a (1, 2) topology --------
    _, dir2 = make_scene_topology(devs2)
    pipe_dir = GuidedSVDPipeline(pipe.m, dataclasses.replace(
        pipe.cfg, direction_sharding=dir2))
    args, _ = optin_inputs(pipe)
    (seq, sharded), rec = in_turns(lambda: pipe.denoise(*args),
                                   lambda: pipe_dir.denoise(*args), devs2)
    n = 2 * STEPS
    check_launches("direction", rec["launches"], want_launches(
        geglu_ffn=per["geglu_ffn"] * n,
        flash_attention=per["flash_attention"] * n, gn_stats=n_gn * n,
        gn_apply=n_gn * n, layer_norm=n_ln * n))
    rec["held_to_sequential"] = held("direction", sharded, seq)
    res["direction"] = rec
    say("parallel", path="direction_sharding", **rec)
    del args, seq, sharded, pipe_dir

    # -- pair waves: the scene phase's run, 2 waves a cycle -----------
    pair4, dir4 = make_scene_topology(devs4)
    pipe_pairs = GuidedSVDPipeline(pipe.m, dataclasses.replace(
        pipe.cfg, direction_sharding=dir4))
    out = os.path.join(BUILD_OUT, "parallel_scene")
    shutil.rmtree(out, ignore_errors=True)
    pargs = cli_train.build_parser().parse_args(
        ["-s", "(in memory)", "-m", out] + SCENE_FLAGS)
    runner = cli_train.build_runner(pargs, scene_data(dev),
                                    completion_fn=pipe_pairs,
                                    topology=(pair4, dir4))
    if not (runner.cfg.pair_parallel and pair4.shards == 2):
        raise AssertionError("parallel: the runner has no 2-slot pair axis")
    _, total_s, launches, peak = timed_run(
        lambda: runner.run(log_every=0), devs4)
    slots = SCENE_CYCLES * 2 * pair4.shards       # 3 pairs + 1 padded
    steps = GS_ITERS * (1 + SCENE_CYCLES)
    want = {k: slots * unit["launches"][k] for k in UNIT_KERNELS}
    if (any(launches[k] != v for k, v in want.items())
            or not gs_path_ok(launches, steps)):
        raise AssertionError(f"parallel pairs: launches {launches}, "
                             f"expected {want}")
    caches = sorted(os.listdir(runner.save_dir))
    want_caches = sorted(f"interpolated_dense_views_cyc{c}_view{p}.npz"
                         for c in range(SCENE_CYCLES)
                         for p in range(SCENE_PAIRS))
    if caches != want_caches:
        raise AssertionError(f"parallel pairs: caches {caches} (a padded "
                             f"slot wrote one?)")
    pair_held = {}
    for p in range(SCENE_PAIRS):
        name = f"interpolated_dense_views_cyc0_view{p}.npz"
        with np.load(os.path.join(runner.save_dir, name)) as got, \
                np.load(os.path.join(BUILD_OUT, "scene", "dense_views",
                                     name)) as want_:
            pair_held[p] = held(f"pairs cycle-0 pair {p}",
                                torch.from_numpy(got["frames"]),
                                torch.from_numpy(want_["frames"]))
            if not np.array_equal(got["poses"], want_["poses"]):
                raise AssertionError(f"parallel pairs: pair {p} poses")
    res["pairs"] = dict(
        total_s=total_s, scene_phase_total_s=scene_total_s,
        phases_s={k: v["total_s"] for k, v in
                  runner.timer.summary().items()},
        waves_per_cycle=2, slots_per_cycle=2 * pair4.shards,
        caches=len(caches), held_to_scene_phase=pair_held,
        launches=launches, peak_mem_gb=peak)
    say("parallel", path="pair_waves", **res["pairs"])
    del runner, pipe_pairs

    # -- TP and SP forwards: one full-width batch-3 UNet forward ------
    g = torch.Generator(device=dev).manual_seed(11)
    sample = torch.randn((3, FRAMES, HEIGHT // 8, WIDTH // 8, 8),
                         generator=g, device=dev).to(torch.bfloat16)
    ehs = torch.randn((3, 1, 1024), generator=g,
                      device=dev).to(torch.bfloat16)
    t = pipe.schedule.timesteps[0]
    tids = pipe._added_time_ids(3)
    unet = pipe.m.unet
    census = NormCensus()
    census.watch(unet, "unet_parallel")
    fwd_args = (sample, t, ehs, tids, (1, 2))
    with KernelShapes() as shapes, torch.no_grad():
        whole = unet(*fwd_args)
        known = set(known_shapes) | set(shapes.calls)
        known_n = set(known_norms) | {(k[0],) + k[2:] for k in census.calls}
        tp_run, params_tp = make_tp_unet_forward(
            make_mesh(axis_name="model", devices=devs2), unet)
        sp_run = make_sp_unet_forward(
            make_mesh(axis_name="seq", devices=devs2), unet)
        for r in sp_run.replicas[1:]:
            if r is not unet:
                census.watch(r, "unet_parallel")
        undo = temporal_gn_recorder(census, "unet_sp_temporal")
        try:
            for name, run in (("tp", tp_run), ("sp", sp_run)):
                (ref, got), rec = in_turns(lambda: unet(*fwd_args),
                                           lambda: run(*fwd_args), devs2)
                if name == "tp":
                    want = want_launches(
                        geglu_ffn=2 * per["geglu_ffn"],
                        flash_attention=2 * per["flash_attention"],
                        gn_stats=n_gn, gn_apply=n_gn, layer_norm=n_ln)
                else:
                    # a temporal GroupNorm: one sums launch a shard
                    want = want_launches(
                        geglu_ffn=2 * per["geglu_ffn"],
                        flash_attention=2 * per["flash_attention"],
                        gn_stats=2 * n_gn, gn_apply=2 * n_gn,
                        layer_norm=2 * n_ln)
                check_launches(name, rec["launches"], want)
                e = check_rel(f"parallel {name}", got, whole, PAR_TOL)
                rec["held_to_unsharded"] = dict(
                    max_abs=e[0], rel_rms=e[1], max_abs_rel=e[2])
                res[name] = rec
                say("parallel", path=f"{name}_forward", **rec)
                del ref, got
        finally:
            undo()
        half = {k: v for k, v in params_tp.items()
                if isinstance(v, list)}
        res["tp"]["split_weights"] = len(half)
        res["tp"]["shard_rows_to_q_level1"] = [
            t.shape[0] for t in params_tp[
                "down_blocks.0.attentions.0.transformer_blocks.0.attn1."
                "to_q.weight"]]
        del tp_run, sp_run, params_tp, half, whole

        # -- GPipe: 4 stages of a level-1 BasicTransformerBlock -------
        gen = torch.Generator(device=dev).manual_seed(12)
        blocks = [init_random_weights_(BasicTransformerBlock(
            320, 5, 64, 1024).to(dev), gen).to(torch.bfloat16).eval()
            for _ in range(PAR_STAGES)]
        census.watch(torch.nn.ModuleList(blocks), "gpipe")
        x = torch.randn((3 * PAR_MICRO, (HEIGHT // 8) * (WIDTH // 8), 320),
                        generator=gen, device=dev).to(torch.bfloat16)
        # one CLIP context for every row (its one token broadcasts)
        ctx = torch.randn((1, 1, 1024), generator=gen,
                          device=dev).to(torch.bfloat16)
        mesh4 = make_mesh(axis_name="stage", devices=devs4)
        run = make_gpipe(mesh4, lambda b, xin: b(
            xin, to_device(ctx, xin.device)), PAR_STAGES)

        def sequential():
            y = x
            for b in blocks:
                y = b(y, ctx)
            return y
        (ref, got), rec = in_turns(sequential,
                                   lambda: run(blocks, x, PAR_MICRO), devs4)
        calls = PAR_STAGES * PAR_MICRO
        flash = A.takes_flash(x.shape[1], x.shape[1], 64)  # 9216 tokens
        check_launches("gpipe", rec["launches"], want_launches(
            geglu_ffn=calls, flash_attention=calls * flash,
            layer_norm=3 * calls))
        e = check_rel("parallel gpipe", got, ref, PAR_TOL)
        rec["held_to_sequential"] = dict(max_abs=e[0], rel_rms=e[1],
                                         max_abs_rel=e[2])
        # x on the host: the stages on the cards, the output gathered
        # onto the host and read at once
        host = run(blocks, x.cpu(), PAR_MICRO)
        if host.device.type != "cpu" or not torch.equal(host, got.cpu()):
            raise AssertionError("parallel gpipe: the gather onto the host "
                                 f"differs {errors(host, got.cpu())}")
        rec["host_gather_bit_equal"] = True
        del host
        res["gpipe"] = rec
        say("parallel", path="gpipe", **rec)
        del blocks, x, ref, got
    census.close()
    new_shapes = {k: c for k, c in shapes.calls.items() if k not in known}
    new_norms = {k: c for k, c in census.calls.items()
                 if (k[0],) + k[2:] not in known_n}
    del pipe, sample, ehs, unet
    torch.cuda.empty_cache()

    # -- DP GS step: 4 views over 2 replicas --------------------------
    state, gt, cam = gs_truth(dev)
    cams = [camera_from_fov(0.9, 0.7, cam.width, cam.height,
                            look_at_w2c([x_, 0.0, 0.0], [0.0, 0.0, 2.5]),
                            device=dev) for x_ in (-0.3, -0.1, 0.1, 0.3)]
    with torch.no_grad():
        targets = torch.stack([RZ.render(gt, c, method="kernel",
                                         tile_cap=GS_CAP).rgb for c in cams])
    cfg = TrainConfig(tile_cap=GS_CAP)
    ts = TrainState(gaussians=state,
                    adam=AdamState.init(GM.get_params(state)),
                    stats=DensifyStats.zeros(state.capacity, dev), step=0)
    cams_st = stack_cameras(cams)
    extent = max(scene_extent(cams_st), 1e-6)
    step, prepare = make_dp_gs_train_step(
        make_mesh(axis_name="data", devices=devs2), cfg, extent)
    placed = prepare(ts, cams_st, targets)
    (one, dp), rec = in_turns(
        lambda: step(ts, cams_st, targets), lambda: step(*placed), devs2,
        value=lambda out: (out[0] if isinstance(out[0], TrainState)
                           else out[0][0]).gaussians.means)
    check_launches("dp_gs", rec["launches"], want_launches(
        **gs_want(len(cams), len(cams))))
    lr = position_lr(cfg, extent, 0)
    loss_rel = abs(float(dp[1]) - float(one[1])) / abs(float(one[1]))
    d = (dp[0][0].gaussians.means - one[0].gaussians.means).abs()
    beyond = float((d > DP_MEANS_ATOL).float().mean())
    if not (loss_rel <= DP_LOSS_RTOL and float(d.max()) <= 2 * lr
            and beyond <= DP_MEANS_FRACTION):
        raise AssertionError(
            f"parallel dp_gs: loss rel {loss_rel}, means max {d.max()} "
            f"(2 lr {2 * lr}), share beyond {DP_MEANS_ATOL}: {beyond}")
    rec.update(loss=float(dp[1]), loss_one_replica=float(one[1]),
               loss_rel=loss_rel, means_max_abs=float(d.max()),
               means_share_beyond_atol=beyond, lr_means=lr,
               views=len(cams), replicas=2)
    res["dp_gs"] = rec
    say("parallel", path="dp_gs_step", **rec)
    return res, new_norms, new_shapes


class ShapeRecorder:
    """A kernel wrapper that counts its calls by the shape of the first
    argument in ``calls`` (a GEGLU call of a tensor-parallel shard adds its
    inner width) and passes each on."""

    def __init__(self, name, fn, calls):
        self.name, self.fn, self.calls = name, fn, calls

    def __call__(self, x, *args):
        key = (self.name, tuple(x.shape))
        if self.name == "geglu_ffn" and args[2].shape[1] != 4 * x.shape[1]:
            key = (self.name, tuple(x.shape) + (args[2].shape[1],))
        self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(x, *args)


class KernelShapes:
    """Counts, while active, the GEGLU and flash calls by the shape the
    kernel sees: the names the callers look up (``L.geglu_ffn``, which
    FeedForward calls, and ``A.flash_attention``, which ``A.attention``
    calls) are bound to ShapeRecorders. ``calls``: {(name, shape): calls},
    shape (rows, C) for GEGLU ((rows, C, inner) for a tensor-parallel
    shard's) and (B, H, S, D) for flash."""

    def __init__(self):
        self.calls = {}

    def _recorder(self, name, fn):
        return ShapeRecorder(name, fn, self.calls)

    def totals(self):
        out = {"geglu_ffn": 0, "flash_attention": 0}
        for (name, _), n in self.calls.items():
            out[name] += n
        return out

    def __enter__(self):
        self._saved = L.geglu_ffn, A.flash_attention
        L.geglu_ffn = self._recorder("geglu_ffn", self._saved[0])
        A.flash_attention = self._recorder("flash_attention", self._saved[1])
        return self

    def __exit__(self, *exc):
        L.geglu_ffn, A.flash_attention = self._saved


class NormCensus:
    """Counts, by forward pre-hooks, the GroupNorm and LayerNorm calls of
    the modules given to ``watch`` while it is active: {key: calls} with
    key (kind, where, shape, dtype, silu, groups, eps, weight dtype), shape
    (B, S, C) for GroupNorm and (R, C) for LayerNorm, as the kernels see
    them."""

    def __init__(self):
        self.calls = {}
        self._hooks = []

    def watch(self, module, where):
        for m in module.modules():
            if isinstance(m, (L.GroupNorm, L.LayerNorm)):
                self._hooks.append(m.register_forward_pre_hook(
                    lambda mod, args, where=where: self._count(mod, args[0],
                                                               where)))

    def _count(self, mod, x, where):
        c = x.shape[-1]
        if isinstance(mod, L.GroupNorm):
            key = ("group_norm", where,
                   (x.shape[0], x.numel() // (x.shape[0] * c), c),
                   x.dtype, mod.silu, mod.num_groups, mod.eps,
                   mod.weight.dtype)
        else:
            key = ("layer_norm", where, (x.numel() // c, c), x.dtype,
                   False, 0, mod.eps, mod.weight.dtype)
        self.calls[key] = self.calls.get(key, 0) + 1

    def totals(self, where=None):
        """Calls by kind, of the modules watched as ``where`` or of all."""
        out = {"group_norm": 0, "layer_norm": 0}
        for key, n in self.calls.items():
            if where is None or key[1] == where:
                out[key[0]] += n
        return out

    def close(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []


def norm_inputs(shape, dtype, gen, dev, wdtype=torch.float32):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.2).to(dtype)
    w = (torch.randn((c,), generator=gen, device=dev) * 0.3 + 1.0).to(wdtype)
    b = (torch.randn((c,), generator=gen, device=dev) * 0.2).to(wdtype)
    return x, w, b


def check_norm_row(key, calls, gen, dev):
    """One census shape: the norm kernels against their plain versions on
    random inputs of that shape and dtype, and their times. Weight and
    bias come in the module's dtype (the UNet's bf16: the kernels take
    them as they are). Two GroupNorm stats calls must agree bit for bit
    and leave the arrival counters at zero."""
    kind, where, shape, dtype, silu, groups, eps, wdtype = key
    x, w, b = norm_inputs(shape, dtype, gen, dev, wdtype)
    numel, isz = x.numel(), x.element_size()
    big = numel > 50_000_000
    iters = 5 if big else 20
    row = dict(kind=kind, where=where, shape=list(shape),
               dtype=str(dtype).replace("torch.", ""),
               weight_dtype=str(w.dtype).replace("torch.", ""), silu=silu,
               groups=groups, calls=calls)
    if kind == "gn_sums":
        row.update(check_gn_sums(x, w, b, groups, eps, silu, iters))
    elif kind == "group_norm":
        a, bb = N.group_norm_stats(x, w, b, groups, eps)
        a2, bb2 = N.group_norm_stats(x, w, b, groups, eps)
        torch.cuda.synchronize()
        left = int(N._gn_buffers(dev, 0, shape[0])[1].abs().sum())
        if not (torch.equal(a, a2) and torch.equal(bb, bb2)) or left:
            raise AssertionError(f"gn_stats at {shape}: repeat equal "
                                 f"{torch.equal(a, a2)} "
                                 f"{torch.equal(bb, bb2)}, counters left "
                                 f"{left}")
        del a2, bb2
        a_ref, bb_ref = N.group_norm_affine_reference(x, w, b, groups, eps)
        e_a = check_close("gn_stats a", a, a_ref, *AFFINE_TOL)
        e_b = check_close("gn_stats b", bb, bb_ref, *AFFINE_TOL)
        y = N.group_norm_apply(x, a_ref, bb_ref, silu)
        y_ref = N.group_norm_apply_reference(x, a_ref, bb_ref, silu)
        e_y = check_close("gn_apply", y.float(), y_ref.float(),
                          *NORM_TOL[dtype])
        del y, y_ref
        whole = N.group_norm(x, w, b, groups, eps, silu)
        whole_ref = N.group_norm_reference(x, w, b, groups, eps, silu)
        e_whole = check_close("group_norm", whole.float(), whole_ref.float(),
                              *NORM_TOL[dtype])
        del whole, whole_ref
        torch.cuda.synchronize()

        def library():
            # F.group_norm on the NCHW view (channels-last strides)
            y4 = F.group_norm(x.permute(0, 2, 1)[..., None], groups,
                              w.to(dtype), b.to(dtype), eps)
            return F.silu(y4) if silu else y4

        ops_apply = NORM_OPS["apply_silu" if silu else "apply"] * numel
        st_bound = bound_ms(NORM_OPS["stats"] * numel, numel * isz,
                            PEAK_F32_FLOPS)
        ap_bound = bound_ms(ops_apply, 2 * numel * isz, PEAK_F32_FLOPS)
        row.update(
            stats=dict(max_abs_err=max(e_a[0], e_b[0]),
                       rel_rms_err=max(e_a[1], e_b[1]),
                       ms=cuda_ms(lambda: N.group_norm_stats(
                           x, w, b, groups, eps), iters),
                       plain_ms=cuda_ms(lambda: N.group_norm_affine_reference(
                           x, w, b, groups, eps), 2),
                       bound_ms=st_bound[0], bound_by=st_bound[1]),
            apply=dict(max_abs_err=e_y[0], rel_rms_err=e_y[1],
                       ms=cuda_ms(lambda: N.group_norm_apply(
                           x, a_ref, bb_ref, silu), iters),
                       plain_ms=cuda_ms(lambda: N.group_norm_apply_reference(
                           x, a_ref, bb_ref, silu), 2),
                       bound_ms=ap_bound[0], bound_by=ap_bound[1]),
            whole=dict(max_abs_err=e_whole[0], rel_rms_err=e_whole[1],
                       ms=cuda_ms(lambda: N.group_norm(
                           x, w, b, groups, eps, silu), iters),
                       plain_ms=cuda_ms(lambda: N.group_norm_reference(
                           x, w, b, groups, eps, silu), 2),
                       library_ms=cuda_ms(library, iters)))
    else:
        y = N.layer_norm(x, w, b, eps)
        y_ref = N.layer_norm_reference(x, w, b, eps)
        e_y = check_close("layer_norm", y.float(), y_ref.float(),
                          *NORM_TOL[dtype])
        del y, y_ref
        torch.cuda.synchronize()
        bms, by = bound_ms(NORM_OPS["layer_norm"] * numel, 2 * numel * isz,
                           PEAK_F32_FLOPS)
        row.update(layer_norm=dict(
            max_abs_err=e_y[0], rel_rms_err=e_y[1],
            ms=cuda_ms(lambda: N.layer_norm(x, w, b, eps), iters),
            plain_ms=cuda_ms(lambda: N.layer_norm_reference(x, w, b, eps), 2),
            library_ms=cuda_ms(lambda: F.layer_norm(
                x, (shape[-1],), w.to(dtype), b.to(dtype), eps), iters),
            bound_ms=bms, bound_by=by))
    say("kernels", **row)
    del x, w, b
    torch.cuda.empty_cache()
    return row


def check_gn_sums(x, w, b, groups, eps, silu, iters):
    """A frame shard's temporal GroupNorm at its shape: the sums launch
    against float64 sums (SUMS_RTOL; two launches equal bit for bit, the
    arrival counters left at zero) and the apply kernel against its plain
    version, with their times."""
    s = N.group_norm_sums(x)
    s2 = N.group_norm_sums(x)
    torch.cuda.synchronize()
    left = int(N._gn_buffers(x.device, 0, x.shape[0])[1].abs().sum())
    if not torch.equal(s, s2) or left:
        raise AssertionError(f"gn_sums at {tuple(x.shape)}: repeat equal "
                             f"{torch.equal(s, s2)}, counters left {left}")
    xd = x.double()
    want = torch.stack([xd.sum(dim=1), (xd * xd).sum(dim=1)])
    scale = torch.stack([xd.abs().sum(dim=1), (xd * xd).sum(dim=1)])
    d = (s.double() - want).abs()
    rel = float((d / scale.clamp_min(1e-30)).max())
    if not rel <= SUMS_RTOL:
        raise AssertionError(f"gn_sums at {tuple(x.shape)}: error {rel} of "
                             f"the terms' magnitude > {SUMS_RTOL}")
    del s2, xd, want, scale
    a_ref, bb_ref = N.group_norm_affine_from_sums(s, x.shape[1], w, b,
                                                  groups, eps)
    y = N.group_norm_apply(x, a_ref, bb_ref, silu)
    y_ref = N.group_norm_apply_reference(x, a_ref, bb_ref, silu)
    e_y = check_close("gn_apply", y.float(), y_ref.float(),
                      *NORM_TOL[x.dtype])
    del y, y_ref
    torch.cuda.synchronize()
    numel, isz = x.numel(), x.element_size()
    st_bound = bound_ms(NORM_OPS["stats"] * numel, numel * isz,
                        PEAK_F32_FLOPS)
    ap_bound = bound_ms(NORM_OPS["apply_silu" if silu else "apply"] * numel,
                        2 * numel * isz, PEAK_F32_FLOPS)
    return dict(
        sums=dict(max_abs_err=float(d.max()), max_rel_err=rel,
                  ms=cuda_ms(lambda: N.group_norm_sums(x), iters),
                  plain_ms=cuda_ms(lambda: N.group_norm_sums_reference(x),
                                   2),
                  bound_ms=st_bound[0], bound_by=st_bound[1]),
        apply=dict(max_abs_err=e_y[0], rel_rms_err=e_y[1],
                   ms=cuda_ms(lambda: N.group_norm_apply(
                       x, a_ref, bb_ref, silu), iters),
                   plain_ms=cuda_ms(lambda: N.group_norm_apply_reference(
                       x, a_ref, bb_ref, silu), 2),
                   bound_ms=ap_bound[0], bound_by=ap_bound[1]))


def check_norms(census, dev):
    """Every GroupNorm and LayerNorm shape of the census against the plain
    versions, as check_norm_row does."""
    gen = torch.Generator(device=dev).manual_seed(7)
    return [check_norm_row(key, calls, gen, dev)
            for key, calls in sorted(census.items(), key=str)]


def norm_entries(rows, per_forward, launches):
    """Kernel-line entries of gn_stats, gn_apply and layer_norm: times
    summed over one batch-3 UNet forward's calls (the census rows of the
    UNet, calls per forward = census calls / per_forward forwards)."""
    out = []
    for name, kind, part, line in (
            ("gn_stats", "group_norm", "stats", 88),
            ("gn_apply", "group_norm", "apply", 106),
            ("layer_norm", "layer_norm", "layer_norm", 179)):
        unet = [r for r in rows if r["kind"] == kind and r["where"] == "unet"]
        mine = [r for r in rows if r["kind"] == kind
                or (part == "apply" and r["kind"] == "gn_sums")]

        def tot(key, rs=unet, part=part):
            return sum(r[part][key] * r["calls"] / per_forward for r in rs)
        by = max(unet, key=lambda r: r[part]["bound_ms"] * r["calls"])
        lib = (tot("library_ms") if kind == "layer_norm" else None)
        entry = {
            "name": name, "route": "cuda",
            "source": f"syn3r_tpu_torch/csrc/{kind}.cu",
            "replaces": f"syn3r_tpu/ops/pallas_norm.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r[part]["max_abs_err"] for r in mine),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"), "bound_by": by[part]["bound_by"],
            "library_ms": lib,
            "per": "one batch-3 UNet forward "
                   f"({int(sum(r['calls'] for r in unet) / per_forward)} "
                   "calls)"}
        if name == "gn_stats":
            # the sums launch at the frame shards' shapes (parallel phase)
            sums = [r["sums"] for r in rows if r["kind"] == "gn_sums"]
            entry["sums_max_rel_err"] = max(
                (r["max_rel_err"] for r in sums), default=None)
        if kind == "group_norm":
            # F.group_norm computes the whole GroupNorm (stats and apply):
            # a yardstick for the pair of kernels, not for either alone
            for key in ("ms", "plain_ms", "library_ms"):
                entry[f"group_norm_{key}"] = tot(key, part="whole")
        out.append(entry)
    return out


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--geglu-parent", metavar="DIR",
                    help="a checkout whose GEGLU kernel to compare with")
    opts = ap.parse_args()
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
    hgmma = {name: sass_count(name, "HGMMA")
             for name in ("geglu_ffn", "flash_attention",
                          "flash_attention_bwd")}
    say("build", hgmma_in_sass={k: "not available" if v is None else v
                                for k, v in hgmma.items()})
    if any(v == 0 for v in hgmma.values()):
        raise AssertionError(f"no HGMMA in the SASS: {hgmma}")

    gen = torch.Generator(device=dev).manual_seed(0)
    smi_sampler = SmiSampler()
    try:
        ffn_rows = check_geglu(gen, dev, smi_sampler)
        ffn_small = check_geglu_small(gen, dev)
        ffn_parent = (geglu_parity(opts.geglu_parent, gen, dev)
                      if opts.geglu_parent else None)
        attn_rows = check_attention(gen, dev, smi_sampler)
        frame_rows = check_frame_attention(gen, dev, smi_sampler)
    finally:
        smi_sampler.close()
    small = check_small_unet(dev)
    unit, pipe, census = run_unit(dev)
    guided = run_guided_phase(pipe, unit, dev)
    norm_rows = check_norms(census, dev)
    scene = run_scene(pipe, unit["launches"])
    dtu, dtu_census, dtu_shapes = run_dtu(pipe, unit, census)
    dtu_norm_rows = check_norms(dtu_census, dev)
    dtu_kernel_rows = check_unet_kernels(dtu_shapes, dev)
    optin_args, optin_imgs = optin_inputs(pipe)
    known_norms = {(k[0],) + k[2:] for k in (*census, *dtu_census)}
    optins, optin_norms, optin_shapes = run_optins(
        pipe, unit, optin_args, set(dtu_shapes), known_norms)
    optin_norm_rows = check_norms(optin_norms, dev)
    optin_kernel_rows = check_unet_kernels(optin_shapes, dev, "optins")
    optins["forward_warp"] = check_forward_warp(optin_imgs)
    del optin_args, optin_imgs
    slice_run = run_slice(pipe, unit)
    vision, weights = run_vision(dev)
    dl3dv = run_dl3dv(pipe, unit, weights)
    del pipe                 # the GS phases measure their own peak memory
    torch.cuda.empty_cache()
    comp = check_composite(dev)
    proj = check_project(dev)
    gs_small = check_gs_small(dev)
    gs = run_gs(dev)
    lpips = run_lpips(dev)
    mono = run_mono(dev)
    fleet = run_fleet(dev)
    parallel, par_norms, par_shapes = run_parallel(
        dev, unit, scene["total_s"], set(dtu_shapes) | set(optin_shapes),
        known_norms | {(k[0],) + k[2:] for k in optin_norms})
    par_norm_rows = check_norms(par_norms, dev)
    par_kernel_rows = check_unet_kernels(par_shapes, dev, "parallel")
    par_launches = {}
    for rec in parallel.values():
        if isinstance(rec, dict) and "launches" in rec:
            for k, v in rec["launches"].items():
                par_launches[k] = par_launches.get(k, 0) + v
    by_phase = {"unit": unit["launches"],
                "guided": guided["unit"]["launches"],
                "gs": gs["launches"],
                "scene": scene["launches"], "dtu": dtu["launches"],
                "dl3dv": dl3dv["launches"],
                "lpips": lpips["launches"],
                "optins": optins["launches_all"],
                "slice": slice_run["launches"],
                "mono": mono["launches"],
                "parallel": par_launches}

    kernels = [
        kernel_entry("geglu_ffn", "syn3r_tpu_torch/csrc/geglu_ffn.cu",
                     "syn3r_tpu/ops/pallas_ffn.py:63", ffn_rows,
                     scene["launches"]["geglu_ffn"]),
        kernel_entry("flash_attention",
                     "syn3r_tpu_torch/csrc/flash_attention.cu",
                     "syn3r_tpu/models/layers.py:185", attn_rows,
                     scene["launches"]["flash_attention"]),
        kernel_entry("frame_attention",
                     "syn3r_tpu_torch/csrc/frame_attention.cu",
                     "none (XLA: syn3r_tpu/models/layers.py:137)",
                     frame_rows, unit["frame_attention_launches"]),
    ]
    for name, line in (("composite_fwd", 67), ("composite_bwd", 140)):
        r = comp[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"syn3r_tpu_torch/csrc/{name}.cu",
            "replaces": f"syn3r_tpu/ops/pallas_rasterize.py:{line}",
            "launches": scene["launches"][name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "per": "one call at T 96, px 2048, cap 1024, K 128"})
    for k in kernels[-2:]:
        k["skip_removed_fraction"] = comp[k["name"]]["skip"][
            "removed_fraction"]
    for name in ("project_fwd", "project_bwd"):
        r = proj[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "syn3r_tpu_torch/csrc/project.cu",
            "replaces": "none (XLA: syn3r_tpu/ops/rasterize.py:55)",
            "launches": scene["launches"][name],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "autograd_route_ms": proj["autograd_route_ms"],
            "per": "one call at 131,072 slots, 504x378, SH degree 3"})
    # GEGLU and flash: the largest error at the dtu and optins phases'
    # shapes too
    for k in kernels[:2]:
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["max_abs_err"]
            for r in dtu_kernel_rows + optin_kernel_rows + par_kernel_rows
            if r["name"] == k["name"]])
    kernels += bwd_entries(guided, guided["unit"]["launches"])
    kernels += norm_entries(norm_rows + dtu_norm_rows + optin_norm_rows
                            + par_norm_rows, unit["forwards"],
                            scene["launches"])
    for k in kernels:
        k["launches_by_phase"] = {p: c.get(k["name"], 0)
                                  for p, c in by_phase.items()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "hgmma_in_sass": hgmma,
                   "geglu_ffn": ffn_rows, "geglu_ffn_small": ffn_small,
                   "geglu_ffn_against_parent": ffn_parent,
                   "flash_attention": attn_rows,
                   "frame_attention": frame_rows,
                   "small_unet": small, "unit": unit, "guided": guided,
                   "norms": norm_rows,
                   "composite": comp, "project": proj,
                   "gs_small": gs_small, "gs": gs,
                   "scene": scene, "dtu": dtu, "dtu_norms": dtu_norm_rows,
                   "dtu_kernels": dtu_kernel_rows,
                   "vision": vision, "dl3dv": dl3dv,
                   "optins": optins, "optin_norms": optin_norm_rows,
                   "optin_kernels": optin_kernel_rows, "slice": slice_run,
                   "lpips": lpips, "mono": mono, "fleet": fleet,
                   "parallel": parallel, "parallel_norms": par_norm_rows,
                   "parallel_kernels": par_kernel_rows,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
