"""The DL3DV refine's cell with its LPIPS term (``dl3dv_gs_refine_lpips``)
on the CPU: its entries in BENCHMARK.json; a run cut to the CPU the way
``tiny_gs.py`` cuts ``llff_gs_refine`` (the same overrides; the cell's 9
views, confidence 0.2 and ``lpips_weight`` 1 kept), which comes out
correct, in which both LPIPS faults and the TF32 control fail a limit, and
whose reference agrees with the port's plain path; and the two LPIPS
readers (``gs.lpips_conv_ms``, ``gs.lpips_conv_roofline``) on synthetic
profiles."""

import copy
import json
import math
import time

import pytest
import torch

import gs_faults
from control_gs import readings
from counts import lpips as counts_lpips
from counts.composite import PEAK_F32_FLOPS
from harness import common, kind_gs, lpips_kernels
from harness.cli import load_cell, run_cell
from reference import gs as ref
from test_benchmark_gs import (CARD_ONLY, EXACT, GS_METRICS, NUMBERS,
                               PLAIN_TOL, values)
from tiny_gs import CELL as LLFF_CELL
from tiny_gs import TINY_SCENE, TINY_TRAFFIC, TINY_TRAIN

ROOT = common.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "dl3dv_gs_refine_lpips"
CONFIG = "gs_dl3dv_refine_lpips"
LPIPS_METRICS = {"gs.lpips_conv_ms", "gs.lpips_conv_roofline"}
# the keys in which the configuration's train differs from the LLFF cell's
CHANGED = {"iterations": 1500, "start_sample_svd_iter": 1000,
           "lpips_weight": 1.0}
STEPS = 200
# kernels of the cell's traced stretch (H100, cuDNN through torch 2.11),
# names cut where the profiler's are longer: the LPIPS term's convolutions
# (forward, input gradient, FFT engines, layout transforms) ...
CONV = (
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
    "tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_"
    "kernel__5x_cudnn",
    "sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
    "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_"
    "kernel__5x_cudnn",
    "void cudnn::cnn::dgrad2d_grouped_direct_kernel<float, int, float, "
    "float, false, true, 0, 3>(cudnn::cnn::DgradGroupedDirectParams)",
    "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
    "false, false, true>(int, int, int, float const*, int, float*)",
    "void fft2d_r2c_32x32<float, false, 0u, false>(float2*, float const*, "
    "int, int, int, int, int, int, int, int, int, cudnn::reduced_divisor)",
    "void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*, "
    "float2 const*, int, int, int, int, int, int, int, int, int, float)",
    "void gemv2N_kernel<int, int, float2, float2, float2, float2, 128, 2, 4, "
    "4, 1, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched"
    "<float2 const>, float2>>(cublasGemvParamsEx)",
    "void nchwToNhwcKernel<float, float, float, true, false, "
    "(cudnnKernelDataType_t)0>(int, int, int, int, float const*, float*)",
)
# ... and everything else the GS step runs
OTHER = (
    "void at::native::(anonymous namespace)::conv_depthwise2d_forward_"
    "kernel_generic<float, int>(torch::headeronly::detail::"
    "GenericPackedTensorAccessor)",
    "void at::native::(anonymous namespace)::conv_depthwise2d_backward_"
    "kernel<0, 1, float, int>(torch::headeronly::detail::"
    "GenericPackedTensorAccessor)",
    "(anonymous namespace)::composite_fwd_kernel(float const*, float "
    "const*, float const*, float const*, float*, float*, unsigned int*)",
    "(anonymous namespace)::composite_bwd_grad(float const*, float const*)",
    "(anonymous namespace)::composite_bwd_tot(float const*, float const*)",
    "void (anonymous namespace)::project_bwd_kernel<3>(float const*)",
    "void (anonymous namespace)::indexing_backward_kernel_small_stride"
    "<float>(long const*, long const*, float const*, float*, long)",
    "void at::native::(anonymous namespace)::max_pool_backward_nchw<float, "
    "float, int>(float const*, long const*, int, int, int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)",
    "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, "
    "float, float, float, float, false, true, true, false, 6, false, "
    "cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>>>",
    "Memcpy DtoD (Device -> Device)",
)


class Profile:
    """A read profile's kernel table: name -> (device seconds, count)."""

    def __init__(self, kernels: dict):
        self.kernels = kernels


def tiny_dl3dv_run(seed: int = 1, seconds: float = 0.0, trace: bool = False,
                   **train) -> common.Run:
    """The cell cut as ``tiny_gs.tiny_gs_run`` cuts the LLFF cell."""
    entry, config, traffic, per_layer = load_cell(CELL)
    config = copy.deepcopy(config)
    config["scene"].update(TINY_SCENE)
    config["train"].update(TINY_TRAIN, **train)
    traffic = dict(traffic, **TINY_TRAFFIC)
    return common.Run(config=config, traffic=traffic, per_layer=per_layer,
                      seed=seed, seconds=seconds, trace=trace,
                      device=torch.device("cpu"), t0=time.perf_counter())


def test_entries():
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert cell == {"name": CELL, "config": CONFIG,
                    "traffic": "gs_refine_dl3dv", "chips": 1,
                    "why": cell["why"]}
    conf = {c["name"]: c for c in BENCH["configs"]}[CONFIG]
    assert conf["file"] == f"benchmark/configs/{CONFIG}.json"
    assert conf["reduced"] == ["iterations", "start_sample_svd_iter"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["gs_step_ms"]["workloads"] == [LLFF_CELL, CELL]
    reported = {m["name"]: m for m in BENCH["per_layer"]
                if CELL in m.get("workloads", [])}
    assert set(reported) == GS_METRICS | LPIPS_METRICS
    for name in GS_METRICS:
        assert reported[name]["workloads"] == [LLFF_CELL, CELL]
    for name in LPIPS_METRICS:
        m = reported[name]
        assert m["workloads"] == [CELL] and m["moves"] == "gs_step_ms"
        assert m["source"] == "device_trace"
        assert m["layer"] == "models/lpips.py"
    assert reported["gs.lpips_conv_ms"]["unit"] == "ms/step"
    assert reported["gs.lpips_conv_roofline"]["unit"] == "%"
    assert {m["name"] for m in load_cell(CELL)[3]} \
        == GS_METRICS | LPIPS_METRICS
    assert not LPIPS_METRICS & {m["name"] for m in load_cell(LLFF_CELL)[3]}


def test_configuration():
    """The DL3DV refine's scene, the LLFF cell's train but for the LPIPS
    weight and the cut episode, and the cell's limits."""
    _, config, traffic, _ = load_cell(CELL)
    _, llff, _, _ = load_cell(LLFF_CELL)
    assert config["name"] == CONFIG
    scene = config["scene"]
    assert (scene["width"], scene["height"]) == (960, 540)
    assert (scene["train_views"], scene["frames"]) == (9, 25)
    assert scene["cam_confidence"] == 0.2
    assert scene["truth_gaussians"] == 262144
    assert 59.0 < math.degrees(2 * math.atan(
        scene["width"] / 2 / scene["focal"])) < 61.0
    train = config["train"]
    assert {k: train[k] for k in CHANGED} == CHANGED
    assert {k: v for k, v in train.items() if k not in CHANGED} \
        == {k: v for k, v in llff["train"].items() if k not in CHANGED}
    assert set(config["reduced"]) == {"iterations", "start_sample_svd_iter"}
    assert set(config["check"]) == NUMBERS
    assert all(config["check"][k] == 0 for k in EXACT)
    ref.refuse_unknown(train)
    kind_gs.train_config(config)
    assert traffic["kind"] == "gs"
    assert traffic["start_live"] < traffic["fit_capacity"]
    reader = common.load_reader("gs.lpips_conv_roofline")
    assert reader.__globals__["FRAME"] == (scene["height"],
                                           scene["width"])


def test_episode_boundaries_and_follows():
    train = load_cell(CELL)[1]["train"]
    assert kind_gs.densify_boundaries(train) == list(range(1099, 1500, 100))
    seeds = (1, 2 ** 31 + 5, 77, 12345, 9, 10, 3, 4)
    assert {kind_gs.followed_boundary(train, s) for s in seeds} <= set(
        range(1099, 1500, 100))
    assert {kind_gs.follow_from(train, s) for s in seeds} == {1300, 1400}


@pytest.mark.parametrize("name", CONV + OTHER)
def test_name_rule(name):
    """cuDNN's convolution kernels and its FFT engines' are the term's;
    SSIM's depthwise convolutions, the port's kernels, a GEMV on real
    operands and the rest of the step are not."""
    assert lpips_kernels.is_conv(name) == (name in CONV)


def test_readers_on_a_synthetic_profile():
    conv = {name: (0.001 * (i + 1), 10) for i, name in enumerate(CONV)}
    other = {name: (0.5, 10) for name in OTHER}
    prof = Profile({**conv, **other})
    spent = sum(s for s, _ in conv.values())
    ctx = {"kind": "gs", "profile": prof, "steps": STEPS}
    ms = common.load_reader("gs.lpips_conv_ms")(ctx)
    roof = common.load_reader("gs.lpips_conv_roofline")(ctx)
    assert math.isclose(ms, 1e3 * spent / STEPS)
    ops = counts_lpips.step_ops(540, 960)
    assert 0.63e12 < ops < 0.64e12           # 0.632 TFLOP a step
    assert math.isclose(roof, 100.0 * ops * STEPS / (spent * PEAK_F32_FLOPS))


@pytest.mark.parametrize("ctx", [
    {"kind": "gs", "profile": Profile({n: (0.5, 10) for n in OTHER}),
     "steps": STEPS},                            # llff_gs_refine's kernels
    {"kind": "gs", "profile": Profile({}), "steps": STEPS},
    {"kind": "denoise"}])
def test_readers_read_nothing_without_the_terms_kernels(ctx):
    for name in LPIPS_METRICS:
        assert common.load_reader(name)(ctx) is None


@pytest.fixture(scope="module")
def sound():
    return run_cell(tiny_dl3dv_run(seed=5, trace=True))


def test_tiny_run_comes_out_correct(sound):
    """On the CPU no operation runs on a device: of the per-layer metrics
    only the capture count reads."""
    assert sound["correct"] is True and sound["failed"] == 0
    assert sound["attempted"] == 20
    assert set(sound["metrics"]) == GS_METRICS - CARD_ONLY
    assert sound["metrics"]["gs.graph_captures"]["value"] == 0
    assert set(sound["check"]) == NUMBERS
    assert all(values(sound)[k] == 0 for k in EXACT)


@pytest.mark.parametrize("fault", gs_faults.LPIPS_FAULTS)
def test_lpips_fault_comes_out_not_correct(fault):
    assert fault in gs_faults.applicable(load_cell(CELL)[1]["train"])
    with gs_faults.planted(fault):
        result = run_cell(tiny_dl3dv_run(seed=5))
    assert result["correct"] is False and result["failed"] == 1


def test_control_fails_a_limit():
    row = readings(tiny_dl3dv_run(seed=7), control=True)
    limits = load_cell(CELL)[1]["check"]
    assert all(row["program"][k] <= limits[k] for k in NUMBERS), row
    assert any(v > limits[k] for k, v in row["control"].items()), row


def test_reference_agrees_with_the_ports_plain_path():
    """Seed 5 grows in its warm episode; the port has the seeded LPIPS
    weights installed and on, the reference the same weights."""
    run = tiny_dl3dv_run(seed=5)
    prog = kind_gs.build(run)
    assert prog.trainer._lpips is not None and prog.trainer.use_lpips_loss
    assert len(prog.scene.train_cams) == 9
    assert all(math.isclose(float(c["confidence"]), 0.2, rel_tol=1e-6)
               for c in prog.scene.pseudo_cams)
    kind_gs.episode(prog)
    kept = kind_gs.Kept.of(prog)
    assert kept.lpips is not None and kept.growth[0] == "warm"
    assert kept.steps.picks[0][1] == 1.0          # a pseudo view, depth on
    kind_gs.free(prog)
    got = values({"check": kind_gs.check(run, kept)})
    assert all(got[k] == 0 for k in EXACT), got
    assert all(got[k] < tol for k, tol in PLAIN_TOL.items()), got
