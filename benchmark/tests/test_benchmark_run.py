"""Whole runs of the cells at a tiny size on the CPU: the result line, the
refusal without a card, configuration keys that the run does not
implement, the reference against the port's plain path, faults planted in
the program, and the float8 control. The control at the cells' own size
needs the card (``chip``)."""

import json

import pytest
import torch

from control import readings
from harness import cli, kind_denoise
from harness.cli import run_cell
from tiny import tiny_run
from syn3r_tpu_torch.diffusion.pipeline import GuidedSVDPipeline
from syn3r_tpu_torch.models.svd_unet import UNetSpatioTemporalConditionModel

CELLS = ["llff_post_denoise", "dtu_prob_denoise"]
# four steps a call, the third (sigma 2.27 to 0.002, where the UNet's
# output moves the step as at the cells' steps 6 to 9 of 10) checked, to
# the tightest of the cell's limits: a run takes seconds on the CPU
SHORT = {"num_inference_steps": 4}
CHECKED = {"unet_rel.step2", "step_rel.step2", "unet_rows_off"}
# on the CPU no kernel of the card runs: these readers find nothing
CARD_ONLY = {"denoise.geglu_roofline", "denoise.flash_roofline",
             "denoise.norm_roofline"}


def short_run(cell, **kw):
    run = tiny_run(cell, **dict(SHORT, **kw))
    steps = run.config["check"]["steps"]
    run.config["check"]["steps"] = {"2": {
        k: min(lim[k] for lim in steps.values()) for k in ("unet_rel",
                                                           "step_rel")}}
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    result = run_cell(short_run(cell, seed=2 ** 31 + 11))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 4
    assert set(result["metrics"]) == {"denoise_step_s", "setup_s"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["check"]) == CHECKED
    assert result["check"]["unet_rows_off"]["value"] == 0
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(cell):
    run = short_run(cell, seed=5, trace=True)
    result = run_cell(run)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert result["correct"] is True
    names = {m["name"] for m in run.per_layer}
    assert set(result["metrics"]) == names - CARD_ONLY
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("section, key, value", [
    ("pipeline", "guidance_through_unet", True),
    ("pipeline", "guidance_reuse_cfg_uncond", True),
    ("pipeline", "latent_num", 2),
    ("pipeline", "no_such_key", 1),
    ("unet", "transformer_layers_per_block", 2),
    ("unet", "no_such_key", 1),
])
def test_a_key_the_run_does_not_implement_stops_it(section, key, value):
    """A key reaches the port, or is one that the reference implements at
    its value, or the run stops before its window."""
    run = short_run(CELLS[0], seed=6)
    run.config[section][key] = value
    with pytest.raises(ValueError, match=key):
        run_cell(run)


@pytest.mark.parametrize("key, value", [("fused_guidance_cfg", False),
                                        ("direction_parallel", True)])
def test_keys_that_choose_how_the_step_runs_reach_the_port(key, value,
                                                           monkeypatch):
    seen = []
    init = GuidedSVDPipeline.__init__

    def spy(self, models, cfg, *args, **kw):
        seen.append(getattr(cfg, key))
        init(self, models, cfg, *args, **kw)
    monkeypatch.setattr(GuidedSVDPipeline, "__init__", spy)
    run = short_run(CELLS[0], seed=6)
    run.config["pipeline"][key] = value
    result = run_cell(run)
    assert seen and set(seen) == {value}
    assert result["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_plain_path(cell):
    """In float32 the program's plain path and the reference part only by
    rounding."""
    result = run_cell(short_run(cell, seed=3, compute_dtype="float32"))
    assert result["check"]["unet_rel.step2"]["value"] < 1e-5
    assert result["check"]["step_rel.step2"]["value"] < 1e-4


def test_the_followed_step_is_drawn_from_the_seed():
    config = {"check": {"steps": {"6": {}, "7": {}}}}
    drawn = [kind_denoise.followed_step(config, s)
             for s in (1, 2 ** 31 + 5, 77, 12345, 9, 10)]
    assert set(drawn) == {6, 7}
    assert drawn == [kind_denoise.followed_step(config, s)
                     for s in (1, 2 ** 31 + 5, 77, 12345, 9, 10)]


def state_unchanged(monkeypatch):
    advance = GuidedSVDPipeline._advance

    def frozen(self, states, lats, step_i, stack_pairs=False):
        advance(self, states, lats, step_i, stack_pairs)
        return [lat.clone() for lat in lats]
    monkeypatch.setattr(GuidedSVDPipeline, "_advance", frozen)


def half_batch(monkeypatch):
    forward = UNetSpatioTemporalConditionModel.forward

    def half(self, sample, t, ehs, tids, groups=None, **kw):
        keep = -(-sample.shape[0] // 2)
        out = forward(self, sample[:keep], t, ehs[:keep], tids[:keep],
                      None, **kw)
        rest = out.mean(dim=0, keepdim=True).expand(
            sample.shape[0] - keep, *out.shape[1:])
        return torch.cat([out, rest])
    monkeypatch.setattr(UNetSpatioTemporalConditionModel, "forward", half)


def altered_answer(monkeypatch):
    forward = UNetSpatioTemporalConditionModel.forward

    def altered(self, *args, **kw):
        out = forward(self, *args, **kw).clone()
        out[:, 1] = out[:, 2]
        return out
    monkeypatch.setattr(UNetSpatioTemporalConditionModel, "forward",
                        altered)


def output_reused_off_the_followed_step(monkeypatch):
    """Step 1's UNet outputs are step 0's: the followed step 2 starts from
    the program's own latents and reads sound."""
    stacked = GuidedSVDPipeline._unet_stacked

    def reused(self, t, parts, groups):
        ts = torch.as_tensor(self.schedule.timesteps).double()
        step = int((ts - float(t)).abs().argmin())
        if step == 1:
            return self._step0.pop(0)
        out = stacked(self, t, parts, groups)
        if step == 0:
            self._step0 = getattr(self, "_step0", []) + [out]
        return out
    monkeypatch.setattr(GuidedSVDPipeline, "_unet_stacked", reused)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_answer,
                                   output_reused_off_the_followed_step],
                         ids=lambda f: f.__name__)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    """One chip, so no exchange between chips can be left out."""
    fault(monkeypatch)
    result = run_cell(short_run(cell, seed=9))
    assert result["correct"] is False and result["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    run = short_run(cell, seed=4)
    (row,) = readings(run, (2,))
    limits = run.config["check"]["steps"]["2"]
    assert all(row["program"][k] <= limits[k] for k in limits)
    assert any(row["control"][k] > limits[k] for k in limits)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_at_full_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness import common
    from harness.cli import load_cell
    entry, config, traffic, per_layer = load_cell(cell)
    run = common.Run(config=config, traffic=traffic,
                     per_layer=per_layer, seed=123, seconds=0.0,
                     trace=False, device=torch.device("cuda", 0), t0=0.0)
    step = kind_denoise.followed_step(config, run.seed)
    (row,) = readings(run, (step,))
    limits = config["check"]["steps"][str(step)]
    assert all(row["program"][k] <= limits[k] for k in limits)
    assert any(row["control"][k] > limits[k] for k in limits)
