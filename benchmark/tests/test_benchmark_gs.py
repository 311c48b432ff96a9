"""The GS cell at a tiny size on the CPU (``tiny_gs.py``): its entries in
BENCHMARK.json, whole runs and their result lines, the reference against
the port's plain tile path through a densify and a growth (also with the
LPIPS term), the reference's LPIPS against the port's, each planted fault
and the TF32 control failing the check, keys the run does not implement,
and no JAX in the process."""

import json
import math

import pytest
import torch

import gs_faults
from control_gs import readings
from harness import cli, common, kind_gs
from harness.cli import load_cell, run_cell
from reference import gs as ref
from reference import lpips as ref_lpips
from tiny_gs import CELL, tiny_gs_run

ROOT = common.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NUMBERS = {"loss_rel", "grad_rel", "change_rel", "densify_rows_off",
           "densify_rel", "adam_written_off", "growth_rows_off"}
EXACT = {"densify_rows_off", "adam_written_off", "growth_rows_off"}
GS_METRICS = {"gs.composite_ms", "gs.other_kernel_ms", "gs.idle_share",
              "gs.graph_captures", "gs.composite_fwd_roofline",
              "gs.composite_bwd_roofline", "gs.mfu"}
# on the CPU no operation runs on a device: these readers find nothing
CARD_ONLY = GS_METRICS - {"gs.graph_captures"}
# the float32 reference against the port's plain tile path: both compute
# in float32 in another order (the power as a product against the port's
# einsum, one cumsum against chunks of 128), so they part by rounding
PLAIN_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-3, "change_rel": 1e-3,
             "densify_rel": 1e-5}


def values(result):
    return {k: v["value"] for k, v in result["check"].items()}


def test_entries():
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert cell == {"name": CELL, "config": "gs_llff_refine",
                    "traffic": "gs_refine", "chips": 1, "why": cell["why"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["gs_step_ms"]["workloads"] == [CELL]
    assert e2e["gs_step_ms"]["unit"] == "ms/step"
    gs = {m["name"]: m for m in BENCH["per_layer"] if CELL in m.get(
        "workloads", [])}
    assert set(gs) == GS_METRICS
    assert all(m["moves"] == "gs_step_ms" for m in gs.values())
    assert all(m["unit"] == "%" for n, m in gs.items() if "roofline" in n)
    entry, config, traffic, per_layer = load_cell(CELL)
    assert traffic["kind"] == "gs"
    assert {m["name"] for m in per_layer} == GS_METRICS
    assert set(config["check"]) == NUMBERS
    assert all(config["check"][k] == 0 for k in EXACT)
    assert config["reduced"].keys() == {"iterations"}
    ref.refuse_unknown(config["train"])
    kind_gs.train_config(config)


def test_denoise_cells_report_nothing_of_the_gs_cell():
    for cell in ("llff_post_denoise", "dtu_prob_denoise"):
        names = {m["name"] for m in load_cell(cell)[3]}
        assert not names & GS_METRICS


def test_episode_boundaries_and_follows_drawn_from_the_seed():
    train = load_cell(CELL)[1]["train"]
    assert kind_gs.densify_boundaries(train) == list(range(2099, 3000, 100))
    seeds = (1, 2 ** 31 + 5, 77, 12345, 9, 10, 3, 4)
    drawn = {kind_gs.followed_boundary(train, s) for s in seeds}
    assert len(drawn) > 2 and drawn <= set(range(2099, 3000, 100))
    assert {kind_gs.follow_from(train, s) for s in seeds} <= set(
        range(2500, 3000, 100))


@pytest.fixture(scope="module")
def sound():
    """A sound tiny run whose seed grows the capacity in its warm episode,
    and a traced one."""
    return (run_cell(tiny_gs_run(seed=5)),
            run_cell(tiny_gs_run(seed=2 ** 31 + 11, trace=True)))


def test_result_line(sound):
    result, _ = sound
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 20
    assert set(result["metrics"]) == {"gs_step_ms", "setup_s"}
    assert set(result["check"]) == NUMBERS
    assert all(values(result)[k] == 0 for k in EXACT)
    json.dumps(result)


def test_traced_result_line(sound):
    _, result = sound
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert result["correct"] is True
    assert set(result["metrics"]) == GS_METRICS - CARD_ONLY
    assert result["metrics"]["gs.graph_captures"]["value"] == 0
    assert result["device"]["window_s"] > 0
    assert not cli.forbidden_modules()


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("rasterizer, lpips_weight", [
    ("tiled", None), ("kernel", None), ("kernel", 1.0)])
def test_reference_agrees_with_the_ports_plain_path(rasterizer, lpips_weight):
    """Seed 5 grows in its warm episode; its followed densify writes
    slots. With an ``lpips_weight`` the port has the seeded LPIPS weights
    installed and on, and the reference the same weights; without, the
    port has none."""
    train = {} if lpips_weight is None else {"lpips_weight": lpips_weight}
    run = tiny_gs_run(seed=5, rasterizer=rasterizer, **train)
    prog = kind_gs.build(run)
    assert (prog.trainer._lpips is not None) == bool(train)
    assert prog.trainer.use_lpips_loss == bool(train)
    kind_gs.episode(prog)
    kept = kind_gs.Kept.of(prog)
    assert (kept.lpips is not None) == bool(train)
    assert kept.growth[0] == "warm"
    assert int(kept.densify[2].gaussians.active.sum()) > int(
        kept.densify[0].gaussians.active.sum())
    assert kept.steps.picks[0][1] == 1.0          # a pseudo view, depth on
    kind_gs.free(prog)
    got = values({"check": kind_gs.check(run, kept)})
    assert all(got[k] == 0 for k in EXACT), got
    assert all(got[k] < tol for k, tol in PLAIN_TOL.items()), got


@pytest.mark.parametrize("fault", sorted(gs_faults.FAULTS))
def test_fault_comes_out_not_correct(fault):
    """The cell's four faults, the three any training cell can have and
    the LPIPS term's two, these with an ``lpips_weight`` of 1
    (``gs_faults.py``); one chip, so no exchange between chips can be left
    out."""
    train = ({"lpips_weight": 1.0} if fault in gs_faults.LPIPS_FAULTS
             else {})
    with gs_faults.planted(fault):
        result = run_cell(tiny_gs_run(seed=5, **train))
    assert result["correct"] is False and result["failed"] == 1


def test_faults_applicable():
    assert gs_faults.applicable({}) == [
        n for n in gs_faults.FAULTS if n not in gs_faults.LPIPS_FAULTS]
    assert gs_faults.applicable({"lpips_weight": 0.0}) \
        == gs_faults.applicable({})
    assert gs_faults.applicable({"lpips_weight": 1.0}) == list(
        gs_faults.FAULTS)


@pytest.mark.parametrize("lpips_weight", [None, 1.0])
def test_control_fails_a_limit(lpips_weight):
    train = {} if lpips_weight is None else {"lpips_weight": lpips_weight}
    row = readings(tiny_gs_run(seed=7, **train), control=True)
    limits = load_cell(CELL)[1]["check"]
    assert all(row["program"][k] <= limits[k] for k in NUMBERS), row
    assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.parametrize("section, key, value", [
    ("train", "use_proximity_densify", True),
    ("train", "rasterizer", "dense"),
    ("train", "lpips_weight", -1.0),
    ("train", "no_such_key", 1),
])
def test_a_key_the_run_does_not_implement_stops_it(section, key, value):
    run = tiny_gs_run(seed=6)
    run.config[section][key] = value
    with pytest.raises(ValueError, match=key):
        run_cell(run)


@pytest.mark.parametrize("value, ok", [
    (0, True), (0.0, True), (1.0, True), (2, True), (-1.0, False),
    (-1e-9, False), (math.nan, False), (math.inf, False), (True, False),
    ("1", False)])
def test_lpips_weight_values(value, ok):
    if ok:
        ref.refuse_unknown({"lpips_weight": value})
    else:
        with pytest.raises(ValueError, match="lpips_weight"):
            ref.refuse_unknown({"lpips_weight": value})


def test_lpips_weights_drawn_from_the_seed():
    cpu = torch.device("cpu")
    a = kind_gs.lpips_weights(11, cpu)
    b = kind_gs.lpips_weights(11, cpu)
    c = kind_gs.lpips_weights(12, cpu)
    assert {k: tuple(v.shape) for k, v in a.items()} == ref_lpips.shapes()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.slice1.0.weight"],
                           c["net.slice1.0.weight"])
    assert all(bool((v >= 0).all()) for k, v in a.items()
               if k.startswith("lin"))
    w = a["net.slice5.28.weight"]            # conv5_3, fan in 512 x 9
    assert abs(float(w.std()) - (2.0 / (512 * 9)) ** 0.5) < 1e-3


def test_reference_lpips_agrees_with_the_ports():
    """``reference/lpips.py`` against the port's ``LPIPS`` on the seeded
    weights installed as ``kind_gs`` installs them, at a 60x90 frame (odd
    sizes after the pools): value and input gradient; and each tap's
    share."""
    from syn3r_tpu_torch.models.lpips import (convert_lpips_torch,
                                              lpips_module)
    cpu = torch.device("cpu")
    weights = kind_gs.lpips_weights(3, cpu)
    port = lpips_module(convert_lpips_torch(weights), cpu)
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(60, 90, 3, generator=gen)
    b = (a + 0.2 * torch.rand(60, 90, 3, generator=gen)).clamp(0, 1)
    a1, a2 = (a.clone().requires_grad_(True) for _ in range(2))
    mine = port(a1, b)
    theirs = ref_lpips.distance(weights, a2, b, ref.Precision())
    assert abs(float(mine.detach()) - float(theirs.detach())) \
        <= 1e-5 * abs(float(theirs.detach()))
    (g1,) = torch.autograd.grad(mine, a1)
    (g2,) = torch.autograd.grad(theirs, a2)
    assert float((g1 - g2).norm()) <= 1e-5 * float(g2.norm())
    taps = ref_lpips.tap_distances(weights, a, b, ref.Precision())
    assert len(taps) == 5 and all(float(t) > 0 for t in taps)
    assert math.isclose(float(sum(taps)), float(theirs.detach()),
                        rel_tol=1e-6)


def test_precision_rounds_to_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -9, -3.0 - 2 ** -10])
    got = ref.Precision("tf32")(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -3.0 - 2 ** -9]
    assert torch.equal(ref.Precision()(x), x)
    assert math.isclose(float(ref.Precision("tf32")(torch.tensor(0.1))), 0.1,
                        rel_tol=2 ** -11)
