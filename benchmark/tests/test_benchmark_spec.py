"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

from harness import common
from harness.cli import load_cell

ROOT = common.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


def line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


def test_configs():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
        data = json.loads(path.read_text())
        assert set(c["reduced"]) == set(data["reduced"])
        assert data["name"] == c["name"]
        assert c["source"].startswith("https://")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_workloads_name_configs_traffic_and_kinds():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((common.BENCH_DIR / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (common.BENCH_DIR / "harness"
                / f"kind_{traffic['kind']}.py").is_file()
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_are_reported_where_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2, cell
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved)) <= moved
        prefix = m["name"].split(".")[0]
        layers.setdefault(m["layer"], set()).add(prefix)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"]), cell


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    read = common.load_reader(metric)
    assert callable(read)
    assert read({"kind": "none of this cell's"}) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_load_cell(cell):
    entry, config, traffic, per_layer = load_cell(cell)
    assert entry["name"] == cell
    assert per_layer
    assert traffic["kind"] in ("denoise", "gs")
    if traffic["kind"] == "gs":         # test_benchmark_gs.test_entries
        assert config["check"]["densify_rows_off"] == 0
        return
    assert config["check"]["unet_rows_off"] == 0
    assert config["check"]["steps"]
    for step, limits in config["check"]["steps"].items():
        assert 0 <= int(step) < config["pipeline"]["num_inference_steps"]
        assert set(limits) == {"unet_rel", "step_rel"}


def test_files_under_paths_are_named_from_name_characters():
    for path in Path(common.BENCH_DIR).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
