"""BENCHMARK.json against the benchmark's rules, and every file the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16


def test_every_config_has_a_cell_on_one_chip():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for cell in CELLS:
        mine = [m for m in e2e.values() if reports(m, cell)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(reports(m, cell) for m in SPEC["per_layer"])


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for same in layers.values():            # one layer, one spelling
        assert len(same) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"portbench/configs/{w['config']}.json"
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    limit = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert limit["logit_gap"] > 0
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if reports(m, cell):
            assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_roofline_and_mfu_beside_each_other():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            for cell in m["workloads"]:
                assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                           and reports(x, cell) for x in SPEC["per_layer"])


def test_check_fits_the_driver_budget():
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare
    t = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
    assert t <= 43200
