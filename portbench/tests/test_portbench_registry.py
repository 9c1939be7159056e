"""The harness finds each cell's configuration, traffic, limits and metric
readers by name, and picks up a cell and a metric added as new files only."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.tests.cells import REAL, REPO, TINY, make_root, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = spec.benchmark(REPO)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in b[part]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    assert {m["name"] for m in b["end_to_end"]} == {"image_iters_per_s", "peak_mem_gib", "setup_s"}
    assert all(m["moves"] == "image_iters_per_s" for m in b["per_layer"])
    assert all(w["chips"] == 1 for w in b["workloads"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", [REAL, *TINY])
def test_each_cell_finds_its_files_by_name(root, cell):
    c = spec.cell(cell, root)
    assert c.config["name"] == "csmri_bm3d"
    assert c.traffic["algo"] in ("gd", "svrg")
    assert set(c.limits["limits"]) == {"update_gap", "denoise_gap", "denoise_gap_q90"}
    assert c.problem.__name__.endswith(c.config["problem"]) and c.loop.__name__.endswith(c.traffic["algo"])
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"], root).read)
    assert {m["name"] for m in c.end_to_end} == {"image_iters_per_s", "peak_mem_gib", "setup_s"}


def test_a_cell_and_a_metric_added_as_new_files_are_picked_up(tmp_path):
    root = make_root(tmp_path)
    (root / "portbench" / "metrics" / "dummy.lanes.py").write_text("def read(t):\n    return float(t.lanes)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "dummy.lanes", "unit": "lanes", "better": "higher", "source": "program_counter",
                           "layer": "loop", "moves": "image_iters_per_s", "workloads": ["tiny_csmri.gd"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell("tiny_csmri.gd", root)
    assert "dummy.lanes" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("dummy.lanes", root).read(type("T", (), {"lanes": 2})()) == 2.0
    result = run(root, "tiny_csmri.gd")
    assert result["correct"] and result["attempted"] == 2 * 3 and result["failed"] == 0
    assert set(result["metrics"]) == {"image_iters_per_s", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        spec.cell("no_such.cell", REPO)
