"""The benchmark as data: every cell of BENCHMARK.json finds its files by
name, names and units keep to their characters, and a cell is added with new
files and entries alone."""

import json
import re
import shutil

import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher"), metric
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert (cells.ROOT / cell.job["checkpoint"]).is_file()
        assert "sweep_gap" in cell.limits and ({"stats_gap"} <= set(cell.limits)
                                                  or {"mean_gap", "variance_gap"} <= set(cell.limits))
        if cell.job["config"]["optim"]["optimizer"] != "none":
            assert {"update_gap", "change_gap"} <= set(cell.limits)
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


def test_what_every_cell_reports(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported, (w["name"], m["name"])


def test_layers_are_named_alike(bench):
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    rooflines = {m["layer"] for m in bench["per_layer"] if m["name"].endswith("_roofline")}
    assert len(rooflines) == 1 and all(m["unit"] == "%" for m in bench["per_layer"]
                                       if m["name"].endswith("_roofline") or "mfu" in m["name"])


def test_a_cell_is_added_by_files_alone(tmp_path, bench):
    """A new configuration, job, limits and metric: new files and entries, no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    config = json.loads((root / "benchmark/configs/psiformer_n6_q15.json").read_text())
    config["name"] = "psiformer_n6_q15_copy"
    (root / "benchmark/configs/psiformer_n6_q15_copy.json").write_text(json.dumps(config))
    (root / "benchmark/jobs/prod_r4.infer_l2.json").write_text(json.dumps(
        {**json.loads((root / "benchmark/jobs/prod_r4.train_l2.json").read_text()),
         "config": {"system": {"compute_l2": True}, "optim": {"optimizer": "none", "block_size": 10}}}))
    (root / "benchmark/limits/n6q15.infer_l2.json").write_text(json.dumps({"stats_gap": 1, "sweep_gap": 1}))
    (root / "benchmark/metrics/new_metric.py").write_text("def read(run):\n    return None\n")
    new["configs"].append({**bench["configs"][0], "name": "psiformer_n6_q15_copy",
                           "file": "benchmark/configs/psiformer_n6_q15_copy.json"})
    new["workloads"].append({"name": "n6q15.infer_l2", "config": "psiformer_n6_q15_copy",
                             "traffic": "prod_r4.infer_l2", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "program_span",
                             "layer": "device", "moves": "iters_per_s", "workloads": ["n6q15.infer_l2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = cells.load_cell("n6q15.infer_l2", root=root)
    assert cell.job["config"]["optim"]["optimizer"] == "none" and cell.limits["sweep_gap"] == 1
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert cells.metric_reader("new_metric", root / "benchmark")(None) is None
    assert "new_metric" not in [m["name"] for m in cells.load_cell("n6q15.train_l2", root=root).per_layer]
    for w in bench["workloads"]:  # the cells already there read the same files as before
        assert cells.load_cell(w["name"], root=root).job == cells.load_cell(w["name"]).job
