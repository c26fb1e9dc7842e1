"""The benchmark as data: a cell of ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a file of its own, found by name:

* ``configs[].file``: the configuration's sizes (``benchmark/configs/<config>.json``);
* ``benchmark/jobs/<traffic>.json``: the job, its checkpoint, optimizer, L^2
  mode, penalties, fixed lower states and block size;
* ``benchmark/limits/<workload>.json``: the limit of every number that decides
  ``correct``;
* ``benchmark/metrics/<metric>.py``: the reader of each per-layer metric;
* ``benchmark/work/counts/<config>/<traffic>.json``: the operations of one
  iteration, counted on the CPU.

So a later change adds a cell, a configuration, a job or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


class Cell(NamedTuple):
    name: str
    config_name: str
    config: dict
    job_name: str
    job: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    limits: dict  # {number: limit}


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf8") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def job_path(job: str, bench: Path = BENCH) -> Path:
    return bench / "jobs" / f"{job}.json"


def limits_path(workload: str, bench: Path = BENCH) -> Path:
    return bench / "limits" / f"{workload}.json"


def metric_path(metric: str, bench: Path = BENCH) -> Path:
    return bench / "metrics" / f"{metric}.py"


def work_path(config: str, job: str, bench: Path = BENCH) -> Path:
    return bench / "work" / "counts" / config / f"{job}.json"


def load_cell(name: str, benchmark: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files read; raises ``KeyError`` for an unknown cell."""
    benchmark = benchmark or load_benchmark(root)
    bench = root / "benchmark"
    workloads = {w["name"]: w for w in benchmark["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(workloads)}")
    w = workloads[name]
    config_entry = {c["name"]: c for c in benchmark["configs"]}[w["config"]]
    with open(root / config_entry["file"], encoding="utf8") as f:
        config = json.load(f)
    with open(job_path(w["traffic"], bench), encoding="utf8") as f:
        job = json.load(f)
    with open(limits_path(name, bench), encoding="utf8") as f:
        limits = json.load(f)
    return Cell(
        name, w["config"], config, w["traffic"], job, w["chips"],
        [m for m in benchmark["end_to_end"] if _reports(m, name)],
        [m for m in benchmark["per_layer"] if _reports(m, name)],
        limits,
    )


def metric_reader(metric: str, bench: Path = BENCH):
    """The ``read(run) -> float | None`` function of ``benchmark/metrics/<metric>.py``."""
    path = metric_path(metric, bench)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
