"""The benchmark's registry: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by name:

* a configuration: the JSON file its ``BENCHMARK.json`` entry names
  (``portbench/configs/<config>.json``), whose ``problem`` and ``denoiser``
  name the modules ``portbench/problems/<problem>.py`` and
  ``portbench/denoisers/<denoiser>.py`` (program side) and
  ``portbench/reference/<problem>.py`` and ``<denoiser>.py`` (reference);
* a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``algo`` names
  ``portbench/loops/<algo>.py`` and ``portbench/reference/<algo>.py``;
* a cell's correctness limits: ``portbench/limits/<cell>.json``;
* a per-layer metric: a reader ``portbench/metrics/<metric>.py`` with
  ``read(trace) -> float | None``.

``root`` is the checkout's root (this file's grandparent unless a caller
gives another, as the tests do)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def problem(self):
        return importlib.import_module(f"portbench.problems.{self.config['problem']}")

    @property
    def denoiser(self):
        return importlib.import_module(f"portbench.denoisers.{self.config['denoiser']}")

    @property
    def loop(self):
        return importlib.import_module(f"portbench.loops.{self.traffic['algo']}")

    def reference(self, part: str):
        """The reference module of this cell's problem, denoiser or algo."""
        name = {"problem": self.config["problem"], "denoiser": self.config["denoiser"],
                "algo": self.traffic["algo"]}[part]
        return importlib.import_module(f"portbench.reference.{name}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def metric_reader(name: str, root: Path = ROOT):
    """The module ``portbench/metrics/<name>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
