"""Unified configuration: JSON ``Params`` + the experiment config tree.

A copy of ``pnp_svrg_tpu/utils/config.py`` (pure Python; the port keeps its
own so that it never imports the JAX package). The reference has no unified
config system: ctor kwargs, function kwargs, module-level grids, argparse,
and a small JSON ``Params`` helper coexist (SURVEY.md §5 "Config / flag
system"; reference ``denoisers/DeepDenoisers/training/utilities/params.py:3-50``).
This module provides both layers:

* :class:`Params` -- the reference's JSON hyperparameter bag (load/save/
  update, attribute access), kept API-compatible so training scripts read
  the same way.
* :class:`ExperimentConfig` -- one dataclass tree covering problem /
  algorithm / denoiser / mesh / sweep, serializable to a single JSON file
  in the JAX package's layout (either side loads the other's files), with
  the same defaults and the same ``ValueError`` on unknown keys and
  sections.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


class Params:
    """Dict-backed hyperparameter bag with JSON round-tripping.

    ``Params(path)`` loads a JSON file; ``Params(dict)`` wraps a dict.
    Attribute access reads/writes the underlying dict (reference
    ``params.py:3-50`` semantics).
    """

    def __init__(self, source: str | Path | dict | None = None):
        object.__setattr__(self, "__dict__", {})
        if isinstance(source, (str, Path)):
            self.update(source)
        elif isinstance(source, dict):
            self.__dict__.update(source)

    @classmethod
    def from_json(cls, json_path: str | Path) -> "Params":
        return cls(json_path)

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        return cls(d)

    def save(self, json_path: str | Path) -> None:
        with open(json_path, "w") as f:
            json.dump(self.__dict__, f, indent=4, sort_keys=True)

    def update(self, json_path: str | Path) -> None:
        """Merge keys from another JSON file (reference ``params.py:28-33``)."""
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    @property
    def dict(self) -> dict:
        return self.__dict__

    def __repr__(self) -> str:
        return f"Params({self.__dict__!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Params) and self.__dict__ == other.__dict__


@dataclasses.dataclass
class ProblemConfig:
    kind: str = "csmri"  # csmri | deblur | pr
    image: str = "13.png"
    h: int = 128
    w: int = 128
    snr: float = 10.0
    sample_prob: float = 0.5  # csmri
    kernel: str = "Minimal"  # deblur
    scale_percent: float = 100.0  # deblur
    num_meas: int = 8192  # pr
    seed: int = 0


@dataclasses.dataclass
class AlgorithmConfig:
    name: str = "svrg"  # gd | sgd | svrg | saga | sarah
    eta: float = 6000.0
    n_iters: int = 176  # gd/sgd/saga total; svrg/sarah use n_outer*t2
    n_outer: int = 16
    t2: int = 10
    mini_batch_size: int = 4000
    hist_size: int = 10
    lr_decay: float = 1.0
    variant: str | None = None  # None = algorithm default; "faithful" = ref v1
    converge_check: bool = False
    diverge_check: bool = False
    seed: int = 1


@dataclasses.dataclass
class DenoiserConfig:
    kind: str = "bm3d"  # tv | nlm | bm3d | dncnn | mmo
    sigma_modifier: float = 1.0
    denoise_strength: float = 0.0
    decay: float = 1.0
    search: int = 8  # bm3d
    model_type: str = "RealSN_DnCNN"  # dncnn
    noise_level: int = 5  # dncnn checkpoint sigma


@dataclasses.dataclass
class MeshConfig:
    batch: int = 1  # data-parallel axis size (images)
    meas: int = 1  # measurement-parallel axis size


@dataclasses.dataclass
class SweepConfig:
    max_evals: int = 100
    seed: int = 0
    out_csv: str = "hyperparam-tuning/sweep.csv"


@dataclasses.dataclass
class ExperimentConfig:
    """The full experiment description, one JSON file end to end."""

    problem: ProblemConfig = dataclasses.field(default_factory=ProblemConfig)
    algorithm: AlgorithmConfig = dataclasses.field(default_factory=AlgorithmConfig)
    denoiser: DenoiserConfig = dataclasses.field(default_factory=DenoiserConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=SweepConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        def build(field_cls, sub):
            names = {f.name for f in dataclasses.fields(field_cls)}
            unknown = set(sub) - names
            if unknown:
                raise ValueError(
                    f"unknown {field_cls.__name__} keys: {sorted(unknown)}"
                )
            return field_cls(**sub)

        sections = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(d) - set(sections)
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)}")
        kwargs = {
            name: build(sections[name].default_factory, sub)
            for name, sub in d.items()
        }
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str | Path) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
