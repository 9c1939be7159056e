"""Config-guarded checkpoints of denoiser training.

Port of ``pnp_svrg_tpu/training/checkpoint.py`` with its on-disk layout: an
experiment directory holds ``config.json`` (the guard), one ``{name}.npz``
per array tree of the state with ``/``-joined keys (the Flax layout:
``variables.npz``, ``u_state.npz``) and ``meta.json`` with the scalars. A
directory either package writes loads in the other. Re-opening an experiment
with another configuration raises :class:`ConfigMismatch`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from pnp_svrg_tpu_torch.models.convert import load_flax_npz, save_flax_npz


class ConfigMismatch(RuntimeError):
    pass


def _check_config(exp_dir: Path, config: dict, what: str) -> None:
    stored = json.loads((exp_dir / "config.json").read_text())
    if stored != config:
        raise ConfigMismatch(f"{what} {exp_dir}: stored config differs\n stored={stored}\n new={config}")


def save_checkpoint(exp_dir: str | Path, state: dict, config: dict) -> None:
    """Write ``state`` (nested dicts of arrays, and scalars) with the config
    guard: the first save writes ``config.json``, a later one with another
    config raises."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = exp_dir / "config.json"
    if cfg_path.exists():
        _check_config(exp_dir, config, "refusing to save into")
    else:
        cfg_path.write_text(json.dumps(config, indent=2, sort_keys=True))
    meta = {}
    for name, tree in state.items():
        if isinstance(tree, (int, float, str)):
            meta[name] = tree
        else:
            save_flax_npz({name: _to_numpy(tree)}, exp_dir / f"{name}.npz")
    (exp_dir / "meta.json").write_text(json.dumps(meta))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def load_checkpoint(exp_dir: str | Path, config: dict | None = None) -> dict | None:
    """The stored state (numpy arrays in the Flax layout, and the scalars),
    after checking ``config`` against the guard; None when the directory
    holds no experiment yet."""
    exp_dir = Path(exp_dir)
    if not (exp_dir / "config.json").exists():
        return None
    if config is not None:
        _check_config(exp_dir, config, "refusing to resume")
    state: dict = {}
    for npz in exp_dir.glob("*.npz"):
        tree = load_flax_npz(npz)
        state[npz.stem] = tree[npz.stem] if npz.stem in tree else tree
    meta_path = exp_dir / "meta.json"
    if meta_path.exists():
        state.update(json.loads(meta_path.read_text()))
    return state
