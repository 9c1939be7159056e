"""Flax checkpoints (``checkpoints/*.npz``) into the port's ``torch.nn`` models.

:func:`load_flax_npz` and :func:`_unflatten` are copies of the numpy-only
helpers of ``pnp_svrg_tpu/models/convert.py`` (importing that module would
pull in the JAX package). :func:`torch_state_dict_from_flax` carries Flax
variables onto a model of ``models/dncnn.py``:

* Flax numbers ``Conv_i`` and ``BatchNorm_i`` by order of appearance; the
  model's ``net`` holds its layers in that order, so the i-th ``Conv2d`` takes
  ``Conv_i`` and the j-th ``BatchNorm2d`` takes ``BatchNorm_j``;
* conv kernels go from Flax's (kh, kw, I, O) to torch's (O, I, kh, kw), the
  inverse of the JAX package's ``_conv_to_flax``;
* ``params/BatchNorm_j/{scale,bias}`` and ``batch_stats/BatchNorm_j/{mean,var}``
  become ``weight``, ``bias``, ``running_mean`` and ``running_var``.

A Flax variable that no layer takes, or a layer that finds none, raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_flax_npz(path: Path) -> dict:
    """Flax variables from an ``.npz`` of ``/``-joined keys."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def torch_state_dict_from_flax(variables: dict, model: nn.Module) -> dict:
    """A ``state_dict`` for ``model`` (its layers in ``model.net``) from Flax
    variables ``{"params": ..., "batch_stats": ...}``; raises ``KeyError``
    for a Flax variable that is left over or one that is missing."""
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    used: set[str] = set()

    def take(key: str) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"Flax variables lack {key!r}")
        used.add(key)
        return torch.tensor(np.asarray(flat[key], dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    n_conv = n_bn = 0
    for pos, layer in enumerate(model.net):
        name = f"net.{pos}"
        if isinstance(layer, nn.Conv2d):
            base = f"params/Conv_{n_conv}"
            sd[f"{name}.weight"] = take(f"{base}/kernel").permute(3, 2, 0, 1).contiguous()
            if layer.bias is not None:
                sd[f"{name}.bias"] = take(f"{base}/bias")
            n_conv += 1
        elif isinstance(layer, nn.BatchNorm2d):
            base = f"BatchNorm_{n_bn}"
            sd[f"{name}.weight"] = take(f"params/{base}/scale")
            sd[f"{name}.bias"] = take(f"params/{base}/bias")
            sd[f"{name}.running_mean"] = take(f"batch_stats/{base}/mean")
            sd[f"{name}.running_var"] = take(f"batch_stats/{base}/var")
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            n_bn += 1
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"Flax variables left over after mapping onto {type(model).__name__}: {left}")
    return sd
