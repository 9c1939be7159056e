"""Flax checkpoints (``checkpoints/*.npz``) to and from the port's ``torch.nn`` models.

:func:`load_flax_npz`, :func:`save_flax_npz`, :func:`_flatten` and
:func:`_unflatten` are copies of the numpy-only helpers of
``pnp_svrg_tpu/models/convert.py`` (importing that module would pull in the
JAX package). :func:`torch_state_dict_from_flax` carries Flax variables onto
a model of ``models/dncnn.py``, and :func:`flax_variables_from_torch` is its
inverse, so the port's weights load in the JAX package's loaders:

* Flax numbers ``Conv_i`` and ``BatchNorm_i`` by order of appearance; the
  model's ``net`` holds its layers in that order, so the i-th ``Conv2d`` takes
  ``Conv_i`` and the j-th ``BatchNorm2d`` takes ``BatchNorm_j``;
* conv kernels go from Flax's (kh, kw, I, O) to torch's (O, I, kh, kw), the
  inverse of the JAX package's ``_conv_to_flax``;
* ``params/BatchNorm_j/{scale,bias}`` and ``batch_stats/BatchNorm_j/{mean,var}``
  become ``weight``, ``bias``, ``running_mean`` and ``running_var``.

A Flax variable that no layer takes, or a layer that finds none, raises.

The spectral-norm vectors of training (``u_state/Conv_i``) are NHWC
``(1, hw, hw, C_out)`` in Flax and NCHW ``(1, C_out, hw, hw)`` in the port:
:func:`u_state_from_flax` and :func:`u_state_to_flax` carry them across.
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


def save_flax_npz(variables: dict, path: Path) -> None:
    """Write nested numpy arrays as an ``.npz`` of ``/``-joined keys, as the
    JAX package writes them."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **_flatten(variables))


def flax_layers(model: nn.Module) -> list[tuple[str, str, nn.Module]]:
    """``(flax name, torch prefix, layer)`` for each conv and BatchNorm of
    ``model.net`` in order: ``("Conv_0", "net.0", conv)``, ...,
    ``("BatchNorm_0", "net.3", bn)``, ..."""
    out = []
    counts = {"Conv": 0, "BatchNorm": 0}
    for pos, layer in enumerate(model.net):
        kind = "Conv" if isinstance(layer, nn.Conv2d) else "BatchNorm" if isinstance(layer, nn.BatchNorm2d) else None
        if kind is not None:
            out.append((f"{kind}_{counts[kind]}", f"net.{pos}", layer))
            counts[kind] += 1
    return out


def _kernel_to_flax(weight: torch.Tensor) -> np.ndarray:
    """torch (O, I, kh, kw) to Flax (kh, kw, I, O)."""
    return np.ascontiguousarray(weight.detach().cpu().numpy().transpose(2, 3, 1, 0))


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
    for base, name, layer in flax_layers(model):
        if isinstance(layer, nn.Conv2d):
            sd[f"{name}.weight"] = take(f"params/{base}/kernel").permute(3, 2, 0, 1).contiguous()
            if layer.bias is not None:
                sd[f"{name}.bias"] = take(f"params/{base}/bias")
        else:
            sd[f"{name}.weight"] = take(f"params/{base}/scale")
            sd[f"{name}.bias"] = take(f"params/{base}/bias")
            sd[f"{name}.running_mean"] = take(f"batch_stats/{base}/mean")
            sd[f"{name}.running_var"] = take(f"batch_stats/{base}/var")
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"Flax variables left over after mapping onto {type(model).__name__}: {left}")
    return sd


def flax_variables_from_torch(model: nn.Module) -> dict:
    """Flax variables ``{"params": ..., "batch_stats": ...}`` (numpy f32) of
    ``model``: the inverse of :func:`torch_state_dict_from_flax`. The
    ``batch_stats`` collection is there only when the model has
    BatchNorm layers, as in Flax."""
    params: dict = {}
    batch_stats: dict = {}
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    for base, _, layer in flax_layers(model):
        if isinstance(layer, nn.Conv2d):
            params[base] = {"kernel": _kernel_to_flax(layer.weight)}
            if layer.bias is not None:
                params[base]["bias"] = as_np(layer.bias)
        else:
            params[base] = {"scale": as_np(layer.weight), "bias": as_np(layer.bias)}
            batch_stats[base] = {"mean": as_np(layer.running_mean), "var": as_np(layer.running_var)}
    return {"params": params, "batch_stats": batch_stats} if batch_stats else {"params": params}


def u_state_from_flax(u_state: dict, device=None) -> dict[str, torch.Tensor]:
    """Flax ``u_state`` (``Conv_i`` -> NHWC (1, hw, hw, C)) as NCHW tensors."""
    return {name: torch.tensor(np.asarray(u, dtype=np.float32)).permute(0, 3, 1, 2).contiguous().to(device)
            for name, u in u_state.items()}


def u_state_to_flax(u_state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's NCHW ``u_state`` in Flax's NHWC layout (numpy f32)."""
    return {name: np.ascontiguousarray(u.detach().cpu().numpy().transpose(0, 2, 3, 1))
            for name, u in u_state.items()}
