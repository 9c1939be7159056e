"""Flax checkpoints (``checkpoints/*.npz``) to and from the port's ``torch.nn``
models, and the reference's PyTorch ``.pth`` checkpoints to Flax ``.npz``.

The port keeps its own copy of every function of
``pnp_svrg_tpu/models/convert.py`` (importing that module would pull in the
JAX package), with the same semantics: :func:`load_flax_npz`,
:func:`save_flax_npz`, :func:`_flatten` and :func:`_unflatten`, and the
``.pth`` conversion, :func:`convert_all` over :data:`CONVERSIONS` from the
reference checkout (:data:`REFERENCE_ROOT`) into :data:`DEFAULT_OUT`. It
reads the reference's three checkpoint layouts:

* plain state dicts with ``module.dncnn.N.*`` keys (DnCNN / RealSN variants,
  saved from ``nn.DataParallel``-wrapped ``nn.Sequential`` models);
* plain state dicts with ``dncnn.N.*`` keys (SimpleCNN);
* fully pickled ``nn.DataParallel`` modules (the MMO ``DnCNN_nobn_*`` files),
  unpickled against a stub ``models.basic_models.simple_CNN`` class and
  reduced to their state dicts.

Torch conv weights (O, I, kh, kw) become Flax (kh, kw, I, O) kernels, and
BatchNorm (weight, bias, running_mean, running_var) Flax (scale, bias,
mean, var) split across the params and batch_stats collections. It runs on
the CPU and needs no card.

:func:`torch_state_dict_from_flax` carries Flax variables onto
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

import sys
import types
from pathlib import Path

import numpy as np
import torch
from torch import nn

_REPO_ROOT = Path(__file__).resolve().parents[2]
# The reference implementation's checkout beside this repository (as
# ``utils/io.py``'s REFERENCE_DATA_DIR), and the converted checkpoints'
# directory.
REFERENCE_ROOT = _REPO_ROOT.parent / "reference"
DEFAULT_OUT = _REPO_ROOT / "checkpoints"


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


def _strip_prefix(sd: dict, prefix: str = "module.") -> dict:
    return {
        (k[len(prefix) :] if k.startswith(prefix) else k): v for k, v in sd.items()
    }


def _load_torch_state_dict(path: Path) -> dict:
    """The state dict of a ``.pth`` file, its ``module.`` prefixes stripped.
    A fully pickled module of the reference's ``models`` package unpickles
    against a stub class of the same name (``nn.Module`` restores its state
    through ``__dict__``; ``__init__`` is never called)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError:
        models_pkg = types.ModuleType("models")
        basic = types.ModuleType("models.basic_models")

        class simple_CNN(nn.Module):  # noqa: N801 (reference class name)
            pass

        basic.simple_CNN = simple_CNN
        models_pkg.basic_models = basic
        sys.modules.setdefault("models", models_pkg)
        sys.modules.setdefault("models.basic_models", basic)
        obj = torch.load(path, map_location="cpu", weights_only=False)

    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return _strip_prefix(dict(obj))


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def sequential_dncnn_to_flax(sd: dict) -> dict:
    """Map ``dncnn.N.*`` Sequential keys to the Flax DnCNN/MMOSimpleCNN
    naming (Conv_0, Conv_1, ..., BatchNorm_0, ...). Conv/BN order inside the
    Sequential is positional; Flax numbering is by occurrence order, which
    matches."""
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("dncnn.")})
    params: dict = {}
    batch_stats: dict = {}
    conv_i = 0
    bn_i = 0
    for idx in idxs:
        keys = {k.split(".", 2)[2] for k in sd if k.startswith(f"dncnn.{idx}.")}
        get = lambda name: np.asarray(sd[f"dncnn.{idx}.{name}"].numpy())  # noqa: E731
        if "running_mean" in keys:  # BatchNorm layer
            params[f"BatchNorm_{bn_i}"] = {"scale": get("weight"), "bias": get("bias")}
            batch_stats[f"BatchNorm_{bn_i}"] = {"mean": get("running_mean"), "var": get("running_var")}
            bn_i += 1
        elif "weight" in keys:  # Conv layer
            layer = {"kernel": _conv_to_flax(get("weight"))}
            if "bias" in keys:
                layer["bias"] = get("bias")
            params[f"Conv_{conv_i}"] = layer
            conv_i += 1
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def mmo_simple_cnn_to_flax(sd: dict) -> dict:
    """Map the MMO ``simple_CNN`` keys (in_conv / conv_list.N / out_conv) to
    Flax ``Conv_0..Conv_{depth-1}``."""
    n_mid = len({k.split(".")[1] for k in sd if k.startswith("conv_list.")})
    order = ["in_conv"] + [f"conv_list.{i}" for i in range(n_mid)] + ["out_conv"]
    params = {}
    for i, base in enumerate(order):
        params[f"Conv_{i}"] = {
            "kernel": _conv_to_flax(np.asarray(sd[f"{base}.weight"].numpy())),
            "bias": np.asarray(sd[f"{base}.bias"].numpy()),
        }
    return {"params": params}


# Checkpoints shipped with the reference that convert (its RealSN_DnCNN .pth
# files are not shipped), as paths under the reference checkout.
CONVERSIONS = {
    "dncnn_noise5": "denoisers/DeepDenoisers/Pretrained_models/DnCNN_noise5.pth",
    "dncnn_noise15": "denoisers/DeepDenoisers/Pretrained_models/DnCNN_noise15.pth",
    "dncnn_noise40": "denoisers/DeepDenoisers/Pretrained_models/DnCNN_noise40.pth",
    "simplecnn_noise5": "denoisers/DeepDenoisers/Pretrained_models/SimpleCNN_noise5.pth",
    "simplecnn_noise15": "denoisers/DeepDenoisers/Pretrained_models/SimpleCNN_noise15.pth",
    "simplecnn_noise40": "denoisers/DeepDenoisers/Pretrained_models/SimpleCNN_noise40.pth",
    "realsn_simplecnn_noise5": "denoisers/DeepDenoisers/Pretrained_models/RealSN_SimpleCNN_noise5.pth",
    "realsn_simplecnn_noise15": "denoisers/DeepDenoisers/Pretrained_models/RealSN_SimpleCNN_noise15.pth",
    "realsn_simplecnn_noise40": "denoisers/DeepDenoisers/Pretrained_models/RealSN_SimpleCNN_noise40.pth",
    "mmo_dncnn_nobn_nch1_nlev0.009": "denoisers/checkpoints/pretrained/DnCNN_nobn_nch_1_nlev_0.009.pth",
    "mmo_dncnn_nobn_nch1_nlev0.01": "denoisers/checkpoints/pretrained/DnCNN_nobn_nch_1_nlev_0.01.pth",
    "mmo_dncnn_nobn_nch3_nlev0.01": "denoisers/checkpoints/pretrained/DnCNN_nobn_nch_3_nlev_0.01.pth",
    "mmo_dncnn_nobn_nch3_nlev0.007": "denoisers/checkpoints/pretrained/DnCNN_nobn_nch_3_nlev_0.007.pth",
}


def convert_all(out_dir: Path = DEFAULT_OUT, reference_root: Path = REFERENCE_ROOT):
    """Convert every :data:`CONVERSIONS` file found under ``reference_root``
    into ``out_dir/<name>.npz`` (a missing one is skipped); returns the names
    converted."""
    converted = []
    for name, rel in CONVERSIONS.items():
        src = reference_root / rel
        if not src.exists():
            print(f"skip {name}: {src} missing")
            continue
        sd = _load_torch_state_dict(src)
        if name.startswith("mmo_"):
            variables = mmo_simple_cnn_to_flax(sd)
        else:
            variables = sequential_dncnn_to_flax(sd)
        dst = out_dir / f"{name}.npz"
        save_flax_npz(variables, dst)
        n_params = sum(int(np.prod(v.shape)) for v in _flatten(variables).values())
        print(f"converted {name}: {n_params:,} params -> {dst}")
        converted.append(name)
    return converted


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


if __name__ == "__main__":
    convert_all()
