"""CNN denoisers: the DnCNN-family residual denoiser and the MMO direct one.

Port of ``pnp_svrg_tpu/denoisers/dncnn.py``. The weights are the Flax
variables in the repository's ``checkpoints/*.npz``, carried onto the
``torch.nn`` models by ``models/convert.py``. The convolutions run through
cuDNN on the card (``device.py`` turns its TF32 off and makes it
deterministic); the JAX package leaves them to XLA outside any Pallas
kernel, so no hand-written kernel stands behind them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
from torch import nn

from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.models.convert import load_flax_npz, torch_state_dict_from_flax
from pnp_svrg_tpu_torch.models.dncnn import MMOSimpleCNN, model_for_type

CHECKPOINT_DIR = Path(__file__).resolve().parents[2] / "checkpoints"


def load_denoiser_params(name: str) -> dict:
    """Flax variables of the checkpoint ``checkpoints/<name>.npz``."""
    path = CHECKPOINT_DIR / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    return load_flax_npz(path)


def flax_model(model: nn.Module, variables: dict, device=None) -> nn.Module:
    """``model`` with the Flax ``variables`` loaded, in eval mode, on
    ``device`` (CUDA unless ``"cpu"`` is passed)."""
    model.load_state_dict(torch_state_dict_from_flax(variables, model))
    return model.to(resolve_device(device)).eval().requires_grad_(False)


@dataclasses.dataclass(frozen=True)
class DnCNNDenoiser:
    """Residual CNN denoiser with the reference's scale trick: per image
    min-max normalise, scale into ``[shift, shift + range]`` with
    ``range = 1 + sigma_train/255/2``, predict the noise residual, subtract,
    undo the scale. ``sigma_train`` is the noise level the checkpoint was
    trained for; the PnP sigma estimate and step count are ignored."""

    model: nn.Module
    sigma_train: float = 15.0
    model_type: str = "DnCNN"
    channels: int = 1

    @classmethod
    def from_pretrained(cls, model_type: str = "DnCNN", sigma: int = 15, device=None):
        variables = load_denoiser_params(f"{model_type.lower()}_noise{sigma}")
        model = flax_model(model_for_type(model_type), variables, device)
        return cls(model=model, sigma_train=float(sigma), model_type=model_type)

    @torch.no_grad()
    def denoise(self, x: torch.Tensor, sigma_est=0.0, t=0) -> torch.Tensor:
        del sigma_est, t
        xb = x[None] if x.dim() == 2 else x  # (B, H, W)
        lo = xb.amin(dim=(-2, -1), keepdim=True)
        hi = xb.amax(dim=(-2, -1), keepdim=True)
        xt = (xb - lo) / (hi - lo)
        # f32 arithmetic, as the JAX package forms it from an f32 sigma_train.
        scale_range = np.float32(1.0) + np.float32(self.sigma_train) / np.float32(255.0) / np.float32(2.0)
        scale_shift = (np.float32(1.0) - scale_range) / np.float32(2.0)
        xt = xt * float(scale_range) + float(scale_shift)
        out = xt - self.model(xt[:, None])[:, 0]
        out = (out - float(scale_shift)) / float(scale_range)
        out = out * (hi - lo) + lo
        return out[0] if x.dim() == 2 else out


@dataclasses.dataclass(frozen=True)
class MMODenoiser:
    """MMO direct denoiser: clip the input to [0, 1], apply the DnCNN_nobn
    network, clip the output. Takes (H, W), a (B, H, W) grayscale batch, or
    one (H, W, C) image."""

    model: nn.Module
    channels: int = 1

    @classmethod
    def from_pretrained(cls, channels: int = 1, n_lev: float = 0.01, device=None):
        variables = load_denoiser_params(f"mmo_dncnn_nobn_nch{channels}_nlev{n_lev}")
        return cls(model=flax_model(MMOSimpleCNN(channels=channels), variables, device),
                   channels=channels)

    @torch.no_grad()
    def denoise(self, x: torch.Tensor, sigma_est=0.0, t=0) -> torch.Tensor:
        del sigma_est, t
        if x.dim() == 2:
            inp, restore = x[None, None], lambda o: o[0, 0]
        elif x.dim() == 3 and self.channels == 1:
            inp, restore = x[:, None], lambda o: o[:, 0]
        else:  # (H, W, C)
            inp, restore = x.permute(2, 0, 1)[None], lambda o: o[0].permute(1, 2, 0)
        out = self.model(inp.clamp(0.0, 1.0))
        return restore(out.clamp(0.0, 1.0))
