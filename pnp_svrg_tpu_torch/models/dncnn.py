"""The DnCNN model family as ``torch.nn`` modules.

Port of ``pnp_svrg_tpu/models/dncnn.py``: the 17-layer batch-norm DnCNN
residual-noise predictor (``use_bn=False`` at depth 4 is SimpleCNN) and the
MMO direct denoiser with its input skip. The JAX modules take NHWC inputs;
these take NCHW, as ``torch.nn.Conv2d`` does. Flax's ``padding="SAME"`` for
a 3x3 kernel at stride 1 is ``padding=1``. The convolutions are cuDNN's on
the card, as the JAX package leaves them to XLA outside any Pallas kernel.

Each model keeps its layers in one ``nn.Sequential`` (``net``), in the order
in which Flax numbers ``Conv_i`` and ``BatchNorm_i``, which is what
``models/convert.py`` maps the Flax variables onto.
"""

from __future__ import annotations

import torch
from torch import nn


def _conv(cin: int, cout: int, bias: bool) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class DnCNN(nn.Module):
    """Conv + ReLU, (depth - 2) x [Conv (+ BatchNorm) + ReLU], Conv.

    Predicts the noise residual (``x = noisy - r``). BatchNorm uses its
    running statistics (the JAX module's ``train=False``), eps 1e-5."""

    def __init__(self, channels: int = 1, depth: int = 17, features: int = 64, use_bn: bool = True):
        super().__init__()
        self.channels, self.depth, self.features, self.use_bn = channels, depth, features, use_bn
        layers = [_conv(channels, features, False), nn.ReLU()]
        for _ in range(depth - 2):
            layers.append(_conv(features, features, False))
            if use_bn:
                layers.append(nn.BatchNorm2d(features, eps=1e-5))
            layers.append(nn.ReLU())
        layers.append(_conv(features, channels, False))
        self.net = nn.Sequential(*layers)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class MMOSimpleCNN(nn.Module):
    """The MMO denoiser network ("DnCNN_nobn"): depth-20 LeakyReLU(0.01) CNN
    with bias and an input skip; returns the denoised image itself."""

    def __init__(self, channels: int = 1, depth: int = 20, features: int = 64):
        super().__init__()
        self.channels, self.depth, self.features = channels, depth, features
        layers = [_conv(channels, features, True), nn.LeakyReLU(0.01)]
        for _ in range(depth - 2):
            layers += [_conv(features, features, True), nn.LeakyReLU(0.01)]
        layers.append(_conv(features, channels, True))
        self.net = nn.Sequential(*layers)
        self.eval()

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        return self.net(x_in) + x_in


def model_for_type(model_type: str, channels: int = 1) -> nn.Module:
    """The model of a checkpoint family, keyed as in the JAX package."""
    if model_type in ("DnCNN", "RealSN_DnCNN"):
        return DnCNN(channels=channels, depth=17, use_bn=True)
    if model_type in ("SimpleCNN", "RealSN_SimpleCNN"):
        return DnCNN(channels=channels, depth=4, use_bn=False)
    if model_type == "DnCNN_nobn":
        return MMOSimpleCNN(channels=channels, depth=20)
    raise ValueError(f"unknown model type {model_type!r}")
