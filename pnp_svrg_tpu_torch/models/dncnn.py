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

Training: the JAX module's ``train`` argument is the module's own
``training`` flag (``model.train()``; every model starts in eval mode).
:class:`BatchNorm` then normalises with the batch statistics and updates its
running statistics by Flax's rule, and :func:`flax_init_` gives a model
Flax's initial values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Flax BatchNorm(momentum=0.9): running = 0.9 * running + 0.1 * batch.
BN_MOMENTUM = 0.9
# Flax's lecun_normal draws from a normal truncated at +-2 standard deviations,
# whose std is this fraction of the untruncated one; Flax divides it out.
_TRUNC_STD = 0.87962566103423978


def _conv(cin: int, cout: int, bias: bool) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class BatchNorm(nn.BatchNorm2d):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW inputs.

    In eval mode it normalises with the running statistics, as
    ``nn.BatchNorm2d`` does. In training mode it normalises with the batch's
    mean and biased variance and moves the running statistics by
    ``running = 0.9 * running + 0.1 * batch`` with the *biased* variance, as
    Flax does; ``nn.BatchNorm2d`` would store the unbiased one."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class DnCNN(nn.Module):
    """Conv + ReLU, (depth - 2) x [Conv (+ BatchNorm) + ReLU], Conv.

    Predicts the noise residual (``x = noisy - r``). In eval mode (the
    default, the JAX module's ``train=False``) BatchNorm uses its running
    statistics; see :class:`BatchNorm` for training mode."""

    def __init__(self, channels: int = 1, depth: int = 17, features: int = 64, use_bn: bool = True):
        super().__init__()
        self.channels, self.depth, self.features, self.use_bn = channels, depth, features, use_bn
        layers = [_conv(channels, features, False), nn.ReLU()]
        for _ in range(depth - 2):
            layers.append(_conv(features, features, False))
            if use_bn:
                layers.append(BatchNorm(features))
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


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Give ``model`` Flax's initial values in place: every conv kernel from
    ``lecun_normal`` (a normal of variance 1 / fan_in truncated at two
    standard deviations, its scale corrected for the truncation), biases 0,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1. The draws
    come from ``generator``; they cannot replay Flax's key stream."""
    for layer in model.modules():
        if isinstance(layer, nn.Conv2d):
            fan_in = layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
        elif isinstance(layer, nn.BatchNorm2d):
            layer.reset_parameters()
    return model


def model_for_type(model_type: str, channels: int = 1) -> nn.Module:
    """The model of a checkpoint family, keyed as in the JAX package."""
    if model_type in ("DnCNN", "RealSN_DnCNN"):
        return DnCNN(channels=channels, depth=17, use_bn=True)
    if model_type in ("SimpleCNN", "RealSN_SimpleCNN"):
        return DnCNN(channels=channels, depth=4, use_bn=False)
    if model_type == "DnCNN_nobn":
        return MMOSimpleCNN(channels=channels, depth=20)
    raise ValueError(f"unknown model type {model_type!r}")
