"""Noise standard-deviation estimation (wavelet-detail MAD).

Port of ``pnp_svrg_tpu/ops/sigma.py`` (skimage ``estimate_sigma``): the
level-1 db2 diagonal band, exact zeros dropped, ``median(|HH|) / 0.6745``,
one estimate per image of a (..., H, W) stack.

The median of an even count is the mean of the two middle values, as the
reference takes ``0.5 * (s[(n-1)//2] + s[n//2])`` over a sort.
``torch.median`` returns the lower of the two, so it is not used.
"""

from __future__ import annotations

import torch

from pnp_svrg_tpu_torch.ops.wavelet import dwt2

# scipy.stats.norm.ppf(0.75)
_MAD_DENOM = 0.6744897501960817


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of ``values`` where ``mask`` holds; 0 where
    nothing does."""
    big = torch.finfo(values.dtype).max
    s = torch.sort(torch.where(mask, values, big), dim=-1).values
    n = mask.sum(dim=-1, keepdim=True)
    last = values.shape[-1] - 1
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)
    med = 0.5 * (s.gather(-1, lo) + s.gather(-1, hi))
    return torch.where(n > 0, med, torch.zeros_like(med))[..., 0]


def estimate_sigma(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (...) AWGN sigma estimates from db2 HH coefficients."""
    _, (_, _, hh) = dwt2(image, "db2")
    absd = hh.abs().reshape(hh.shape[:-2] + (-1,))
    return _masked_median(absd, absd > 0) / _MAD_DENOM
