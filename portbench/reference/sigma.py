"""The wavelet noise estimate the loops hand the denoiser (skimage's
``estimate_sigma``): the level-1 db2 diagonal band on a half-point symmetric
extension, exact zeros dropped, ``median(|HH|) / 0.6745``, the median of an
even count the mean of the two middle values. float32."""

from __future__ import annotations

import torch

_DB2_LO = (-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025)
_MAD_DENOM = 0.6744897501960817  # scipy.stats.norm.ppf(0.75)


def _filters() -> tuple:
    lo = [float(torch.tensor(v, dtype=torch.float32)) for v in _DB2_LO]
    n = len(lo)
    hi = [float(torch.tensor((-1.0) ** (i + 1) * _DB2_LO[n - 1 - i], dtype=torch.float32)) for i in range(n)]
    return lo, hi


def _analysis_last(x: torch.Tensor) -> tuple:
    lo, hi = _filters()
    taps = len(lo)
    out_len = (x.shape[-1] + taps - 1) // 2
    e = taps - 1
    ext = torch.cat([x[..., :e].flip(-1), x, x[..., -e:].flip(-1)], dim=-1)
    ca = cd = None
    for j in range(taps):
        s = taps - j
        sl = ext[..., s: s + 2 * out_len - 1: 2]
        ca = sl * lo[j] if ca is None else ca + sl * lo[j]
        cd = sl * hi[j] if cd is None else cd + sl * hi[j]
    return ca, cd


def diagonal_band(img: torch.Tensor) -> torch.Tensor:
    """The level-1 db2 HH band of each (..., H, W) image."""
    _, hi_r = _analysis_last(img)
    _, hh = _analysis_last(hi_r.transpose(-1, -2))
    return hh.transpose(-1, -2)


def estimate_sigma(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float32 -> (...) sigma estimates."""
    absd = diagonal_band(img.to(torch.float32)).abs()
    absd = absd.reshape(absd.shape[:-2] + (-1,))
    mask = absd > 0
    big = torch.finfo(absd.dtype).max
    s = torch.sort(torch.where(mask, absd, big), dim=-1).values
    n = mask.sum(dim=-1, keepdim=True)
    last = absd.shape[-1] - 1
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)
    med = 0.5 * (s.gather(-1, lo) + s.gather(-1, hi))
    return torch.where(n > 0, med, torch.zeros_like(med))[..., 0] / _MAD_DENOM
