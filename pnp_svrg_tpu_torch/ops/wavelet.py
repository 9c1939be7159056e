"""2-D discrete wavelet transforms and BayesShrink denoising (pywt conventions).

Port of ``pnp_svrg_tpu/ops/wavelet.py``. The analysis runs on a *half-point
symmetric* extension (pywt ``mode='symmetric'``, numpy's ``symmetric`` pad).
``torch.nn.functional.pad`` has no such mode (its ``"reflect"`` is numpy's
``reflect``, one sample off), so the extension is built with ``flip``/``cat``,
and the strided filter is a sum of strided slices, which keeps convolution
libraries out of it. The synthesis is zero-upsampling followed by a full
correlation with the decomposition filters cropped by ``L - 2`` (the pywt
``idwt`` convention), again a sum of shifted slices.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# Daubechies decomposition low-pass filters (pywt coefficient values).
_DB_LO = {
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [
        -0.12940952255092145,
        0.22414386804185735,
        0.836516303737469,
        0.48296291314469025,
    ],
    "db4": [
        -0.010597401784997278,
        0.032883011666982945,
        0.030841381835986965,
        -0.18703481171888114,
        -0.02798376941698385,
        0.6308807679295904,
        0.7148465705525415,
        0.23037781330885523,
    ],
}

WAVELETS = tuple(_DB_LO)


def _filters(wavelet: str) -> tuple[np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi) as float32; ``hi[i] = (-1)^(i+1) lo[L-1-i]``."""
    if wavelet not in _DB_LO:
        raise ValueError(f"unknown wavelet {wavelet!r}; have {WAVELETS}")
    lo = np.asarray(_DB_LO[wavelet], dtype=np.float64)
    n = lo.shape[0]
    hi = np.array([(-1.0) ** (i + 1) * lo[n - 1 - i] for i in range(n)])
    return lo.astype(np.float32), hi.astype(np.float32)


def filter_length(wavelet: str) -> int:
    return len(_DB_LO[wavelet])


def dwt_max_level(data_len: int, wavelet: str) -> int:
    """Maximum useful decomposition level (pywt ``dwt_max_level`` formula)."""
    flen = filter_length(wavelet)
    if data_len < flen - 1 or flen < 2:
        return 0
    return int(math.floor(math.log2(data_len / (flen - 1.0))))


def _symmetric_extend(x: torch.Tensor, e: int) -> torch.Tensor:
    """Half-point symmetric extension by ``e`` samples on each side of the
    last axis (``x[e-1..0] ++ x ++ x[n-1..n-e]``)."""
    if x.shape[-1] < e:
        raise ValueError(f"signal of length {x.shape[-1]} is shorter than {e}")
    return torch.cat([x[..., :e].flip(-1), x, x[..., -e:].flip(-1)], dim=-1)


def _dwt_along_last(x: torch.Tensor, wavelet: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-level analysis along the last axis:
    ``out[k] = sum_j f[j] ext[2k + L - j]``."""
    lo, hi = _filters(wavelet)
    taps = lo.shape[0]
    out_len = (x.shape[-1] + taps - 1) // 2
    ext = _symmetric_extend(x, taps - 1)
    ca = cd = None
    for j in range(taps):
        s = taps - j  # ext index 2k + L - j
        sl = ext[..., s : s + 2 * out_len - 1 : 2]
        ca = sl * float(lo[j]) if ca is None else ca + sl * float(lo[j])
        cd = sl * float(hi[j]) if cd is None else cd + sl * float(hi[j])
    return ca, cd


def _idwt_along_last(ca: torch.Tensor, cd: torch.Tensor, wavelet: str, out_len: int) -> torch.Tensor:
    """Single-level synthesis along the last axis: zero-upsample both bands
    (``u[2k] = c[k]``), pad by ``L - 1`` zeros, correlate with the
    decomposition filters and keep ``[L - 2, L - 2 + out_len)``:
    ``out[n] = sum_j lo[j] ua[n + L - 2 + j] + hi[j] ud[n + L - 2 + j]``."""
    lo, hi = _filters(wavelet)
    taps = lo.shape[0]

    def up(c):
        u = torch.stack([c, torch.zeros_like(c)], dim=-1).reshape(c.shape[:-1] + (-1,))
        return F.pad(u, (taps - 1, taps - 1))

    ua, ud = up(ca), up(cd)
    out = None
    for j in range(taps):
        s = taps - 2 + j
        term = ua[..., s : s + out_len] * float(lo[j]) + ud[..., s : s + out_len] * float(hi[j])
        out = term if out is None else out + term
    return out


def dwt1(x: torch.Tensor, wavelet: str = "db1") -> tuple[torch.Tensor, torch.Tensor]:
    """1-D single-level DWT along the last axis -> (cA, cD)."""
    return _dwt_along_last(x, wavelet)


def idwt1(ca: torch.Tensor, cd: torch.Tensor, wavelet: str, out_len: int) -> torch.Tensor:
    """Inverse of :func:`dwt1`."""
    return _idwt_along_last(ca, cd, wavelet, out_len)


def dwt2(
    x: torch.Tensor, wavelet: str = "db1"
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """2-D single-level DWT over the last two axes, pywt ``dwt2`` band order:
    ``(cA, (cH, cV, cD))``."""
    lo_r, hi_r = _dwt_along_last(x, wavelet)  # along axis -1
    swap = lambda a: a.transpose(-1, -2)  # noqa: E731
    ll, lh = _dwt_along_last(swap(lo_r), wavelet)  # along axis -2
    hl, hh = _dwt_along_last(swap(hi_r), wavelet)
    return swap(ll), (swap(lh), swap(hl), swap(hh))


def idwt2(
    ca: torch.Tensor,
    details: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    wavelet: str,
    out_shape: tuple[int, int],
) -> torch.Tensor:
    """Inverse of :func:`dwt2` producing the last-two-axes shape ``out_shape``."""
    ch, cv, cd = details
    swap = lambda a: a.transpose(-1, -2)  # noqa: E731
    lo_r = _idwt_along_last(swap(ca), swap(ch), wavelet, out_shape[0])
    hi_r = _idwt_along_last(swap(cv), swap(cd), wavelet, out_shape[0])
    return _idwt_along_last(swap(lo_r), swap(hi_r), wavelet, out_shape[1])


def wavedec2(x: torch.Tensor, wavelet: str = "db1", levels: int | None = None) -> list:
    """Multi-level 2-D decomposition, pywt ``wavedec2`` order:
    ``[cA_n, (cH_n, cV_n, cD_n), ..., (cH_1, cV_1, cD_1)]``."""
    if levels is None:
        levels = dwt_max_level(min(x.shape[-2:]), wavelet)
    coeffs = []
    ca = x
    for _ in range(levels):
        ca, det = dwt2(ca, wavelet)
        coeffs.append(det)
    return [ca] + coeffs[::-1]


def waverec2(coeffs: Sequence, wavelet: str, out_shape: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`wavedec2`. ``out_shape`` is the last-two-axes shape
    of the original image; the intermediate shapes are re-derived from it
    (level ``i`` has ``(n + L - 1) // 2`` samples of level ``i - 1``'s ``n``)."""
    levels = len(coeffs) - 1
    taps = filter_length(wavelet)
    shapes = [tuple(out_shape)]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append(((h + taps - 1) // 2, (w + taps - 1) // 2))
    ca = coeffs[0]
    for i, det in enumerate(coeffs[1:]):
        ca = idwt2(ca, det, wavelet, shapes[levels - 1 - i])
    return ca


def soft_threshold(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``sign(x) * max(|x| - t, 0)``."""
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def _bayes_threshold(detail: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """BayesShrink threshold of one band, per image:
    ``sigma^2 / sqrt(max(E[d^2] - sigma^2, eps))`` (skimage ``_bayes_thresh``),
    the mean over the last two axes."""
    dvar = (detail * detail).mean(dim=(-2, -1), keepdim=True)
    eps = torch.finfo(detail.dtype).eps
    return var / torch.sqrt(torch.clamp(dvar - var, min=eps))


def denoise_wavelet_bayes(
    x: torch.Tensor, sigma, wavelet: str = "db1", levels: int | None = None
) -> torch.Tensor:
    """BayesShrink soft-threshold wavelet denoising over the last two axes
    (skimage ``denoise_wavelet(method='BayesShrink', mode='soft')``):
    ``max(dwt_max_level - 3, 1)`` levels unless given, every detail band
    shrunk by its own threshold. ``sigma`` is a scalar or one value per
    image of the leading axes."""
    if levels is None:
        levels = max(dwt_max_level(min(x.shape[-2:]), wavelet) - 3, 1)
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    var = (sigma * sigma).reshape(sigma.shape + (1, 1)) if sigma.dim() else sigma * sigma
    coeffs = wavedec2(x, wavelet, levels)
    out = [coeffs[0]]
    for det in coeffs[1:]:
        out.append(tuple(soft_threshold(d, _bayes_threshold(d, var)) for d in det))
    return waverec2(out, wavelet, tuple(x.shape[-2:]))
