"""Single-level 2-D discrete wavelet analysis (pywt conventions).

Port of ``dwt2`` from ``pnp_svrg_tpu/ops/wavelet.py``. The analysis runs on a
*half-point symmetric* extension (pywt ``mode='symmetric'``, numpy's
``symmetric`` pad). ``torch.nn.functional.pad`` has no such mode (its
``"reflect"`` is numpy's ``reflect``, one sample off), so the extension is
built with ``flip``/``cat``, and the strided filter is a sum of strided slices,
which keeps convolution libraries out of it.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _filters(wavelet: str) -> tuple[np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi) as float32; ``hi[i] = (-1)^(i+1) lo[L-1-i]``."""
    if wavelet not in _DB_LO:
        raise ValueError(f"unknown wavelet {wavelet!r}; have {tuple(_DB_LO)}")
    lo = np.asarray(_DB_LO[wavelet], dtype=np.float64)
    n = lo.shape[0]
    hi = np.array([(-1.0) ** (i + 1) * lo[n - 1 - i] for i in range(n)])
    return lo.astype(np.float32), hi.astype(np.float32)


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
