"""Bilinear sampling operator and its exact adjoint (the Deblur/SR
downsampling).

Port of ``pnp_svrg_tpu/ops/resize.py``. The operator is an explicit 4-point
gather (indices + weights, built on the host by :func:`bilinear_gather_params`,
a verbatim copy of the reference's numpy, meshgrid axis quirk included: row
coordinates come from the W-spaced linspace and column coordinates from the
H-spaced one, which coincide for square images). Forward is a weighted
gather; the adjoint is a scatter-add through ``index_add_``, the stock op the
JAX package also uses there (``.at[].add``, no Pallas kernel). On the card
``index_add_`` adds with atomics, so its float order changes from run to
run.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10


def bilinear_gather_params(h: int, w: int, lr_h: int, lr_w: int) -> tuple[np.ndarray, np.ndarray]:
    """(idx int32 (M, 4), weights float32 (M, 4)) for bilinear sampling of an
    (h*w,) raveled image at an (lr_h x lr_w) grid. Identity when the shapes
    match (the reference special-cases ``scale_percent == 100``)."""
    m = lr_h * lr_w
    if (lr_h, lr_w) == (h, w):
        idx = np.stack([np.arange(m)] * 4, axis=1).astype(np.int32)
        wts = np.zeros((m, 4), np.float32)
        wts[:, 0] = 1.0
        return idx, wts

    pts_h = np.linspace(_EPS, h - (1 + _EPS), lr_h)
    pts_w = np.linspace(_EPS, w - (1 + _EPS), lr_w)
    # Reference quirk: row coords from the W-spaced points, cols from H-spaced.
    rows = np.repeat(pts_w, lr_w) if lr_h == lr_w else np.repeat(
        np.linspace(_EPS, h - (1 + _EPS), lr_h), lr_w
    )
    cols = np.tile(pts_h, lr_h) if lr_h == lr_w else np.tile(
        np.linspace(_EPS, w - (1 + _EPS), lr_w), lr_h
    )

    r0 = np.floor(rows).astype(np.int64)
    c0 = np.floor(cols).astype(np.int64)
    dr = (rows - r0).astype(np.float32)
    dc = (cols - c0).astype(np.float32)
    r1 = np.clip(r0 + 1, 0, h - 1)
    c1 = np.clip(c0 + 1, 0, w - 1)

    idx = np.stack(
        [r0 * w + c0, r0 * w + c1, r1 * w + c0, r1 * w + c1], axis=1
    ).astype(np.int32)
    wts = np.stack(
        [(1 - dr) * (1 - dc), (1 - dr) * dc, dr * (1 - dc), dr * dc], axis=1
    ).astype(np.float32)
    return idx, wts


def bilinear_apply(v: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Forward: (..., N) -> (..., M), the weighted 4-point gather."""
    return (v[..., idx] * wts).sum(dim=-1)


def bilinear_adjoint(r: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, n: int) -> torch.Tensor:
    """Adjoint: (..., M) -> (..., N), the scatter-add of the weighted
    residuals."""
    lead = r.shape[:-1]
    contrib = (r[..., None] * wts).reshape(lead + (-1,))
    out = torch.zeros(lead + (n,), dtype=r.dtype, device=r.device)
    return out.index_add_(out.dim() - 1, idx.reshape(-1), contrib)
