"""Bilinear sampling operator and its exact adjoint (the Deblur/SR
downsampling).

Port of ``pnp_svrg_tpu/ops/resize.py``. The operator is an explicit 4-point
gather (indices + weights, built on the host by :func:`bilinear_gather_params`,
a verbatim copy of the reference's numpy, meshgrid axis quirk included: row
coordinates come from the W-spaced linspace and column coordinates from the
H-spaced one, which coincide for square images). Forward is a weighted
gather; the adjoint is the JAX package's scatter-add (``.at[].add``, no
Pallas kernel) written as a gather: :func:`bilinear_adjoint_table`, built
once on the host, lists for every high-resolution pixel its (sample,
corner) terms in ascending flattened order, and :func:`bilinear_adjoint`
adds them one column at a time. The order is fixed, so the adjoint repeats
itself bit for bit on the card, and it is the order in which XLA's CPU
scatter adds the same terms.
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


def bilinear_adjoint_table(idx: np.ndarray, n: int) -> np.ndarray:
    """(N, K) int64: for each of the ``n`` pixels, the positions ``4 * m +
    corner`` of ``idx`` (M, 4) that point at it, ascending, padded with
    ``4 * M`` (a zero the adjoint appends); K is the most any pixel has."""
    flat = np.asarray(idx).reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pix = flat[order]
    table = np.full((n, max(int(counts.max(initial=0)), 1)), flat.size, np.int64)
    table[pix, np.arange(flat.size) - starts[pix]] = order
    return table


def bilinear_adjoint(r: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, n: int,
                     table: torch.Tensor | None = None) -> torch.Tensor:
    """Adjoint: (..., M) -> (..., N), the weighted residuals summed into each
    pixel in the fixed order of ``table`` (:func:`bilinear_adjoint_table` of
    ``idx``, on ``r``'s device; made here from ``idx`` when not given, which
    copies it to the host)."""
    if table is None:
        table = torch.as_tensor(bilinear_adjoint_table(idx.cpu().numpy(), n), device=r.device)
    lead = r.shape[:-1]
    contrib = (r[..., None] * wts).reshape(lead + (-1,))
    terms = torch.cat([contrib, contrib.new_zeros(lead + (1,))], dim=-1)[..., table]  # (..., N, K)
    out = torch.zeros(lead + (n,), dtype=r.dtype, device=r.device)
    for k in range(table.shape[1]):
        out = out + terms[..., k]
    return out
