"""Shared problem-construction helpers (port of ``pnp_svrg_tpu/core/problem.py``).

SNR <-> sigma uses the reference's formula with an *unsquared* norm,
``SNR_lin = ||Y0||_F / sigma^2 / H / W``, so that "SNR 10 dB" sets the same
noise level as the paper's experiments. ``H`` and ``W`` are the image's size
whatever the measurements' shape.

The JAX helpers reduce over the whole array of one unbatched problem. The
port's problems carry a leading batch axis, so every helper reduces per lane
over the last ``ndim`` axes only: 2 for an image or a CSMRI spectrum
(..., H, W), 1 for a measurement vector (..., M) of Deblur or phase
retrieval.
"""

from __future__ import annotations

import torch


def _dims(ndim: int) -> tuple:
    return tuple(range(-ndim, 0))


def minmax_normalize(x: torch.Tensor, ndim: int = 2) -> torch.Tensor:
    """Affinely map each slice of the last ``ndim`` axes onto [0, 1]."""
    lo = x.amin(dim=_dims(ndim), keepdim=True)
    hi = x.amax(dim=_dims(ndim), keepdim=True)
    return (x - lo) / (hi - lo)


def _norm(y0: torch.Tensor, ndim: int) -> torch.Tensor:
    return torch.linalg.vector_norm(y0.reshape(y0.shape[: y0.dim() - ndim] + (-1,)), dim=-1)


def snr_to_sigma(snr_db: float, y0: torch.Tensor, h: int, w: int, ndim: int = 2) -> torch.Tensor:
    """Noise sigma for a target SNR in dB, one per slice of ``y0``'s last
    ``ndim`` axes."""
    snr_lin = 10.0 ** (snr_db / 10.0)
    return torch.sqrt(_norm(y0, ndim) / snr_lin / h / w)


def sigma_to_snr(sigma: torch.Tensor, y0: torch.Tensor, h: int, w: int, ndim: int = 2) -> torch.Tensor:
    """SNR in dB from sigma (the inverse of :func:`snr_to_sigma`)."""
    return 10.0 * torch.log10(_norm(y0, ndim) / (sigma * sigma) / h / w)


def resolve_noise(
    y0: torch.Tensor, h: int, w: int, snr: float | None, sigma: float | None, ndim: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """(snr, sigma) per lane of ``y0`` (measurements over its last ``ndim``
    axes): exactly one may be given; neither means noiseless (snr 1e10,
    sigma 0)."""
    lead = y0.shape[: y0.dim() - ndim]
    if snr is not None and sigma is None:
        return torch.full(lead, float(snr), device=y0.device), snr_to_sigma(snr, y0, h, w, ndim)
    if sigma is not None and snr is None:
        sig = torch.full(lead, float(sigma), device=y0.device)
        return sigma_to_snr(sig, y0, h, w, ndim), sig
    if snr is None and sigma is None:
        return torch.full(lead, 1e10, device=y0.device), torch.zeros(lead, device=y0.device)
    raise ValueError("specify either snr or sigma, not both")
