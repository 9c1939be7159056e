"""Shared problem-construction helpers (port of ``pnp_svrg_tpu/core/problem.py``).

SNR <-> sigma uses the reference's formula with an *unsquared* norm,
``SNR_lin = ||Y0||_F / sigma^2 / H / W``, so that "SNR 10 dB" sets the same
noise level as the paper's experiments. Every helper works per image over the
last two axes.
"""

from __future__ import annotations

import torch


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Affinely map each (H, W) slice onto [0, 1]."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo)


def snr_to_sigma(snr_db: float, y0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Noise sigma for a target SNR in dB, per image of ``y0`` (..., H, W)."""
    snr_lin = 10.0 ** (snr_db / 10.0)
    norm = torch.linalg.vector_norm(y0.reshape(y0.shape[:-2] + (-1,)), dim=-1)
    return torch.sqrt(norm / snr_lin / h / w)


def sigma_to_snr(sigma: torch.Tensor, y0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SNR in dB from sigma (the inverse of :func:`snr_to_sigma`)."""
    norm = torch.linalg.vector_norm(y0.reshape(y0.shape[:-2] + (-1,)), dim=-1)
    return 10.0 * torch.log10(norm / (sigma * sigma) / h / w)


def resolve_noise(
    y0: torch.Tensor, h: int, w: int, snr: float | None, sigma: float | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(snr, sigma) per image: exactly one may be given; neither means
    noiseless (snr 1e10, sigma 0)."""
    lead = y0.shape[:-2]
    if snr is not None and sigma is None:
        return torch.full(lead, float(snr), device=y0.device), snr_to_sigma(snr, y0, h, w)
    if sigma is not None and snr is None:
        sig = torch.full(lead, float(sigma), device=y0.device)
        return sigma_to_snr(sig, y0, h, w), sig
    if snr is None and sigma is None:
        return torch.full(lead, 1e10, device=y0.device), torch.zeros(lead, device=y0.device)
    raise ValueError("specify either snr or sigma, not both")

