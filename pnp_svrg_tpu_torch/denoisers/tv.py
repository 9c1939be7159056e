"""Wavelet BayesShrink denoiser (the reference's "TV" denoiser).

Port of ``pnp_svrg_tpu/denoisers/tv.py``. Despite its name the reference's
``TVDenoiser`` is a wavelet denoiser (skimage ``denoise_wavelet`` with
``method='BayesShrink'``); this one runs :func:`denoise_wavelet_bayes`
(``ops/wavelet.py``) over a (B, H, W) batch in plain PyTorch (the JAX
package has no kernel here).

Sigma follows the reference contract per lane: where the estimate is
positive, ``sigma_est * sigma_modifier``; elsewhere
``denoise_strength * decay**t`` with ``t`` the lane's 1-based call count.
"""

from __future__ import annotations

import dataclasses

import torch

from pnp_svrg_tpu_torch.ops.wavelet import denoise_wavelet_bayes


@dataclasses.dataclass(frozen=True)
class TVDenoiser:
    """PnP wavelet denoiser. ``denoise_strength``, ``sigma_modifier`` and
    ``decay`` may be floats or (B,) tensors on the images' device."""

    denoise_strength: torch.Tensor | float = 0.0
    sigma_modifier: torch.Tensor | float = 1.0
    decay: torch.Tensor | float = 1.0
    wavelet: str = "db1"

    def effective_sigma(self, sigma_est: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        fallback = self.denoise_strength * self.decay**t
        return torch.where(sigma_est > 0, sigma_est * self.sigma_modifier, fallback)

    def denoise(self, x: torch.Tensor, sigma_est: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigma_est = torch.as_tensor(sigma_est, dtype=x.dtype, device=x.device)
        sigma = self.effective_sigma(sigma_est, t).to(x.dtype)
        return denoise_wavelet_bayes(x, sigma, wavelet=self.wavelet)
