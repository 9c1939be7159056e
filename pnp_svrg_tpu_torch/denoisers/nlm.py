"""Non-local means denoiser.

Port of ``pnp_svrg_tpu/denoisers/nlm.py``: skimage's slow-mode NLM
(patch_size 4, patch_distance 5) as a shift-and-accumulate loop, with the
sigma contract the JAX package gives it (``nlm.py:140-150``): where the
estimate is positive, ``h = sigma = sigma_est * sigma_modifier``; elsewhere
``h = denoise_strength * decay**t`` and ``sigma = 0``.

The JAX class has a ``use_pallas`` switch; here the tensor's device decides
instead. A CUDA tensor runs kernel K3 (``ops/cuda/nlm.py``, ``csrc/nlm.cu``),
a CPU tensor its plain PyTorch version; there is no other route.
"""

from __future__ import annotations

import dataclasses

import torch

from pnp_svrg_tpu_torch.ops.cuda.nlm import nlm_denoise


@dataclasses.dataclass(frozen=True)
class NLMDenoiser:
    """PnP NLM denoiser. ``denoise_strength``, ``sigma_modifier`` and
    ``decay`` may be floats or (B,) tensors on the images' device."""

    denoise_strength: torch.Tensor | float = 0.0
    sigma_modifier: torch.Tensor | float = 1.0
    decay: torch.Tensor | float = 1.0
    patch_size: int = 4
    patch_distance: int = 5

    def _h_sigma(self, x, sigma_est, t):
        sigma_est = torch.as_tensor(sigma_est, dtype=x.dtype, device=x.device)
        use_est = sigma_est > 0
        scaled = sigma_est * self.sigma_modifier
        h = torch.where(use_est, scaled, self.denoise_strength * self.decay**t)
        sigma = torch.where(use_est, scaled, 0.0)
        return h, sigma

    def denoise(self, x: torch.Tensor, sigma_est: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h, sigma = self._h_sigma(x, sigma_est, t)
        return nlm_denoise(x, h, sigma, self.patch_size, self.patch_distance)

    def denoise_bounded(self, x, sigma_est, t, row_valid_bounds: tuple) -> torch.Tensor:
        """Denoise with explicit in-image row bounds ``(lo, hi)`` (the
        row-sharded spatial path of the JAX package)."""
        h, sigma = self._h_sigma(x, sigma_est, t)
        return nlm_denoise(x, h, sigma, self.patch_size, self.patch_distance,
                           row_valid_bounds=row_valid_bounds)

    def spatial_halo(self) -> int:
        """Dependency radius in rows for row-sharded denoising."""
        return self.patch_distance + self.patch_size
