"""Tensor operations: metrics, the sigma estimate, wavelets, Fourier
operators and minibatch sampling (the hand-written CUDA kernels are in
``ops/cuda/`` and build at first use, never at import)."""

from pnp_svrg_tpu_torch.ops.fourier import fft_blur_1d, fft_blur_1d_adjoint_kernel
from pnp_svrg_tpu_torch.ops.metrics import mse, psnr, psnr_rounded, ssim
from pnp_svrg_tpu_torch.ops.sampling import sample_k_indices, sample_k_mask
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.ops.wavelet import (
    denoise_wavelet_bayes,
    dwt1,
    dwt2,
    idwt1,
    idwt2,
    soft_threshold,
    wavedec2,
    waverec2,
)

__all__ = [
    "psnr",
    "psnr_rounded",
    "ssim",
    "mse",
    "estimate_sigma",
    "dwt1",
    "idwt1",
    "dwt2",
    "idwt2",
    "wavedec2",
    "waverec2",
    "denoise_wavelet_bayes",
    "soft_threshold",
    "fft_blur_1d",
    "fft_blur_1d_adjoint_kernel",
    "sample_k_mask",
    "sample_k_indices",
]
