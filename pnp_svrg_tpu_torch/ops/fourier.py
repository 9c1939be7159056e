"""Fourier-domain operators: 2-D FFTs and the 1-D circular "fft_blur"
convolution of the Deblur problem.

Port of ``pnp_svrg_tpu/ops/fourier.py``. ``fft2`` and ``ifft2`` transform the
last two axes, as ``jnp.fft.fft2`` does. The Deblur forward model treats an H*W image
as one periodic signal of length N and convolves it with a raveled kernel:
``real(ifft(fft(a) * fft(b))) * sqrt(N)`` over the last axis, so a (B, N)
stack holds one signal per lane. ``torch.fft`` follows numpy's unnormalised
forward / 1/N inverse convention, as ``jnp.fft`` does.
"""

from __future__ import annotations

import math

import torch


def fft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(x)


def ifft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(x)


def fft_blur_1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution of ``a`` and ``b`` along the last axis, scaled
    by ``sqrt(N)``; ``b`` broadcasts against ``a``'s leading axes."""
    n = a.shape[-1]
    out = torch.fft.ifft(torch.fft.fft(a) * torch.fft.fft(b))
    return out.real * math.sqrt(n)


def fft_blur_1d_adjoint_kernel(b: torch.Tensor) -> torch.Tensor:
    """The kernel whose ``fft_blur_1d`` is the adjoint of blurring with ``b``:
    ``roll(flip(b), 1)`` along the last axis, the circular time-reversal
    ``b[-n mod N]``."""
    return torch.roll(torch.flip(b, dims=(-1,)), 1, dims=-1)
