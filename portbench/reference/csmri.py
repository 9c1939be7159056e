"""CS-MRI's gradients, plainly: ``grad_full(z) = Re ifft2(mask * fft2(z) - y) / m0``
and the unnormalised minibatch sum ``Re ifft2(mask * mb * (fft2(z) - y))``.

The reference computes in float64 (complex128); the control in complex64
with every FFT input rounded to TF32 (cuFFT has no TF32 mode, and a
half-precision FFT, which a later change might reach for, keeps the same 10
bits)."""

from __future__ import annotations

import torch

from portbench.reference.precision import round_tf32


def _cast(inputs: dict, z: torch.Tensor, tf32: bool) -> tuple:
    b, h, w = inputs["mask"].shape
    z = z.reshape(b, h, w)
    if tf32:
        return round_tf32(z.to(torch.float32)), round_tf32(inputs["y"]), inputs["mask"]
    return z.to(torch.float64), inputs["y"].to(torch.complex128), inputs["mask"].to(torch.float64)


def grad_full(inputs: dict, z: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    z, y, mask = _cast(inputs, z, tf32)
    res = mask * torch.fft.fft2(z) - y
    g = torch.fft.ifft2(res).real / inputs["m0"].to(z.dtype)[:, None, None]
    return g.reshape(g.shape[0], -1)


def grad_stoch(inputs: dict, z: torch.Tensor, mb: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    z, y, mask = _cast(inputs, z, tf32)
    mbb = mask * mb.reshape(mask.shape).to(mask.dtype)
    g = torch.fft.ifft2(mbb * (torch.fft.fft2(z) - y)).real
    return g.reshape(g.shape[0], -1)


def minibatch_fault(inputs: dict, mb: torch.Tensor, k: int) -> str | None:
    """Why ``mb`` is no minibatch of ``k`` sampled coefficients a lane (0/1,
    inside the sampling mask), or None."""
    mask = inputs["mask"]
    mb = mb.reshape(mask.shape).to(torch.float32)
    if not bool(((mb == 0) | (mb == 1)).all()):
        return "a minibatch mask holds values other than 0 and 1"
    if bool((mb * (1 - mask)).any()):
        return "a minibatch takes a coefficient outside the sampling mask"
    counts = mb.sum(dim=(-2, -1))
    if not bool((counts == k).all()):
        return f"minibatch sizes {counts.tolist()}, expected {k} a lane"
    return None
