"""Precision switches for the reference and its control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 products (matmul, einsum, cuDNN convolutions) on or off, cuDNN
    deterministic; the previous settings restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32's 10-bit mantissa, to
    nearest, ties to even: the operands a TF32 product sees. Used where an
    operation has no TF32 mode of its own (the FFT)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()), round_tf32(x.imag.contiguous()))
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x.to(torch.float32))
