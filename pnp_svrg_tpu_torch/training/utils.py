"""Training-side utilities (port of ``pnp_svrg_tpu/training/utils.py``).

Batched PSNR/SSIM on the port's ``ops/metrics.py``, the orthogonality
regulariser of Lipschitz-constrained training and its epoch decay, and the
conv-kernel unrollers that check spectral norms against an explicit matrix
(host numpy/scipy copies of the JAX package's).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pnp_svrg_tpu_torch.ops.metrics import psnr as _psnr
from pnp_svrg_tpu_torch.ops.metrics import ssim as _ssim


def batch_psnr(pred: torch.Tensor, clean: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean PSNR over a (B, H, W) or (B, C, H, W) batch, each sample's MSE
    over all its pixels."""
    pred = pred.reshape(pred.shape[0], -1, pred.shape[-1])
    clean = clean.reshape(pred.shape)
    return _psnr(clean, pred, data_range=data_range).mean()


def batch_ssim(pred: torch.Tensor, clean: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over a (B, H, W) or (B, 1, H, W) batch."""
    pred = pred.reshape(pred.shape[0], pred.shape[-2], pred.shape[-1])
    clean = clean.reshape(pred.shape)
    return _ssim(clean, pred, data_range=data_range).mean()


def l2_reg_normal_ortho(weights: Sequence[torch.Tensor], generator: torch.Generator | None = None,
                        probes: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """The orthogonality regulariser ``sum_W sigma_max(W^T W - I)^2`` over the
    >= 2-D tensors of ``weights``.

    A 4-D conv weight (O, I, kh, kw) becomes the (O, kh * kw * I) matrix of
    the JAX package's Flax layout (the columns in (kh, kw, I) order), any
    other one (rows, rest). The largest singular value of ``W^T W - I`` is
    estimated by one power iteration (u -> v -> u -> sigma) from a Gaussian
    probe: ``probes[i]`` for the i-th such weight when given (the tests pass
    the JAX package's), else a fresh draw from ``generator``, which must
    differ per call (a fixed probe would let training hide spectral mass
    orthogonal to it)."""
    mats = [w.permute(0, 2, 3, 1).reshape(w.shape[0], -1) if w.dim() == 4 else w.reshape(w.shape[0], -1)
            for w in weights if w.dim() >= 2]
    total = torch.zeros((), dtype=torch.float32, device=mats[0].device if mats else None)
    for i, w1 in enumerate(mats):
        cols = w1.shape[1]
        m = w1.T @ w1 - torch.eye(cols, dtype=w1.dtype, device=w1.device)
        u = probes[i] if probes is not None else torch.randn(cols, generator=generator, dtype=w1.dtype,
                                                              device=w1.device)
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = m.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = m @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        sigma = u @ (m @ v)
        total = total + sigma**2
    return total


def adjust_ortho_decay_rate(epoch: int, lamb_decay: float) -> float:
    """The reference's staircase decay of the orthogonality weight."""
    if epoch > 40:
        return 0.0
    if epoch > 30:
        return 1e-6 * lamb_decay
    if epoch > 20:
        return 1e-4 * lamb_decay
    if epoch > 10:
        return 1e-3 * lamb_decay
    return lamb_decay


def unroll_kernel(kernel: np.ndarray, n: int) -> np.ndarray:
    """Dense matrix of the VALID 2-D correlation with ``kernel`` on an n x n
    input: rows are output pixels (c_out blocks of (n-m+1)^2), columns the
    flattened input pixels. ``kernel``: (c_out, 1, m, m) or (m, m)."""
    kernel = np.asarray(kernel)
    if kernel.ndim == 2:
        kernel = kernel[None, None]
    c_out, _, m, _ = kernel.shape
    out_n = n - m + 1
    rows = c_out * out_n * out_n
    mat = np.zeros((rows, n * n), kernel.dtype)
    for c in range(c_out):
        k = kernel[c, 0]
        for oy in range(out_n):
            for ox in range(out_n):
                r = c * out_n * out_n + oy * out_n + ox
                for j in range(m):
                    mat[r, (oy + j) * n + ox : (oy + j) * n + ox + m] = k[j]
    return mat


def unroll_kernel_sparse(kernel: np.ndarray, n: int, sparse: bool = True):
    """Sparse (scipy ``lil_matrix``) variant of :func:`unroll_kernel`."""
    if not sparse:
        return unroll_kernel(kernel, n)
    from scipy.sparse import lil_matrix

    kernel = np.asarray(kernel)
    if kernel.ndim == 2:
        kernel = kernel[None, None]
    c_out, _, m, _ = kernel.shape
    out_n = n - m + 1
    mat = lil_matrix((c_out * out_n * out_n, n * n))
    for c in range(c_out):
        k = kernel[c, 0]
        for oy in range(out_n):
            for ox in range(out_n):
                r = c * out_n * out_n + oy * out_n + ox
                for j in range(m):
                    base = (oy + j) * n + ox
                    mat[r, base : base + m] = k[j]
    return mat
