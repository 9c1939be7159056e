"""Small orthonormal transform matrices (numpy; a copy of
``pnp_svrg_tpu/ops/transforms.py``) for the BM3D 3-D transform.

Kept bit-identical to the reference so that the port's BM3D builds the same
``kron(H_K, D (x) D)`` matrix.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D such that ``D @ x`` transforms a length-n
    signal; ``D.T @ c`` inverts."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0, :] *= 1.0 / math.sqrt(n)
    d[1:, :] *= math.sqrt(2.0 / n)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """Orthonormal Walsh-Hadamard matrix (n must be a power of two)."""
    if n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / math.sqrt(n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def haar_matrix(n: int) -> np.ndarray:
    """Orthonormal Haar matrix (n must be a power of two)."""
    if n & (n - 1):
        raise ValueError(f"Haar size must be a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        m = h.shape[0]
        top = np.kron(h, [1.0, 1.0])
        bot = np.kron(np.eye(m), [1.0, -1.0])
        h = np.vstack([top, bot]) / math.sqrt(2.0)
    return h.astype(np.float32)


@functools.lru_cache(maxsize=None)
def kaiser2d(n: int, beta: float = 2.0) -> np.ndarray:
    """2-D separable Kaiser window (BM3D aggregation weighting)."""
    w = np.kaiser(n, beta)
    return np.outer(w, w).astype(np.float32)
