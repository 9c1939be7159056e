"""Image quality metrics (PSNR, SSIM), batched over leading axes.

Port of ``pnp_svrg_tpu/ops/metrics.py``. Every function reduces over the last
two axes only, so a (B, H, W) stack gives (B,) values (the JAX side gets the
same by ``vmap``). SSIM follows skimage's ``gaussian_weights=True``
convention: reflect padding, Gaussian sigma 1.5 truncated at 3.5, the filter
radius cropped before the mean. The separable filter is written with slices,
so no convolution library (and no TF32) is involved.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.float() - b.float()
    return (d * d).mean(dim=(-2, -1))


def psnr(
    image_true: torch.Tensor, image_test: torch.Tensor, data_range: float = 1.0
) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the last two axes."""
    return 10.0 * torch.log10((data_range * data_range) / mse(image_true, image_test))


def psnr_rounded(
    image_true: torch.Tensor, image_test: torch.Tensor, data_range: float = 1.0
) -> torch.Tensor:
    """PSNR rounded to 2 decimals, the reference's reporting convention, as
    ``jnp.round(x, 2)`` computes it under XLA: ``x * 100`` rounded half to
    even, times the f32 constant 0.01 (XLA turns the division by 100 into
    that product, which can differ from ``torch.round(x, decimals=2)`` in
    the last bit)."""
    p = psnr(image_true, image_test, data_range)
    return torch.round(p * 100.0) * p.new_tensor(0.01)


def _gaussian_kernel1d(sigma: float, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d_separable(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable 2-D correlation with reflect padding over the last two axes."""
    r = (len(k) - 1) // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, h, w), (r, r, r, r), mode="reflect")[:, 0]
    taps = [float(t) for t in k]
    rows = sum(t * x[:, j : j + h, :] for j, t in enumerate(taps))
    out = sum(t * rows[:, :, j : j + w] for j, t in enumerate(taps))
    return out.reshape(*lead, h, w)


def ssim(
    image_true: torch.Tensor, image_test: torch.Tensor, data_range: float = 1.0
) -> torch.Tensor:
    """Structural similarity (skimage defaults: K1=0.01, K2=0.03, no sample
    covariance correction)."""
    a = image_true.float()
    b = image_test.float()
    k = _gaussian_kernel1d(1.5)
    f = lambda z: _filter2d_separable(z, k)  # noqa: E731
    mu_a, mu_b = f(a), f(b)
    var_a = f(a * a) - mu_a * mu_a
    var_b = f(b * b) - mu_b * mu_b
    cov = f(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    s = num / den
    r = (len(k) - 1) // 2
    return s[..., r:-r, r:-r].mean(dim=(-2, -1))
