"""Deblurring + super-resolution: circular blur, then bilinear downsampling.

Port of ``pnp_svrg_tpu/problems/deblur.py``. The problem carries a leading
batch axis natively, as ``problems/csmri.py`` does: measurements are (B, M),
kernels (B, N), images (B, H, W) and scalars (B,). The bilinear gather
``ds_idx``/``ds_w`` (M, 4) and its adjoint's table ``ds_adj`` depend only on
the sizes, so the lanes share them (``stack_problems`` does not
concatenate them).

* Blur is the reference's 1-D circular FFT convolution of the *raveled*
  image with a kernel scaled by 1/N, times sqrt(N) (``ops/fourier.py``).
* Downsampling is the explicit 4-point bilinear gather and its scatter-add
  adjoint, summed in a fixed order (``ops/resize.py``).
* ``grad_full = Blur^T S^T (S Blur z - Y) / M`` with the adjoint kernel
  ``roll(flip(b), 1)``; ``grad_stoch`` restricts the residual to a (B, M)
  0/1 minibatch mask and returns the unnormalised sum.
* ``x_init`` is uniform random; the noise and ``x_init`` come from an
  explicit ``torch.Generator``, so they are not the JAX package's numbers
  (``convert.py`` carries those over).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.problem import resolve_noise
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.ops.fourier import fft_blur_1d, fft_blur_1d_adjoint_kernel
from pnp_svrg_tpu_torch.ops.metrics import psnr
from pnp_svrg_tpu_torch.ops.resize import (
    bilinear_adjoint,
    bilinear_adjoint_table,
    bilinear_apply,
    bilinear_gather_params,
)
from pnp_svrg_tpu_torch.ops.sampling import sample_k_mask
from pnp_svrg_tpu_torch.utils.io import resolve_data_path

SHARED = {"shared": True}  # field metadata: one value for every lane


@dataclasses.dataclass(frozen=True)
class Deblur:
    """Batched Deblur/SR problem."""

    y: torch.Tensor  # float32 (B, M), noisy blurred + downsampled measurements
    b: torch.Tensor  # float32 (B, N), raveled blur kernel (already / N)
    b_adj: torch.Tensor  # float32 (B, N), adjoint kernel roll(flip(b), 1)
    x: torch.Tensor  # float32 (B, H, W), ground truth
    x_init: torch.Tensor  # float32 (B, H, W), uniform-random init
    ds_idx: torch.Tensor = dataclasses.field(metadata=SHARED)  # int64 (M, 4) into N
    ds_w: torch.Tensor = dataclasses.field(metadata=SHARED)  # float32 (M, 4)
    ds_adj: torch.Tensor = dataclasses.field(metadata=SHARED)  # int64 (N, K), bilinear_adjoint_table
    allowed: torch.Tensor = None  # float32 (B, M) 0/1: the measurements a lane owns
    snr: torch.Tensor = None  # float32 (B,)
    sigma: torch.Tensor = None  # float32 (B,)

    @property
    def batch_size(self) -> int:
        return self.y.shape[0]

    @property
    def h(self) -> int:
        return self.x.shape[-2]

    @property
    def w(self) -> int:
        return self.x.shape[-1]

    @property
    def n(self) -> int:
        return self.h * self.w

    @property
    def m(self) -> int:
        return self.y.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.y.device

    def _flat(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(self.batch_size, self.n)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``S Blur(z)`` as (B, M), for (B, H, W) or (B, N) ``z``."""
        return bilinear_apply(fft_blur_1d(self._flat(z), self.b), self.ds_idx, self.ds_w)

    def f(self, z: torch.Tensor) -> torch.Tensor:
        """(B,) data fidelity ``||allowed * (Y - S Blur z)||^2 / (2 M)``."""
        r = self.allowed * (self.y - self.forward(z))
        return (r * r).sum(dim=-1) / (2.0 * self.m)

    def _adjoint(self, res: torch.Tensor) -> torch.Tensor:
        return fft_blur_1d(bilinear_adjoint(res, self.ds_idx, self.ds_w, self.n, self.ds_adj), self.b_adj)

    def grad_full(self, z: torch.Tensor) -> torch.Tensor:
        return self._adjoint(self.allowed * (self.forward(z) - self.y)) / self.m

    def grad_stoch(self, z: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
        """Unnormalised minibatch gradient; ``mb`` is a (B, M) 0/1 mask."""
        return self._adjoint(mb.reshape(self.y.shape) * (self.forward(z) - self.y))

    def mb_shape(self, k: int) -> tuple:
        return (self.batch_size, self.m)

    def select_mb(self, generator: torch.Generator, k: int) -> torch.Tensor:
        """(B, M) 0/1 masks with k ones per lane among its owned measurements."""
        return sample_k_mask(self.y.shape, k, generator, allowed=self.allowed, ndim=1)

    def full_mb(self) -> torch.Tensor:
        return self.allowed

    def grad_sum(self, z: torch.Tensor) -> torch.Tensor:
        """``grad_stoch`` over every owned measurement."""
        return self.grad_stoch(z, self.allowed)

    def m_total(self) -> torch.Tensor:
        return self.allowed.sum(dim=-1)

    def psnr(self, z: torch.Tensor) -> torch.Tensor:
        return psnr(self.x, z.reshape(self.x.shape))


def make_minimal_kernel(h: int, w: int) -> np.ndarray:
    """The reference's built-in "Minimal" 3-point blur (``DeblurSR.py:80-87``)."""
    b = np.zeros((h, w), np.float32)
    b[0, 0] = 1.0
    b[h // 2, h // 2] = 1.0
    b[h // 2, h // 3] = 1.0
    b[h // 2, h // 4] = 1.0
    return b / 4.0


def make_identity_kernel(h: int, w: int) -> np.ndarray:
    """No blurring (``DeblurSR.py:77-79``)."""
    b = np.zeros(h * w, np.float32)
    b[0] = 1.0
    return b


def load_kernel_image(path, h: int, w: int) -> np.ndarray:
    """Blur kernel from an image file resized to (H, W) by PIL's default
    resampling: raw pixel values (uint8 scale, not normalised); the 1/N
    scaling happens in :func:`make_deblur`. A relative path is looked up in
    the repository's ``data/`` directory first. The default resampling filter
    depends on the Pillow version, so the committed Deblur-SR fixture stores
    its kernel."""
    from PIL import Image

    img = Image.open(resolve_data_path(path))
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img.resize((w, h)), np.float32)


def deblur_kernel(kernel, h: int, w: int) -> np.ndarray:
    """An (H, W) or (N,) kernel array from ``kernel``: an array, "Minimal",
    "Identity", or the path of a kernel image."""
    if isinstance(kernel, str):
        if kernel == "Minimal":
            return make_minimal_kernel(h, w)
        if kernel == "Identity":
            return make_identity_kernel(h, w)
        if kernel.endswith((".png", ".jpg", ".jpeg")):
            return load_kernel_image(kernel, h, w)
        raise ValueError(f"unknown built-in kernel {kernel!r}")
    return np.asarray(kernel, np.float32)


def make_deblur(
    image,
    generator: torch.Generator,
    kernel="Minimal",
    scale_percent: int = 100,
    snr: float | None = None,
    sigma: float | None = None,
    device=None,
) -> Deblur:
    """A one-lane :class:`Deblur` from an (H, W) image in [0, 1] on ``device``
    (CUDA unless ``"cpu"`` is passed); ``generator`` must live there too and
    draws the noise, then ``x_init``. The kernel (see :func:`deblur_kernel`)
    is raveled and scaled by 1/N."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, problem on {dev}")
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev)[None]
    _, h, w = x.shape
    n = h * w
    b = torch.as_tensor(deblur_kernel(kernel, h, w), dtype=torch.float32, device=dev).reshape(1, n) / n
    lr_h, lr_w = int(h * scale_percent / 100), int(w * scale_percent / 100)
    idx, wts = bilinear_gather_params(h, w, lr_h, lr_w)
    ds_idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    ds_w = torch.as_tensor(wts, device=dev)
    ds_adj = torch.as_tensor(bilinear_adjoint_table(idx, n), device=dev)
    y0 = bilinear_apply(fft_blur_1d(x.reshape(1, n), b), ds_idx, ds_w)
    snr_out, sig = resolve_noise(y0, h, w, snr, sigma, ndim=1)
    y = y0 + sig[:, None] * torch.randn(y0.shape, generator=generator, device=dev)
    x_init = torch.rand((1, h, w), generator=generator, device=dev)
    return Deblur(
        y=y.to(torch.float32), b=b, b_adj=fft_blur_1d_adjoint_kernel(b), x=x, x_init=x_init,
        ds_idx=ds_idx, ds_w=ds_w, ds_adj=ds_adj, allowed=torch.ones_like(y0),
        snr=snr_out.to(torch.float32), sigma=sig.to(torch.float32),
    )
