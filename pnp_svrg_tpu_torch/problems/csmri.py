"""Compressed-sensing MRI: subsampled-Fourier measurements.

Port of ``pnp_svrg_tpu/problems/csmri.py``. The problem carries a leading
batch axis natively: every image field is (B, H, W) and every scalar field is
(B,), so one instance holds all lanes and no vmap is needed.

* ``Y = mask * fft2(X) + mask * N(0, sigma)`` with *real* Gaussian noise added
  to the complex spectrum.
* ``x_init = minmax(|ifft2(Y)|)``.
* ``grad_full(z) = real(ifft2(mask * fft2(z) - Y)) / m0`` with ``m0`` the
  number of sampled coefficients.
* ``grad_stoch(z, mb)`` restricts the residual to ``mask * mb`` and returns
  the *unnormalised* sum; the loops divide by the minibatch size.
* Minibatches are drawn uniformly without replacement from the sampled
  locations (``ops/sampling.py``), from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.problem import minmax_normalize, resolve_noise
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.ops.metrics import psnr
from pnp_svrg_tpu_torch.ops.sampling import sample_k_mask


@dataclasses.dataclass(frozen=True)
class CSMRI:
    """Batched subsampled-Fourier MRI problem."""

    y: torch.Tensor  # complex64 (B, H, W), masked noisy spectrum
    mask: torch.Tensor  # float32 (B, H, W), 0/1 sampling mask
    x: torch.Tensor  # float32 (B, H, W), ground truth in [0, 1]
    x_init: torch.Tensor  # float32 (B, H, W), zero-filled |ifft2| init
    m0: torch.Tensor  # float32 (B,), number of sampled coefficients
    snr: torch.Tensor  # float32 (B,)
    sigma: torch.Tensor  # float32 (B,)

    @property
    def batch_size(self) -> int:
        return self.y.shape[0]

    @property
    def h(self) -> int:
        return self.y.shape[-2]

    @property
    def w(self) -> int:
        return self.y.shape[-1]

    @property
    def n(self) -> int:
        return self.h * self.w

    @property
    def m(self) -> int:
        return self.h * self.w

    @property
    def device(self) -> torch.device:
        return self.y.device

    def _img(self, z: torch.Tensor) -> torch.Tensor:
        return z.reshape(self.batch_size, self.h, self.w)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``mask * fft2(z)`` for (B, H, W) or (B, N) ``z``."""
        return self.mask * torch.fft.fft2(self._img(z))

    def f(self, z: torch.Tensor) -> torch.Tensor:
        """(B,) data fidelity ``||Y - mask*fft2(z)||_F^2 / (2 M)``."""
        r = self.y - self.forward(z)
        return (r.abs() ** 2).sum(dim=(-2, -1)) / (2.0 * self.m)

    def grad_full(self, z: torch.Tensor) -> torch.Tensor:
        res = self.mask * torch.fft.fft2(self._img(z)) - self.y
        return torch.fft.ifft2(res).real / self.m0[:, None, None]

    def grad_stoch(self, z: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
        """Unnormalised minibatch gradient; ``mb`` is a (B, H, W) 0/1 mask."""
        mbb = self.mask * mb.reshape(self.mask.shape)
        res = mbb * (torch.fft.fft2(self._img(z)) - self.y)
        return torch.fft.ifft2(res).real

    def mb_shape(self, k: int) -> tuple:
        return tuple(self.mask.shape)

    def select_mb(self, generator: torch.Generator, k: int) -> torch.Tensor:
        """(B, H, W) 0/1 masks with k ones per lane, drawn from the sampled
        locations."""
        return sample_k_mask(self.mask.shape, k, generator, allowed=self.mask)

    def full_mb(self) -> torch.Tensor:
        return self.mask

    def grad_sum(self, z: torch.Tensor) -> torch.Tensor:
        """``grad_stoch`` over every sampled coefficient."""
        return self.grad_stoch(z, self.mask)

    def m_total(self) -> torch.Tensor:
        return self.m0

    def grad_scale(self) -> torch.Tensor:
        """(B,) factor s with ``autodiff(f) == s * grad_full``: the DFT
        adjoint's N cancels f's 1/M (M = N), leaving ``grad_full``'s 1/m0
        as the only mismatch (the reference's rescaled gradient)."""
        return self.m0

    def psnr(self, z: torch.Tensor) -> torch.Tensor:
        """(B,) PSNR of ``z`` against the ground truth."""
        return psnr(self.x, self._img(z))


def make_csmri(
    image,
    generator: torch.Generator,
    sample_prob: float = 0.5,
    snr: float | None = None,
    sigma: float | None = None,
    keep_low_freq: int = 0,
    device=None,
) -> CSMRI:
    """A one-lane :class:`CSMRI` from an (H, W) image in [0, 1] on ``device``
    (CUDA unless ``"cpu"`` is passed); ``generator`` must live there too.

    ``keep_low_freq``: guarantee the lowest ``k`` x ``k`` frequency block
    (indices in (-k, k) per axis) is sampled (the variable-density masks of
    the Set12-VD lanes); 0 keeps the reference's uniform Bernoulli mask.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, problem on {dev}")
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev)[None]
    _, h, w = x.shape
    mask = (torch.rand((1, h, w), generator=generator, device=dev) < sample_prob)
    mask = mask.to(torch.float32)
    if keep_low_freq:
        k = int(keep_low_freq)

        def low_idx(n):
            if k <= 1:
                return torch.arange(1, device=dev)
            return torch.cat([torch.arange(k), torch.arange(n - k + 1, n)]).to(dev)

        mask[:, low_idx(h)[:, None], low_idx(w)[None, :]] = 1.0
    y0 = mask * torch.fft.fft2(x)
    snr_out, sig = resolve_noise(y0, h, w, snr, sigma)
    noise = sig[:, None, None] * torch.randn((1, h, w), generator=generator, device=dev)
    y = y0 + mask * noise
    x_init = minmax_normalize(torch.fft.ifft2(y).abs())
    return CSMRI(
        y=y.to(torch.complex64),
        mask=mask,
        x=x,
        x_init=x_init.to(torch.float32),
        m0=mask.sum(dim=(-2, -1)),
        snr=snr_out.to(torch.float32),
        sigma=sig.to(torch.float32),
    )
