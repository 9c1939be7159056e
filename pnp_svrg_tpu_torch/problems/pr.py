"""Phase retrieval from Gaussian magnitude measurements.

Port of ``pnp_svrg_tpu/problems/pr.py``. The problem carries a leading batch
axis natively: ``a`` is (B, M, N), ``y`` (B, M), images (B, H, W), scalars
(B,). Lanes that share one matrix (replicas of one problem, as the PR +
SARAH lane runs 8 of them) hold it once: ``a`` is then (1, M, N), every
product with it is one matrix product over the lanes, and a minibatch
gathers each lane's rows from it. ``stack_problems`` keeps ``a`` once when
every lane holds the same tensor.

* ``y = |A x| + noise``. Every product is a plain f32 ``torch.matmul`` (the
  JAX package leaves them to XLA outside any Pallas kernel); TF32 is off
  (``device.py``).
* Spectral initialisation: power iteration on ``D = A^T diag(y) A / M``
  without forming D, with the reference's stop (both the max-element
  estimate and the iterate stationary within ``tol``, at most 10,000
  steps). JAX runs it as a ``lax.while_loop``; here it is a host loop that
  reads the condition back each step, which is set-up only.
* Amplitude-loss gradients: ``grad_full = A^T(((|Aw|-y)/|Aw|) * Aw) / M``;
  ``grad_stoch`` takes (B, k) row indices, gathers those rows of A and
  returns the unnormalised sum.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.problem import minmax_normalize, resolve_noise
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.ops.metrics import psnr
from pnp_svrg_tpu_torch.ops.sampling import sample_k_indices

MAX_POWER_ITERS = 10_000


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, R, N) @ (B, N) -> (B, R); a (1, R, N) ``a`` serves every lane in
    one (B, N) @ (N, R) product."""
    if a.shape[0] == 1 < v.shape[0]:
        return v @ a[0].T
    return torch.matmul(a, v[..., None])[..., 0]


def _rmatvec(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(B, R, N)^T @ (B, R) -> (B, N); a (1, R, N) ``a`` as in :func:`_matvec`."""
    if a.shape[0] == 1 < u.shape[0]:
        return u @ a[0]
    return torch.matmul(u[..., None, :], a)[..., 0, :]


@dataclasses.dataclass(frozen=True)
class PhaseRetrieval:
    """Batched phase retrieval problem."""

    # float32 (B, M, N) Gaussian measurement matrices, or (1, M, N) for all lanes
    a: torch.Tensor = dataclasses.field(metadata={"kept_once_if_same": True})
    y: torch.Tensor  # float32 (B, M), noisy magnitudes
    x: torch.Tensor  # float32 (B, H, W), ground truth
    x_init: torch.Tensor  # float32 (B, H, W), spectral init
    snr: torch.Tensor  # float32 (B,)
    sigma: torch.Tensor  # float32 (B,)

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
        return _matvec(self.a, self._flat(z)).abs()

    def f(self, z: torch.Tensor) -> torch.Tensor:
        r = self.y - self.forward(z)
        return (r * r).sum(dim=-1) / (2.0 * self.m)

    def _amplitude_grad(self, a_rows: torch.Tensor, y_rows: torch.Tensor, z) -> torch.Tensor:
        t = _matvec(a_rows, self._flat(z))
        at = t.abs()
        return _rmatvec(a_rows, (at - y_rows) / at * t)

    def grad_sum(self, z: torch.Tensor) -> torch.Tensor:
        """The unnormalised gradient over every row, without gathering A."""
        return self._amplitude_grad(self.a, self.y, z)

    def grad_full(self, z: torch.Tensor) -> torch.Tensor:
        return self.grad_sum(z) / self.m

    def grad_stoch(self, z: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
        """Unnormalised minibatch gradient; ``mb`` is a (B, k) index tensor.
        Gathers the k rows of A of each lane (B*k*N floats)."""
        mb = mb.to(torch.int64)
        if self.a.shape[0] == 1:
            rows = self.a[0].index_select(0, mb.reshape(-1)).reshape(mb.shape + (self.n,))
        else:
            rows = self.a[torch.arange(self.batch_size, device=mb.device)[:, None], mb]
        return self._amplitude_grad(rows, self.y.gather(1, mb), z)

    def mb_shape(self, k: int) -> tuple:
        return (self.batch_size, k)

    def select_mb(self, generator: torch.Generator, k: int) -> torch.Tensor:
        """(B, k) distinct measurement indices per lane."""
        return sample_k_indices(self.y.shape, k, generator)

    def full_mb(self) -> torch.Tensor:
        return torch.arange(self.m, device=self.device).expand(self.batch_size, self.m)

    def m_total(self) -> int:
        return self.m

    def psnr(self, z: torch.Tensor) -> torch.Tensor:
        return psnr(self.x, z.reshape(self.x.shape))


def spectral_init(
    a: torch.Tensor, y: torch.Tensor, x_norm: torch.Tensor, tol: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Power iteration on ``D = A^T diag(y) A / M`` per lane, matrix-free:
    ``v <- D v / max(D v)`` from ``v = 2`` until ``|mu - mu_old| <= tol`` or
    ``||v - v_old|| <= tol`` (or 10,000 steps), then
    ``sqrt(mu) * v / ||v|| * x_norm``. A lane that stops is frozen while
    the others go on. Returns ((B, N) init, (B,) int64 steps per lane).

    The stop is fragile: near it ``|mu - mu_old|`` is a few f32 ulps of
    ``mu``, so the step at which it falls under ``tol`` depends on the
    products' rounding. Each lane's products are therefore taken on their
    own (``mv`` per lane), so that a lane stops where it would alone."""
    (bsz, m), n = y.shape, a.shape[-1]
    dev = a.device
    lane_a = [a[i if a.shape[0] > 1 else 0] for i in range(bsz)]

    def dv(v):
        return torch.stack([torch.mv(ai.T, y[i] * torch.mv(ai, v[i])) for i, ai in enumerate(lane_a)]) / m
    v = torch.full((bsz, n), 2.0, device=dev)
    v_old = torch.ones((bsz, n), device=dev)
    mu = torch.ones(bsz, device=dev)
    mu_old = torch.full((bsz,), 2.0, device=dev)
    steps = torch.zeros(bsz, dtype=torch.int64, device=dev)

    def running():
        return (((mu - mu_old).abs() > tol)
                & (torch.linalg.vector_norm(v - v_old, dim=-1) > tol)
                & (steps < MAX_POWER_ITERS))

    go = running()
    while bool(go.any()):
        v_new = dv(v)
        mu_new = v_new.amax(dim=-1)
        keep = go[:, None]
        v, v_old = torch.where(keep, v_new / mu_new[:, None], v), torch.where(keep, v, v_old)
        mu, mu_old = torch.where(go, mu_new, mu), torch.where(go, mu, mu_old)
        steps = steps + go.to(torch.int64)
        go = running()
    scale = torch.sqrt(mu) / torch.linalg.vector_norm(v, dim=-1) * x_norm
    return v * scale[:, None], steps


def make_phase_retrieval(
    image,
    generator: torch.Generator,
    num_meas: int,
    snr: float | None = None,
    sigma: float | None = None,
    device=None,
    stats: dict | None = None,
) -> PhaseRetrieval:
    """A one-lane :class:`PhaseRetrieval` from an (H, W) image on ``device``
    (CUDA unless ``"cpu"`` is passed); ``generator`` must live there too and
    draws A, then the noise. ``stats``, if given, receives the spectral
    initialisation's ``spectral_init_steps`` and ``spectral_init_s``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, problem on {dev}")
    x = torch.as_tensor(np.asarray(image, np.float32), device=dev)[None]
    _, h, w = x.shape
    a = torch.randn((1, num_meas, h * w), generator=generator, device=dev)
    y0 = _matvec(a, x.reshape(1, -1)).abs()
    snr_out, sig = resolve_noise(y0, h, w, snr, sigma, ndim=1)
    y = y0 + sig[:, None] * torch.randn(y0.shape, generator=generator, device=dev)
    t0 = time.perf_counter()
    xi, steps = spectral_init(a, y, torch.linalg.vector_norm(x.reshape(1, -1), dim=-1))
    if stats is not None:
        stats["spectral_init_steps"] = int(steps[0])
        stats["spectral_init_s"] = time.perf_counter() - t0
    return PhaseRetrieval(
        a=a, y=y, x=x, x_init=minmax_normalize(xi.reshape(1, h, w)),
        snr=snr_out.to(torch.float32), sigma=sig.to(torch.float32),
    )
