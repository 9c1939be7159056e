"""Spectral normalisation of the convolution operator ("real SN").

Port of ``pnp_svrg_tpu/models/spectral_norm.py``. The power iteration runs
on the 3x3 stride-1 SAME convolution itself, not on the kernel reshaped to a
matrix, so ``torch.nn.utils.spectral_norm`` (which normalises the matrix) is
not used: its sigma is another number and the RealSN bound would not hold.

* ``u`` lives in the conv's output space on a fixed probe, here NCHW
  ``(1, C_out, hw, hw)`` (the JAX package's is NHWC ``(1, hw, hw, C_out)``);
* one iteration: ``v = normalize(conv^T u)``, ``u = normalize(conv v)``; the
  adjoint, which the JAX package takes with ``jax.vjp``, is
  ``F.conv_transpose2d(u, W, padding=1)`` for a kernel ``W`` in torch's
  (O, I, 3, 3) layout;
* ``sigma = <u, conv(v)>``, and the kernel is scaled by ``target / sigma``.

Also the BatchNorm spectral clamp (``bn_spectral_clamp``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PROBE_HW = 40  # the reference's probe size

# The reference's adaptive schedule for a 6-layer SimpleCNN: early layers get
# norm headroom, later ones clamp hard; the product is about 1.
ADAPTIVE_SIGMAS_6 = (5.0, 2.0, 1.0, 0.681, 0.464, 0.316)


def _conv_same(v: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NCHW SAME convolution (3x3, stride 1) with an (O, I, 3, 3) kernel."""
    return F.conv2d(v, kernel, padding=kernel.shape[-1] // 2)


def _conv_adjoint(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_conv_same`: output space to input space."""
    return F.conv_transpose2d(u, kernel, padding=kernel.shape[-1] // 2)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def _iterate(kernel: torch.Tensor, u: torch.Tensor, n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    for _ in range(n_iters):
        u = _normalize(_conv_same(_normalize(_conv_adjoint(u, kernel)), kernel))
    return u, _normalize(_conv_adjoint(u, kernel))


def conv_power_iteration(kernel: torch.Tensor, u: torch.Tensor, n_iters: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv operator's largest singular value: ``(sigma, u_new)`` after
    ``n_iters`` iterations from ``u`` (1, C_out, H, W)."""
    u_new, v = _iterate(kernel, u, n_iters)
    return torch.sum(u_new * _conv_same(v, kernel)), u_new


def init_u(cout: int, hw: int = PROBE_HW, generator: torch.Generator | None = None,
           device=None) -> torch.Tensor:
    """A random unit ``u`` of shape (1, cout, hw, hw)."""
    return _normalize(torch.randn((1, cout, hw, hw), generator=generator, device=device))


@torch.no_grad()
def power_iteration_uv(kernel: torch.Tensor, u: torch.Tensor, n_iters: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the power iteration and return ``(u_new, v_new)`` outside the
    gradient: the training-time contract of torch's ``spectral_norm``, where
    the pair is iterated without grad and ``sigma = <u, W v>`` is then
    differentiated with u and v held fixed (:func:`sigma_uv`)."""
    return _iterate(kernel, u, n_iters)


def sigma_uv(kernel: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sigma = <u, conv(v, W)>``: linear, hence differentiable, in the
    kernel for fixed u and v. Dividing the kernel by it inside the forward
    pass lets gradients flow through the normalisation; a post-step
    projection instead shrinks every learned update and collapses the model
    to the zero predictor."""
    return torch.sum(u * _conv_same(v, kernel))


def spectrally_normalize_kernel(kernel: torch.Tensor, u: torch.Tensor, target: float = 1.0,
                                n_iters: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(kernel * target / sigma, sigma, u_new)``."""
    sigma, u_new = conv_power_iteration(kernel, u, n_iters)
    return kernel * (target / sigma), sigma, u_new


def realsn_target(lip: float = 0.3, depth: int = 17) -> float:
    """Per-layer Lipschitz target of a depth-layer net with product bound
    ``lip``."""
    return float(lip ** (1.0 / depth))


def realsn_targets(lip: float, depth: int, adaptive=None) -> tuple[float, ...]:
    """Per-layer sigma targets of a ``depth``-conv stack: ``lip^(1/depth)``
    each, or the explicit list ``adaptive`` (e.g. :data:`ADAPTIVE_SIGMAS_6`),
    whose length must equal ``depth``."""
    if adaptive is not None:
        sigmas = tuple(float(s) for s in adaptive)
        if len(sigmas) != depth:
            raise ValueError(
                f"Length of SN list ({len(sigmas)}) incompatible with num of layers ({depth})"
            )
        return sigmas
    return (realsn_target(lip, depth),) * depth


def bn_spectral_clamp(scale: torch.Tensor, bias: torch.Tensor, running_var: torch.Tensor,
                      target: float = 1.0, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp a BatchNorm layer's operator norm to ``target`` by scaling
    (scale, bias) together when ``max |scale| / sqrt(var + eps)`` exceeds
    it."""
    sigma_cur = torch.max(torch.abs(scale) / torch.sqrt(running_var + eps))
    coef = torch.where(sigma_cur > target, target / sigma_cur, torch.ones_like(sigma_cur))
    return scale * coef, bias * coef
