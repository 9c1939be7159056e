"""Numerical gradient checks of a problem's ``grad_full`` and ``grad_stoch``.

Port of ``pnp_svrg_tpu/core/checks.py`` (the reference's
``Problem.grad_full_check`` and ``grad_stoch_check``,
``problems/problem.py:131-175``):

* :func:`grad_full_check` compares ``n_dirs`` random *directional*
  derivatives, ``<grad, d>`` against the central difference
  ``(f(z + eps d) - f(z - eps d)) / (2 eps)``, in float64;
* :func:`grad_stoch_check` uses that every ``grad_stoch`` is linear in its
  minibatch indicator: ``grad_stoch(z, full_mb) / m_total == grad_full(z)``
  is the reference's "sum of all singleton stochastic gradients / M"
  identity in one evaluation.

The port's problems carry a batch axis, so each lane is checked and the
largest error over the lanes is returned. Both raise
:class:`GradientCheckError` beyond ``tol``.
"""

from __future__ import annotations

import dataclasses

import torch


class GradientCheckError(AssertionError):
    """Analytic gradient disagrees with its numerical check."""


_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def widen(problem):
    """The problem with every float32 tensor field as float64 and every
    complex64 field as complex128, on the same device: central differences
    of the data-fidelity term cancel catastrophically in f32 (f is O(100),
    the directional signal O(1e-6))."""
    changes = {}
    for f in dataclasses.fields(problem):
        v = getattr(problem, f.name)
        if isinstance(v, torch.Tensor) and v.dtype in _WIDER:
            changes[f.name] = v.to(_WIDER[v.dtype])
    return dataclasses.replace(problem, **changes)


def _lanes(problem, z) -> torch.Tensor:
    return (problem.x_init if z is None else z).reshape(problem.batch_size, -1)


def grad_full_check(
    problem,
    z=None,
    generator: torch.Generator | None = None,
    eps: float = 1e-6,
    tol: float = 1e-4,
    n_dirs: int = 8,
    raise_on_fail: bool = True,
) -> float:
    """Directional finite-difference check of ``problem.grad_full`` in
    float64 (the reference checks in numpy f64 with the same eps and tol).

    For ``n_dirs`` random unit directions d per lane, drawn in float64 from
    ``generator`` (seed 0 on the problem's device by default), compares
    ``<grad_full(z), d>`` with the central difference of ``problem.f``.
    Where the problem has ``grad_scale()`` (CSMRI keeps the reference's
    gradient rescaled by 1/m0), the gradient is multiplied by it first.
    Returns the largest over the lanes of the max error relative to the
    lane's largest directional derivative."""
    p64 = widen(problem)
    dev = p64.x_init.device
    z64 = _lanes(problem, z).to(device=dev, dtype=torch.float64)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    g = p64.grad_full(z64).reshape(z64.shape)
    if hasattr(p64, "grad_scale"):
        g = torch.as_tensor(p64.grad_scale(), dtype=torch.float64, device=dev).reshape(-1, 1) * g
    dirs = torch.randn((n_dirs,) + tuple(z64.shape), generator=generator, dtype=torch.float64, device=dev)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    fd = torch.stack([(p64.f(z64 + eps * d) - p64.f(z64 - eps * d)) / (2 * eps) for d in dirs])
    an = (g[None] * dirs).sum(dim=-1)  # (n_dirs, B)
    scale = torch.clamp(an.abs().amax(dim=0), min=1e-12)
    err = float(((fd - an).abs().amax(dim=0) / scale).max())
    if raise_on_fail and err > tol:
        raise GradientCheckError(
            f"grad_full_check failed: max relative directional error {err:.3e} "
            f"> tol {tol:.1e} (fd={fd.tolist()}, analytic={an.tolist()})"
        )
    return err


def grad_stoch_check(
    problem,
    z=None,
    tol: float = 1e-6,
    raise_on_fail: bool = True,
) -> float:
    """Unbiasedness identity check of ``problem.grad_stoch``:
    ``grad_stoch(z, full_mb()) / m_total() == grad_full(z)`` in the
    problem's own precision (pass :func:`widen` of it for float64). Returns
    the largest over the lanes of the max deviation relative to the lane's
    largest gradient entry."""
    z = _lanes(problem, z)
    m = torch.as_tensor(problem.m_total(), dtype=z.dtype, device=z.device).reshape(-1, 1)
    lhs = problem.grad_stoch(z, problem.full_mb()).reshape(z.shape) / m
    rhs = problem.grad_full(z).reshape(z.shape)
    scale = torch.clamp(rhs.abs().amax(dim=-1), min=1e-20)
    err = float(((lhs - rhs).abs().amax(dim=-1) / scale).max())
    if raise_on_fail and err > tol:
        raise GradientCheckError(
            f"grad_stoch_check failed: max relative deviation {err:.3e} "
            f"> tol {tol:.1e}"
        )
    return err
