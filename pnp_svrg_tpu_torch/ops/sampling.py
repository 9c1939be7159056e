"""Fixed-count minibatch sampling (port of ``pnp_svrg_tpu/ops/sampling.py``).

Sampling without replacement by the top-k trick: one uniform score per
candidate, -1 outside ``allowed``, keep the k largest. The mask is recovered by
comparing every score with the k-th largest, so no scatter is needed. The
random numbers come from an explicit ``torch.Generator``; they cannot replay
JAX's threefry streams, so only the distribution matches the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def _scores(shape: tuple, ndim: int, generator: torch.Generator, allowed) -> torch.Tensor:
    """(lead..., n) uniform scores over the last ``ndim`` axes of ``shape``
    flattened, -1 where ``allowed`` is not positive."""
    lead, n = shape[: len(shape) - ndim], int(np.prod(shape[len(shape) - ndim :]))
    g = torch.rand(lead + (n,), generator=generator, device=generator.device)
    if allowed is not None:
        g = torch.where(allowed.reshape(lead + (n,)) > 0, g, -1.0)
    return g


def sample_k_indices(
    shape: tuple,
    k: int,
    generator: torch.Generator,
    allowed: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., k) int64 indices, ``k`` distinct ones in ``range(M)`` for each
    row of ``shape`` (..., M), drawn uniformly among the ``allowed > 0``
    positions (which must number at least k): the top-k of the scores."""
    g = _scores(tuple(shape), 1, generator, allowed)
    return torch.topk(g, k, dim=-1).indices


def sample_k_mask(
    shape: tuple,
    k: int,
    generator: torch.Generator,
    allowed: torch.Tensor | None = None,
    ndim: int = 2,
) -> torch.Tensor:
    """0/1 float mask of ``shape`` with exactly ``k`` ones in each slice of
    its last ``ndim`` axes ((H, W) images by default, (M,) vectors with
    ``ndim=1``), drawn uniformly among the ``allowed > 0`` positions.

    Uniform scores are almost surely distinct, so exactly k positions pass
    ``g >= thr``; ``g >= 0`` keeps disallowed positions out.
    """
    shape = tuple(shape)
    g = _scores(shape, ndim, generator, allowed)
    thr = torch.topk(g, k, dim=-1).values[..., -1:]
    mask = (g >= thr) & (g >= 0)
    return mask.to(torch.float32).reshape(shape)
