"""Fixed-count minibatch sampling (port of ``pnp_svrg_tpu/ops/sampling.py``).

Sampling without replacement by the top-k trick: one uniform score per
candidate, -1 outside ``allowed``, keep the k largest. The mask is recovered by
comparing every score with the k-th largest, so no scatter is needed. The
random numbers come from an explicit ``torch.Generator``; they cannot replay
JAX's threefry streams, so only the distribution matches the reference.
"""

from __future__ import annotations

import torch


def sample_k_mask(
    shape: tuple,
    k: int,
    generator: torch.Generator,
    allowed: torch.Tensor | None = None,
) -> torch.Tensor:
    """0/1 float mask of ``shape`` (..., H, W) with exactly ``k`` ones in each
    (H, W) slice, drawn uniformly among the ``allowed > 0`` positions.

    Uniform scores are almost surely distinct, so exactly k positions pass
    ``g >= thr``; ``g >= 0`` keeps disallowed positions out.
    """
    shape = tuple(shape)
    lead, n = shape[:-2], shape[-2] * shape[-1]
    g = torch.rand(lead + (n,), generator=generator, device=generator.device)
    if allowed is not None:
        g = torch.where(allowed.reshape(lead + (n,)) > 0, g, -1.0)
    thr = torch.topk(g, k, dim=-1).values[..., -1:]
    mask = (g >= thr) & (g >= 0)
    return mask.to(torch.float32).reshape(shape)
