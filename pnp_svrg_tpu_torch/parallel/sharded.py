"""Phase retrieval with A's rows sharded over the meas axis.

Port of ``pnp_svrg_tpu/parallel/sharded.py``: the dense (M, N) Gaussian A is
the one large measurement operand, so each meas shard holds ``M / n`` of its
rows, forms its partial gradient with two f32 products (plain
``torch.matmul``; the JAX package leaves them to XLA) and one psum over the
meas axis makes the global gradient (``PR.py:75-79`` distributed). Also the
dp x mp PnP step (lanes over ``batch``, rows over ``meas``) of the
multi-chip dry run.
"""

from __future__ import annotations

import dataclasses

import torch

from pnp_svrg_tpu_torch.core.batched import take_lanes
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.parallel.meas import _lane_range, split_meas
from pnp_svrg_tpu_torch.parallel.mesh import BATCH_AXIS, MEAS_AXIS
from pnp_svrg_tpu_torch.problems.pr import _matvec, _rmatvec


def shard_pr_problem(problem, mesh) -> list:
    """This process's part of a batched ``PhaseRetrieval``: its lanes along
    the mesh's batch axis, and for each meas shard it holds, that shard's
    rows of A and y (an A held once stays held once) in memory of their own,
    so that the whole A can be freed; the rest replicated."""
    lane0, count = _lane_range(problem.batch_size, mesh.axis(BATCH_AXIS))
    meas = mesh.axis(MEAS_AXIS)
    split = split_meas(take_lanes(problem, slice(lane0, lane0 + count)), meas.size)
    return [dataclasses.replace(split[s], a=split[s].a.clone(), y=split[s].y.clone())
            for s in meas.shards]


def _rows_total(shards, meas) -> int:
    return shards[0].m * meas.size


def pr_grad_full_sharded(shards: list, z: torch.Tensor, mesh) -> torch.Tensor:
    """The full amplitude gradient (B, N) of this process's lanes from its
    row shards (:func:`shard_pr_problem`): the shards' unnormalised partial
    gradients, one psum over meas, over the global row count."""
    meas = mesh.axis(MEAS_AXIS)
    g = meas.psum(torch.stack([p.grad_sum(z) for p in shards]))
    return g / _rows_total(shards, meas)


def sharded_pnp_step(mesh, denoiser, eta: float):
    """The dp x mp PnP iteration for a batch of phase retrieval problems:
    ``step(shards, z) -> (z', psnr)`` on :func:`shard_pr_problem`'s shards
    and this process's (B_local, N) ``z``: the gradient (``|A z|`` clamped at
    1e-12) psummed over meas, ``z - eta * grad``, the sigma estimate, one
    denoise at ``t = 1`` (on every meas shard, each its own bitwise-equal
    copy) and the PSNR; the batch's ``z'`` and PSNR gathered along the batch
    axis onto every rank."""
    meas, batch = mesh.axis(MEAS_AXIS), mesh.axis(BATCH_AXIS)

    def partial(p, z):
        t = _matvec(p.a, z)
        at = torch.clamp(t.abs(), min=1e-12)
        return _rmatvec(p.a, (at - p.y) / at * t)

    def step(shards, z):
        p = shards[0]
        grad = meas.psum(torch.stack([partial(s, z) for s in shards])) / _rows_total(shards, meas)
        img = (z - eta * grad).reshape(-1, p.h, p.w)
        t = torch.ones(img.shape[0], dtype=torch.int32, device=img.device)
        img = denoiser.denoise(img, estimate_sigma(img), t)
        psnr = 10.0 * torch.log10(1.0 / ((img - p.x) ** 2).mean(dim=(-2, -1)))
        out = img.reshape(z.shape)
        if batch.size > 1:
            return batch.all_gather(out[None], dim=0), batch.all_gather(psnr[None], dim=0)
        return out, psnr

    return step
