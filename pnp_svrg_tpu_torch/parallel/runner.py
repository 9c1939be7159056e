"""Batched multi-image reconstruction over a mesh.

Port of ``pnp_svrg_tpu/parallel/runner.py``: one PnP loop over a batch of
problems (the reference fans images out over a ``multiprocessing.Pool``),
with the lanes split over the ranks of the mesh's ``batch`` axis, the
measurements over a ``meas`` axis, or the denoise step's rows over a
``spatial`` axis. Every rank returns the whole batch's result.
"""

from __future__ import annotations

import torch

from pnp_svrg_tpu_torch.algorithms.loops import _ALGOS
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.parallel.meas import lane_seed, run_batch_meas_sharded, run_local
from pnp_svrg_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    MEAS_AXIS,
    SPATIAL_AXIS,
    LocalAxis,
    make_spatial_mesh,
    world_size,
)
from pnp_svrg_tpu_torch.parallel.spatial import run_batch_spatial


def run_batch(algo: str, problems, denoiser, seed: int = 0, mesh=None,
              image_shards: int | None = None, **hp) -> dict:
    """Run one PnP loop over a problem batch (a batched problem or a list,
    stacked here) and return ``z``, ``image``, ``psnr_per_iter``,
    ``final_psnr``, ``psnr_before_denoise`` and ``sigma_est`` of the whole
    batch on every rank.

    * ``image_shards=k``: the denoise step row-sharded over a spatial axis
      of size k (``parallel/spatial.py``; BM3D and NLM). Without a mesh:
      a (world / k, k) mesh over the process group, or in a single process
      the k shards emulated in it.
    * a mesh with a ``meas`` axis larger than 1: the measurements split over
      it (``parallel/meas.py``).
    * otherwise each rank of the mesh's ``batch`` axis runs its ``B / W``
      lanes (all of them without a mesh).

    Minibatches come from one stream a (meas shard, lane) pair seeded from
    ``seed`` (:func:`~pnp_svrg_tpu_torch.parallel.meas.lane_seed`), so the
    result does not depend on how lanes are laid out over ranks; injected
    ``masks`` / ``mb0`` carry a leading meas-shard axis (1 without one).
    SAGA's ``table_axis`` may name a mesh axis."""
    if isinstance(problems, (list, tuple)):
        problems = stack_problems(problems)
    if algo not in _ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}; have {sorted(_ALGOS)}")
    fn = _ALGOS[algo]
    if image_shards is not None and image_shards > 1:
        if mesh is None:
            n = world_size()
            mesh = (make_spatial_mesh((n // image_shards, image_shards), device=problems.device)
                    if n > 1 else
                    make_spatial_mesh((1, image_shards), device=problems.device, emulate=True))
        elif mesh.shape.get(SPATIAL_AXIS) != image_shards:
            raise ValueError(f"mesh {mesh.shape} has no spatial axis of size {image_shards}; "
                             "build one with make_spatial_mesh")
        return run_batch_spatial(fn, problems, denoiser, mesh, seed, **hp)
    if mesh is not None and mesh.shape.get(MEAS_AXIS, 1) > 1:
        return run_batch_meas_sharded(fn, problems, denoiser, mesh, seed, **hp)
    batch = mesh.axis(BATCH_AXIS) if mesh is not None else LocalAxis(BATCH_AXIS, 1)
    return run_local(fn, [problems], LocalAxis(MEAS_AXIS, 1), batch, denoiser, seed,
                     2.0 * problems.m, hp, mesh.axes if mesh is not None else {})


def reconstruct_set12(algo: str, make_problem, denoiser, h: int = 128, w: int = 128, mesh=None,
                      seed: int = 0, device=None, **hp) -> dict:
    """One problem a Set12 image, reconstructed as one batch.

    ``make_problem(image, generator) -> problem`` builds a one-lane problem
    (e.g. ``lambda im, g: make_csmri(im, g, sample_prob=0.5, snr=10,
    device=dev)``); image i's generator is seeded from ``(seed, i)``."""
    from pnp_svrg_tpu_torch.utils.io import load_image, set12_paths

    dev = resolve_device(device)
    problems = [make_problem(load_image(p, h, w),
                             torch.Generator(device=dev).manual_seed(lane_seed(seed, 0, i)))
                for i, p in enumerate(set12_paths())]
    return run_batch(algo, stack_problems(problems), denoiser, seed=seed + 1, mesh=mesh, **hp)
