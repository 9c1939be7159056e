"""Row-sharded denoising with halo rows.

Port of ``pnp_svrg_tpu/parallel/spatial.py``. The image rows are split over
an axis (``parallel/mesh.py``); each shard denoises its block extended by
``halo`` rows on each side, with the denoiser told which rows of the
extended block are image rows (``row_valid_bounds``), and keeps the block's
own rows. Shards at the image's edge fill the missing neighbour with their
own reflected rows, which is what ``F.pad(mode="reflect")`` gives the
unsharded denoiser, so a denoiser whose output pixel depends on inputs at
most ``halo`` rows away gives the unsharded result: NLM (halo = patch
distance + patch size) bit for bit. BM3D's halo is ``stages * (search +
block)`` rounded up to the step, its reference grid re-anchors per shard, and
seams differ by aggregation weights only.

The JAX package shifts halos round a ring with ``ppermute``. Here one
``all_gather`` of every shard's top and bottom ``halo`` rows serves every
backend (gloo has no ``send``/``recv`` of CUDA tensors), and each shard takes
its neighbours' rows from it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.parallel.mesh import BATCH_AXIS, MEAS_AXIS, SPATIAL_AXIS, LocalAxis
from pnp_svrg_tpu_torch.parallel.meas import run_local


def _bounds(shard: int, n: int, ext_h: int, halo: int) -> tuple:
    """The image rows ``[lo, hi)`` of shard ``shard``'s extended block: the
    halo at a global edge is padding."""
    return (halo if shard == 0 else 0, ext_h - halo if shard == n - 1 else ext_h)


def denoise_spatial(denoise_fn, blocks: torch.Tensor, axis, halo: int) -> torch.Tensor:
    """Apply ``denoise_fn(ext, (lo, hi)) -> ext-shaped`` to this process's row
    blocks ``blocks`` (local shards, rows, ...) of an image row-sharded over
    ``axis``, with ``halo`` rows from the neighbours; returns the blocks'
    denoised rows, same shape. Each block must have more than ``halo``
    rows."""
    rows = blocks.shape[1]
    if rows < halo + 1:
        raise ValueError(f"shard height {rows} too small for halo {halo}")
    n = axis.size
    edges = torch.stack([blocks[:, :halo], blocks[:, -halo:]], dim=1)  # (local, 2, halo, ...)
    edges = axis.all_gather(edges[:, None], dim=0)  # (n, 2, halo, ...)
    out = []
    for i, s in enumerate(axis.shards):
        x = blocks[i]
        top = x[1:halo + 1].flip(0) if s == 0 else edges[s - 1, 1]
        bot = x[-halo - 1:-1].flip(0) if s == n - 1 else edges[s + 1, 0]
        ext = torch.cat([top, x, bot], dim=0)
        out.append(denoise_fn(ext, _bounds(s, n, ext.shape[0], halo))[halo:halo + rows])
    return torch.stack(out)


def _row_blocks_of(image: torch.Tensor, axis) -> torch.Tensor:
    """This process's row blocks of a full (H, ...) image."""
    h = image.shape[0]
    if h % axis.size:
        raise ValueError(f"image height {h} not divisible by {axis.size} shards")
    rows = h // axis.size
    return torch.stack([image[s * rows:(s + 1) * rows] for s in axis.shards])


def nlm_denoise_spatial(image, h, sigma, mesh, patch_size: int = 4, patch_distance: int = 5,
                        axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """Row-sharded NLM of an (H, W) image held by every rank, equal to
    ``nlm_denoise`` bit for bit; returns the full image on every rank."""
    from pnp_svrg_tpu_torch.ops.cuda.nlm import nlm_denoise

    axis = mesh.axis(axis_name)
    out = denoise_spatial(
        lambda x, bounds: nlm_denoise(x, h, sigma, patch_size, patch_distance,
                                      row_valid_bounds=bounds),
        _row_blocks_of(image, axis), axis, patch_distance + patch_size)
    return axis.all_gather(out, dim=0)


def bm3d_denoise_spatial(image, sigma, mesh, params=None, stages: int = 2,
                         axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """Row-sharded BM3D of an (H, W) image held by every rank, with the halo
    of :meth:`BM3DDenoiser.spatial_halo`; returns the full image on every
    rank. It equals the unsharded BM3D when the height, the shard height and
    the halo are multiples of the step (the shards' reference grids are the
    global one's) up to the aggregation at the seams."""
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams, bm3d_denoise

    p = params or BM3DParams()
    axis = mesh.axis(axis_name)
    out = denoise_spatial(
        lambda x, bounds: bm3d_denoise(x, sigma, params=p, stages=stages, row_valid_bounds=bounds),
        _row_blocks_of(image, axis), axis, BM3DDenoiser(params=p, stages=stages).spatial_halo())
    return axis.all_gather(out, dim=0)


@dataclasses.dataclass(frozen=True)
class SpatialTiledDenoiser:
    """The denoise step of a PnP loop, row-sharded over ``axis``.

    The (B, H, W) iterate is replicated along the axis (images are small;
    what this shards is the denoiser's working set and compute: BM3D's
    patch groups are ~100x the image). Each shard reflect-pads the image by
    ``halo``, cuts its block of ``H / n`` rows plus the halo, denoises it
    with the inner denoiser's ``denoise_bounded`` and the shard's image-row
    bounds, and one ``all_gather`` puts the blocks together again."""

    inner: object
    halo: int
    axis: object

    def denoise(self, x: torch.Tensor, sigma_est: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        xb = x if x.dim() == 3 else x[None]
        n, halo = self.axis.size, self.halo
        rows = xb.shape[1] // n
        xp = F.pad(xb, (0, 0, halo, halo), mode="reflect")
        ext_h = rows + 2 * halo
        out = torch.stack([
            self.inner.denoise_bounded(xp[:, s * rows:s * rows + ext_h], sigma_est, t,
                                       _bounds(s, n, ext_h, halo))[:, halo:halo + rows]
            for s in self.axis.shards])
        full = self.axis.all_gather(out, dim=1)
        return full if x.dim() == 3 else full[0]


def run_batch_spatial(fn, problem, denoiser, mesh, seed: int = 0, **hp) -> dict:
    """Run one PnP loop with the denoise step row-sharded over the mesh's
    spatial axis and the lanes data parallel over its batch axis; the
    full batch's result on every rank. A mesh of ``make_spatial_mesh(...,
    emulate=True)`` runs every shard in this one process."""
    spatial = mesh.axis(SPATIAL_AXIS)
    h = problem.h
    if h % spatial.size:
        raise ValueError(f"image height {h} not divisible by {spatial.size} shards")
    if not hasattr(denoiser, "denoise_bounded"):
        raise TypeError(f"{type(denoiser).__name__} has no bounded/row-sharded denoise path "
                        "(supported: BM3DDenoiser, NLMDenoiser)")
    return run_local(fn, [problem], LocalAxis(MEAS_AXIS, 1), mesh.axis(BATCH_AXIS),
                     SpatialTiledDenoiser(denoiser, denoiser.spatial_halo(), spatial), seed, 2.0 * problem.m, hp,
                     mesh.axes)
