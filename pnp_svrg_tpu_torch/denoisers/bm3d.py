"""Two-stage BM3D over a (B, H, W) image batch.

Port of ``pnp_svrg_tpu/denoisers/bm3d.py`` (Dabov et al. 2007, fixed group
size K): block matching, a 3-D transform (2-D DCT per patch x Walsh-Hadamard
along the group) with hard thresholding, weighted overlap-add aggregation;
then a Wiener stage that matches on the stage-1 estimate.

Two steps run hand-written CUDA kernels on the card and their plain PyTorch
versions on the CPU:

* block matching: K1, ``ops/cuda/bm3d_match.py``, in the rounding mode that
  ``BM3DParams.matcher`` and ``match_dtype`` name;
* the aggregation: K2, ``ops/cuda/bm3d_aggregate.py``, the patch
  scatter-add and the static overlap-add back to image space in one pass
  (its plain version builds the (B, hh*ww, 2*b*b) patch-position table and
  folds it with ``torch.nn.functional.fold``).

The 3-D transform is one (K*b*b)-wide ``torch.matmul`` with
``kron(H_K, D (x) D)``, as the JAX package leaves it to XLA.

When the search offsets are grid-aligned (``search_step`` a multiple of
``step`` and the reference grid the full lattice), the aggregation is the
scatter-free ``_aggregate_dense`` instead: a one-hot contraction over group
slots and a clamp-shift contraction, both ``torch.einsum`` as the JAX package
leaves them to XLA; K2 does not run there.

``topk="approx"`` takes the exact top-k: off the TPU the JAX package's
``jax.lax.approx_min_k`` returns the exact k smallest distances, and only the
order of tied indices may differ from ``exact``'s; here ties go to the lowest
offset index, as with ``exact``.

``row_valid_bounds=(lo, hi)`` (the row-sharded spatial path,
``parallel/spatial.py``) marks the rows outside ``[lo, hi)`` as padding, as
the JAX package does (``bm3d.py:423-450``): K1 matches no candidate there,
reference blocks there get aggregation weight 0 in both stages, the dense
aggregation is off, and the matching rounds as the XLA matcher does
(``bf16_xla`` for a bf16 ``match_dtype``, whatever ``matcher`` says).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pnp_svrg_tpu_torch.ops.cuda.bm3d_aggregate import (
    AggregateGeometry,
    aggregate_geometry,
    aggregate_plan,
    bm3d_aggregate,
    unfold_table,
)
from pnp_svrg_tpu_torch.ops.cuda.bm3d_match import MatchGeometry, bm3d_match, match_geometry
from pnp_svrg_tpu_torch.ops.transforms import dct_matrix, hadamard_matrix, kaiser2d


@dataclasses.dataclass(frozen=True)
class BM3DParams:
    """Static BM3D configuration (same fields and defaults as the reference)."""

    block: int = 8  # patch edge
    step: int = 4  # reference-block stride
    search: int = 12  # search radius (window (2r+1)^2 offsets)
    group_ht: int = 16  # group size, hard-threshold stage
    group_wie: int = 16  # group size, Wiener stage
    lam: float = 2.7  # hard threshold = lam * sigma
    kaiser_beta: float = 2.0
    match_dtype: str = "float32"  # "bfloat16": bf16 match distances
    topk: str = "exact"  # "approx" takes the exact top-k (ties to the lowest offset)
    matcher: str = "xla"  # "xla"/"auto" or "pallas"/"pallas_interpret":
    # names which JAX matcher's bf16 rounding the port follows
    search_step: int = 1  # candidate-offset stride within the window


def match_mode(p: BM3DParams, bounded: bool = False) -> str:
    """The K1 rounding mode for these parameters (see ``ops/cuda/bm3d_match.py``);
    row bounds always take the XLA matcher's."""
    if p.match_dtype == "float32":
        return "f32"
    if p.match_dtype != "bfloat16":
        raise ValueError(f"unknown match_dtype {p.match_dtype!r}")
    if bounded or p.matcher in ("xla", "auto"):
        return "bf16_xla"
    if p.matcher in ("pallas", "pallas_interpret"):
        return "bf16_pallas"
    raise ValueError(f"unknown matcher {p.matcher!r}")


def _ref_grid(size: int, block: int, step: int) -> np.ndarray:
    """Reference-block coordinates: stride grid, last block always included."""
    last = size - block
    pts = list(range(0, last + 1, step))
    if pts[-1] != last:
        pts.append(last)
    return np.asarray(pts, np.int32)


def search_offsets(search: int, search_step: int) -> np.ndarray:
    """(S, 2) (dy, dx) offsets of the window, or its ``search_step``
    sublattice, in ascending index order (``bm3d.py:418-420``)."""
    d1 = (search_step * np.arange(-(search // search_step), search // search_step + 1))
    return np.asarray([(dy, dx) for dy in d1 for dx in d1], np.int32)


@dataclasses.dataclass(frozen=True)
class _Geometry:
    rows: np.ndarray
    cols: np.ndarray
    offsets: np.ndarray
    rows_t: torch.Tensor
    cols_t: torch.Tensor
    offsets_t: torch.Tensor
    kaiser: torch.Tensor  # (b*b,)
    t3_ht: torch.Tensor
    t3_wie: torch.Tensor
    match: MatchGeometry | None  # K1's device-side grid, offsets and layout (CUDA only)
    agg: AggregateGeometry | None  # K2's footprints (CUDA, and not the dense path)
    # Dense aggregation only: (S, nR, nR) and (S, nC, nC) clamp-shift matrices.
    shift_y: torch.Tensor | None
    shift_x: torch.Tensor | None


def dense_aggregation(h: int, w: int, p: BM3DParams) -> bool:
    """Whether every group member lands on the reference lattice, so the
    aggregation is ``_aggregate_dense`` (``bm3d.py:423-429``)."""
    return (
        p.search_step > 1
        and p.search_step % p.step == 0
        and (h - p.block) % p.step == 0
        and (w - p.block) % p.step == 0
    )


@functools.lru_cache(maxsize=8)
def _clamp_shift_mats(q_list: tuple, n: int) -> np.ndarray:
    """(S, n, n) stack of 0/1 clamp-shift matrices: ``M[s, t, i] = 1`` iff
    ``clip(i + q_list[s], 0, n-1) == t``, the lattice image of
    ``_gather_groups``' coordinate clip for grid-aligned offsets."""
    mats = np.zeros((len(q_list), n, n), np.float32)
    for s, q in enumerate(q_list):
        for i in range(n):
            mats[s, int(np.clip(i + q, 0, n - 1)), i] = 1.0
    return mats


@functools.lru_cache(maxsize=16)
def _geometry(h: int, w: int, p: BM3DParams, device: torch.device,
              bounded: bool = False) -> _Geometry:
    """Grid, offsets and transform matrices, made once per shape and device so
    the reconstruction loop copies nothing from the host. Row bounds turn
    the dense aggregation off (``bm3d.py:423-429``)."""
    rows = _ref_grid(h, p.block, p.step)
    cols = _ref_grid(w, p.block, p.step)
    offsets = search_offsets(p.search, p.search_step)
    d2 = dct_matrix(p.block)
    d2d = np.kron(d2, d2)  # 2-D DCT on row-major-flattened patches

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    on_card = torch.device(device).type == "cuda"
    shift_y = shift_x = agg = None
    if dense_aggregation(h, w, p) and not bounded:
        q = offsets // p.step
        shift_y = dev(_clamp_shift_mats(tuple(q[:, 0].tolist()), len(rows)))
        shift_x = dev(_clamp_shift_mats(tuple(q[:, 1].tolist()), len(cols)))
    elif on_card:
        agg = aggregate_geometry(h, w, tuple(rows.tolist()), tuple(cols.tolist()),
                                 int(np.abs(offsets).max()), p.block, torch.device(device))
        for k in (p.group_ht, p.group_wie):  # K2's refusals, before K1 launches
            aggregate_plan(agg, k)
    return _Geometry(
        rows=rows, cols=cols, offsets=offsets,
        rows_t=dev(rows, torch.int64), cols_t=dev(cols, torch.int64),
        offsets_t=dev(offsets, torch.int64),
        kaiser=dev(kaiser2d(p.block, p.kaiser_beta).reshape(-1)),
        t3_ht=dev(np.kron(hadamard_matrix(p.group_ht), d2d)),
        t3_wie=dev(np.kron(hadamard_matrix(p.group_wie), d2d)),
        match=match_geometry(rows, cols, offsets, p.block, device) if on_card else None,
        agg=agg, shift_y=shift_y, shift_x=shift_x,
    )


def _patch_tensor(imgs: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H-b+1, W-b+1, b, b) strided view of all patches; flattening the
    last two axes row-major gives the reference's (ky, kx) patch order."""
    return imgs.unfold(1, block, 1).unfold(2, block, 1)


def _gather_groups(imgs, g: _Geometry, top_idx, block):
    """(B, nR, nC, K, b*b) patch groups for top-K offset indices, with member
    coordinates clipped to the image; also returns their (py, px)."""
    b, h, w = imgs.shape
    off = g.offsets_t[top_idx.to(torch.int64)]  # (B, nR, nC, K, 2)
    py = torch.clamp(g.rows_t[None, :, None, None] + off[..., 0], 0, h - block)
    px = torch.clamp(g.cols_t[None, None, :, None] + off[..., 1], 0, w - block)
    bi = torch.arange(b, device=imgs.device)[:, None, None, None]
    groups = _patch_tensor(imgs, block)[bi, py, px]  # (B, nR, nC, K, b, b)
    return groups.reshape(*groups.shape[:4], block * block), py, px


def _transform_3d(groups_flat, t3):
    """Forward 3-D transform as ONE (K*b*b)-wide matmul."""
    return groups_flat @ t3.T


def _itransform_3d(coeffs_flat, t3):
    return coeffs_flat @ t3  # t3 is orthonormal: inverse = transpose


def _aggregate(est_groups, weights, py, px, block, h, w, kaiser,
               agg: AggregateGeometry | None):
    """Weighted overlap-add of patch estimates, then ``num / den``: K2 adds
    each member's ``est * wk`` and ``wk`` into the (num, den) planes in one
    pass. Also returns K2's arguments (idx, est, wgt, kaiser, h, w,
    geometry)."""
    b, bb = est_groups.shape[0], est_groups.shape[-1]
    idx = (py * (w - block + 1) + px).reshape(b, -1).to(torch.int32)
    args = (idx, est_groups.reshape(b, -1, bb), weights.reshape(b, -1), kaiser, h, w, agg)
    num, den = bm3d_aggregate(*args)
    return num / torch.clamp(den, min=1e-12), args


def _aggregate_dense(est_groups, weights, top_idx, block, step, h, w, kaiser,
                     shift_y, shift_x):
    """Scatter-free aggregation for grid-aligned offsets (``bm3d.py:343-392``):
    every member lands on a reference-grid position, so a one-hot
    contraction over group slots gives per-offset contribution grids, the
    clamp-shift matrices move them onto the lattice (folding border members
    as ``_gather_groups``' clip does), and a strided upsample fills the
    patch-position table for the shared unfold-add."""
    b, nr, nc, k, bb = est_groups.shape
    s = shift_y.shape[0]
    hh, ww = h - block + 1, w - block + 1
    wk = weights[..., None] * kaiser  # (B, nR, nC, b*b)
    offs = torch.arange(s, device=top_idx.device)
    oh = (top_idx[..., None].to(torch.int64) == offs).to(est_groups.dtype)  # (B,nR,nC,K,S)
    c_num = torch.einsum("bijks,bijkp->bsijp", oh, est_groups) * wk[:, None]
    cnt = oh.sum(dim=3)  # (B, nR, nC, S) members per offset
    c_den = cnt.permute(0, 3, 1, 2)[..., None] * wk[:, None]
    c = torch.cat([c_num, c_den], dim=-1)  # (B, S, nR, nC, 2*b*b)
    grid = torch.einsum("sti,bsijp,suj->btup", shift_y, c, shift_x)  # (B, nR, nC, 2*b*b)
    table = torch.zeros((b, hh, ww, 2 * bb), dtype=torch.float32, device=est_groups.device)
    table[:, ::step, ::step] = grid
    num, den = unfold_table(table.reshape(b, hh * ww, 2 * bb), block, h, w)
    return num / torch.clamp(den, min=1e-12)


def _check_supported(p: BM3DParams):
    if p.topk not in ("exact", "approx"):
        raise ValueError(f"unknown topk {p.topk!r}; have 'exact' and 'approx'")


def _ref_weight(g: _Geometry, p: BM3DParams, bounds):
    """1, or under row bounds (1, nR, 1) with 0 for the reference blocks
    that are not wholly inside ``[lo, hi)`` (``bm3d.py:437-442``)."""
    if bounds is None:
        return 1.0
    lo, hi = bounds
    return ((g.rows_t >= lo) & (g.rows_t <= hi - p.block)).to(torch.float32)[None, :, None]


def _match(x, p: BM3DParams, g: _Geometry, k: int, bounds):
    return bm3d_match(x, g.rows, g.cols, g.offsets, p.block, k, match_mode(p, bounds is not None),
                      geometry=g.match, row_valid_bounds=bounds)


def _stage1(x, sigma, p: BM3DParams, g: _Geometry, bounds=None):
    """Hard-thresholding stage up to aggregation: (est, weights, top_idx, py, px)."""
    sig_g = sigma[:, None, None]
    sig_c = sigma[:, None, None, None]
    bb = p.block * p.block
    top_idx = _match(x, p, g, p.group_ht, bounds)
    groups, py, px = _gather_groups(x, g, top_idx, p.block)
    coeffs = _transform_3d(groups.reshape(*groups.shape[:3], -1), g.t3_ht)
    keep = coeffs.abs() > p.lam * sig_c
    coeffs_ht = torch.where(keep, coeffs, 0.0)
    n_kept = torch.clamp(keep.sum(dim=-1), min=1).to(torch.float32)
    est = _itransform_3d(coeffs_ht, g.t3_ht).reshape(*groups.shape[:3], -1, bb)
    wgt = _ref_weight(g, p, bounds) / (sig_g * sig_g * n_kept + 1e-12)
    return est, wgt, top_idx, py, px


def _stage2(x, basic, sigma, p: BM3DParams, g: _Geometry, bounds=None):
    """Wiener stage up to aggregation, matching on the stage-1 estimate:
    (est, weights, top_idx, py, px)."""
    sig_g = sigma[:, None, None]
    sig_c = sigma[:, None, None, None]
    bb = p.block * p.block
    top_idx = _match(basic, p, g, p.group_wie, bounds)
    g_basic, py, px = _gather_groups(basic, g, top_idx, p.block)
    g_noisy, _, _ = _gather_groups(x, g, top_idx, p.block)
    c_basic = _transform_3d(g_basic.reshape(*g_basic.shape[:3], -1), g.t3_wie)
    c_noisy = _transform_3d(g_noisy.reshape(*g_noisy.shape[:3], -1), g.t3_wie)
    wien = c_basic**2 / (c_basic**2 + sig_c * sig_c + 1e-12)
    est = _itransform_3d(wien * c_noisy, g.t3_wie).reshape(*g_basic.shape[:3], -1, bb)
    wgt = _ref_weight(g, p, bounds) / (sig_g * sig_g * (wien**2).sum(dim=-1) + 1e-12)
    return est, wgt, top_idx, py, px


def _aggregate_stage(stage_out, p: BM3DParams, g: _Geometry, h, w):
    """The stage's estimate by the aggregation its geometry selects, and the
    arguments handed to K2 (None on the dense path, which runs no K2)."""
    est, wgt, top_idx, py, px = stage_out
    if g.shift_y is not None:
        return _aggregate_dense(est, wgt, top_idx, p.block, p.step, h, w, g.kaiser,
                                g.shift_y, g.shift_x), None
    return _aggregate(est, wgt, py, px, p.block, h, w, g.kaiser, g.agg)


def _denoise(images, sigma, p: BM3DParams, stages: int, row_valid_bounds):
    """(estimate, stage-1 K2 arguments or None)."""
    x = images.to(torch.float32)
    b, h, w = x.shape
    _check_supported(p)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).expand(b)
    bounds = row_valid_bounds
    g = _geometry(h, w, p, x.device, bounds is not None)
    basic, agg_in = _aggregate_stage(_stage1(x, sigma, p, g, bounds), p, g, h, w)
    if stages == 1:
        return basic, agg_in
    out, _ = _aggregate_stage(_stage2(x, basic, sigma, p, g, bounds), p, g, h, w)
    return out, agg_in


def bm3d_denoise_batch(
    images: torch.Tensor,
    sigma,
    params: BM3DParams = BM3DParams(),
    stages: int = 2,
    row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """Two-stage BM3D over (B, H, W) ``images`` with per-image ``sigma``
    ((B,) or scalar). ``stages=1`` runs hard thresholding only;
    ``row_valid_bounds``: integer ``(lo, hi)``, rows outside are padding."""
    return _denoise(images, sigma, params, stages, row_valid_bounds)[0]


def stage1_aggregate_inputs(images, sigma, params: BM3DParams = BM3DParams()):
    """The stage-1 basic estimate and the (idx, est, wgt, kaiser, h, w,
    geometry) that its aggregation hands to K2 -- real inputs for checking
    the kernels (None on the dense path)."""
    return _denoise(images, sigma, params, 1, None)


def bm3d_denoise(image, sigma, params: BM3DParams = BM3DParams(), stages: int = 2,
                 row_valid_bounds=None):
    """Two-stage BM3D of a single (H, W) image."""
    return bm3d_denoise_batch(image[None], sigma, params, stages, row_valid_bounds)[0]


@dataclasses.dataclass(frozen=True)
class BM3DDenoiser:
    """PnP denoiser with the reference sigma contract: ``sigma_modifier *
    sigma_est`` where the estimate is positive, else
    ``denoise_strength * decay**t``. Fields may be floats or (B,) tensors."""

    denoise_strength: torch.Tensor | float = 0.0
    sigma_modifier: torch.Tensor | float = 1.0
    decay: torch.Tensor | float = 1.0
    params: BM3DParams = BM3DParams()
    stages: int = 2

    def _sigma(self, sigma_est, t):
        fallback = self.denoise_strength * self.decay**t
        return torch.where(sigma_est > 0, sigma_est * self.sigma_modifier, fallback)

    def denoise(self, x: torch.Tensor, sigma_est: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigma = self._sigma(sigma_est, t)
        if x.dim() == 3:
            return bm3d_denoise_batch(x, sigma, params=self.params, stages=self.stages)
        return bm3d_denoise(x, sigma, params=self.params, stages=self.stages)

    def denoise_bounded(self, x, sigma_est, t, row_valid_bounds: tuple) -> torch.Tensor:
        """The same step with the rows outside ``row_valid_bounds = (lo, hi)``
        as padding (a halo-extended block of the row-sharded spatial path)."""
        xb = x if x.dim() == 3 else x[None]
        out = bm3d_denoise_batch(xb, self._sigma(sigma_est, t), params=self.params,
                                 stages=self.stages, row_valid_bounds=row_valid_bounds)
        return out if x.dim() == 3 else out[0]

    def spatial_halo(self) -> int:
        """Rows of halo for row-sharded denoising: each stage is exact only
        ``search + block`` rows inside the halo and the Wiener stage matches
        again on the stage-1 estimate, so the halo adds up over the stages;
        rounded up to the reference step so that the shards' reference grids
        are the global one's (``bm3d.py:584-594``)."""
        halo = self.stages * (self.params.search + self.params.block)
        return halo + (-halo) % self.params.step
