"""Port parity: the fused aggregation K2 (``ops/cuda/bm3d_aggregate.py``) on
real BM3D estimates, and the host-side geometry both BM3D kernels index
shared memory by.

On the CPU ``bm3d_aggregate`` takes its plain version; the kernel itself is
held against that version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``. The geometry helpers are plain Python, so the
footprints and regions the kernels stage are checked here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu.ops.pallas.bm3d_scatter import bm3d_scatter_pallas
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1


def _stage(size, stage, seed=0):
    """Real stage-``stage`` estimates of a noisy (2, size, size) batch:
    (est, wgt, py, px, geometry) from the port's stage functions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    clean = 0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.0)
    x = torch.tensor((clean[None] + 0.1 * rng.standard_normal((2, size, size))).astype(np.float32))
    p = bm3d.BM3DParams(search=6)
    g = bm3d._geometry(size, size, p, x.device)
    sigma = torch.tensor([0.1, 0.12])
    out = bm3d._stage1(x, sigma, p, g)
    if stage == 2:
        basic, _ = bm3d._aggregate_stage(out, p, g, size, size)
        out = bm3d._stage2(x, basic, sigma, p, g)
    est, wgt, _, py, px = out
    return est, wgt, py, px, g


# The planes reach ~130 at these sizes, where one f32 ulp is 1.5e-5: the
# two packages sum in different orders, so agreement is atol 1e-5 plus 1e-6
# relative (a few ulps).
TOL = dict(atol=1e-5, rtol=1e-6)


def _k2_args(est, wgt, py, px, g, size):
    b, bb = est.shape[0], est.shape[-1]
    idx = (py * (size - 7) + px).reshape(b, -1).to(torch.int32)
    return idx, est.reshape(b, -1, bb), wgt.reshape(b, -1), g.kaiser


@pytest.mark.parametrize("size", [32, 34, 48])  # 34: the last reference block is off the grid
@pytest.mark.parametrize("stage", [1, 2])
def test_plain_k2_matches_jax_aggregate(size, stage):
    est, wgt, py, px, g = _stage(size, stage)
    want_num, want_den = jbm3d._aggregate(
        jnp.asarray(est.numpy()), jnp.asarray(wgt.numpy()), jnp.asarray(py.numpy()),
        jnp.asarray(px.numpy()), 8, size, size, jnp.asarray(g.kaiser.numpy()))
    args = _k2_args(est, wgt, py, px, g, size)
    for num, den in (k2.bm3d_aggregate_plain(*args, size, size), k2.bm3d_aggregate(*args, size, size)):
        np.testing.assert_allclose(num.numpy(), np.asarray(want_num), **TOL)
        np.testing.assert_allclose(den.numpy(), np.asarray(want_den), **TOL)


@pytest.mark.parametrize("size", [32, 34, 48])
def test_plain_k2_matches_pallas_scatter_and_unfold(size):
    est, wgt, py, px, g = _stage(size, 1, seed=1)
    idx, est_f, wgt_f, kai = (t.numpy() for t in _k2_args(est, wgt, py, px, g, size))
    k = est.shape[3]
    wk = np.repeat(wgt_f, k, axis=1)[..., None] * kai  # wk first, then est * wk
    upd = np.concatenate([est_f * wk, np.broadcast_to(wk, est_f.shape)], axis=-1)
    hh = size - 7
    table = bm3d_scatter_pallas(jnp.asarray(idx), jnp.asarray(upd), hh * hh, interpret=True)
    want_num, want_den = jbm3d._unfold_table(table.reshape(2, hh, hh, 2, 8, 8), 8, size, size)
    num, den = k2.bm3d_aggregate_plain(*_k2_args(est, wgt, py, px, g, size), size, size)
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), **TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(want_den), **TOL)


def _members(rows, offsets, size):
    """(nR, S) clipped member coordinates along one axis, as ``_gather_groups``."""
    return np.clip(rows[:, None] + offsets[None, :], 0, size - 8)


GEOMETRIES = [(size, search, step) for size in (34, 48, 128) for search in (6, 8)
              for step in (1, 2)]


@pytest.mark.parametrize("size,search,search_step", GEOMETRIES)
def test_k2_footprints_cover_every_clipped_member(size, search, search_step):
    grid = bm3d._ref_grid(size, 8, 4)
    offs = bm3d.search_offsets(search, search_step)
    oy, ox, fh, fw = k2.footprints(size, size, grid, grid, int(np.abs(offs).max()), 8)
    for origins, tile, along, fsize in ((oy, k2.TILE_R, offs[:, 0], fh),
                                        (ox, k2.TILE_C, offs[:, 1], fw)):
        assert len(origins) == -(-len(grid) // tile)
        members = _members(grid, along, size)  # (n, S)
        for t, origin in enumerate(origins):
            m = members[t * tile : (t + 1) * tile]
            assert origin >= 0 and m.min() >= origin  # the patch starts inside
            assert m.max() + 8 <= origin + fsize  # and ends inside
            assert origin + 8 <= size
    # The headline's 2 x 2 tile at search 8 holds a 28 x 28 footprint.
    if (size, search) == (128, 8):
        assert (fh, fw) == (28, 28) and 2 * k2._WARPS * fh * fw * 4 < 48 * 1024


@pytest.mark.parametrize("size,search,search_step", GEOMETRIES)
def test_k1_tile_regions_hold_every_patch_and_candidate(size, search, search_step):
    grid = bm3d._ref_grid(size, 8, 4)
    offs = bm3d.search_offsets(search, search_step)
    s = int(np.abs(offs).max())
    oy, ox, smem_h, smem_w, ref_rows = k1.tile_regions(grid, grid, s, 8)
    assert ref_rows <= k1._REF_ROWS  # the kernel's register tile of reference rows
    for t in range(len(oy)):
        refs = grid[t * k1.TILE_R : (t + 1) * k1.TILE_R]
        assert refs.max() + 8 - refs[0] <= ref_rows
    for origins, tile, along, extent in ((oy, k1.TILE_R, offs[:, 0], smem_h),
                                         (ox, k1.TILE_C, offs[:, 1], smem_w)):
        for t, origin in enumerate(origins):
            refs = grid[t * tile : (t + 1) * tile]
            assert origin == refs[0] - s
            cand = refs[:, None] + along[None, :]  # unclipped: invalid ones are read too
            assert cand.min() >= origin and cand.max() + 8 <= origin + extent
    # The column plans: reference column j's 8-wide sum is the half sums at
    # two listed positions, all inside the staged region.
    plans = k1.column_plans(grid, s, 8)
    for t, plan in enumerate(plans):
        nb, pos = plan[0], plan[1 : 1 + k1._MAX_COLS]
        lx = grid[t * k1.TILE_C : (t + 1) * k1.TILE_C] - grid[t * k1.TILE_C] + s
        for j, v in enumerate(lx):
            a, b = plan[1 + k1._MAX_COLS + 2 * j : 3 + k1._MAX_COLS + 2 * j]
            assert a < nb and b < nb and pos[a] == v and pos[b] == v + 4
        assert pos[:nb].max() + 4 <= smem_w and len(set(pos[:nb])) == nb
    g = k1.match_geometry(grid, grid, offs, 8, "cpu")
    assert g.pitch % 2 == 1 and g.pitch >= g.smem_w  # odd pitch: conflict-free loads
    assert g.d_pitch % 2 == 1 and g.d_pitch >= len(offs)
    assert g.smem_bytes <= 227 * 1024
