"""K1's choice of kernel and the block-8 tile kernel's host-made plans, on
the CPU.

``match_kernel`` (``ops/cuda/bm3d_match.py``) names the kernel that takes a
K1 call on the card: ``bm3d_match_kernel`` keeps every call it took before
the tile kernel existed (the headline's, the bench lanes', the sweep's, the
drivers' and the spatial path's shards), ``bm3d_match_tile_kernel`` takes
block 8 otherwise (the reference profile's step 3 at 1,521 and 2,401
offsets, 16 and 32 matches, and every step 1-8), ``bm3d_match_span_kernel``
the other blocks, and ``bm3d_match_any_kernel`` only grids that do not
strictly ascend (``tests/test_torch_k1_span.py`` holds the span kernel's
plans). The tile kernel's plans (``tile_plan``) cut each axis of
the reference grid into tiles whose patches span at most ``TILE_SPAN``
pixels; here each plan is held to what the kernel reads of it: every
reference column's 8-wide sum taken once, from exactly its 8 columns, and
every tile inside the kernel's shared-memory and register constants. The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import collections

import pytest

import chip_smoke
from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, CSMRI_BATCH_LANES, bench_config
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1

FIRST, TILE, ANY, SPAN = k1.K1_KERNELS
KERNEL_COLS = k1.TILE_SPAN - 8 + 1  # kTileCols: span columns an 8-wide sum can start at
MAX_SMEM = 227 * 1024


def _geometry(p: bm3d.BM3DParams, h: int, w: int | None = None) -> k1.MatchGeometry:
    return k1.match_geometry(bm3d._ref_grid(h, p.block, p.step), bm3d._ref_grid(w or h, p.block, p.step),
                             bm3d.search_offsets(p.search, p.search_step), p.block, "cpu")


def _first_kernel_calls() -> dict:
    """label -> (params, height, width) of every lane that ran
    bm3d_match_kernel before the tile kernel: the headline's CSMRI lanes,
    the bench lanes, the sweep, the drivers and the spatial path's shard."""
    calls = {label: (chip_smoke.CSMRI_LANES[label][3], 128, 128) for label in ("headline", "turbo", "turbo4")}
    calls |= {label: (spec[3], 128, 128) for label, spec in CSMRI_BATCH_LANES.items()}
    for label in ("pr_bm3d", "deblur_bm3d", "deblur_sr_bm3d"):
        cfg = bench_config(label)
        calls[label] = (cfg["params"], cfg["size"], cfg["size"])
    calls["sweep_and_drivers"] = (bm3d.BM3DParams(search=8), 128, 128)
    calls["drivers_256px"] = (bm3d.BM3DParams(search=8), 256, 256)
    calls["spatial_shard"] = (bm3d.BM3DParams(search=8), 192, 256)  # a 256 px image's halo-extended half
    return calls


@pytest.mark.parametrize("label", list(_first_kernel_calls()))
def test_match_kernel_keeps_the_first_kernels_calls(label):
    p, h, w = _first_kernel_calls()[label]
    g = _geometry(p, h, w)
    for k in (p.group_ht, p.group_wie):
        assert k1.match_kernel(g, p.block, k) == FIRST


@pytest.mark.parametrize("row,k", [("profile_ht", 16), ("profile_wiener", 32), ("search24", 16)])
def test_match_kernel_names_the_tile_kernel_at_the_envelope_rows(row, k):
    block, step, search, k_row, _ = chip_smoke.ENVELOPE_K1[row]
    assert (block, step, k_row) == (8, 3, k)
    g = _geometry(bm3d.BM3DParams(block=8, step=3, search=search), 128)
    assert k1.match_kernel(g, 8, k) == TILE
    p = BM3D_PROFILE_LANE[3]
    assert (p.block, p.step, p.search) == (8, 3, 19) and search in (19, 24)


@pytest.mark.parametrize("step", range(1, 9))
@pytest.mark.parametrize("size", [37, 64, 128])
def test_match_kernel_names_the_tile_kernel_at_every_step_of_block_8(step, size):
    """Past the first kernel's settings (32 matches; 1,521 offsets at k 16)
    every block-8 call at every step goes to the tile kernel, which has a
    plan for every such grid."""
    for search, k in ((8, 32), (19, 16), (2, 64)):
        g = _geometry(bm3d.BM3DParams(step=step, search=search), size)
        assert k1.match_kernel(g, 8, k) == TILE
    g = _geometry(bm3d.BM3DParams(step=step, search=8), size)
    assert g.row_tiles is not None and g.col_tiles is not None
    assert k1.match_kernel(g, 8, 16) == (FIRST if g.first_kernel_takes(8, 16) else TILE)


K1_CORNERS_OFF_BLOCK_8 = [(2, 1, 0, 1), (2, 2, 24, 64), (16, 16, 24, 64), (16, 1, 2, 1), (4, 2, 3, 4),
                          (5, 2, 4, 8)]


@pytest.mark.parametrize("block,step,search,k", K1_CORNERS_OFF_BLOCK_8)
def test_match_kernel_leaves_the_other_blocks_to_the_any_kernel(block, step, search, k):
    """Since the span kernel, "the other blocks" go to it, not to the
    any-kernel, which keeps only grids that do not strictly ascend (the
    test below)."""
    g = _geometry(bm3d.BM3DParams(block=block, step=step, search=search), 64)
    assert g.row_tiles is None and g.col_tiles is None and not g.first_kernel_takes(block, k)
    assert g.tile_order is not None
    assert k1.match_kernel(g, block, k) == SPAN


def test_a_grid_that_does_not_strictly_ascend_has_no_tile_plan():
    assert k1.tile_plan([0, 4, 4, 8], 8, k1.TILE_MAX) is None
    g = k1.match_geometry([0, 3, 3], [0, 3, 6], bm3d.search_offsets(2, 1), 8, "cpu")
    assert g.row_tiles is None and k1.match_kernel(g, 8, 32) == ANY


@pytest.mark.parametrize("block", [2, 4, 5, 16])
def test_a_grid_that_does_not_strictly_ascend_still_goes_to_the_any_kernel(block):
    g = k1.match_geometry([0, 1, 1], [0, 2, 4], bm3d.search_offsets(3, 1), block, "cpu")
    assert g.tile_order is None and k1.match_kernel(g, block, 4) == ANY == k1.PREV_DESIGN
    ascending = k1.match_geometry([0, 1, 2], [0, 2, 4], bm3d.search_offsets(3, 1), block, "cpu")
    assert k1.match_kernel(ascending, block, 4) == SPAN


def _span_sums(cols_mask: int) -> dict:
    """The kernel's 8-wide sums in one span row, as multisets of the span
    columns their trees add: the doubling tree's sum at every position
    (pairs, fours, eights, in place and ascending), at the mask's set bits."""
    t = [collections.Counter([x]) for x in range(k1.TILE_SPAN)]
    for width, last in ((1, k1.TILE_SPAN - 1), (2, k1.TILE_SPAN - 3), (4, KERNEL_COLS)):
        for x in range(last):
            t[x] = t[x] + t[x + width]
    return {x: t[x] for x in range(KERNEL_COLS) if cols_mask >> x & 1}


@pytest.mark.parametrize("step", range(1, 9))
@pytest.mark.parametrize("width", [8, 9, 16, 31, 37, 64, 100, 128, 192, 255, 256])
def test_tile_plans_take_each_reference_sum_once_from_its_8_columns(step, width):
    grid = bm3d._ref_grid(width, 8, step)
    rows = k1.tile_plan(grid, 8, k1.TILE_MAX)
    most_rows = int(rows[:, 1].max())
    cols = k1.tile_plan(grid, 8, k1.TILE_MAX // most_rows)
    for plan in (rows, cols):
        taken = []
        for start, n, mask in plan:
            refs = grid[start:start + n]
            offsets = [int(v) - int(refs[0]) for v in refs]
            assert n >= 1 and mask == sum(1 << v for v in offsets)
            assert offsets[-1] + 8 <= k1.TILE_SPAN  # a lane (row) or register (column) for each span pixel
            taken += [int(v) for v in refs]
        assert taken == [int(v) for v in grid]  # every reference coordinate in one tile, in order
    assert all(int(r[1]) * int(c[1]) <= k1.TILE_MAX for r in rows for c in cols)
    for start, n, mask in cols:
        sums = _span_sums(int(mask))
        refs = grid[start:start + n]
        assert sorted(sums) == [int(v) - int(refs[0]) for v in refs]
        for x, terms in sums.items():
            assert terms == collections.Counter(range(x, x + 8))  # exactly its 8 columns, each once
    # The rows: lane y adds the 8 lanes from it by the same doubling tree.
    lanes = [collections.Counter([y]) for y in range(k1.TILE_SPAN)]
    for width_ in (1, 2, 4):
        lanes = [lanes[y] + (lanes[y + width_] if y + width_ < k1.TILE_SPAN else lanes[y])
                 for y in range(k1.TILE_SPAN)]
    for start, n, mask in rows:
        for y in range(KERNEL_COLS):
            if mask >> y & 1:
                assert lanes[y] == collections.Counter(range(y, y + 8))


@pytest.mark.parametrize("search,search_step", [(0, 1), (2, 1), (19, 1), (24, 1), (12, 3)])
def test_visit_order_is_every_offset_once_nearest_the_centre_first(search, search_step):
    """The tile kernel visits the offsets nearest the window's centre first
    (ties by index) and compares each by its own index, so the order moves
    no result; its geometry holds the order and the offsets in it."""
    offs = bm3d.search_offsets(search, search_step)
    order = k1.visit_order(offs)
    assert sorted(order.tolist()) == list(range(len(offs)))
    keys = [(int((offs[s] ** 2).sum()), int(s)) for s in order]
    assert keys == sorted(keys) and order[0] == len(offs) // 2  # (0, 0), the reference block itself
    grid = bm3d._ref_grid(128, 8, 3)
    g = k1.match_geometry(grid, grid, offs, 8, "cpu")
    assert g.tile_order.tolist() == order.tolist()
    assert g.tile_offsets.tolist() == offs[order].tolist()


@pytest.mark.parametrize("search", [0, 8, 19, 24])
@pytest.mark.parametrize("k", [1, 16, 32, 64])
def test_tile_kernel_shared_memory_fits_three_ctas_where_the_profile_runs(search, k):
    grid = bm3d._ref_grid(128, 8, 3)
    g = k1.match_geometry(grid, grid, bm3d.search_offsets(search, 1), 8, "cpu")
    assert g.tile_pitch % 2 == 1 and g.tile_pitch >= k1.TILE_SPAN + 2 * search
    assert g.tile_smem_bytes(k) <= MAX_SMEM
    if search <= 19 and k <= 32:  # the reference profile's calls: three CTAs an SM
        assert 3 * (g.tile_smem_bytes(k) + 1024) <= 228 * 1024
    assert g.row_tiles.shape == g.col_tiles.shape == (5, 3)  # 41 = 4 x 9 + 5 reference blocks an axis


def test_chip_smoke_checks_each_lanes_k1_kernel():
    """chip_smoke.py holds every K1 launch of a lane's timed run to the
    lane's kernel, and its profile's K1 names to that kernel alone."""
    zero = dict.fromkeys(k1.K1_KERNELS, 0)
    chip_smoke.check_k1_kernels("bm3d_profile", zero | {TILE: 320}, {"bm3d_match": 320}, [TILE])
    chip_smoke.check_k1_kernels("headline", zero | {FIRST: 320}, {"bm3d_match": 320}, [FIRST])
    chip_smoke.check_k1_kernels("pr_bm3d", zero | {FIRST: 480}, {"bm3d_match": 480})
    with pytest.raises(RuntimeError, match="K1 launches by kernel"):
        chip_smoke.check_k1_kernels("bm3d_profile", zero | {TILE: 319, ANY: 1}, {"bm3d_match": 320})
    with pytest.raises(RuntimeError, match="profile's K1 kernels"):
        chip_smoke.check_k1_kernels("bm3d_profile", zero | {TILE: 320}, {"bm3d_match": 320}, [ANY, TILE])
    assert chip_smoke.KERNEL_GROUPS[0] == ("K1 bm3d_match", k1.K1_KERNELS)
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_122bm3d_match_tile_kernelILi1ELi1ELi3EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 68 registers, used 1 barriers")
    assert list(chip_smoke.ptxas_summary(log)) == ["bm3d_match_tile_kernel<1, 1, 3>"]
