"""K1's windows staged in parts, on the CPU: the host-made part plans and
the kernels' visit of them, held to the plain version and to the JAX
package's matcher.

Where the whole region of a wide window would crowd the CTA, the tile
kernel (block 8, k up to 64) and the span kernel (blocks 2-16) stage the
reach in parts (``part_plan``: the cells of bands of dy and dx, cut where
some tile's live offsets begin or end, ``MatchGeometry.live_cuts``, each
part with its own halo, the reference span staged apart) and visit only the
parts some block of the tile can take (``parts_live``, the kernels' own
test). Here each plan is held to what the kernels read of it: every offset
of the reach in exactly one part, in the visiting order, inside its part's
bounds; every part a tile skips +inf for every block of the tile under
``match_distances_plain``, with and without row bounds; and the plain top-k
over the offsets each tile visits equal to ``bm3d_match_plain`` over the
whole window in all three modes. The plan a call takes
(``MatchGeometry.tile`` / ``.span`` with a reach) has one part at every
lane's geometry and parts where the whole region would crowd the CTA. The
kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, CSMRI_BATCH_LANES, bench_config
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.examples.k1_variants import square_cuts
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1

TILE, SPAN = "bm3d_match_tile_kernel", "bm3d_match_span_kernel"
# (block, step, search, size) at small sizes; the parts each is cut to
# here besides its plan's own: live cuts split to a width, square parts and
# bands of dy across the window (WIDTHS, SQUARES).
POINTS = [(8, 3, 24, 48), (8, 4, 40, 64), (4, 2, 24, 48), (4, 3, 40, 64), (6, 3, 30, 56)]
WIDTHS, SQUARES = (9, 21), ((13, 13), (11, 81))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # Workers of eight intra-op threads each slowed this file's torch ops
    # sixfold; one thread a worker, restored after.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    clean = 0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.0)
    return (clean[None] + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def _dyadic(shape, seed):
    return (0.25 * np.random.default_rng(seed).integers(0, 5, shape)).astype(np.float32)


def _geometry(block, step, search, size, search_step=1):
    rows = bm3d._ref_grid(size, block, step)
    offs = bm3d.search_offsets(search, search_step)
    return rows, offs, k1.match_geometry(rows, rows, offs, block, "cpu")


def _plans(g, reach, k):
    """The plan the call takes and parts plans of each of :data:`WIDTHS`
    and :data:`SQUARES`."""
    cuts = [(w, None) for w in WIDTHS] + [(e[0], square_cuts(reach.host[0], e)) for e in SQUARES]
    if g.block == 8:
        return [g.tile(k, reach=reach)] + [g.tile_parts(k, reach, w, c) for w, c in cuts]
    return [g.span(k, reach=reach)] + [p for p in (g.span_parts(k, reach, w, c) for w, c in cuts) if p is not None]


def _visited(g, plan, reach, n_offsets, lo, hi, last_c):
    """(nR, nC, S) bool: the window indices the kernel visits for each
    block: its tile's live parts (``parts_live`` with candidate top rows in
    ``[lo, hi]`` and columns in ``[0, last_c]``), or the whole reach on one
    part."""
    rows, cols = np.asarray(g.rows), np.asarray(g.cols)
    out = np.zeros((len(rows), len(cols), n_offsets), bool)
    order = reach.host[1] if plan.parts is None else plan.parts.order.numpy()
    table = None if plan.parts is None else plan.parts.table.numpy()
    for r0, nr, _ in plan.row_tiles.numpy():
        for c0, nc, _ in plan.col_tiles.numpy():
            if table is None:
                out[r0:r0 + nr, c0:c0 + nc, order] = True
                continue
            live = k1.parts_live(table, (rows[r0], rows[r0 + nr - 1]), (cols[c0], cols[c0 + nc - 1]), lo, hi, last_c)
            for first, count in table[live, :2]:
                out[r0:r0 + nr, c0:c0 + nc, order[first:first + count]] = True
    return out


@pytest.mark.parametrize("search,search_step", [(3, 1), (19, 1), (40, 1), (40, 3), (95, 4)])
@pytest.mark.parametrize("edge", [(1, 1), (9, 9), (27, 27), (8, 8), (11, 191), "live"])
def test_the_part_plan_covers_each_offset_of_the_reach_once(search, search_step, edge):
    offs = bm3d.search_offsets(search, search_step)
    order = k1.visit_order(offs)
    if edge == "live":  # where the tiles of block 8 at step 3 on a 128 px image begin and end, then 21 wide
        rows = bm3d._ref_grid(128, 8, 3)
        g = k1.match_geometry(rows, rows, offs, 8, "cpu")
        cuts = g.live_cuts(g.row_tiles, g.col_tiles, g.reach(128, 128), 21)
        edge = (21, 21)
    else:
        cuts = square_cuts(offs, edge)
    p = k1.part_plan(offs[order], order, cuts, "cpu")
    table, porder, poffs = p.table.numpy(), p.order.numpy(), p.offsets.numpy()
    assert sorted(porder.tolist()) == list(range(len(offs)))  # every offset once
    assert np.array_equal(offs[porder], poffs)
    assert table[:, 1].sum() == len(offs) and (table[:, 1] > 0).all()
    assert np.array_equal(table[:, 0], np.concatenate([[0], np.cumsum(table[:, 1])[:-1]]))
    rank = np.empty(len(offs), int)
    rank[order] = np.arange(len(offs))
    bands = []
    for first, count, dy0, dy1, dx0, dx1 in table:
        part = poffs[first:first + count]
        assert (part[:, 0].min(), part[:, 0].max(), part[:, 1].min(), part[:, 1].max()) == (dy0, dy1, dx0, dx1)
        assert dy1 - dy0 < edge[0] and dx1 - dx0 < edge[1]
        assert p.rows >= k1.TILE_SPAN + dy1 - dy0 and p.pitch - 1 >= k1.TILE_SPAN + dx1 - dx0
        assert (np.diff(rank[porder[first:first + count]]) > 0).all()  # in the visiting order
        band = [np.searchsorted(cuts[a], part[:, a], side="right") for a in (0, 1)]
        assert all((b == b[0]).all() for b in band)  # one band of each axis
        bands.append((int(dy0 + dy1) ** 2 + int(dx0 + dx1) ** 2, band[0][0], band[1][0]))
    assert bands == sorted(bands) and len(set(bands)) == len(bands)  # nearest the centre first
    assert p.pitch % 2 == 1 and p.words == k1.REF_WORDS + p.rows * (p.pitch + 1)


@pytest.mark.parametrize("bounds", [None, (5, 40)])
@pytest.mark.parametrize("block,step,search,size", POINTS)
def test_a_part_a_tile_skips_is_inf_for_every_block_of_the_tile(block, step, search, size, bounds):
    rows, offs, g = _geometry(block, step, search, size)
    x = torch.tensor(_noisy((1, size, size), block))
    dists = k1.match_distances_plain(x, rows, rows, offs, block, row_valid_bounds=bounds)[0].numpy()
    lo, hi = (0, size) if bounds is None else bounds
    reach = g.reach(size, size)
    skipped = 0
    for plan in (p for p in _plans(g, reach, 16) if p.parts is not None):
        table, order = plan.parts.table.numpy(), plan.parts.order.numpy()
        for r0, nr, _ in plan.row_tiles.numpy():
            for c0, nc, _ in plan.col_tiles.numpy():
                live = k1.parts_live(table, (rows[r0], rows[r0 + nr - 1]), (rows[c0], rows[c0 + nc - 1]), lo,
                                     hi - block, size - block)
                for first, count in table[~live, :2]:
                    assert np.isinf(dists[r0:r0 + nr, c0:c0 + nc, order[first:first + count]]).all()
                    skipped += 1
    assert skipped > 0  # every point has tiles that skip parts


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block,step,search,size", POINTS)
def test_the_top_k_over_each_tiles_visits_is_the_whole_windows(block, step, search, size, mode):
    """Each plan's visits leave out only +inf distances (so its top-k is the
    whole window's whatever the order), and the top-k over the plan's own
    visits is ``bm3d_match_plain``'s, on noisy images and on dyadic ones
    with row bounds."""
    rows, offs, g = _geometry(block, step, search, size)
    reach = g.reach(size, size)
    for bounds, make in ((None, _noisy), ((3, size - 5), _dyadic)):
        x = torch.tensor(make((1, size, size), block + search))
        lo, hi = (0, size) if bounds is None else bounds
        dists = k1.match_distances_plain(x, rows, rows, offs, block, mode, row_valid_bounds=bounds)
        plans = _plans(g, reach, 16)
        for plan in plans:
            seen = torch.tensor(_visited(g, plan, reach, len(offs), lo, hi - block, size - block))
            assert torch.equal(torch.where(seen[None], dists, torch.inf), dists), plan.parts and plan.parts.cuts
        got = k1.top_k_offsets_plain(torch.where(seen[None], dists, torch.inf), 16)
        assert torch.equal(got, k1.bm3d_match_plain(x, rows, rows, offs, block, 16, mode, row_valid_bounds=bounds))


def _lane_calls() -> dict:
    """label -> (params, height, width, [k]) of every lane's BM3D calls: the
    headline's CSMRI lanes, the bench lanes, bm3d_profile, the sweep and the
    drivers."""
    calls = {label: (chip_smoke.CSMRI_LANES[label][3], 128, 128) for label in ("headline", "turbo", "turbo4")}
    calls |= {label: (spec[3], 128, 128) for label, spec in CSMRI_BATCH_LANES.items()}
    for label in ("pr_bm3d", "deblur_bm3d", "deblur_sr_bm3d"):
        cfg = bench_config(label)
        calls[label] = (cfg["params"], cfg["size"], cfg["size"])
    calls["bm3d_profile"] = (BM3D_PROFILE_LANE[3], 128, 128)
    calls["sweep_and_drivers"] = (bm3d.BM3DParams(search=8), 128, 128)
    calls["drivers_256px"] = (bm3d.BM3DParams(search=8), 256, 256)
    return calls


def _plan_of(g, reach, k):
    kernel = k1.match_kernel(g, g.block, k)
    if kernel == TILE:
        return kernel, g.tile(k, reach=reach), g.tile(k, reach.search)
    if kernel == SPAN:
        return kernel, g.span(k, reach=reach), g.span(k, reach.search)
    return kernel, None, None


@pytest.mark.parametrize("label", list(_lane_calls()))
def test_every_lane_takes_the_one_part_plan(label):
    p, h, w = _lane_calls()[label]
    rows, cols = bm3d._ref_grid(h, p.block, p.step), bm3d._ref_grid(w, p.block, p.step)
    g = k1.match_geometry(rows, cols, bm3d.search_offsets(p.search, p.search_step), p.block, "cpu")
    for k in (p.group_ht, p.group_wie):
        kernel, plan, one = _plan_of(g, g.reach(h, w), k)
        assert plan is one and (plan is None or plan.parts is None), (kernel, k)


# chip_smoke.py's K1 rows at search 19 or less off the first kernel: the
# span rows, bm3d_profile's tile rows, and the wide rows there.
NARROW_ROWS = {row: v for table in (chip_smoke.ENVELOPE_K1, chip_smoke.ENVELOPE_K1_WIDE)
               for row, v in table.items() if v[2] <= 19}


@pytest.mark.parametrize("row", list(NARROW_ROWS))
def test_the_rows_at_search_19_or_less_take_the_one_part_plan(row):
    block, step, search, k, _ = NARROW_ROWS[row]
    rows, offs, g = _geometry(block, step, search, 128)
    kernel, plan, one = _plan_of(g, g.reach(128, 128), k)
    assert plan is one and (plan is None or plan.parts is None), kernel
    if kernel == TILE and k <= 64:  # the whole region lets three CTAs share an SM
        assert 3 * (one.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("row,parted", [("search32", False), ("search_widest", True), ("block4_s40", True)])
def test_the_wide_rows_plans_let_three_ctas_share_an_sm(row, parted):
    block, step, search, k, _ = chip_smoke.ENVELOPE_K1_WIDE[row]
    rows, offs, g = _geometry(block, step, search, 128)
    reach = g.reach(128, 128)
    kernel, plan, one = _plan_of(g, reach, k)
    assert (plan.parts is not None) == parted and 3 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.smem_bytes <= 227 * 1024 and plan.most <= (k1.TILE_MAX if kernel == TILE else k1.SPAN_MOST)
    table = None if plan.parts is None else plan.parts.table.numpy()
    cost = g.visit_cost(plan.row_tiles, plan.col_tiles, table, reach)
    assert cost <= g.visit_cost(one.row_tiles, one.col_tiles, None, reach)
    if kernel == TILE:  # the geometry's own tiles, TILE_MAX blocks: one part left one CTA an SM at search 95
        assert plan.most == k1.TILE_MAX and plan.row_tiles is g.row_tiles
        assert (228 * 1024 // (one.smem_bytes + 1024) == 1) == parted
    else:  # the tiles of a narrow window (block4_s19's), not the 63 blocks the whole region leaves
        narrow = _geometry(block, step, 19, 128)[2].span(k, 19)
        assert len(plan.row_tiles) * len(plan.col_tiles) == len(narrow.row_tiles) * len(narrow.col_tiles) == 30
        assert one.most == 63 and plan.most >= narrow.most


def test_the_visit_cost_counts_each_tiles_chunks_and_parts():
    rows, offs, g = _geometry(8, 3, 19, 128)
    reach = g.reach(128, 128)
    assert g.visit_cost(g.row_tiles, g.col_tiles, None, reach) == 25 * -(-len(offs) // k1.TILE_CHUNK)
    whole = k1.part_plan(*reach.host, ((), ()), "cpu")  # the whole window, one part staged apart
    assert len(whole.table) == 1
    assert g.visit_cost(g.row_tiles, g.col_tiles, whole.table.numpy(), reach) == 25 * (24 + k1.PART_COST)


def test_a_kernel_that_takes_no_parts_refuses_a_parts_plan():
    rows, offs, g = _geometry(8, 3, 40, 64)
    reach = g.reach(64, 64)
    parted = g.tile_parts(16, reach, 9)
    x = torch.zeros((1, 64, 64))
    out = torch.empty((1, len(rows), len(rows), 16), dtype=torch.int32)
    for kernel, k in (("bm3d_match_span_rt_kernel", 16), ("bm3d_match_pixel_kernel", 4), (TILE, 128)):
        with pytest.raises(ValueError, match="takes no window in parts"):
            k1.launch(kernel, None, x, g, out, 8, k, "f32", 0, 64, plan=parted)
    with pytest.raises(ValueError, match="k up to 64"):
        g.tile_parts(128, reach)


def _set_agreement(a, b) -> float:
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), np.asarray(b).reshape(-1, b.shape[-1])
    return float(np.mean([len(set(p) & set(q)) / a.shape[1] for p, q in zip(a, b)]))


@pytest.mark.parametrize("block,step,search", [(8, 3, 24), (8, 4, 40), (4, 2, 24), (4, 3, 40)])
def test_bm3d_match_at_a_wide_window_agrees_with_the_jax_matcher(block, step, search):
    """The port's matcher at windows as wide as the 48 px image against the
    JAX package's XLA matcher (``_match_distances`` + ``_top_k_offsets``,
    the CPU's path): exactly on dyadic images, in 999 of 1,000 matches on
    noisy ones (f32 sums in another order may swap a near-tied member)."""
    rows, offs, g = _geometry(block, step, search, 48)
    assert (k1.match_kernel(g, block, 16), g.reach(48, 48).search) == (TILE if block == 8 else SPAN, search)
    for make, exact in ((_noisy, False), (_dyadic, True)):
        x = make((2, 48, 48), block * 100 + search)
        want = np.asarray(jbm3d._top_k_offsets(jbm3d._match_distances(jnp.asarray(x), rows, rows, offs, block), 16))
        got = k1.bm3d_match(torch.tensor(x), rows, rows, offs, block, 16, "f32", geometry=g).numpy()
        assert got.shape == want.shape == (2, len(rows), len(rows), 16)
        if exact:
            assert np.array_equal(got, want)
        else:
            assert _set_agreement(got, want) >= 0.999


@pytest.mark.parametrize("block,search,k", [(8, 19, 64), (8, 95, 16), (4, 40, 16)])
def test_the_plans_are_made_on_the_host_for_a_geometry_on_any_device(block, search, k):
    """The card's geometry holds its tables on the card; the part plans read
    them on the host (a ``meta`` tensor, like a CUDA one, has no numpy
    view), and give the plans the CPU geometry gives."""
    rows = bm3d._ref_grid(128, block, 3 if block == 8 else 2)
    offs = bm3d.search_offsets(search, 1)
    plans = []
    for device in ("cpu", "meta"):
        g = k1.match_geometry(rows, rows, offs, block, device)
        reach = g.reach(128, 128)
        plans.append(g.tile(k, reach=reach) if block == 8 else g.span(k, reach=reach))
    cpu, meta = plans
    assert cpu.parts is not None and meta.parts.table.device.type == "meta"
    assert (meta.most, meta.smem_bytes, meta.parts.cuts) == (cpu.most, cpu.smem_bytes, cpu.parts.cuts)
