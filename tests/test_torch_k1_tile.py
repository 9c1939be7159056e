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

import numpy as np

import pytest
import torch

import chip_smoke
from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, CSMRI_BATCH_LANES, bench_config
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1

FIRST, TILE, ANY, SPAN, *_ = k1.K1_KERNELS
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


def _source_constant(name: str) -> int:
    """``constexpr int <name> = <value>`` in ``csrc/bm3d_match.cu``."""
    import re

    from pnp_svrg_tpu_torch.ops.cuda import _build

    text = (_build.SRC_DIR / "bm3d_match.cu").read_text()
    return int(re.search(rf"constexpr int (?:\w+ = \w+, )*{name} = (\d+)", text).group(1))


def test_the_k1_plan_constants_are_the_sources():
    assert _source_constant("kRankK") == k1.RANK_K == 128 == k1.MATCH_ENVELOPE["k"][1]
    assert _source_constant("kTileMax") == k1.TILE_MAX
    assert _source_constant("kChunk") == k1.TILE_CHUNK
    assert _source_constant("kTileSpan") == k1.TILE_SPAN
    assert _source_constant("kTileWarps") * 32 == k1.SPAN_MOST


def rank_merge(dists: np.ndarray, order: np.ndarray, k: int = k1.RANK_K) -> np.ndarray:
    """``merge_chunk_ranks`` for one block, step for step: (S,) float32
    distances (window index order) visited in ``order`` in chunks of
    ``TILE_CHUNK``; the running top-k as 64-bit keys (distance bits << 32 |
    index; ~0 empty); a candidate survives below the k-th key; its place is
    the binary search's count of keys below it plus the survivors below it,
    a key's its own index plus the survivors below it; places past k drop
    out. Returns the k indices (index 0 for an empty entry)."""
    empty = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys = np.full(k, empty, np.uint64)
    for s0 in range(0, len(order), k1.TILE_CHUNK):
        idx = order[s0:s0 + k1.TILE_CHUNK].astype(np.uint64)
        bits = dists[order[s0:s0 + k1.TILE_CHUNK]].astype(np.float32).view(np.uint32)
        ck = bits.astype(np.uint64) << np.uint64(32) | idx
        surv = ck[(bits != 0x7F800000) & (ck < keys[k - 1])]
        merged = np.full(k, empty, np.uint64)
        for c in surv:
            lo, half = 0, k // 2
            while half:
                lo += half if keys[lo + half - 1] < c else 0
                half //= 2
            at = lo + int((surv < c).sum())
            if at < k:
                merged[at] = c
        for e, key in enumerate(keys):
            at = e + int((surv < key).sum())
            if at < k:
                merged[at] = key
        assert not (merged == empty).any() or (keys == empty).any()  # every place filled once
        keys = merged
    return np.where(keys >> np.uint64(32) >= 0x7F800000, 0, keys & np.uint64(0xFFFFFFFF)).astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "inf", "few_finite", "none_finite", "real"])
@pytest.mark.parametrize("search", [19, 8])
def test_the_rank_merge_gives_the_plain_top_k_at_k_128(case, search):
    """At k 128 the tile and span kernels merge each chunk by ranks: on
    seeded distances with many exact ties, with +inf, with fewer finite
    candidates than k (and none), the model of the merge gives
    ``top_k_offsets_plain``'s indices exactly, in the visiting order."""
    offs = bm3d.search_offsets(search, 1)
    s = len(offs)
    rng = np.random.default_rng(search * 10 + len(case))
    d = {"ties": 0.25 * rng.integers(0, 12, s), "real": rng.standard_normal(s) ** 2,
         "inf": np.where(rng.random(s) < 0.3, np.inf, 0.5 * rng.integers(0, 40, s)),
         "few_finite": np.where(rng.random(s) < 60 / s, rng.integers(0, 5, s), np.inf),
         "none_finite": np.full(s, np.inf)}[case].astype(np.float32)
    want = k1.top_k_offsets_plain(torch.tensor(d)[None], k1.RANK_K)[0].numpy()
    for order in (k1.visit_order(offs), np.arange(s, dtype=np.int32), rng.permutation(s).astype(np.int32)):
        assert np.array_equal(rank_merge(d, order), want)


@pytest.mark.parametrize("search", [0, 3, 19, 24, 25, 40, 46, 47, 73])
def test_tile_kernel_at_k_128_shares_an_sm_where_its_tiles_allow(search):
    """At k 128 the tile kernel's tiles hold as many blocks as let three
    CTAs share an SM, or else two, where that keeps at least half of
    TILE_MAX, else TILE_MAX; its plan takes every reference block once and
    its CTA fits the card."""
    most = k1.tile_most(search, 128)
    fits = [max([m for m in range(1, k1.TILE_MAX + 1) if k1.tile_smem_bytes(search, 128, m) <= budget] or [0])
            for budget in k1.TILE_BUDGETS]
    assert k1.TILE_BUDGETS == (228 * 1024 // 3 - 1024, 228 * 1024 // 2 - 1024)
    assert most == next((m for m in fits if m >= k1.TILE_MAX // 2), k1.TILE_MAX)
    assert all(k1.tile_most(search, k) == k1.TILE_MAX for k in (1, 16, 32, 64))
    grid = bm3d._ref_grid(128, 8, 3)
    g = k1.match_geometry(grid, grid, bm3d.search_offsets(search, 1), 8, "cpu")
    plan = g.tile(128)
    assert plan.most <= most and plan.smem_bytes == k1.tile_smem_bytes(search, 128, plan.most) <= MAX_SMEM
    for tiles in (plan.row_tiles.numpy(), plan.col_tiles.numpy()):
        assert [int(v) for t in tiles for v in grid[t[0]:t[0] + t[1]]] == [int(v) for v in grid]
    assert int(plan.row_tiles[:, 1].max()) * int(plan.col_tiles[:, 1].max()) == plan.most
    assert g.tile(32).most == k1.TILE_MAX and g.tile(32).row_tiles is g.row_tiles
    if search == 19:  # the k128 row: 42 blocks a tile, three CTAs an SM (81 before: one)
        assert plan.most == 42 and 3 * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("block", [1, 2, 4, 7, 8, 9, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("k", [1, 4, 8, 16, 32, 64, 128])
def test_match_kernel_names_each_block_and_k_its_kernel_and_replaced_design(block, k):
    """Every k-128 call at block 8 goes to the tile kernel, every block
    2-16 to the span kernel, block 1 to the pixel kernel up to k 8 and to
    the run-time span kernel past it, blocks 17-32 to the run-time span
    kernel; ``prev_design`` names the design each replaced."""
    step = max(1, block // 2)
    g = _geometry(bm3d.BM3DParams(block=block, step=step, search=5), 64)
    kernel = k1.match_kernel(g, block, k)
    want = (FIRST if g.first_kernel_takes(block, k) else TILE if block == 8 else SPAN if 2 <= block <= 16 else
            "bm3d_match_pixel_kernel" if block == 1 and k <= 8 else "bm3d_match_span_rt_kernel")
    assert kernel == want and kernel in k1.K1_KERNELS and kernel in k1.ENTRIES
    prev = k1.prev_design(kernel, k)
    if block in (1, 17, 24, 31, 32) or (k == 128 and block != 8):
        assert prev == k1.SPAN_SERIAL == "bm3d_match_span_serial_kernel"
    elif k == 128:
        assert prev == k1.TILE_SLOTS == "bm3d_match_tile_slots_kernel"
    elif kernel == FIRST:
        assert prev == k1.PREV_DESIGN
    else:
        assert prev == k1.PREV_DESIGN == ANY
    k1.check_match_envelope(block, k, 5, step)  # the envelope still takes it


def test_chip_smoke_times_each_redesigned_k1_row_beside_its_replaced_design():
    """chip_smoke.py's k128, block1, block24 and block4_k128 rows go to the
    rank merge, the pixel kernel and the run-time span kernel, and its
    search32, search_widest and block4_s40 rows to the tile and span kernels
    on their plans (the two wide windows in parts), each timed beside the
    design it replaced (the parts rows: the same kernel on the one-part
    plan); none of those kernels may take a launch off the rows, and
    ptxas's lines name each."""
    want = {"k128": TILE, "block1": "bm3d_match_pixel_kernel", "block24": "bm3d_match_span_rt_kernel",
            "block4_k128": SPAN, "search32": TILE, "search_widest": TILE, "block4_s40": SPAN}
    assert set(chip_smoke.K1_REDESIGNED_WIDE) == set(want)
    assert set(chip_smoke.K1_PARTS_WIDE) == {"search32", "search_widest", "block4_s40"}
    assert chip_smoke.ENVELOPE_K1_WIDE["block4_k128"] == (4, 2, 19, 128, "basic")
    for row, kernel in want.items():
        block, step, search, k, _ = chip_smoke.ENVELOPE_K1_WIDE[row]
        g = _geometry(bm3d.BM3DParams(block=block, step=step, search=search), 128)
        assert k1.match_kernel(g, block, k) == kernel
        if row in chip_smoke.K1_PARTS_WIDE:
            assert k1.prev_design(kernel, k, parts=True) == kernel
        else:
            assert k1.prev_design(kernel, k) == (k1.TILE_SLOTS if block == 8 else k1.SPAN_SERIAL)
    assert set(k1.K1_KERNELS[3:]) <= set(chip_smoke.REDESIGNED_OFF_LANES)
    names = {"_ZN12_GLOBAL__N_125bm3d_match_span_rt_kernelILb1EEEvPKf": "bm3d_match_span_rt_kernel<1>",
             "_ZN12_GLOBAL__N_129bm3d_match_span_serial_kernelILb0EEEvPKf": "bm3d_match_span_serial_kernel<0>",
             "_ZN12_GLOBAL__N_123bm3d_match_pixel_kernelILi1ELi4EEEvPKf": "bm3d_match_pixel_kernel<1, 4>",
             "_ZN12_GLOBAL__N_128bm3d_match_tile_slots_kernelILi2EEEvPKf": "bm3d_match_tile_slots_kernel<2>",
             "_ZN12_GLOBAL__N_122bm3d_match_span_kernelILb0EEEvPKf": "bm3d_match_span_kernel<0>",
             "_ZN12_GLOBAL__N_128bm3d_match_tile_kernel_partsILi1ELi2EEEvPKf": "bm3d_match_tile_kernel_parts<1, 2>",
             "_ZN12_GLOBAL__N_128bm3d_match_span_kernel_partsILb1EEEvPKf": "bm3d_match_span_kernel_parts<1>"}
    for mangled, name in names.items():
        log = f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\nptxas info    : Used 80 registers"
        assert list(chip_smoke.ptxas_summary(log)) == [name]


def one_block_top_k(dists: np.ndarray, order: np.ndarray, k: int, warps: int = k1.SPAN_MOST // 32) -> np.ndarray:
    """``span_one_block_rt``'s selection for a tile of one block, step for
    step: warp w walks positions w, w + warps, ... of the visiting order and
    keeps its own sorted list of 32 64-bit keys (a candidate below entry
    k - 1 enters at the count of keys below it, the rest moving up one
    lane); then k rounds of an argmin over the warps' lists (the least
    distance bits, then the least index among them) take the result."""
    empty = np.uint64(0xFFFFFFFFFFFFFFFF)
    lists = []
    for w in range(warps):
        mine = np.full(32, empty, np.uint64)
        for c in range(w, len(order), warps):
            d = np.float32(dists[order[c]])
            if not np.isfinite(d):
                continue
            key = np.uint64(d.view(np.uint32)) << np.uint64(32) | np.uint64(order[c])
            if key < mine[k - 1]:
                at = int((mine < key).sum())
                mine = np.concatenate([mine[:at], [key], mine[at:-1]]).astype(np.uint64)
        lists.append(mine)
    keys = np.concatenate(lists)
    out = []
    for _ in range(k):
        hi = (keys >> np.uint64(32)).min()
        lo = (keys[(keys >> np.uint64(32)) == hi] & np.uint64(0xFFFFFFFF)).min()
        win = hi << np.uint64(32) | lo
        out.append(0 if win == empty else int(lo))
        keys = np.where(keys == win, empty, keys)
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("case", ["ties", "inf", "few_finite", "real"])
@pytest.mark.parametrize("k", [1, 4, 16, 32])
def test_the_one_block_path_gives_the_plain_top_k(case, k):
    """At blocks 17-32 a tile of one block keeps a top-k a warp and merges
    the eight at the end: on seeded distances (exact ties, +inf, fewer
    finite candidates than k) the model gives ``top_k_offsets_plain``'s
    indices exactly."""
    offs = bm3d.search_offsets(8, 1)
    s = len(offs)
    rng = np.random.default_rng(k * 10 + len(case))
    d = {"ties": 0.25 * rng.integers(0, 6, s), "real": rng.standard_normal(s) ** 2,
         "inf": np.where(rng.random(s) < 0.4, np.inf, 0.5 * rng.integers(0, 40, s)),
         "few_finite": np.where(rng.random(s) < 10 / s, rng.integers(0, 3, s), np.inf)}[case].astype(np.float32)
    want = k1.top_k_offsets_plain(torch.tensor(d)[None], k)[0].numpy()
    assert np.array_equal(one_block_top_k(d, k1.visit_order(offs), k), want)


def test_every_k1_variant_edits_text_the_source_has():
    """``examples/k1_variants.py`` builds each variant by replacing text of
    ``csrc/bm3d_match.cu``; a variant whose text the source no longer has
    would fail only on the card."""
    from pnp_svrg_tpu_torch.examples import k1_variants
    from pnp_svrg_tpu_torch.ops.cuda import _build

    src = (_build.SRC_DIR / "bm3d_match.cu").read_text()
    tables = (k1_variants.VARIANTS, k1_variants.SPAN_VARIANTS, k1_variants.RANK_VARIANTS, k1_variants.RT_VARIANTS,
              k1_variants.PART_VARIANTS)
    for table in tables:
        for name, edits in table.items():
            assert edits and all(old in src for old, _ in edits), name
