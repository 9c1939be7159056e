"""K1's span kernel (``bm3d_match_span_kernel``, every block other than 8) on
the CPU: its host-made plans, a model of its order of adds, and the plain
version it is held to against the JAX package's Pallas matcher.

``match_kernel`` sends every K1 call at a block other than 8 on a strictly
ascending grid to the span kernel (``tests/test_torch_k1_tile.py`` holds the
choice). Its tiles are ``tile_plan``'s, cut by ``span_plan`` to what three
CTAs an SM leave room for; here each plan is held to what the kernel reads
of it at every block 2-16: every reference coordinate in exactly one tile,
every tile inside the kernel's span and its ``most``, and each block's sum
taken once from exactly its own columns and rows by the kernel's tree. The
tree (the block's binary decomposition, the largest power of two first,
each part a doubling tree) is modelled in numpy float32, whose adds round
as the kernel's ``__fadd_rn`` do, and held to ``match_distances_plain``:
within the near-tie of the block's own terms on real images, exactly on
dyadic ones. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pnp_svrg_tpu.ops.pallas.bm3d_match import bm3d_match_pallas
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1

BLOCKS = [b for b in range(2, 17)]
MAX_SMEM = 227 * 1024


def _tree(block: int, lo: int = 0) -> collections.Counter:
    """The multiset of terms (by position from ``lo``) the kernel's tree adds
    for one block: the largest power of two of ``block`` as a doubling tree,
    then the rest from its end by the same rule."""
    hb = 1 << (block.bit_length() - 1)
    part = collections.Counter(range(lo, lo + hb))
    return part if hb == block else part + _tree(block - hb, lo + hb)


def tree_sum(a: np.ndarray, block: int, axis: int) -> np.ndarray:
    """The kernel's tree of ``block`` consecutive float32 values along
    ``axis`` at every start (the last ``block - 1`` starts cut off): the
    largest power of two hb as doubling sums, plus the tree of the rest
    from hb on, added last (``row_window_sums`` / ``lane_window_sum``)."""
    n = a.shape[axis]
    take = lambda v, s, m: np.take(v, np.arange(s, s + m), axis=axis)  # noqa: E731
    hb = 1 << (block.bit_length() - 1)
    q, w = a, 1
    while w < hb:  # q: the 2w-wide doubling sums from each start
        q = take(q, 0, q.shape[axis] - w) + take(q, w, q.shape[axis] - w)
        w *= 2
    q = take(q, 0, n - block + 1)
    if hb == block:
        return q
    return q + tree_sum(take(a, hb, n - hb), block - hb, axis)


def model_distances(imgs: np.ndarray, rows, cols, offsets, block: int, mode: str) -> np.ndarray:
    """(B, nR, nC, S) distances as the span kernel forms them: each rounded
    term once per (pixel, offset), the row tree, then the column tree, in
    float32; +inf where the candidate leaves the image."""
    x = torch.tensor(imgs)
    if mode == "bf16_xla":
        x = x.to(torch.bfloat16).to(torch.float32)
    b, h, w = x.shape
    rows, cols = np.asarray(rows), np.asarray(cols)
    out = np.full((b, len(rows), len(cols), len(offsets)), np.inf, np.float32)
    for s, (dy, dx) in enumerate(np.asarray(offsets)):
        cand = torch.zeros_like(x)
        ys, xs = slice(max(0, -dy), min(h, h - dy)), slice(max(0, -dx), min(w, w - dx))
        cand[:, ys, xs] = x[:, ys.start + dy:ys.stop + dy, xs.start + dx:xs.stop + dx]
        d = x - cand
        if mode == "bf16_xla":
            d = d.to(torch.bfloat16).to(torch.float32)
        t = d * d
        if mode != "f32":
            t = t.to(torch.bfloat16).to(torch.float32)
        sums = tree_sum(tree_sum(t.numpy(), block, 2), block, 1)  # (B, H - block + 1, W - block + 1)
        valid = ((rows[:, None] + dy >= 0) & (rows[:, None] + dy <= h - block)
                 & (cols[None, :] + dx >= 0) & (cols[None, :] + dx <= w - block))
        out[..., s] = np.where(valid, sums[:, rows][:, :, cols], np.inf)
    return out


def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[-2], :shape[-1]]
    clean = 0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.5)
    return (clean + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def _dyadic(shape, seed):
    return (0.25 * np.random.default_rng(seed).integers(0, 5, shape)).astype(np.float32)


@pytest.mark.parametrize("block", BLOCKS)
def test_the_tree_takes_each_term_of_a_block_once(block):
    assert _tree(block) == collections.Counter(range(block))
    ones = np.ones((1, 40), np.float32)
    assert np.array_equal(tree_sum(ones, block, 1), np.full((1, 41 - block), block, np.float32))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("width", [37, 64, 128])
def test_span_plans_take_each_reference_block_once_inside_the_span(block, width):
    for step in sorted({1, 2, max(1, block // 2), block}):
        grid = bm3d._ref_grid(width, block, step)
        for search, k in ((3, 4), (8, 16), (24, 64)):
            plan = k1.span_plan(grid, grid, block, search, k, "cpu")
            most = k1.span_most(search, k)
            assert 1 <= plan.most <= most <= k1.SPAN_MOST
            for tiles in (plan.row_tiles.numpy(), plan.col_tiles.numpy()):
                taken = []
                for start, n, mask in tiles:
                    refs = [int(v) for v in grid[start:start + n]]
                    assert n >= 1 and mask == sum(1 << (v - refs[0]) for v in refs)
                    assert refs[-1] - refs[0] + block <= k1.TILE_SPAN  # a lane (row) or register (column) a pixel
                    taken += refs
                assert taken == [int(v) for v in grid]
            rows_most, cols_most = int(plan.row_tiles[:, 1].max()), int(plan.col_tiles[:, 1].max())
            assert rows_most * cols_most == plan.most
            # Each block's sum: the row tree at its column, the lane tree at
            # its row, over exactly its own block x block pixels of the span.
            for start, n, mask in plan.col_tiles.numpy():
                for x in (v for v in range(k1.TILE_SPAN) if mask >> v & 1):
                    assert x + block <= k1.TILE_SPAN and _tree(block, x) == collections.Counter(range(x, x + block))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("search", [0, 8, 24])
@pytest.mark.parametrize("k", [1, 4, 16, 32, 64])
def test_span_kernel_shared_memory_lets_three_ctas_share_an_sm(block, search, k):
    grid = bm3d._ref_grid(128, block, max(1, block // 2))
    plan = k1.span_plan(grid, grid, block, search, k, "cpu")
    pitch = (k1.TILE_SPAN + 2 * search) | 1
    assert plan.smem_bytes == k1.span_smem_bytes(search, pitch, plan.most, k) <= MAX_SMEM
    assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.most <= k1.SPAN_MOST  # at most a thread of the CTA a block
    assert k1.span_entries(k) == max(k, 4)


# (block, step, search, size): every block, steps on and off the block, the
# last reference block off the step grid (sizes not on it).
MODEL_POINTS = [(2, 1, 3, 21), (3, 2, 2, 23), (4, 2, 3, 26), (5, 2, 4, 27), (6, 3, 3, 29), (7, 1, 2, 24),
                (9, 4, 2, 30), (10, 5, 3, 33), (11, 3, 2, 31), (12, 6, 2, 32), (13, 7, 2, 34), (14, 2, 1, 32),
                (15, 5, 2, 36), (16, 8, 3, 40)]


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block,step,search,size", MODEL_POINTS)
def test_the_kernels_order_of_adds_gives_the_plain_distances(block, step, search, size, mode):
    rows, cols = bm3d._ref_grid(size, block, step), bm3d._ref_grid(size + 3, block, step)
    offs = bm3d.search_offsets(search, 1)
    tie = chip_smoke.near_tie(block)
    for make, exact in ((_noisy, False), (_dyadic, True)):
        x = make((2, size, size + 3), block)
        got = model_distances(x, rows, cols, offs, block, mode)
        want = k1.match_distances_plain(torch.tensor(x), rows, cols, offs, block, mode).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        if exact:
            assert np.array_equal(got, want)
        else:
            fin = np.isfinite(want)
            gap = np.abs(got[fin] - want[fin]) / np.maximum(np.maximum(got[fin], want[fin]), 1e-30)
            assert gap.max() <= tie


def _set_agreement(a, b) -> float:
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), np.asarray(b).reshape(-1, b.shape[-1])
    return float(np.mean([len(set(p) & set(q)) / a.shape[1] for p, q in zip(a, b)]))


# (block, step, search, k, size): chip_smoke.py's rows off block 8, cut to
# 32-48 px.
JAX_POINTS = [(2, 1, 3, 4, 32), (4, 2, 3, 4, 32), (5, 2, 4, 8, 40), (6, 3, 6, 8, 40), (16, 8, 8, 16, 48)]


@pytest.mark.parametrize("block,step,search,k,size", JAX_POINTS)
def test_plain_matcher_agrees_with_the_pallas_matcher_off_block_8(block, step, search, k, size):
    rows = bm3d._ref_grid(size, block, step)
    offs = bm3d.search_offsets(search, 1)
    for make, exact in ((_noisy, False), (_dyadic, True)):
        x = make((2, size, size), block + 100)
        want = np.asarray(bm3d_match_pallas(jnp.asarray(x), tuple(rows.tolist()), tuple(rows.tolist()),
                                            tuple(map(tuple, offs.tolist())), block, k, interpret=True))
        got = k1.bm3d_match_plain(torch.tensor(x), rows, rows, offs, block, k).numpy()
        assert got.shape == want.shape == (2, len(rows), len(rows), k)
        if exact:
            assert np.array_equal(got, want)
        else:
            # Exact top-k on both sides; f32 sums in another order may swap
            # a near-tied member in or out.
            assert _set_agreement(got, want) >= 0.999


def test_envelope_rows_off_block_8_go_to_the_span_kernel():
    off8 = {row: v for row, v in chip_smoke.ENVELOPE_K1.items() if v[0] != 8}
    assert set(off8) == {"golden", "block2", "block5", "block6", "block16", "block4_s19"}
    for block, step, search, k, _ in off8.values():
        grid = bm3d._ref_grid(128, block, step)
        g = k1.match_geometry(grid, grid, bm3d.search_offsets(search, 1), block, "cpu")
        assert k1.match_kernel(g, block, k) == "bm3d_match_span_kernel" != k1.PREV_DESIGN


@pytest.mark.parametrize("search,k", [(3, 4), (19, 16), (40, 16), (50, 16), (60, 128), (103, 16)])
def test_span_tiles_let_three_ctas_share_an_sm_or_else_fill_one(search, k):
    # Within SPAN_BUDGET (three CTAs an SM) where it holds a block; past
    # that (a wide window's region), as many blocks as one CTA's 227 KB hold.
    most = k1.span_most(search, k)
    pitch = (k1.TILE_SPAN + 2 * search) | 1
    need = lambda n: k1.span_smem_bytes(search, pitch, n, k) + 4  # noqa: E731  (with the alignment word)
    budget = k1.SPAN_BUDGET if need(1) <= k1.SPAN_BUDGET else 227 * 1024
    assert 1 <= most <= k1.SPAN_MOST and need(most) <= budget
    assert most == k1.SPAN_MOST or need(most + 1) > budget
    assert (budget == k1.SPAN_BUDGET) == (search <= 50)  # (60, 128) and (103, 16): one CTA an SM
