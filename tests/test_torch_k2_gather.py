"""K2's gather form (``bm3d_aggregate_gather_kernel``) on the CPU: its member
index, its order of adds and the rule that sends a call to it.

The kernel builds a per-call index of each image's members bucketed by
patch position (row ``py * ww + px``), each bucket in ascending member id,
and sums every output pixel's terms in ascending (patch position, member
id). Here the index's plain version (``member_index_plain``) is held to a
numpy sort, and a plain walk of the kernel's order of adds (``_walk``:
the pixels' buckets in ascending order, each bucket's members in order) to
``bm3d_aggregate_plain`` (bit for bit on dyadic values, 1e-6 of the planes
otherwise), to the JAX package's ``_aggregate`` and to
``bm3d_scatter_pallas`` in interpret mode followed by ``_unfold_table``,
at the (block, step, search, K) of the five rows where staged footprints
lost to ``index_add_`` (search 40 and 95 become windows wider than the
image). The kernel itself is held to its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu.ops.pallas.bm3d_scatter import bm3d_scatter_pallas
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2

GATHER = k2.K2_KERNELS[2]
# The five rows (block, step, search, K) and the image edge each is tried at.
ROWS = {"block1": ((1, 1, 3, 4), 32), "block4_step6": ((4, 6, 3, 4), 48), "block24": ((24, 12, 8, 16), 48),
        "search40": ((8, 3, 40, 32), 48), "search_widest": ((8, 3, 95, 16), 32)}
# As tests/test_torch_aggregate.py: the two packages sum in different
# orders, planes up to a few hundred.
TOL = dict(atol=1e-5, rtol=1e-6)
# Jitted: eager JAX compiles each of the unfold-add's block^2 pads alone
# (a minute at block 24).
_jax_aggregate = jax.jit(jbm3d._aggregate, static_argnums=(4, 5, 6))
_jax_unfold = jax.jit(jbm3d._unfold_table, static_argnums=(1, 2, 3))


def _members(row: str, seed: int = 0, dyadic: bool = False):
    """(est (B, nR, nC, K, b*b), wgt (B, nR, nC), py, px (B, nR, nC, K), kaiser,
    size) for B = 2 images: each member a patch of the image at most
    ``search`` from its reference block along each axis (K1 takes no
    candidate off the image), drawn uniformly; values like BM3D's
    (estimates in [0, 1]), or dyadic."""
    (block, step, search, k), size = ROWS[row]
    rng = np.random.default_rng(seed)
    grid = bm3d._ref_grid(size, block, step)
    n = len(grid)
    lo = np.maximum(grid - search, 0)
    span = np.minimum(grid + search, size - block) - lo + 1
    py = lo[None, :, None, None] + (rng.random((2, n, n, k)) * span[None, :, None, None]).astype(np.int64)
    px = lo[None, None, :, None] + (rng.random((2, n, n, k)) * span[None, None, :, None]).astype(np.int64)
    bb = block * block
    if dyadic:
        est = 0.125 * rng.integers(0, 17, (2, n, n, k, bb)) - 1.0
        wgt = 2.0 ** rng.integers(-2, 3, (2, n, n))
        kai = 0.25 * rng.integers(0, 5, bb) + 0.25
    else:
        est = rng.uniform(0.0, 1.0, (2, n, n, k, bb))
        wgt = rng.uniform(0.5, 2.0, (2, n, n))
        kai = rng.uniform(0.1, 1.0, bb)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(est), f32(wgt), py, px, f32(kai), size


def _k2_args(est, wgt, py, px, kai, size):
    """K2's (idx, est, wgt, kaiser, h, w) of those members, as torch tensors."""
    b, block = est.shape[0], math.isqrt(est.shape[-1])
    idx = (py * (size - block + 1) + px).reshape(b, -1).astype(np.int32)
    return (torch.tensor(idx), torch.tensor(est).reshape(b, -1, est.shape[-1]), torch.tensor(wgt).reshape(b, -1),
            torch.tensor(kai), size, size)


def _walk(idx, est, wgt, kaiser, h, w):
    """The gather kernel's sums in its order of adds, in plain PyTorch: every
    pixel adds its terms in the index's order (ascending row ``py * ww +
    px``, then member id), wk = wgt * kaiser and then est * wk, one f32 add
    at a time; pixels no member covers add nothing. The index's entries,
    each spread over its patch's pixels, are sorted stably by pixel, so each
    pixel's terms stay in index order, and summed position by position."""
    b, p, bb = est.shape
    block, k = math.isqrt(bb), p // wgt.shape[1]
    ww = w - block + 1
    offsets, ids = k2.member_index_plain(idx, (h - block + 1) * ww)
    ky = torch.arange(block).repeat_interleave(block)
    kx = torch.arange(block).repeat(block)
    planes = torch.zeros((2, b, h * w))
    for i in range(b):
        m = ids[i * p : int(offsets[i, -1])].long()  # the image's members in index order
        r = idx[i, m].long()
        pix = (((r // ww)[:, None] + ky) * w + (r % ww)[:, None] + kx).reshape(-1)
        wk = wgt[i, m // k][:, None] * kaiser
        terms = torch.stack([(est[i, m] * wk).reshape(-1), wk.reshape(-1)])
        pix, order = torch.sort(pix, stable=True)
        terms = terms[:, order]
        first = torch.searchsorted(pix, pix, right=False)
        pos = torch.arange(len(pix)) - first  # each term's place among its pixel's
        for t in range(int(pos.max()) + 1 if len(pos) else 0):
            at = pos == t
            planes[:, i, pix[at]] += terms[:, at]  # one add a pixel: its t-th term
    return planes[0].view(b, h, w), planes[1].view(b, h, w)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Six workers of eight intra-op threads each slowed this file's many
    # small torch ops thirtyfold; one thread a worker, restored after.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("row", list(ROWS))
def test_member_index_plain_lists_every_in_range_member_once_in_order(row):
    est, wgt, py, px, kai, size = _members(row, seed=1)
    idx, *_ = _k2_args(est, wgt, py, px, kai, size)
    block = math.isqrt(est.shape[-1])
    n_rows = (size - block + 1) ** 2
    idx[0, :3] = torch.tensor([-1, n_rows, 2**30], dtype=torch.int32)  # rows off the table
    idx[1, 5:40] = n_rows - 1  # one crowded bucket
    offsets, ids = k2.member_index_plain(idx, n_rows)
    b, p = idx.shape
    assert offsets.shape == (b, n_rows + 1) and ids.shape == (b * p,)
    for i in range(b):
        rows = idx[i].numpy().astype(np.int64)
        keep = np.flatnonzero((rows >= 0) & (rows < n_rows))
        want = keep[np.lexsort((keep, rows[keep]))]  # by row, then member id
        got = ids[i * p : int(offsets[i, -1])].numpy()
        assert offsets[i, 0] == i * p and np.array_equal(got, want)
        counts = np.diff(offsets[i].numpy())
        assert np.array_equal(counts, np.bincount(rows[keep], minlength=n_rows))
        for r in np.flatnonzero(counts)[:50]:
            members = ids[int(offsets[i, r]) : int(offsets[i, r + 1])].numpy()
            assert np.all(rows[members] == r) and np.all(np.diff(members) > 0)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("row", list(ROWS))
def test_gather_order_of_adds_equals_the_plain_version(row, dyadic):
    args = _k2_args(*_members(row, seed=2, dyadic=dyadic))
    got = _walk(*args)
    want = k2.bm3d_aggregate_plain(*args)
    for g_, w_ in zip(got, want):
        if dyadic:  # every term and partial sum exact: any order gives the same bits
            assert torch.equal(g_, w_)
        else:
            assert float((g_ - w_).abs().max()) <= 1e-6 * float(w_.abs().max())
    if ROWS[row][0][1] > ROWS[row][0][0]:  # a step past the block: uncovered pixels keep 0
        assert bool((want[1] == 0).any()) and torch.equal(got[1] == 0, want[1] == 0)


@pytest.mark.parametrize("row", list(ROWS))
def test_gather_order_of_adds_matches_jax_aggregate(row):
    est, wgt, py, px, kai, size = _members(row, seed=3)
    block = math.isqrt(est.shape[-1])
    want_num, want_den = _jax_aggregate(jnp.asarray(est), jnp.asarray(wgt), jnp.asarray(py), jnp.asarray(px),
                                        block, size, size, jnp.asarray(kai))
    num, den = _walk(*_k2_args(est, wgt, py, px, kai, size))
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), **TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(want_den), **TOL)


@pytest.mark.parametrize("row", list(ROWS))
def test_gather_order_of_adds_matches_pallas_scatter_and_unfold(row):
    est, wgt, py, px, kai, size = _members(row, seed=4)
    idx, est_t, wgt_t, kai_t, h, w = _k2_args(est, wgt, py, px, kai, size)
    block, k = math.isqrt(est.shape[-1]), est.shape[3]
    wk = np.repeat(wgt_t.numpy(), k, axis=1)[..., None] * kai  # wk first, then est * wk
    upd = np.concatenate([est_t.numpy() * wk, np.broadcast_to(wk, est_t.shape)], axis=-1)
    hh = size - block + 1
    table = bm3d_scatter_pallas(jnp.asarray(idx.numpy()), jnp.asarray(upd), hh * hh, interpret=True)
    want_num, want_den = _jax_unfold(table.reshape(2, hh, hh, 2, block, block), block, size, size)
    num, den = _walk(idx, est_t, wgt_t, kai_t, h, w)
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), **TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(want_den), **TOL)


def _card_geometry(block, step, search, size=128):
    grid = tuple(bm3d._ref_grid(size, block, step).tolist())
    return k2.aggregate_geometry(size, size, grid, grid, search, block, torch.device("cpu"))


@pytest.mark.parametrize("row", list(ROWS))
def test_the_rule_sends_each_row_to_the_gather_form_and_each_lane_to_the_compiled_kernel(row):
    # chip_smoke.py's rows (B = 13 at 128 px) take the gather form; every
    # BM3D lane's calls stay on the compiled kernel
    # (tests/test_torch_kernel_plans.py holds all of them).
    (block, step, search, k), _ = ROWS[row]
    assert chip_smoke.ENVELOPE_K2_WIDE[row] == (block, step, search, k)
    geometry = _card_geometry(block, step, search)
    assert k2.aggregate_kernel(block, k, geometry) == GATHER
    kernel, plan = k2.aggregate_plan(geometry, k)
    assert kernel == GATHER and plan == k2.gather_plan(block, k2.per_row(geometry, k))
    headline = _card_geometry(8, 4, 8)
    assert k2.aggregate_plan(headline, 16) == (k2.K2_KERNELS[0], headline)


def test_index_plan_fits_the_index_kernel():
    # Runs of table rows a multiple of 32 long, every row in one, the rows
    # and the members kept in one CTA's shared memory (2 ints a row, 4 a
    # member, 35 more), and threads the kernel takes.
    for b in (1, 2, 13, 36, 200):
        for n_rows, p in ((1, 4), (31, 16), (900, 784), (11025, 1600), (14641, 53792), (16384, 65536),
                          (62001, 112896), (200000, 800000)):
            chunk, cap, threads = k2.index_plan(b, n_rows, p)
            runs = -(-n_rows // chunk)
            assert chunk % 32 == 0 and chunk <= k2.INDEX_MAX_ROWS and cap >= 4096
            assert threads == (1024 if p > 16384 else 512)
            assert (2 * chunk + 35 + 4 * cap) * 4 <= k2.INDEX_SMEM <= 227 * 1024
            assert runs * chunk >= n_rows and (runs - 1) * chunk < n_rows
