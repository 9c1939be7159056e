"""K2's and K3's choice of kernel, the host-made plans of the packed K2
kernel and the cluster K3 kernel, and the cluster kernel's order of adds, on
the CPU.

``aggregate_kernel`` (``ops/cuda/bm3d_aggregate.py``) names the K2 tile
kernel of a call: ``bm3d_aggregate_kernel`` keeps its compiled (8, 16) and
(8, 32), every BM3D lane's; ``bm3d_aggregate_packed_kernel`` takes the rest,
on the tiles ``packed_plan`` chooses. ``nlm_kernel_name``
(``ops/cuda/nlm.py``) names the K3 kernel: ``nlm_kernel`` keeps (4, 5),
every NLM lane's but csmri_nlm_skimage's; ``nlm_cluster_kernel`` takes the
rest, its shifts split by ``cluster_plan`` and ``split_chunks``. Here each
plan is held to what its kernel reads of it, over the envelope, and the
cluster kernel's order of adds (box sums by doubling trees, each lane two
columns, partial sums by warp, then by CTA) is emulated in torch and held
to the JAX package's ``nlm_denoise`` within 1e-5. The kernels themselves
are held to their plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The JAX reference with row bounds at (7, 11) and (11, 15) is a fixture,
``nlm_bounds_jax.npz``: eager ``nlm_denoise`` takes minutes there (a
compile a shift). Rebuild it with
``PYTHONPATH=.:tests python tests/test_torch_kernel_plans.py`` (about 6
minutes).
"""

from __future__ import annotations

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from pnp_svrg_tpu.denoisers.nlm import nlm_denoise as jax_nlm_denoise
from pnp_svrg_tpu.ops.pallas.nlm_kernel import nlm_denoise_pallas
from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, CSMRI_BATCH_LANES, NLM_SKIMAGE, bench_config
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.utils.io import DATA_DIR

COMPILED, PACKED = k2.K2_KERNELS
FIRST_NLM, CLUSTER = k3.K3_KERNELS[:2]
MAX_SMEM = 227 * 1024
FIXTURE = DATA_DIR.parent / "pnp_svrg_tpu_torch" / "data" / "nlm_bounds_jax.npz"


def _constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>`` in ``csrc/<source>.cu``."""
    text = (_build.SRC_DIR / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# --- which kernel takes a call ------------------------------------------------


def _bm3d_calls() -> dict:
    """label -> BM3DParams of every BM3D lane the card runs: the 13-lane
    CSMRI lanes, bm3d_profile, the bench lanes, the sweep and the drivers."""
    calls = {label: spec[3] for label, spec in chip_smoke.CSMRI_LANES.items()}
    calls |= {label: spec[3] for label, spec in CSMRI_BATCH_LANES.items()}
    calls["bm3d_profile"] = BM3D_PROFILE_LANE[3]
    calls |= {label: bench_config(label)["params"] for label in chip_smoke.BENCH_RUNS}
    calls["sweep_and_drivers"] = bm3d.BM3DParams(search=8)
    return calls


def _k2_geometry(size: int, p: bm3d.BM3DParams):
    """K2's geometry of a BM3D call on a ``size`` px image, on the CPU (its
    plans are made on the host)."""
    grid = tuple(bm3d._ref_grid(size, p.block, p.step).tolist())
    search = int(np.abs(bm3d.search_offsets(p.search, p.search_step)).max())
    return k2.aggregate_geometry(size, size, grid, grid, search, p.block, torch.device("cpu"))


@pytest.mark.parametrize("label", list(_bm3d_calls()))
def test_every_bm3d_lane_keeps_the_compiled_k2_kernel(label):
    p = _bm3d_calls()[label]
    for k in (p.group_ht, p.group_wie):
        assert k2.aggregate_kernel(p.block, k) == COMPILED
        for size in (128, 256):  # the lanes' images
            geometry = _k2_geometry(size, p)
            assert k2.aggregate_kernel(p.block, k, geometry) == COMPILED
            assert k2.aggregate_plan(geometry, k) == (COMPILED, geometry)


@pytest.mark.parametrize("size", [128, 256])
@pytest.mark.parametrize("k", [16, 32])
def test_k2_sends_windows_past_the_compiled_tiles_to_the_packed_kernel(size, k):
    # (8, 16) and (8, 32) at step 3: the compiled kernel's 4 warps hold a 2
    # x 2 tile's (2 search + 11)^2 planes to search 37 (231,200 bytes), not
    # 38 (242,208); past that the packed kernel takes the call, one warp a
    # CTA on tiles whose planes fit one CTA (one reference block a tile on
    # 256 px images at search 81).
    for search in (19, 37, 38, 40, 81, 95):
        p = bm3d.BM3DParams(block=8, step=3, search=search, group_ht=k, group_wie=k)
        geometry = _k2_geometry(size, p)
        want = COMPILED if search <= 37 else PACKED
        assert k2.aggregate_kernel(8, k, geometry) == want
        if size == 256 and search > 81:
            continue  # refused: tests/test_torch_params.py
        kernel, plan = k2.aggregate_plan(geometry, k)
        assert kernel == want and plan.smem_bytes <= MAX_SMEM
        if kernel == PACKED:
            assert plan.warps == 1 and plan.fh == plan.fw == min(size, 2 * search + 8 + 3 * (plan.tile - 1))


@pytest.mark.parametrize("block", list(range(2, 17)))
def test_k2_runtime_path_takes_the_packed_kernel(block):
    for k in (1, 2, 4, 8, 16, 32, 64):
        want = COMPILED if (block, k) in ((8, 16), (8, 32)) else PACKED
        assert k2.aggregate_kernel(block, k) == want


def test_every_nlm_lane_keeps_its_k3_kernel():
    # csmri_nlm, the grid, the loops, the sweep and compat run NLMDenoiser's
    # defaults; csmri_nlm_skimage runs skimage's, now on the cluster kernel.
    den = NLMDenoiser()
    assert k3.nlm_kernel_name(den.patch_size, den.patch_distance) == FIRST_NLM
    assert k3.nlm_kernel_name(**NLM_SKIMAGE) == CLUSTER
    for p in range(1, 12):
        for d in range(1, 16):
            assert k3.nlm_kernel_name(p, d) == (FIRST_NLM if (p, d) == (4, 5) else CLUSTER)


# --- K2's packed plan ---------------------------------------------------------


def test_k2_plan_constants_are_the_sources():
    assert k2.PACKED_MAX_WARPS == _constant("bm3d_aggregate", "kPackedMaxWarps")
    assert (k2.TILE_R, k2.TILE_C) == (_constant("bm3d_aggregate", "kTileR"), _constant("bm3d_aggregate", "kTileC"))


def _members(grid, search, block, size):
    """(n, 2 search + 1) clipped member coordinates along one axis, as
    ``_gather_groups`` places them."""
    return np.clip(np.asarray(grid)[:, None] + np.arange(-search, search + 1)[None, :], 0, size - block)


# (block, size) cells of the envelope; each runs every step 1-block (a few),
# search 0-24 (a few) and K 1-64.
PLAN_CELLS = [(b, s) for b in (2, 3, 4, 5, 6, 7, 8, 11, 16) for s in (32, 48, 128) if s >= 2 * b]
SEARCHES = (0, 1, 3, 6, 8, 13, 19, 24)


@pytest.mark.parametrize("block,size", PLAN_CELLS)
def test_k2_packed_plan_holds_every_member_and_lists_every_covering_tile(block, size):
    for step in sorted({1, max(1, block // 2), block}):
        grid = bm3d._ref_grid(size, block, step)
        for search, k in itertools.product(SEARCHES, (1, 4, 16, 64)):
            edge, warps, groups = k2.packed_plan(size, size, grid, grid, search, block, k)
            assert edge >= k2.TILE_R and 1 <= warps <= k2.PACKED_MAX_WARPS
            assert groups == 1 or (groups * block * block <= 32 and groups <= k2.lane_groups(block))
            oy, _, fh, fw = k2.footprints(size, size, grid, grid, search, block, (edge, edge))
            assert fh == fw and k2.packed_smem(fh, fw, warps, groups) <= MAX_SMEM
            # no more scratch than the 2 x 2 tiles'
            poy, _, pfh, _ = k2.footprints(size, size, grid, grid, search, block)
            assert len(oy) ** 2 * fh * fw <= len(poy) ** 2 * pfh * pfh
            # every clipped member of a tile inside its footprint
            members = _members(grid, search, block, size)
            assert len(oy) == -(-len(grid) // edge) and oy == sorted(oy)
            for t, origin in enumerate(oy):
                m = members[t * edge : (t + 1) * edge]
                assert origin >= 0 and m.min() >= origin and m.max() + block <= origin + fh
            # the covering lists: every tile whose members reach a pixel, in
            # ascending order, each listed tile's footprint holding it
            cover = k2.covering_tiles(oy, fh, size)
            for t in range(len(oy)):
                m = members[t * edge : (t + 1) * edge]
                assert all(cover[y][0] <= t <= cover[y][1] for y in range(m.min(), m.max() + block))
            for y, (first, last) in enumerate(cover):
                assert all(oy[t] <= y < oy[t] + fh for t in range(first, last + 1))


def test_k2_packed_plan_at_the_runtime_rows():
    # chip_smoke.py's run-time rows at 128 px: one warp of packed lanes for
    # small patches, two warps otherwise, and tiles of at least 1,024 member
    # values a warp, each CTA in 64 KB.
    want = {"golden": (4, 1, 2), "block2": (8, 1, 8), "block6": (3, 2, 1), "block8_k8": (2, 2, 1),
            "block16": (2, 2, 1)}
    assert list(chip_smoke.ENVELOPE_K2_RUNTIME) == list(want)
    for row, (block, step, search, k) in chip_smoke.ENVELOPE_K2_RUNTIME.items():
        grid = bm3d._ref_grid(128, block, step)
        edge, warps, groups = k2.packed_plan(128, 128, grid, grid, search, block, k)
        assert (edge, warps, groups) == want[row]
        assert edge * edge * k * block * block >= k2.PACKED_VALUES * warps
        _, _, fh, fw = k2.footprints(128, 128, grid, grid, search, block, (edge, edge))
        assert k2.packed_smem(fh, fw, warps, groups) <= k2.PACKED_SMEM


# --- K3's cluster plan --------------------------------------------------------


def test_k3_plan_constants_are_the_sources():
    assert k3.CLUSTER_MAX_WARPS == _constant("nlm", "kClusterMaxWarps")
    assert k3.MAX_CLUSTER == _constant("nlm", "kMaxCluster")
    text = (_build.SRC_DIR / "nlm.cu").read_text()
    built = set(re.findall(r"nlm_cluster_kernel<(\d+), (\d+)>;", text))  # kernel_of's instantiations
    assert built == {(str(p), str(r)) for p in range(1, 12) for r in k3.THREAD_ROWS}


@pytest.mark.parametrize("distance", [1, 2, 5, 11, 15])
def test_k3_split_assigns_every_shift_once_in_dy_major_order(distance):
    shifts = (2 * distance + 1) ** 2
    for cluster in range(1, k3.MAX_CLUSTER + 1):
        for warps in range(1, k3.CLUSTER_MAX_WARPS + 1):
            chunks = k3.split_chunks(shifts, cluster, warps)
            assert len(chunks) == cluster * warps
            assert [q for a, b in chunks for q in range(a, b)] == list(range(shifts))


@pytest.mark.parametrize("b", [1, 9, 36])
@pytest.mark.parametrize("wps", [8, 12, 16, 20, 32])
def test_k3_cluster_plan_fits_the_card(b, wps):
    for p in range(1, 12):
        for d in (1, 2, 5, 11, 15):
            cluster, warps, rows = k3.cluster_plan(b, 128, 128, p, d, 132, wps)
            assert 1 <= cluster <= k3.MAX_CLUSTER and warps in (4, 6, 8) and rows == (4 if d <= 2 else 8)
            assert cluster * warps <= (2 * d + 1) ** 2  # every warp a shift
            tiles = -(-128 // (33 - p)) * -(-128 // (2 * rows)) * b
            per_sm = -(-tiles * cluster // 132)
            smem = k3.cluster_smem(p, d, warps, rows)
            assert smem <= MAX_SMEM
            resident = per_sm * warps <= wps and per_sm * (smem + 1024) <= k3.SM_SMEM
            assert resident or (cluster, warps) == (1, 4)  # else one CTA of 4 warps a tile


def test_k3_cluster_plan_at_the_rows():
    # chip_smoke.py's K3 rows on an H100 (132 SMs, 16 warps of 128
    # registers an SM; 12 at (11, 15)'s 168): the plans the grids in
    # k3_variants.py found fastest or within a few per cent of it.
    want = {((7, 11), 1): (5, 6, 8), ((7, 11), 9): (1, 4, 8), ((1, 1), 1): (1, 8, 4), ((1, 1), 9): (1, 4, 4),
            ((11, 15), 1): (4, 6, 8), ((11, 15), 9): (1, 4, 8)}
    for (pd, b), plan in want.items():
        assert k3.cluster_plan(b, 128, 128, *pd, 132, 12 if pd[0] == 11 else 16) == plan


def test_k3_partial_buffers_are_sized_right():
    # The kernel's layout: the tile and its one-column shift, each
    # (2 R + P - 1 + 2D) x (32 + 2D) f32 (R rows a thread), then wsum and
    # acc planes of 2 R x 32 for each warp; the largest in the envelope
    # within 227 KB.
    for p in range(1, 12):
        for d in range(1, 16):
            for warps in range(1, 9):
                for rows in k3.THREAD_ROWS:
                    tile = (2 * rows + p - 1 + 2 * d) * (32 + 2 * d)
                    assert k3.cluster_smem(p, d, warps, rows) == 4 * (2 * tile + 2 * warps * 2 * rows * 32)
    assert k3.cluster_smem(11, 15, 8, 8) <= MAX_SMEM


# --- K3's order of adds -------------------------------------------------------


def window_of(p: int, e: int) -> list:
    """csrc/nlm.cu's ``window_of``: the pieces (kind, lane offset) of the
    window of the output at column 2 j + e of a lane j, in adding order:
    kind 0 column 2 j', 1 column 2 j' + 1, 2 + k the 2^k column pairs from
    lane j'."""
    pieces, delta, cols = [], e - p // 2, p
    if delta & 1:
        pieces.append((1, (delta - 1) // 2))
        delta, cols = delta + 1, cols - 1
    lane, pairs = delta // 2, cols // 2
    for k in range(3):
        if pairs & (1 << k):
            pieces.append((2 + k, lane))
            lane += 1 << k
    if cols & 1:
        pieces.append((0, lane))
    return pieces


@pytest.mark.parametrize("p", list(range(1, 12)))
def test_k3_windows_cover_each_output_window_once(p):
    for e in (0, 1):
        cols = []
        for kind, off in window_of(p, e):
            first = 2 * off + (kind == 1)
            cols += list(range(first, first + (1 if kind < 2 else 2 << (kind - 2))))
        assert cols == list(range(e - p // 2, e - p // 2 + p))


def _column_boxes(sq: torch.Tensor, p: int, rows: int) -> torch.Tensor:
    """P-row box sums of (B, rows + P - 1, C) squares as the kernel forms
    them: pair sums, fours, eights, then the ascending runs making up P."""
    levels = [sq]
    for k in range(1, 4):
        if (1 << k) <= p:
            half = 1 << (k - 1)
            levels.append(levels[-1][:, :-half] + levels[-1][:, half:])
    out, o = None, 0
    for k in range(4):
        if p & (1 << k):
            v = levels[k][:, o : o + rows]
            out = v if out is None else out + v
            o += 1 << k
    return out


def _window_sums(box: torch.Tensor, p: int, w: int) -> torch.Tensor:
    """(B, H, W) window sums of the (B, H, W + 2 pad) column boxes in the
    kernel's order: strips of 33 - P output columns, each lane two columns,
    pair sums and their doubling across lanes, each window its pieces."""
    pad, out_cols = p // 2, 33 - p
    b, h, wc = box.shape
    dist = torch.empty((b, h, w), dtype=box.dtype)
    lane = torch.arange(16)
    for j0 in range(0, w, out_cols):
        c = F.pad(box[..., j0 : j0 + 32], (0, 32 - min(32, wc - j0)))
        kinds = {0: c[..., 0::2], 1: c[..., 1::2]}
        kinds[2] = kinds[0] + kinds[1]
        for k in (3, 4):
            prev, half = kinds[k - 1], 1 << (k - 3)
            kinds[k] = prev + prev[..., torch.clamp(lane + half, max=15)]
        for e in (0, 1):
            s = None
            for kind, off in window_of(p, e):
                v = kinds[kind][..., torch.clamp(lane + off, 0, 15)]
                s = v if s is None else s + v
            t = 2 * lane + e  # local column; output column j0 - pad + t
            keep = (t >= pad) & (t < pad + out_cols) & (j0 - pad + t < w)
            dist[..., (j0 - pad + t)[keep]] = s[..., keep]
    return dist


def cluster_order_nlm(x: torch.Tensor, h, sigma, p: int, d: int, bounds, plan: tuple) -> torch.Tensor:
    """nlm_cluster_kernel's order of adds in torch (f32; ``exp`` for its
    ``ex2.approx``): each shift's box sums as :func:`_column_boxes` and
    :func:`_window_sums` form them, each (CTA rank, warp) chunk of
    :func:`split_chunks` summed shift by shift, the chunks of a CTA in warp
    order, then the CTAs in rank order."""
    b, hh, ww = x.shape
    pad = p // 2
    xp = F.pad(x[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
    h = torch.as_tensor(h, dtype=torch.float32).reshape(-1, 1, 1)
    sigma = torch.as_tensor(sigma, dtype=torch.float32).reshape(-1, 1, 1)
    inv_h2 = 1.0 / (h * h * p * p)
    offset = 2.0 * sigma * sigma * (p * p)
    lo, hi = bounds or (0, hh)
    row, col = torch.arange(hh)[:, None], torch.arange(ww)[None, :]
    shifts = [(dy, dx) for dy in range(-d, d + 1) for dx in range(-d, d + 1)]
    cluster, warps = plan[:2]
    partial = []
    for q0, q1 in k3.split_chunks(len(shifts), cluster, warps):
        wsum, acc = torch.zeros_like(x), torch.zeros_like(x)
        for dy, dx in shifts[q0:q1]:
            sq = (xp - torch.roll(xp, (-dy, -dx), dims=(-2, -1))) ** 2
            dist = _window_sums(_column_boxes(sq, p, hh), p, ww)
            wgt = torch.exp(-torch.clamp_min(dist - offset, 0.0) * inv_h2)
            wgt = wgt * ((row + dy >= lo) & (row + dy < hi) & (col + dx >= 0) & (col + dx < ww)).float()
            wsum = wsum + wgt
            acc = acc + wgt * torch.roll(x, (-dy, -dx), dims=(-2, -1))
        partial.append((wsum, acc))
    ctas = []
    for r in range(cluster):
        ws, ac = partial[r * warps]
        for s in range(1, warps):
            ws, ac = ws + partial[r * warps + s][0], ac + partial[r * warps + s][1]
        ctas.append((ws, ac))
    ws, ac = ctas[0]
    for w_, a_ in ctas[1:]:
        ws, ac = ws + w_, ac + a_
    return ac / torch.clamp_min(ws, 1e-12)


def _batch() -> tuple:
    rng = np.random.default_rng(15)
    yy, xx = np.mgrid[:32, :40]
    clean = np.clip(0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.0), 0, 1)
    clean[8:16, 10:20] = 0.9
    x = (clean + 0.08 * rng.standard_normal((3, 32, 40))).astype(np.float32)
    return x, np.asarray([0.05, 0.08, 0.12], np.float32), np.asarray([0.05, 0.08, 0.0], np.float32)


NLM_POINTS = [(1, 1), (2, 3), (7, 11), (11, 15)]
NLM_BOUNDS = (4, 28)
FIXTURE_POINTS = ((7, 11), (11, 15))  # the bounded JAX reference in the fixture


def _jax_reference(x, h, s, p, d, bounds):
    if bounds is None and (p, d) in FIXTURE_POINTS:  # held to nlm_denoise by the JAX package's tests
        return np.asarray(nlm_denoise_pallas(jnp.asarray(x), jnp.asarray(h), jnp.asarray(s), p, d, interpret=True))
    if bounds is not None and (p, d) in FIXTURE_POINTS:
        ref = np.load(FIXTURE)
        assert np.array_equal(ref["x"], x) and tuple(ref["bounds"]) == bounds
        return ref[f"p{p}_d{d}"]
    return np.asarray(jax_nlm_denoise(jnp.asarray(x), jnp.asarray(h), jnp.asarray(s), p, d, row_valid_bounds=bounds))


@pytest.mark.parametrize("bounds", [None, NLM_BOUNDS])
@pytest.mark.parametrize("p,d", NLM_POINTS)
def test_k3_cluster_order_of_adds_matches_jax(p, d, bounds):
    x, h, s = _batch()
    want = _jax_reference(x, h, s, p, d, bounds)
    # The plan an H100 takes for this batch (132 SMs, 16 warps an SM), and
    # one that splits the shifts further.
    for plan in (k3.cluster_plan(3, 32, 40, p, d, 132, 16), (3, 5, 8)):
        got = cluster_order_nlm(torch.tensor(x), h, s, p, d, bounds, plan).numpy()
        assert float(np.abs(got - want).max()) <= 1e-5, plan


def build_bounds_fixture() -> None:
    """The JAX package's ``nlm_denoise`` with row bounds at
    :data:`FIXTURE_POINTS` on :func:`_batch` (eager: minutes a point)."""
    x, h, s = _batch()
    out = {"x": x, "h": h, "s": s, "bounds": np.asarray(NLM_BOUNDS)}
    for p, d in FIXTURE_POINTS:
        out[f"p{p}_d{d}"] = np.asarray(jax_nlm_denoise(jnp.asarray(x), jnp.asarray(h), jnp.asarray(s), p, d,
                                                       row_valid_bounds=NLM_BOUNDS))
    np.savez_compressed(FIXTURE, **out)


if __name__ == "__main__":
    build_bounds_fixture()
