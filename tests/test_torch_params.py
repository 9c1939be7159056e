"""Port parity across the BM3D and NLM settings the JAX package accepts.

The port's kernels K1-K3 take a stated envelope of settings on the card
(``MATCH_ENVELOPE``, ``AGGREGATE_ENVELOPE``, ``NLM_ENVELOPE``); here, on the
CPU, their wrappers take the plain versions, which are held to the JAX
package at points inside it and off the kernels' first instantiations: the
golden oracle's BM3D (block 4, step 2, search 3, groups 4 / 4), a window
past 640 offsets with 32 Wiener matches, an odd block, and NLM at skimage's
defaults (patch 7, distance 11) and at the envelope's corners; and at the
corners the widened envelope took: a window wider than the image, a step
past the block, blocks 1 and 24, 128 Wiener matches, NLM at (13, 21) and
(21, 31). Inputs come from a numpy seed at 32-48 px. The kernels themselves are held to the plain
versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

Also here, without a card: each envelope function accepts its table's
corners and raises, naming the bound, on the first value past each; and the
least-time bounds ``chip_smoke.py`` reports take their kernel's parameters
and give the earlier rows' numbers at the earlier shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu.denoisers.nlm import nlm_denoise as jax_nlm_denoise
from pnp_svrg_tpu.ops.pallas.bm3d_match import bm3d_match_pallas
from pnp_svrg_tpu.ops.pallas.nlm_kernel import nlm_denoise_pallas
from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, NLM_SKIMAGE
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.parallel import bm3d_denoise_spatial, make_spatial_mesh, nlm_denoise_spatial

# (block, step, search, group_ht, group_wie): the golden oracle's point
# (tests/test_golden_parity.py), a 27 x 27 window (729 offsets, past the
# first K1 kernel's 640) with the reference profile's 16 / 32 matches, and
# an odd block.
BM3D_POINTS = {"golden": (4, 2, 3, 4, 4), "window729_k32": (8, 3, 13, 16, 32), "odd_block": (5, 2, 4, 8, 8),
               # Past the earlier envelope: a step past the block (gaps
               # between blocks), blocks 1 and 24, 128 Wiener matches of 169
               # offsets; and a window wider than the image (search 28 on a
               # 32 px image, every 4th offset: those past 24 are +inf).
               "step_past_block": (8, 10, 6, 16, 16), "block1": (1, 1, 2, 4, 4), "block24": (24, 12, 4, 4, 4),
               "k128": (4, 2, 6, 16, 128), "search_past_image": (8, 3, 28, 16, 16)}
# The points' search_step (1 unless named) and image size (32 unless named).
BM3D_SEARCH_STEP = {"search_past_image": 4}
BM3D_SIZE = {"window729_k32": 40, "step_past_block": 40, "block24": 40}
# Mean absolute difference of the denoised images, as test_torch_bm3d.py
# holds the default point: f32 sums in another order flip near-tied
# matches; bf16 distances tie more often.
BM3D_TOL = {"float32": 1e-3, "bfloat16": 5e-3}
# JAX's jnp ``nlm_denoise`` unrolls its shifts into one program: at (1, 1) and
# (3, 8) it is compiled here; at (7, 11) (529 shifts) and (11, 15) (961) the
# compile alone takes minutes on the CPU, so there the JAX side is the
# Pallas kernel in interpret mode, which the JAX package's own tests hold to
# ``nlm_denoise`` (tests/test_pallas_nlm.py).
NLM_POINTS = [(1, 1), (3, 8)]
NLM_PALLAS_POINTS = [(7, 11), (11, 15), (13, 21), (21, 31)]
NLM_TOL = 1e-5  # f32 sums in another order (test_torch_nlm.py)
H_LANES = np.asarray([0.05, 0.08, 0.12], np.float32)
S_LANES = np.asarray([0.05, 0.08, 0.0], np.float32)


def _noisy(shape, seed=0, sigma=0.1):
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    yy, xx = np.mgrid[:h, :w]
    clean = np.clip(0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.0), 0, 1)
    clean[h // 4:h // 2, w // 4:w // 2] = 0.9
    return (clean + sigma * rng.standard_normal(shape)).astype(np.float32)


def _params(point: str, match_dtype: str) -> dict:
    block, step, search, ght, gwie = BM3D_POINTS[point]
    return dict(block=block, step=step, search=search, group_ht=ght, group_wie=gwie,
                match_dtype=match_dtype, search_step=BM3D_SEARCH_STEP.get(point, 1))


def _set_agreement(a, b) -> float:
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), np.asarray(b).reshape(-1, b.shape[-1])
    return float(np.mean([len(set(p) & set(q)) / a.shape[1] for p, q in zip(a, b)]))


@pytest.mark.parametrize("match_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("point", list(BM3D_POINTS))
def test_bm3d_matches_jax_across_the_envelope(point, match_dtype):
    size = BM3D_SIZE.get(point, 32)
    x = _noisy((2, size, size), seed=1)
    sig = np.asarray([0.1, 0.12], np.float32)
    kw = _params(point, match_dtype)
    jax_denoise = jax.jit(jbm3d.bm3d_denoise_batch, static_argnames=("params", "stages"))
    want = np.asarray(jax_denoise(jnp.asarray(x), jnp.asarray(sig), params=jbm3d.BM3DParams(**kw)))
    got = bm3d.bm3d_denoise_batch(torch.tensor(x), torch.tensor(sig), bm3d.BM3DParams(**kw)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).mean()) < BM3D_TOL[match_dtype]


def test_reference_profile_is_the_bm3d_profile_lane():
    """The card's bm3d_profile lane runs bm3d 3.0.9's default profile: 8 x 8
    blocks, step 3, a 39 x 39 window, 16 and 32 matches."""
    p = BM3D_PROFILE_LANE[3]
    assert (p.block, p.step, p.search, p.group_ht, p.group_wie) == (8, 3, 19, 16, 32)
    assert len(bm3d.search_offsets(p.search, p.search_step)) == 1521
    assert NLM_SKIMAGE == {"patch_size": 7, "patch_distance": 11}


@pytest.mark.parametrize("patch_size,patch_distance", NLM_POINTS)
def test_nlm_matches_jax_across_the_envelope(patch_size, patch_distance):
    x = _noisy((3, 40, 36), seed=2, sigma=0.08)
    jax_denoise = jax.jit(jax_nlm_denoise, static_argnames=("patch_size", "patch_distance"))
    want = jax_denoise(jnp.asarray(x), jnp.asarray(H_LANES), jnp.asarray(S_LANES),
                       patch_size=patch_size, patch_distance=patch_distance)
    got = k3.nlm_denoise(torch.tensor(x), torch.tensor(H_LANES), torch.tensor(S_LANES),
                         patch_size, patch_distance)
    assert got.shape == x.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= NLM_TOL


def test_pallas_matcher_in_interpret_mode_with_32_matches_past_640_offsets():
    x = _noisy((1, 32, 32), seed=3)
    rows = bm3d._ref_grid(32, 8, 3)
    offs = bm3d.search_offsets(13, 1)
    assert len(offs) == 729
    want = bm3d_match_pallas(jnp.asarray(x), tuple(rows.tolist()), tuple(rows.tolist()),
                             tuple(map(tuple, offs.tolist())), 8, 32, interpret=True)
    got = k1.bm3d_match_plain(torch.tensor(x), rows, rows, offs, 8, 32)
    assert got.shape == want.shape == (1, len(rows), len(rows), 32)
    # Exact top-k on both sides; f32 sums in another order may swap a
    # near-tied member in or out (test_torch_bm3d.py's f32 floor).
    assert _set_agreement(got.numpy(), want) >= 0.999


@pytest.mark.parametrize("patch_size,patch_distance", NLM_PALLAS_POINTS)
def test_pallas_nlm_in_interpret_mode_at_skimage_defaults_and_the_far_corner(patch_size, patch_distance):
    x = _noisy((3, 32, 40), seed=4, sigma=0.08)
    want = nlm_denoise_pallas(jnp.asarray(x), jnp.asarray(H_LANES), jnp.asarray(S_LANES),
                              patch_size, patch_distance, interpret=True)
    got = k3.nlm_denoise(torch.tensor(x), torch.tensor(H_LANES), torch.tensor(S_LANES),
                         patch_size, patch_distance)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= NLM_TOL


def test_row_sharding_at_non_default_points():
    """``parallel/spatial.py``'s halos at the new sizes: NLM at skimage's
    defaults (halo 18 rows) bit for bit, and BM3D at the golden oracle's
    point (halo 2 x (3 + 4) = 14) to the unsharded denoise. The halo rule is
    the JAX package's (``stages * (search + block)``, rounded up to the
    step); the shards keep the global reference grid only where the block
    is a multiple of the step, as there."""
    img = _noisy((96, 40), seed=5)
    mesh = make_spatial_mesh((1, 2), device="cpu", emulate=True)
    assert NLMDenoiser(**NLM_SKIMAGE).spatial_halo() == 18
    ref = k3.nlm_denoise(torch.tensor(img), 0.1, 0.1, **NLM_SKIMAGE)
    got = nlm_denoise_spatial(torch.tensor(img), 0.1, 0.1, mesh, **NLM_SKIMAGE)
    assert torch.equal(got, ref)
    p = bm3d.BM3DParams(**_params("golden", "float32"))
    assert bm3d.BM3DDenoiser(params=p).spatial_halo() == 14
    got = bm3d_denoise_spatial(torch.tensor(img), 0.08, mesh, params=p).numpy()
    ref = bm3d.bm3d_denoise(torch.tensor(img), 0.08, p).numpy()
    assert np.abs(got - ref).max() <= 2e-6  # test_torch_parallel.py's rule for the default point


def _raises_naming(bound: str, fn, *args):
    with pytest.raises(ValueError, match=bound):
        fn(*args)


def test_envelopes_take_their_corners_and_refuse_one_past_each_bound():
    # K1: (block, k, search, step); the search as far as the CTA's shared
    # memory allows at that block and k, the step any.
    for block in (1, 8, 32):
        for k in (1, 128):
            for search in (0, k1.match_search_limit(block, k)):
                for step in (1, block, 40):
                    k1.check_match_envelope(block, k, search, step)
    assert k1.match_search_limit(8, 16) == 95 and k1.match_search_limit(8, 128) == 73
    assert k1.match_search_limit(4, 16) == k1.match_search_limit(24, 128) == 103
    for block, k in ((8, 16), (8, 128), (4, 16), (24, 128)):
        most = k1.match_search_limit(block, k)
        assert k1.match_smem_bytes(block, k, most) <= 227 * 1024 < k1.match_smem_bytes(block, k, most + 1)
    # K2: (block, K); the footprint any window K1 takes at 128 px, search 81
    # at block 8 on a larger image.
    for block in (1, 32):
        for k in (1, 128):
            k2.check_aggregate_envelope(block, k)
    assert _k2_plan(128, k1.match_search_limit(8, 16))[1].smem_bytes <= 227 * 1024
    assert _k2_plan(256, 81)[1].smem_bytes <= 227 * 1024
    # K3: (patch_size, patch_distance); the distance as far as the CTA's
    # shared memory allows at that patch.
    for p in (1, 31):
        for d in (1, k3.nlm_distance_limit(p)):
            k3.check_nlm_envelope(p, d)
    assert (k3.nlm_distance_limit(13), k3.nlm_distance_limit(21), k3.nlm_distance_limit(31)) == (67, 65, 62)
    for p in (1, 13, 21, 31):
        most = k3.nlm_distance_limit(p)
        assert k3.cluster_smem(p, most, 4, 8) <= 227 * 1024 < k3.cluster_smem(p, most + 1, 4, 8)


def _k2_plan(size: int, search: int):
    """K2's plan of a BM3D call at block 8, step 3, K 16 on a ``size`` px
    image (made on the host, so on the CPU here)."""
    grid = tuple(bm3d._ref_grid(size, 8, 3).tolist())
    return k2.aggregate_plan(k2.aggregate_geometry(size, size, grid, grid, search, 8, torch.device("cpu")), 16)


# The first refused value past each bound that stays, and the reason its
# message names (the envelope functions' docstrings give the bytes).
REFUSALS = {
    "k1_block_0": (k1.check_match_envelope, (0, 16, 8, 1), "block 1-32 .a tile's span is 32 pixels, one row a lane"),
    "k1_block_33": (k1.check_match_envelope, (33, 16, 8, 1), "block 1-32 .a tile's span is 32 pixels, one row a lane"),
    "k1_step_0": (k1.check_match_envelope, (8, 16, 8, 0), "step of 1 or more"),
    "k1_k_0": (k1.check_match_envelope, (8, 0, 8, 4), "k in 1-128 .at most four top-k slots a lane"),
    "k1_k_256": (k1.check_match_envelope, (8, 256, 8, 4), "k in 1-128 .at most four top-k slots a lane"),
    "k1_k_24": (k1.check_match_envelope, (8, 24, 8, 4), "power-of-two k"),
    "k1_search_96_block8": (k1.check_match_envelope, (8, 16, 96, 3), "search 0-95 at block 8, k 16 .its CTA's 230340 bytes of shared memory"),
    "k1_search_74_block8_k128": (k1.check_match_envelope, (8, 128, 74, 3), "search 0-73 at block 8, k 128"),
    "k1_search_104_block4": (k1.check_match_envelope, (4, 16, 104, 2), "search 0-103 at block 4, k 16"),
    "k1_search_minus_1": (k1.check_match_envelope, (8, 16, -1, 4), "search 0-95"),
    "k1_any_block_17": (k1.check_any_envelope, (17, 16, 8), "does not strictly ascend .bm3d_match_any_kernel. at block 2-16"),
    "k1_any_k_128": (k1.check_any_envelope, (8, 128, 8), "does not strictly ascend .bm3d_match_any_kernel. at k 1-64"),
    "k1_any_search_25": (k1.check_any_envelope, (8, 16, 25), "at search 0-24"),
    "k2_block_0": (k2.check_aggregate_envelope, (0, 16), "block 1-32"),
    "k2_block_33": (k2.check_aggregate_envelope, (33, 16), "block 1-32"),
    "k2_k_0": (k2.check_aggregate_envelope, (8, 0), "K in 1-128"),
    "k2_k_256": (k2.check_aggregate_envelope, (8, 256), "K in 1-128"),
    "k2_k_48": (k2.check_aggregate_envelope, (8, 48), "power-of-two"),
    "k2_footprint_search_82_256px": (_k2_plan, (256, 82), "footprint whose .num, den. planes fit one CTA's "
                                     "shared memory .232448 bytes.: 172x172 needs 236672"),
    "k3_patch_0": (k3.check_nlm_envelope, (0, 5), "patch_size 1-31 .33 - P whole windows"),
    "k3_patch_32": (k3.check_nlm_envelope, (32, 5), "patch_size 1-31 .33 - P whole windows"),
    "k3_distance_0": (k3.check_nlm_envelope, (4, 0), "patch_distance 1 or more"),
    "k3_distance_66_patch_21": (k3.check_nlm_envelope, (21, 66), "patch_distance 1-65 at patch_size 21 .its CTA's 231520 bytes"),
    "k3_distance_63_patch_31": (k3.check_nlm_envelope, (31, 63), "patch_distance 1-62 at patch_size 31"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_each_remaining_bound_refuses_by_name(case):
    fn, args, reason = REFUSALS[case]
    _raises_naming(reason, fn, *args)


def test_k1_geometry_picks_its_kernel_by_setting():
    """The first K1 kernel keeps the headline's and search12's calls; the
    reference profile, 32 matches and other blocks go to the other two
    (``match_kernel`` names which: ``tests/test_torch_k1_tile.py``); the
    any-kernel's region fits shared memory at the envelope's largest tile."""
    g = k1.match_geometry(bm3d._ref_grid(128, 8, 4), bm3d._ref_grid(128, 8, 4),
                          bm3d.search_offsets(8, 1), 8, "cpu")
    assert g.first_kernel_takes(8, 16) and not g.first_kernel_takes(8, 32)
    g12 = k1.match_geometry(g.rows_t.numpy(), g.cols_t.numpy(), bm3d.search_offsets(12, 1), 8, "cpu")
    assert g12.first_kernel_takes(8, 16)
    prof = bm3d._ref_grid(128, 8, 3)
    gp = k1.match_geometry(prof, prof, bm3d.search_offsets(19, 1), 8, "cpu")
    assert gp.col_plan is None and not gp.first_kernel_takes(8, 16) and gp.step == 3
    big = bm3d._ref_grid(256, 16, 16)
    gb = k1.match_geometry(big, big, bm3d.search_offsets(24, 1), 16, "cpu")
    assert gb.any_smem_bytes <= 227 * 1024 and gb.step == 16


def test_bounds_follow_the_parameters_and_keep_the_earlier_rows():
    """chip_smoke.py's least-time bounds at the headline shapes give the
    numbers of the rows PERF.md holds (K1 3,289,117 valid pairs, separable
    0.0034 ms; K2 53.7 MB, 0.0160 ms; K3 at 15 operations a pair, its box
    sums counted as sliding sums, so bound by the exp: B = 9 0.0041, B = 1
    0.00045 ms at the 1980 MHz clock), and grow with block, k and patch."""
    rows = bm3d._ref_grid(128, 8, 4)
    offs = bm3d.search_offsets(8, 1)
    head = chip_smoke.match_bounds(13, 128, 128, rows, rows, offs)
    assert head["valid_pairs"] == 3_289_117
    assert round(head["bound_separable_ms"], 4) == 0.0034 and head["bound_separable_by"] == "operations"
    assert head == chip_smoke.match_bounds(13, 128, 128, rows, rows, offs, block=8, k=16)
    wide = chip_smoke.match_bounds(13, 128, 128, rows, rows, offs, block=8, k=32)
    assert wide["bytes"] > head["bytes"] and wide["direct_operations"] == head["direct_operations"]
    small = chip_smoke.match_bounds(13, 128, 128, rows, rows, offs, block=4, k=16)
    assert small["direct_operations"] < head["direct_operations"]
    # K2 at the headline stage-1 call: 13 images, 31 x 31 groups of 16 members.
    nbytes, flops = chip_smoke.aggregate_work(13, 31 * 31, 16, 8, 128, 128)
    assert round(nbytes / 1e6, 1) == 53.7 and round(nbytes / chip_smoke.HBM_PEAK * 1e3, 4) == 0.0160
    assert chip_smoke.aggregate_work(13, 41 * 41, 32, 8, 128, 128)[0] > nbytes
    clock = 1980e6
    b9 = chip_smoke.nlm_bound(9, 128, 128, 0, 128, 5, clock)
    b1 = chip_smoke.nlm_bound(1, 128, 128, 0, 128, 5, clock)
    assert round(b9["bound_ms"], 4) == 0.0041 and round(b1["bound_ms"], 5) == 0.00045
    assert b9["bound_term"] == b1["bound_term"] == "exp" and b9["bound_by"] == "operations"
    assert b9 == chip_smoke.nlm_bound(9, 128, 128, 0, 128, 5, clock, patch_size=4)
    p7 = chip_smoke.nlm_bound(9, 128, 128, 0, 128, 11, clock, patch_size=7)
    assert p7["operations_per_pair"] == b9["operations_per_pair"] == 15 and p7["bound_ms"] > b9["bound_ms"]
    ops = [chip_smoke.nlm_bound(1, 32, 32, 0, 32, 1, clock, p)["operations_per_pair"] for p in (1, 2, 3, 11)]
    assert ops == [11, 13, 15, 15]


class _Record:
    """A device record as ``torch.profiler`` gives it: a name and a time."""

    def __init__(self, name: str, us: float):
        self.name = name
        self.time_range = type("Range", (), {"elapsed_us": lambda _self: us})()


def test_lossy_device_ms_counts_every_kernel_name():
    """chip_smoke.py's reading of profiled windows that lost records: a
    kernel name missing from the one-call window still counts (from its
    records over the calls), the time is each name's mean record times its
    launches a call, the names short of records are noted, and a name that
    kept less than half of its records makes it raise."""
    tile, fold = _Record("tile", 3.0), _Record("fold", 1.0)
    window = ([fold], [tile] * 50 + [fold] * 40)  # the one-call window lost the tile
    ms = chip_smoke.lossy_device_ms([window] * 3, 50)
    assert ms == pytest.approx(0.004)
    note = chip_smoke.LOST_RECORDS.pop()
    assert note["launches_a_call"] == {"tile": 1, "fold": 1} and note["names_short"] == ["fold", "tile"]
    two = ([tile, tile, fold], [tile] * 70 + [fold] * 50)  # 2 tiles a call, 30 of 100 lost
    assert chip_smoke.lossy_device_ms([two], 50) == pytest.approx(0.007)
    assert chip_smoke.LOST_RECORDS.pop()["launches_a_call"] == {"tile": 2, "fold": 1}
    with pytest.raises(RuntimeError, match="device records"):
        chip_smoke.lossy_device_ms([([tile], [tile] * 50 + [fold] * 5)], 50)


@pytest.mark.parametrize("row", ["step_past_block", "search32", "k128", "nlm"])
def test_the_wide_calls_fixture_holds_the_port_on_the_cpu(row):
    """``params_wide_jax.npz``, which ``chip_smoke.py``'s ``wide_calls``
    holds the card to (each lane within 0.01 dB of the JAX CPU output),
    against the port's plain path on the same inputs: the BM3D rows within
    that (their bf16 distances flip near-ties), NLM within 1e-5."""
    from pnp_svrg_tpu_torch.convert import (WIDE_BM3D, WIDE_NLM, load_envelope_reference, load_headline_problems,
                                            load_nlm_problem, load_wide_reference, nlm_params)
    from pnp_svrg_tpu_torch.ops.metrics import psnr

    ref = load_wide_reference()
    if row == "nlm":
        got = NLMDenoiser(sigma_modifier=nlm_params()["sigma_modifier"], **WIDE_NLM).denoise(
            torch.tensor(ref["nlm/input"]), torch.tensor(ref["nlm/sigma_est"]), 0)
        assert float((got - torch.tensor(ref["nlm/output"])).abs().max()) <= NLM_TOL
        clean, want = load_nlm_problem("cpu").x, torch.tensor(ref["nlm/output"])
    else:
        env = load_envelope_reference("bm3d_profile")
        lanes = ref["bm3d/lanes"]
        assert lanes.tolist() == [0, 12]
        clean = load_headline_problems("cpu")[0].x[torch.as_tensor(lanes).long()]
        got = bm3d.BM3DDenoiser(params=WIDE_BM3D[row]).denoise(
            torch.tensor(env["first_input"][lanes]), torch.tensor(env["first_sigma"][lanes]), torch.zeros(()))
        want = torch.tensor(ref[f"bm3d/{row}/output"])
    assert float((psnr(clean, got) - psnr(clean, want)).abs().max()) <= chip_smoke.PROFILE_CALL_TOL_DB
