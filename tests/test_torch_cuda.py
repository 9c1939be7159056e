"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the decision is made
inside each test, through the ``cuda`` fixture). This file imports neither
jax nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg, run_pnp, step_schedule
from pnp_svrg_tpu_torch.convert import load_nlm_problem
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser, MMODenoiser
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.ops import resize
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.problems.deblur import make_deblur
from pnp_svrg_tpu_torch.problems.pr import make_phase_retrieval
from pnp_svrg_tpu_torch.utils.io import load_image


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _noisy(size, b=2, seed=0):
    rng = np.random.default_rng(seed)
    clean = np.stack([load_image(p, size, size) for p in ("13.png", "Set12/02.png")][:b])
    return (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)


def _multiset_agreement(a, b):
    """Mean share of each block's k indices that the other holds as often
    (a repeated index, such as the index-0 fill, counts each time)."""
    s = int(max(a.max(), b.max())) + 1
    count = lambda t: torch.zeros(t.numel() // t.shape[-1], s, device=t.device).scatter_add_(  # noqa: E731
        1, t.reshape(-1, t.shape[-1]).long(), torch.ones(t.reshape(-1, t.shape[-1]).shape, device=t.device))
    return float(torch.minimum(count(a), count(b)).sum(1).mean() / a.shape[-1])


# Both versions sum the same 64 rounded terms of a distance in different
# orders; each sum is within 63 half-ulps (2**-24 relative) of the exact one,
# so a slot where they pick different offsets must hold two distances within
# twice that of each other: a near-tie.
NEAR_TIE = 2 * 63 * 2.0**-24


def _slot_gaps(got, want, dists):
    """Per slot, |D[got] - D[want]| / max of the two in the plain version's
    distances D: 0 where the indices agree, inf where they differ and one
    of them is an invalid candidate."""
    dg, dw = (dists.gather(-1, t.long()) for t in (got, want))
    gap = torch.nan_to_num((dg - dw).abs() / torch.maximum(dg, dw), nan=0.0)  # 0/0: a tie at 0
    gap = torch.where(torch.isinf(dg) | torch.isinf(dw), torch.inf, gap)
    return torch.where(got == want, 0.0, gap)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("search_step", [1, 2])
def test_k1_matches_plain(cuda, mode, search_step):
    x = torch.tensor(_noisy(64), device=cuda)
    rows = bm3d._ref_grid(64, 8, 4)
    offs = bm3d.search_offsets(8, search_step)
    before = k1.bm3d_match.launches
    got = k1.bm3d_match(x, rows, rows, offs, 8, 16, mode)
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before + 1
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, rows, offs, 8, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= NEAR_TIE  # right set, right order


def _dyadic(rng, shape, levels, scale):
    """Values ``scale * k`` for integer k in [0, levels]: every product and
    sum the kernels form of them is exact in f32 (and in bf16 for the
    squares of image differences), so any summation order gives the same
    bits."""
    return (scale * rng.integers(0, levels + 1, shape)).astype(np.float32)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("search_step", [1, 2, 4])  # 289, 81 and 25 offsets
@pytest.mark.parametrize("size", [128, 34])  # 34: the last reference block is off the grid
def test_k1_equals_plain_exactly_on_dyadic_images(cuda, mode, search_step, size):
    # Values in {0, 0.25, ..., 1}: many exact ties, which the kernel must
    # break to the lowest offset index as the plain version does.
    x = torch.tensor(_dyadic(np.random.default_rng(size), (2, size, size), 4, 0.25), device=cuda)
    rows = bm3d._ref_grid(size, 8, 4)
    offs = bm3d.search_offsets(8, search_step)
    got = k1.bm3d_match(x, rows, rows, offs, 8, 16, mode)
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    assert torch.equal(got, want)
    if search_step == 4:  # a corner block has 9 valid candidates; index 0 fills the rest
        corner = got[0, 0, 0].cpu().numpy()
        assert len(set(corner[:9])) == 9 and np.all(corner[9:] == 0)


@pytest.mark.parametrize("mode", list(k1.MODES))
def test_k1_equals_plain_exactly_at_625_offsets(cuda, mode):
    """Search 12 (625 offsets: the kernel's PER=20 instantiation) at the
    search12 lane's shape, B = 13 at 128 px; every block keeps at least 16
    valid candidates, so no spare slot is filled."""
    x = torch.tensor(_dyadic(np.random.default_rng(625), (13, 128, 128), 4, 0.25), device=cuda)
    rows = bm3d._ref_grid(128, 8, 4)
    offs = bm3d.search_offsets(12, 1)
    assert len(offs) == 625
    geom = k1.match_geometry(rows, rows, offs, 8, cuda)
    assert geom.smem_bytes <= k1._MAX_SMEM
    got = k1.bm3d_match(x, rows, rows, offs, 8, 16, mode, geometry=geom)
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    assert torch.equal(got, want)
    dists = k1.match_distances_plain(x, rows, rows, offs, 8, mode)
    assert torch.isfinite(dists.gather(-1, got.long())).all()


def _k2_inputs(cuda, size, rng, dyadic, search=8):
    """K2 arguments at ``size`` px: rows of members clipped as
    ``_gather_groups`` clips them (random offsets within ``search``, so rows
    of different groups collide), estimates, weights and a Kaiser window."""
    grid = bm3d._ref_grid(size, 8, 4)
    n, k = len(grid), 16
    offs = rng.integers(-search, search + 1, (2, n, n, k, 2))
    py = np.clip(grid[None, :, None, None] + offs[..., 0], 0, size - 8)
    px = np.clip(grid[None, None, :, None] + offs[..., 1], 0, size - 8)
    idx = (py * (size - 7) + px).reshape(2, -1).astype(np.int32)
    if dyadic:
        est = _dyadic(rng, (2, n * n * k, 64), 16, 0.125) - 1.0
        wgt = 2.0 ** rng.integers(-2, 3, (2, n * n)).astype(np.float32)
        kai = _dyadic(rng, 64, 4, 0.25) + 0.25
    else:
        est = rng.standard_normal((2, n * n * k, 64)).astype(np.float32)
        wgt = rng.uniform(0.5, 5.0, (2, n * n)).astype(np.float32)
        kai = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    geom = k2.aggregate_geometry(size, size, tuple(grid.tolist()), tuple(grid.tolist()),
                                 search, 8, cuda)
    tensors = [torch.tensor(a, device=cuda) for a in (idx, est, wgt, kai)]
    return (*tensors, size, size, geom)


@pytest.mark.parametrize("size", [128, 34])
def test_k2_matches_plain_with_collisions(cuda, size):
    args = _k2_inputs(cuda, size, np.random.default_rng(1), dyadic=True)
    before = k2.bm3d_aggregate.launches
    num, den = k2.bm3d_aggregate(*args)
    torch.cuda.synchronize()
    assert k2.bm3d_aggregate.launches == before + 1
    want_num, want_den = k2.bm3d_aggregate_plain(*args[:6])
    assert torch.equal(num, want_num) and torch.equal(den, want_den)


def test_k2_adds_rows_outside_the_footprint(cuda):
    # Rows anywhere in the table: most fall outside their tile's footprint
    # and take the kernel's global path; dyadic values keep it exact.
    rng = np.random.default_rng(2)
    idx, est, wgt, kai, h, w, geom = _k2_inputs(cuda, 48, rng, dyadic=True)
    idx = torch.tensor(rng.integers(0, 41 * 41, tuple(idx.shape)).astype(np.int32), device=cuda)
    num, den = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
    want_num, want_den = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    assert torch.equal(num, want_num) and torch.equal(den, want_den)


def test_k2_drops_rows_outside_the_table(cuda):
    # The plain version's index_add_ raises on such a row; the kernel cannot
    # raise and drops the member, as the wrapper's docstring states. Three
    # members get rows before, just past and far past the 41 x 41 table; the
    # result is the full sum less their terms (exact: dyadic values).
    idx, est, wgt, kai, h, w, geom = _k2_inputs(cuda, 48, np.random.default_rng(3), dyadic=True)
    want_num, want_den = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    ww = w - 7
    bad = idx.clone()
    for (b, p), row in zip(((0, 5), (1, 77), (1, idx.shape[1] - 1)), (-1, (h - 7) * ww, 2**30)):
        py, px = divmod(int(idx[b, p]), ww)
        wk = (wgt[b, p // 16] * kai).view(8, 8)
        want_num[b, py : py + 8, px : px + 8] -= est[b, p].view(8, 8) * wk
        want_den[b, py : py + 8, px : px + 8] -= wk
        bad[b, p] = row
    num, den = k2.bm3d_aggregate(bad, est, wgt, kai, h, w, geom)
    assert torch.equal(num, want_num) and torch.equal(den, want_den)


def test_k2_matches_plain_on_bm3d_estimates(cuda):
    x = torch.tensor(_noisy(128), device=cuda)
    p = bm3d.BM3DParams(search=8, match_dtype="bfloat16")
    _, args = bm3d.stage1_aggregate_inputs(x, 0.1, p)
    num, den = k2.bm3d_aggregate(*args)
    want_num, want_den = k2.bm3d_aggregate_plain(*args[:6])
    for got, want in ((num, want_num), (den, want_den)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((1, 32, 32), dtype=torch.float64, device=cuda)
    rows = bm3d._ref_grid(32, 8, 4)
    with pytest.raises(ValueError):
        k1.bm3d_match(x, rows, rows, bm3d.search_offsets(4, 1), 8, 16)
    with pytest.raises(ValueError, match="power-of-two k"):  # outside K1's envelope
        k1.bm3d_match(x.float(), rows, rows, bm3d.search_offsets(4, 1), 8, 5)
    x64 = torch.zeros((1, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="block 1-32"):  # a patch edge past the envelope
        k1.bm3d_match(x64, bm3d._ref_grid(64, 33, 4), bm3d._ref_grid(64, 33, 4), bm3d.search_offsets(4, 1), 33, 16)
    big = torch.zeros((1, 256, 256), device=cuda)
    grid = bm3d._ref_grid(256, 8, 4)
    with pytest.raises(ValueError, match="search 0-95"):  # a 193 x 193 window: its region passes 227 KB
        k1.bm3d_match(big, grid, grid, bm3d.search_offsets(96, 8), 8, 16)
    idx, est, wgt, kai, h, w, geom = _k2_inputs(cuda, 34, np.random.default_rng(0), dyadic=False)
    with pytest.raises(ValueError):
        k2.bm3d_aggregate(idx, est.double(), wgt, kai, h, w, geom)
    with pytest.raises(ValueError):
        k2.bm3d_aggregate(idx.long(), est, wgt, kai, h, w, geom)
    with pytest.raises(ValueError):  # 15 members a group do not fit the weights
        k2.bm3d_aggregate(idx[:, :-1], est[:, :-1], wgt, kai, h, w, geom)
    with pytest.raises(ValueError):  # kaiser of a 4 x 4 patch
        k2.bm3d_aggregate(idx, est, wgt, kai[:16], h, w, geom)
    with pytest.raises(ValueError):  # no footprints: the kernel cannot run
        k2.bm3d_aggregate(idx, est, wgt, kai, h, w)
    grid = tuple(bm3d._ref_grid(256, 8, 4).tolist())
    huge = k2.aggregate_geometry(256, 256, grid, grid, 100, 8, cuda)  # 220 x 236 footprint
    n = len(grid) ** 2
    with pytest.raises(ValueError):
        k2.bm3d_aggregate(torch.zeros((1, n * 16), dtype=torch.int32, device=cuda),
                          torch.zeros((1, n * 16, 64), device=cuda),
                          torch.zeros((1, n), device=cuda), kai, 256, 256, huge)


def _nlm_input(cuda, b):
    """The ``13.png`` lane's ``x_init`` after one gradient step, one image a
    lane: lane k steps with its own eta (spread over 2000-12000, around the
    tuned 7000), and h from each image's own sigma estimate."""
    prob = load_nlm_problem(cuda)
    grad = prob.grad_full(prob.x_init)
    etas = torch.linspace(2000.0, 12000.0, b, device=cuda)
    z = prob.x_init - etas[:, None, None] * grad
    h = estimate_sigma(z) * torch.linspace(1.2, 1.7, b, device=cuda)
    return z.contiguous(), h


def _nlm_noise_input(cuda, b, hh, ww):
    """B distinct images of ``hh`` x ``ww``: ``13.png`` plus numpy-seeded
    noise, a different draw a lane, with per-lane h and sigma."""
    rng = np.random.default_rng(hh * 1000 + ww + b)
    clean = load_image("13.png", hh, ww)
    z = (clean + 0.1 * rng.standard_normal((b, hh, ww))).astype(np.float32)
    h = rng.uniform(0.06, 0.2, b).astype(np.float32)
    return torch.tensor(z, device=cuda), torch.tensor(h, device=cuda)


NLM_BOUNDS = {  # row bounds by name, as (lo, hi) for an image of height hh
    "full": lambda hh: (0, hh),
    "band": lambda hh: (hh // 8, hh - hh // 8),  # (16, 112) at 128
    "one_row": lambda hh: (min(10, hh - 1), min(10, hh - 1) + 1),  # (10, 11)
    "empty": lambda hh: (min(5, hh), min(5, hh)),  # (5, 5): no candidate, output 0
}


@pytest.mark.parametrize("bounds", list(NLM_BOUNDS))
@pytest.mark.parametrize("b", [1, 9, 13])
@pytest.mark.parametrize("hh,ww", [(128, 128), (48, 40), (37, 70), (3, 3)])
def test_k3_matches_plain(cuda, hh, ww, b, bounds):
    # Lanes are distinct images, so a kernel that read another lane's image
    # (or h) would fail; 40, 70 and 3 columns fill no whole 29-column tile,
    # 37 and 3 rows no whole 8-row strip.
    z, h = _nlm_input(cuda, b) if hh == 128 else _nlm_noise_input(cuda, b, hh, ww)
    rows = NLM_BOUNDS[bounds](hh)
    before = k3.nlm_denoise.launches
    got = k3.nlm_denoise(z, h, 0.8 * h, row_valid_bounds=rows)
    torch.cuda.synchronize()
    assert k3.nlm_denoise.launches == before + 1
    want = k3.nlm_denoise_plain(z, h, 0.8 * h, row_valid_bounds=rows)
    assert float((got - want).abs().max()) <= 1e-5
    if bounds == "empty":
        assert not bool(got.any())


def test_k3_nan_at_h_zero_and_2d_input(cuda):
    z, h = _nlm_input(cuda, 1)
    zero = torch.zeros(1, device=cuda)
    assert torch.isnan(k3.nlm_denoise(z, zero, zero)).all()
    got = k3.nlm_denoise(z[0], h, h)
    assert got.shape == z.shape[1:]
    assert float((got - k3.nlm_denoise_plain(z[0], h, h)).abs().max()) <= 1e-5


def test_k3_refuses_what_it_is_not_built_for(cuda):
    z, h = _nlm_input(cuda, 1)
    with pytest.raises(ValueError):
        k3.nlm_denoise(z.double(), h, h)
    with pytest.raises(ValueError, match="patch_size 1-31"):  # past K3's envelope
        k3.nlm_denoise(z, h, h, patch_size=32)
    with pytest.raises(ValueError, match="patch_distance 1-69"):  # its tile passes 227 KB at patch 4
        k3.nlm_denoise(z, h, h, patch_distance=70)
    with pytest.raises(ValueError):  # h on the host would make the launch wait
        k3.nlm_denoise(z, h.cpu(), h)
    with pytest.raises(ValueError):
        k3.nlm_denoise(z, h, h, row_valid_bounds=(-1, 128))


def test_nlm_denoiser_on_the_card_matches_the_cpu(cuda):
    z, _ = _nlm_input(cuda, 2)
    est = torch.tensor([0.05, 0.0], device=cuda)
    t = torch.tensor([3, 3], dtype=torch.int32, device=cuda)
    den = NLMDenoiser(denoise_strength=0.1, sigma_modifier=1.3, decay=0.9)
    gpu = den.denoise(z, est, t).cpu()
    cpu = den.denoise(z.cpu(), est.cpu(), t.cpu())
    assert float((gpu - cpu).abs().max()) <= 1e-5


def test_bm3d_on_the_card_matches_the_cpu(cuda):
    x = _noisy(48)
    p = bm3d.BM3DParams(search=6, match_dtype="bfloat16")
    gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p).cpu()
    cpu = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, p)
    assert float((gpu - cpu).abs().mean()) < 1e-4


def test_dense_aggregation_on_the_card_matches_the_cpu(cuda):
    x = _noisy(48)
    p = bm3d.BM3DParams(search=8, search_step=4, matcher="pallas", match_dtype="bfloat16")
    before = k2.bm3d_aggregate.launches
    gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p).cpu()
    assert k2.bm3d_aggregate.launches == before  # the dense path runs no K2
    cpu = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, p)
    assert float((gpu - cpu).abs().mean()) < 1e-4


@pytest.mark.parametrize("denoiser,eta", [
    (bm3d.BM3DDenoiser(sigma_modifier=1.0, params=bm3d.BM3DParams(search=4)), 200.0),
    (NLMDenoiser(sigma_modifier=1.2), 400.0),
    (TVDenoiser(sigma_modifier=0.7), 400.0),
], ids=["bm3d", "nlm", "tv"])
def test_faithful_loop_on_the_card_matches_the_cpu(cuda, denoiser, eta):
    gen = torch.Generator().manual_seed(0)
    cpu = stack_problems([make_csmri(load_image(p, 32, 32), gen, 0.5, snr=10, keep_low_freq=4,
                                     device="cpu")
                          for p in ("Set12/01.png", "13.png")])
    gpu = type(cpu)(**{k: v.to(cuda) for k, v in vars(cpu).items()})
    a, b = (pnp_svrg(p, denoiser, eta, 2, 3, 100, variant="faithful") for p in (cpu, gpu))
    np.testing.assert_allclose(b["psnr_per_iter"].cpu().numpy(), a["psnr_per_iter"].numpy(),
                               atol=0.05)
    assert float((b["image"].cpu() - a["image"]).abs().mean()) < 1e-3


# The PR and Deblur lanes' BM3D shapes: one image (B = 1) at 256 px, f32 at
# 289 offsets (Deblur) and the Pallas matcher's bf16 rounding at 81
# (Deblur-SR).
BENCH_SHAPES = [("f32", 1), ("bf16_pallas", 2)]


@pytest.mark.parametrize("mode,search_step", BENCH_SHAPES)
def test_k1_matches_plain_at_256_px_on_one_image(cuda, mode, search_step):
    x = torch.tensor(_noisy(256, b=1), device=cuda)
    rows = bm3d._ref_grid(256, 8, 4)
    offs = bm3d.search_offsets(8, search_step)
    before = k1.bm3d_match.launches
    got = k1.bm3d_match(x, rows, rows, offs, 8, 16, mode)
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before + 1 and got.shape == (1, 63, 63, 16)
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, rows, offs, 8, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= NEAR_TIE


@pytest.mark.parametrize("mode,search_step", BENCH_SHAPES)
def test_k2_matches_plain_at_256_px_on_one_image(cuda, mode, search_step):
    x = torch.tensor(_noisy(256, b=1), device=cuda)
    p = bm3d.BM3DParams(search=8, search_step=search_step,
                        matcher="xla" if mode == "f32" else "pallas",
                        match_dtype="float32" if mode == "f32" else "bfloat16")
    assert bm3d.match_mode(p) == mode and not bm3d.dense_aggregation(256, 256, p)
    _, args = bm3d.stage1_aggregate_inputs(x, 0.1, p)
    before = k2.bm3d_aggregate.launches
    num, den = k2.bm3d_aggregate(*args)
    torch.cuda.synchronize()
    assert k2.bm3d_aggregate.launches == before + 1
    want_num, want_den = k2.bm3d_aggregate_plain(*args[:6])
    for got, want in ((num, want_num), (den, want_den)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bilinear_pair_on_the_card_matches_the_cpu(cuda):
    idx, wts = resize.bilinear_gather_params(256, 256, 128, 128)
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.standard_normal((2, 256 * 256)).astype(np.float32))
    r = torch.tensor(rng.standard_normal((2, 128 * 128)).astype(np.float32))
    ti, tw = torch.tensor(idx, dtype=torch.int64), torch.tensor(wts)
    fwd = resize.bilinear_apply(v.to(cuda), ti.to(cuda), tw.to(cuda)).cpu()
    want = resize.bilinear_apply(v, ti, tw)
    # A 4-term sum, reduced on the card in another order (or fused into
    # FMAs): f32 rounding, relative to the largest output.
    assert float((fwd - want).abs().max()) <= 1e-6 * float(want.abs().max())
    adj = resize.bilinear_adjoint(r.to(cuda), ti.to(cuda), tw.to(cuda), 256 * 256).cpu()
    want = resize.bilinear_adjoint(r, ti, tw, 256 * 256)
    # A pixel's few terms, summed in the table's fixed order on both sides:
    # f32 rounding at most, relative to the largest.
    assert float((adj - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("which", ["deblur", "deblur_sr", "pr"])
def test_faithful_bench_problems_on_the_card_match_the_cpu(cuda, which):
    img = load_image("Set12/04.png", 32, 32)
    gen = torch.Generator().manual_seed(0)
    if which == "pr":
        cpu, eta = make_phase_retrieval(img, gen, 4096, snr=20, device="cpu"), 0.2
    else:
        scale = 100 if which == "deblur" else 50
        cpu, eta = make_deblur(img, gen, "Minimal", scale, snr=20, device="cpu"), 4e5
    gpu = type(cpu)(**{k: v.to(cuda) for k, v in vars(cpu).items()})
    den = bm3d.BM3DDenoiser(sigma_modifier=1.0, params=bm3d.BM3DParams(search=4))
    a, b = (pnp_svrg(p, den, eta, 2, 3, 400, variant="faithful") for p in (cpu, gpu))
    np.testing.assert_allclose(b["psnr_per_iter"].cpu().numpy(), a["psnr_per_iter"].numpy(),
                               atol=0.05)
    # At 50 % scale three quarters of the pixels are not measured, so where
    # BM3D's near-ties on the random start flip differently on the card the
    # data do not pull the two images back together (mean 1.09e-3 seen once).
    tol = 3e-3 if which == "deblur_sr" else 1e-3
    assert float((b["image"].cpu() - a["image"]).abs().mean()) < tol


@pytest.mark.parametrize("model_type,sigma", [("RealSN_DnCNN", 5), ("SimpleCNN", 15), ("MMO", None)])
def test_cnn_denoiser_on_the_card_matches_the_cpu(cuda, model_type, sigma):
    # cuDNN in f32 with TF32 off against the CPU's convolutions: only the
    # summation order differs (max abs 1e-5 on [0, 1] images).
    x = torch.tensor(_noisy(128))
    if model_type == "MMO":
        gpu_den, cpu_den = (MMODenoiser.from_pretrained(1, 0.01, device=d) for d in (cuda, "cpu"))
    else:
        gpu_den, cpu_den = (DnCNNDenoiser.from_pretrained(model_type, sigma, device=d) for d in (cuda, "cpu"))
    gpu = gpu_den.denoise(x.to(cuda)).cpu()
    assert float((gpu - cpu_den.denoise(x)).abs().max()) <= 1e-5
    assert torch.equal(gpu, gpu_den.denoise(x.to(cuda)).cpu())  # cuDNN held to deterministic algorithms


LOOP_STEPS = {"gd": dict(n_iters=1), "sgd": dict(n_iters=1, mini_batch_size=100),
              "saga": dict(n_iters=1, mini_batch_size=100, hist_size=3),
              "sarah": dict(n_outer=1, t2=1, mini_batch_size=100)}


@pytest.mark.parametrize("algo", list(LOOP_STEPS))
def test_one_step_of_each_new_loop_on_the_card_matches_the_cpu(cuda, algo):
    gen = torch.Generator().manual_seed(0)
    cpu = stack_problems([make_csmri(load_image(p, 32, 32), gen, 0.5, snr=10, keep_low_freq=4, device="cpu")
                          for p in ("Set12/01.png", "13.png")])
    gpu = type(cpu)(**{k: v.to(cuda) for k, v in vars(cpu).items()})
    kw = dict(LOOP_STEPS[algo])
    if algo != "gd":  # the same minibatches on both sides, drawn on the CPU
        mb = lambda: cpu.select_mb(gen, 100)  # noqa: E731
        lead = (1, 1) if algo == "sarah" else (1,)
        masks = torch.stack([mb()]).reshape(lead + tuple(cpu.mb_shape(100)))
        kw["masks"] = masks
        if algo == "saga":
            kw |= {"mb0": mb(), "slots": torch.tensor([1])}
    den = NLMDenoiser(sigma_modifier=1.2)
    before = k3.nlm_denoise.launches
    a = run_pnp(algo, cpu, den, eta=400.0, lr_decay=0.9, **kw)
    b = run_pnp(algo, gpu, den, eta=torch.tensor(400.0, device=cuda), lr_decay=0.9,
                **{k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()})
    assert k3.nlm_denoise.launches - before == (2 if algo == "sarah" else 1)
    np.testing.assert_allclose(b["psnr_per_iter"].cpu().numpy(), a["psnr_per_iter"].numpy(), atol=0.05)
    assert float((b["image"].cpu() - a["image"]).abs().mean()) < 1e-3


def test_step_schedule_on_the_card_is_the_cpu_schedule(cuda):
    eta = torch.tensor([0.2, 0.05])
    want = step_schedule(eta, 0.99, 30, "cpu")
    for e in (eta, eta.to(cuda)):
        got = step_schedule(e, 0.99, 30, cuda)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# The tuning path: the lockstep sweep's 36-lane shapes, compat, the checks.
# ---------------------------------------------------------------------------

SWEEP_LANES = 36  # a lockstep round: 12 Set12 images x 3 TPE candidates


def _sweep_images(cuda):
    """36 distinct 128-px images: the 12 Set12 images at three noise levels."""
    rng = np.random.default_rng(36)
    clean = np.stack([load_image(f"Set12/{i:02d}.png", 128, 128) for i in range(1, 13)] * 3)
    sig = np.repeat([0.05, 0.1, 0.15], 12)[:, None, None]
    return torch.tensor((clean + sig * rng.standard_normal(clean.shape)).astype(np.float32), device=cuda)


def test_k1_and_k2_match_plain_at_the_sweep_shape(cuda):
    x = _sweep_images(cuda)
    rows = bm3d._ref_grid(128, 8, 4)
    offs = bm3d.search_offsets(8, 1)
    before = k1.bm3d_match.launches
    got = k1.bm3d_match(x, rows, rows, offs, 8, 16, "f32")
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before + 1 and got.shape == (SWEEP_LANES, 31, 31, 16)
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, 16, "f32")
    assert _multiset_agreement(got, want) >= 0.999
    dists = k1.match_distances_plain(x, rows, rows, offs, 8, "f32")
    assert float(_slot_gaps(got, want, dists).max()) <= NEAR_TIE
    sig = torch.tensor(np.repeat([0.05, 0.1, 0.15], 12), dtype=torch.float32, device=cuda)
    _, args = bm3d.stage1_aggregate_inputs(x, sig, bm3d.BM3DParams(search=8))
    before = k2.bm3d_aggregate.launches
    num, den = k2.bm3d_aggregate(*args)
    torch.cuda.synchronize()
    assert k2.bm3d_aggregate.launches == before + 1 and num.shape == (SWEEP_LANES, 128, 128)
    want_num, want_den = k2.bm3d_aggregate_plain(*args[:6])
    for g, w in ((num, want_num), (den, want_den)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_k3_matches_plain_at_the_sweep_shape_with_per_lane_h(cuda):
    z = _sweep_images(cuda)
    h = torch.linspace(0.04, 0.3, SWEEP_LANES, device=cuda)  # every lane its own (h, sigma)
    sigma = torch.linspace(0.02, 0.2, SWEEP_LANES, device=cuda).flip(0)
    before = k3.nlm_denoise.launches
    got = k3.nlm_denoise(z, h, sigma)
    torch.cuda.synchronize()
    assert k3.nlm_denoise.launches == before + 1
    want = k3.nlm_denoise_plain(z, h, sigma)
    assert float((got - want).abs().max()) <= 1e-5
    # A lane's result depends on its own (h, sigma) only.
    alone = k3.nlm_denoise(z[17:18].contiguous(), h[17:18].contiguous(), sigma[17:18].contiguous())
    assert float((alone - got[17:18]).abs().max()) <= 1e-6


def test_compat_steps_on_the_card_match_the_cpu(cuda):
    from pnp_svrg_tpu_torch.algorithms import compat

    gen = torch.Generator().manual_seed(0)
    cpu = make_csmri(load_image("13.png", 32, 32), gen, 0.5, snr=10, device="cpu")
    gpu = type(cpu)(**{k: v.to(cuda) for k, v in vars(cpu).items()})
    masks = torch.stack([cpu.select_mb(gen, 100) for _ in range(4)])
    kw = dict(eta=400.0, tt=1e9, T2=2, mini_batch_size=100, max_iters=4, converge_check=False)
    den = NLMDenoiser(sigma_modifier=1.2)
    a = compat.pnp_svrg(cpu, den, masks=masks, **kw)
    before = k3.nlm_denoise.launches
    b = compat.pnp_svrg(gpu, den, masks=masks.to(cuda), **kw)
    assert k3.nlm_denoise.launches - before == 4
    np.testing.assert_allclose(b["psnr_per_iter"], a["psnr_per_iter"], atol=0.011)
    assert float((b["z"].cpu() - a["z"]).abs().max()) < 1e-3
    assert b["gradient_time"] > 0 and b["denoise_time"] > 0


def test_gradient_checks_pass_on_the_card_in_float64(cuda):
    from pnp_svrg_tpu_torch.core import checks

    gen = torch.Generator(device=cuda).manual_seed(0)
    img = load_image("13.png", 32, 32)
    for prob in (make_csmri(img, gen, 0.5, snr=10, device=cuda),
                 make_deblur(img, gen, kernel="Minimal", scale_percent=50, snr=5, device=cuda),
                 make_phase_retrieval(img, gen, 512, snr=20, device=cuda)):
        assert checks.grad_full_check(prob) < 1e-4
        assert checks.grad_stoch_check(checks.widen(prob)) < 1e-6


def test_tune_set12_on_the_headline_fixture(cuda, tmp_path):
    from pnp_svrg_tpu_torch.examples import tune_set12

    rec = tune_set12.main(["--from-fixture", "--n-outer", "1", "--t2", "1", "--mb", "4000",
                           "--etas", "6000", "--mods", "1.0", "--out", str(tmp_path / "t.json")])
    assert len(rec["lanes"]) == 13 and np.isfinite(rec["tuned_psnr"]).all()


def _numpy_patch_set(image_dir, max_images, seed, patch=40, stride=10):
    """The patch pipeline written with numpy loops (the JAX package's numpy
    path), the reference for the device's unfold, rot90 and flip."""
    from pnp_svrg_tpu_torch.training.data import SCALES, load_gray

    rng = np.random.default_rng(seed)
    out = []
    for path in sorted(image_dir.glob("*.png"))[:max_images]:
        for scale in SCALES:
            img = load_gray(path, scale)
            ps = np.stack([img[y:y + patch, x:x + patch] for y in range(0, img.shape[0] - patch + 1, stride)
                           for x in range(0, img.shape[1] - patch + 1, stride)])
            modes = rng.integers(0, 8, size=len(ps))
            aug = [np.rot90(q, int(m) // 2) for q, m in zip(ps, modes)]
            out.append(np.stack([np.flipud(q) if m % 2 else q for q, m in zip(aug, modes)]))
    return np.concatenate(out)


def test_patch_pipeline_on_the_card_is_the_numpy_pipeline(cuda):
    from pnp_svrg_tpu_torch.training import data
    from pnp_svrg_tpu_torch.utils.io import SET12_DIR

    got = data.build_patch_dataset(SET12_DIR, max_images=2, seed=3, device=cuda)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), _numpy_patch_set(SET12_DIR, 2, 3))
    cpu = got.cpu()
    for sigma in (25 / 255.0, (0.0, 55 / 255.0)):
        for (a, na), (b, nb) in zip(data.batches(got, 64, sigma, seed=5), data.batches(cpu, 64, sigma, seed=5)):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
            torch.testing.assert_close(na.cpu(), nb, rtol=0, atol=0)


def test_train_step_and_evaluate_on_the_card_match_the_cpu(cuda):
    """3 steps (BatchNorm, lip and the BN clamp on) from one start on the same
    batches, then the effective network's Set12 scores, on the card and on
    the CPU: losses to 1e-5 relative, weights and statistics to 5e-6,
    PSNR to 1e-4 dB."""
    from pnp_svrg_tpu_torch.models import flax_variables_from_torch, u_state_to_flax
    from pnp_svrg_tpu_torch.training import TrainConfig, evaluate
    from pnp_svrg_tpu_torch.training.data import batches, load_gray
    from pnp_svrg_tpu_torch.training.train_dncnn import (
        effective_variables, init_u_state, new_model, new_optimizer, train_step)
    from pnp_svrg_tpu_torch.utils.io import SET12_DIR

    cfg = TrainConfig(depth=4, features=16, use_bn=True, lip=0.5, bn_sn=1.0, batch_size=8, sn_probe_hw=12)
    runs = {}
    patches = torch.tensor(np.random.default_rng(0).uniform(0, 1, (40, 24, 24)).astype(np.float32))
    val = [load_gray(p) for p in sorted(SET12_DIR.glob("*.png"))[:2]]
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(0)
        model = new_model(cfg, gen).to(dev)
        u_state = init_u_state(model, cfg.sn_probe_hw, gen)
        opt = new_optimizer(model, cfg.lr)
        losses = [float(train_step(model, opt, u_state, noisy, noise, cfg))
                  for noisy, noise in list(batches(patches.to(dev), 8, 25 / 255.0, seed=1))[:3]]
        runs[str(dev)] = (losses, flax_variables_from_torch(model), u_state_to_flax(u_state),
                          evaluate(effective_variables(model, u_state, cfg), val, 25 / 255.0))
    (lc, vc, uc, ec), (lg, vg, ug, eg) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for tree_g, tree_c in ((vg["params"], vc["params"]), (vg["batch_stats"], vc["batch_stats"]), (ug, uc)):
        for name in tree_c:
            for leaf in (tree_c[name] if isinstance(tree_c[name], dict) else {"": tree_c[name]}):
                g = tree_g[name][leaf] if leaf else tree_g[name]
                c = tree_c[name][leaf] if leaf else tree_c[name]
                np.testing.assert_allclose(g, c, rtol=0, atol=5e-6, err_msg=f"{name}/{leaf}")
    np.testing.assert_allclose(eg, ec, atol=1e-4)


# Row bounds (the spatial path): the shards' halo-extended blocks of a
# 256 px image (192 rows, bounds (32, 192) and (0, 160)) and an odd pair.
K1_BOUNDS = [(192, (32, 192)), (192, (0, 160)), (64, (13, 50))]


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("rows_,bounds", K1_BOUNDS)
def test_bounded_k1_equals_plain_exactly_on_dyadic_images(cuda, mode, rows_, bounds):
    x = torch.tensor(_dyadic(np.random.default_rng(rows_), (2, rows_, 256), 4, 0.25), device=cuda)
    rows, cols = bm3d._ref_grid(rows_, 8, 4), bm3d._ref_grid(256, 8, 4)
    offs = bm3d.search_offsets(8, 1)
    got = k1.bm3d_match(x, rows, cols, offs, 8, 16, mode, row_valid_bounds=bounds)
    want = k1.bm3d_match_plain(x, rows, cols, offs, 8, 16, mode, row_valid_bounds=bounds)
    assert torch.equal(got, want)
    # the whole image as bounds leaves every call as it was
    full = k1.bm3d_match(x, rows, cols, offs, 8, 16, mode, row_valid_bounds=(0, rows_))
    assert torch.equal(full, k1.bm3d_match(x, rows, cols, offs, 8, 16, mode))


def test_bounded_bm3d_on_the_card_matches_the_cpu(cuda):
    x = _noisy(48)
    p = bm3d.BM3DParams(search=6, match_dtype="bfloat16")
    gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p, row_valid_bounds=(8, 40)).cpu()
    cpu = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, p, row_valid_bounds=(8, 40))
    assert float((gpu - cpu).abs().mean()) < 1e-4


def test_spatial_nlm_on_the_card_matches_unsharded(cuda):
    from pnp_svrg_tpu_torch.parallel import make_spatial_mesh, nlm_denoise_spatial

    z, h = _nlm_input(cuda, 1)
    mesh = make_spatial_mesh((1, 2), device=cuda, emulate=True)
    got = nlm_denoise_spatial(z[0], h[0], h[0], mesh)
    assert float((got - k3.nlm_denoise(z[0], h[0], h[0])).abs().max()) <= 1e-5


def test_emulated_meas_run_on_the_card_matches_the_cpu(cuda):
    """The meas-split loop (two shards in one process) on the card against
    the same program on the CPU, on the same per-shard minibatches."""
    from pnp_svrg_tpu_torch.parallel import run_batch_meas_emulated, split_meas

    gen = torch.Generator().manual_seed(0)
    cpu = stack_problems([make_csmri(load_image(p, 32, 32), gen, 0.5, snr=10, device="cpu")
                          for p in ("Set12/01.png", "13.png")])
    gpu = type(cpu)(**{k: v.to(cuda) for k, v in vars(cpu).items()})
    rng = np.random.default_rng(1)
    masks = np.zeros((2, 2, 3, 2, 32 * 32), np.float32)  # (shards, n_outer, t2, B, H*W)
    for s, shard in enumerate(split_meas(cpu, 2)):
        allowed = shard.mask.numpy().reshape(2, -1)
        for i in range(2):
            for j in range(3):
                for b in range(2):
                    masks[s, i, j, b, rng.choice(np.flatnonzero(allowed[b]), 50, replace=False)] = 1.0
    masks = torch.tensor(masks.reshape(2, 2, 3, 2, 32, 32))
    den = NLMDenoiser(sigma_modifier=1.2)
    a, b = (run_batch_meas_emulated(pnp_svrg, p, den, 2, masks=masks.to(p.device), eta=400.0,
                                    n_outer=2, t2=3, mini_batch_size=100) for p in (cpu, gpu))
    np.testing.assert_allclose(b["psnr_per_iter"].cpu().numpy(), a["psnr_per_iter"].numpy(), atol=0.05)
    assert float((b["image"].cpu() - a["image"]).abs().mean()) < 1e-3


def _bm3d_call(cuda):
    """A 128 px BM3D denoise (K1 and K2) on the card, built and warmed."""
    x = torch.tensor(_noisy(128, b=1), device=cuda)
    sigma = estimate_sigma(x)
    fn = lambda: bm3d.bm3d_denoise_batch(x, sigma, bm3d.BM3DParams(search=8))  # noqa: E731
    fn()
    torch.cuda.synchronize()
    return fn


@pytest.mark.parametrize("mode", ["scalar", "block"])
def test_phase_timers_fence_waits_for_the_card(cuda, mode):
    """Each fence mode holds the clock until the denoise has run on the card:
    the stream is idle after the phase, and the phase's host time covers the
    device time between two events recorded inside it."""
    from pnp_svrg_tpu_torch.utils.profiling import PhaseTimers

    fn = _bm3d_call(cuda)
    timers = PhaseTimers(fence_mode=mode)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    box = []
    with timers.phase("bm3d", fence=lambda: box[-1]):
        start.record()
        box.append(fn())
        end.record()
    assert torch.cuda.current_stream().query()
    assert timers.totals()["bm3d"] * 1e3 >= start.elapsed_time(end) > 0
    assert timers.counts() == {"bm3d": 1}


def test_scalar_fence_leaves_the_stream_idle(cuda):
    from pnp_svrg_tpu_torch.utils.profiling import scalar_fence

    a = torch.randn(2048, 2048, device=cuda)
    b = a @ a @ a
    c = torch.zeros(3, dtype=torch.complex64, device=cuda) + 1j
    scalar_fence({"b": [b], "c": (c, torch.empty(0, device=cuda))})
    assert torch.cuda.current_stream().query()


def test_trace_names_k1_k2_and_the_annotated_region(cuda, tmp_path):
    import json

    from pnp_svrg_tpu_torch.utils.profiling import annotate, trace

    fn = _bm3d_call(cuda)
    with trace(tmp_path / "tb"):
        with annotate("bm3d"):
            fn()
    (path,) = (tmp_path / "tb").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("bm3d_match_kernel" in n for n in kernels)
    assert any("bm3d_aggregate_kernel" in n for n in kernels)
    assert any(e.get("name") == "bm3d" for e in events)


def test_paper_csmri_gd_anchor_starts_on_the_jax_trace_on_the_card(cuda):
    """The first entries of paper_csmri's ``gd`` row on the JAX driver's
    problem, through the driver's table, against the JAX CPU trace."""
    from pnp_svrg_tpu_torch.algorithms import loops
    from pnp_svrg_tpu_torch.convert import load_paper_csmri_problem, load_paper_reference
    from pnp_svrg_tpu_torch.examples import paper_csmri

    prob = load_paper_csmri_problem("paper_csmri", cuda)
    calls = []
    real = paper_csmri.pnp_gd
    paper_csmri.pnp_gd = lambda p, den, **kw: calls.append((p, den, kw))
    try:
        paper_csmri.make_runs(prob, paper_csmri.parse_args([]), cuda)["gd"]()
    finally:
        paper_csmri.pnp_gd = real
    p, den, kw = calls[0]
    out = loops.pnp_gd(p, den, **(kw | {"n_iters": 5}))
    want = load_paper_reference()["paper_csmri"]["auto"]["rows"]["gd"]["psnr_per_iter"][:6]
    np.testing.assert_allclose(out["psnr_per_iter"][:, 0].cpu().numpy(), want, atol=0.05)


# K2's three checked shapes: the headline's stage 1 (B = 13, 128 px), one
# 128 px image (pr_bm3d) and one 256 px image (deblur_bm3d).
K2_REPEAT_SHAPES = [(13, 128), (1, 128), (1, 256)]


@pytest.mark.parametrize("b,size", K2_REPEAT_SHAPES)
def test_k2_repeats_itself_bit_for_bit(cuda, b, size):
    # The footprints are folded in a fixed order, with no float atomic: 50
    # calls on one real stage-1 call's arguments give the first call's bits.
    x = torch.tensor(_noisy(size, b=min(b, 2)), device=cuda)
    x = x.repeat((b + 1) // 2, 1, 1)[:b].contiguous()
    _, args = bm3d.stage1_aggregate_inputs(x, 0.1, bm3d.BM3DParams(search=8))
    first = k2.bm3d_aggregate(*args)
    for _ in range(50):
        again = k2.bm3d_aggregate(*args)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_two_bm3d_denoises_are_bitwise_equal(cuda):
    x = torch.tensor(_noisy(128, b=1)[0], device=cuda)
    p = bm3d.BM3DParams(search=8, match_dtype="bfloat16")
    assert torch.equal(bm3d.bm3d_denoise(x, 0.1, p), bm3d.bm3d_denoise(x, 0.1, p))


def test_sr_adjoint_on_the_card_repeats_itself(cuda):
    for shape in ((256, 256, 128, 128), (30, 30, 17, 17)):  # the SR lane's, and up to 4 terms a pixel
        idx, wts = resize.bilinear_gather_params(*shape)
        n = shape[0] * shape[1]
        ti, tw = torch.tensor(idx, dtype=torch.int64, device=cuda), torch.tensor(wts, device=cuda)
        table = torch.tensor(resize.bilinear_adjoint_table(idx, n), device=cuda)
        r = torch.randn((2, idx.shape[0]), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
        first = resize.bilinear_adjoint(r, ti, tw, n, table)
        assert all(torch.equal(resize.bilinear_adjoint(r, ti, tw, n, table), first) for _ in range(20))


# The any-kernels at the corners of each kernel's envelope. K1:
# (block, step, search, k); every block keeps at least k valid candidates
# only where the window allows, so spare slots are filled as the plain
# version fills them. Since the span kernel, K1's calls at these corners go
# to the tile kernel (block 8) or the span kernel (every other block); the
# any-kernel keeps the same corners through its own entry point
# (test_k1_any_kernel_by_name_matches_plain_at_the_envelope_corners).
K1_CORNERS = [(2, 1, 0, 1), (2, 2, 24, 64), (16, 16, 24, 64), (16, 1, 2, 1), (8, 3, 19, 32),
              (8, 3, 24, 16), (4, 2, 3, 4), (5, 2, 4, 8)]


def _near_tie(block):
    """NEAR_TIE for block^2 terms a distance."""
    return 2 * (block * block - 1) * 2.0**-24


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block,step,search,k", K1_CORNERS)
def test_k1_any_kernel_matches_plain_at_the_envelope_corners(cuda, block, step, search, k, mode):
    x = torch.tensor(_noisy(64), device=cuda)
    rows = bm3d._ref_grid(64, block, step)
    offs = bm3d.search_offsets(search, 1)
    before = k1.bm3d_match.launches
    got = k1.bm3d_match(x, rows, rows, offs, block, k, mode)
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before + 1
    want = k1.bm3d_match_plain(x, rows, rows, offs, block, k, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, rows, offs, block, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= _near_tie(block)
    dyadic = torch.tensor(_dyadic(np.random.default_rng(block), (2, 64, 64), 4, 0.25), device=cuda)
    assert torch.equal(k1.bm3d_match(dyadic, rows, rows, offs, block, k, mode),
                       k1.bm3d_match_plain(dyadic, rows, rows, offs, block, k, mode))


def _k1_by_name(kernel, x, rows, offs, block, k, mode, bounds=None):
    """K1 launched as ``kernel`` through its own entry point (counts nothing)."""
    g = k1.match_geometry(rows, rows, offs, block, x.device)
    out = torch.empty((x.shape[0], len(rows), len(rows), k), dtype=torch.int32, device=x.device)
    lo, hi = bounds or (0, x.shape[1])
    k1.launch(kernel, k1._lib()[kernel], x.contiguous(), g, out, block, k, mode, lo, hi)
    return out


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block,step,search,k", K1_CORNERS)
def test_k1_any_kernel_by_name_matches_plain_at_the_envelope_corners(cuda, block, step, search, k, mode):
    x = torch.tensor(_noisy(64), device=cuda)
    rows = bm3d._ref_grid(64, block, step)
    offs = bm3d.search_offsets(search, 1)
    before = k1.bm3d_match.launches
    got = _k1_by_name(k1.PREV_DESIGN, x, rows, offs, block, k, mode)
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before
    want = k1.bm3d_match_plain(x, rows, rows, offs, block, k, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, rows, offs, block, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= _near_tie(block)
    dyadic = torch.tensor(_dyadic(np.random.default_rng(block), (2, 64, 64), 4, 0.25), device=cuda)
    assert torch.equal(_k1_by_name(k1.PREV_DESIGN, dyadic, rows, offs, block, k, mode),
                       k1.bm3d_match_plain(dyadic, rows, rows, offs, block, k, mode))


def _k2_stage1_args(cuda, block, step, search, k, size=64):
    x = torch.tensor(_noisy(size), device=cuda)
    p = bm3d.BM3DParams(block=block, step=step, search=search, group_ht=k)
    return bm3d.stage1_aggregate_inputs(x, 0.1, p)[1]


@pytest.mark.parametrize("block,step,search,k", [(2, 1, 0, 1), (2, 2, 24, 64), (16, 16, 24, 64),
                                                  (16, 4, 2, 1), (8, 3, 19, 32), (4, 2, 3, 4)])
def test_k2_any_kernel_matches_plain_at_the_envelope_corners(cuda, block, step, search, k):
    idx, est, wgt, kai, h, w, geom = _k2_stage1_args(cuda, block, step, search, k)
    num, den = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
    want_num, want_den = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    for got, want in ((num, want_num), (den, want_den)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    rng = np.random.default_rng(block * 100 + k)  # dyadic values: every order gives the same bits
    d_est = torch.tensor(_dyadic(rng, tuple(est.shape), 16, 0.125) - 1.0, device=cuda)
    d_wgt = torch.tensor(2.0 ** rng.integers(-2, 3, tuple(wgt.shape)).astype(np.float32), device=cuda)
    d_kai = torch.tensor(_dyadic(rng, block * block, 4, 0.25) + 0.25, device=cuda)
    got = k2.bm3d_aggregate(idx, d_est, d_wgt, d_kai, h, w, geom)
    want = k2.bm3d_aggregate_plain(idx, d_est, d_wgt, d_kai, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2_repeats_itself_bit_for_bit_at_32_matches(cuda):
    # The reference profile's Wiener stage (K = 32, step 3, search 19: a
    # pixel under more covering tiles than the all-at-once fold holds).
    args = _k2_stage1_args(cuda, 8, 3, 19, 32, size=128)
    first = k2.bm3d_aggregate(*args)
    for _ in range(50):
        again = k2.bm3d_aggregate(*args)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("patch_size,patch_distance", [(1, 1), (1, 15), (11, 1), (11, 15), (7, 11),
                                                        (4, 6), (3, 8)])
def test_k3_any_kernel_matches_plain_at_the_envelope_corners(cuda, patch_size, patch_distance, b):
    z, h = _nlm_noise_input(cuda, b, 48, 40)
    for bounds in (None, (6, 42)):
        got = k3.nlm_denoise(z, h, 0.8 * h, patch_size, patch_distance, row_valid_bounds=bounds)
        want = k3.nlm_denoise_plain(z, h, 0.8 * h, patch_size, patch_distance, row_valid_bounds=bounds)
        assert float((got - want).abs().max()) <= 1e-5


def test_bm3d_at_the_reference_profile_on_the_card_matches_the_cpu(cuda):
    x = _noisy(64)
    p = bm3d.BM3DParams(block=8, step=3, search=19, group_ht=16, group_wie=32, match_dtype="bfloat16")
    gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p)
    cpu = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, p)
    # bf16 distances over a 39 x 39 window tie often, and the stage-1
    # estimates differ in their last bits (cuBLAS against the CPU's sums),
    # so the Wiener stage's 32 matches flip at near-ties more often than at
    # search 6 (1.4e-4 on an H100): test_torch_bm3d.py's f32 rule against JAX.
    assert float((gpu.cpu() - cpu).abs().mean()) < 1e-3
    assert torch.equal(gpu, bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p))


# K1's block-8 tile kernel (bm3d_match_tile_kernel): at the reference
# profile's shapes (13 images of 128 px, step 3, 1,521 offsets, 16 and 32
# matches) on K1's rules, exactly on dyadic images there and at every step
# 1-8 (windows, k, row bounds and widths off the profile's too), and bit for
# bit over 50 more calls.
def _profile_batch(seed=0):
    rng = np.random.default_rng(seed)
    paths = [f"Set12/{i:02d}.png" for i in range(1, 13)] + ["13.png"]
    clean = np.stack([load_image(p, 128, 128) for p in paths])
    return (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("search,k", [(19, 16), (19, 32), (24, 16)])
def test_k1_tile_kernel_matches_plain_at_the_profile_shapes(cuda, mode, search, k):
    x = torch.tensor(_profile_batch(), device=cuda)
    rows = bm3d._ref_grid(128, 8, 3)
    offs = bm3d.search_offsets(search, 1)
    g = k1.match_geometry(rows, rows, offs, 8, cuda)
    assert k1.match_kernel(g, 8, k) == "bm3d_match_tile_kernel"
    before, by_kernel = k1.bm3d_match.launches, dict(k1.bm3d_match.by_kernel)
    got = k1.bm3d_match(x, rows, rows, offs, 8, k, mode, geometry=g)
    torch.cuda.synchronize()
    assert k1.bm3d_match.launches == before + 1
    assert k1.bm3d_match.by_kernel == by_kernel | {"bm3d_match_tile_kernel": by_kernel["bm3d_match_tile_kernel"] + 1}
    want = k1.bm3d_match_plain(x, rows, rows, offs, 8, k, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, rows, offs, 8, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= NEAR_TIE
    picked = [int(torch.isinf(dists.gather(-1, t.long())).sum()) for t in (got, want)]
    assert picked[0] == picked[1]


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("k", [16, 32])
def test_k1_tile_kernel_equals_plain_exactly_on_dyadic_images_at_the_profile_shape(cuda, mode, k):
    x = torch.tensor(_dyadic(np.random.default_rng(1521), (13, 128, 128), 4, 0.25), device=cuda)
    rows = bm3d._ref_grid(128, 8, 3)
    offs = bm3d.search_offsets(19, 1)
    assert torch.equal(k1.bm3d_match(x, rows, rows, offs, 8, k, mode),
                       k1.bm3d_match_plain(x, rows, rows, offs, 8, k, mode))


# (step, search, search_step, k, size, row bounds): every step, with the
# grid's last block off the step (size 64 at steps 5-7; 37), spare slots
# filled (search 0-2 at k 16-64), a sublattice window and row bounds.
K1_TILE_POINTS = [(1, 2, 1, 16, 37, None), (2, 5, 1, 64, 64, None), (3, 19, 1, 64, 128, (5, 120)),
                  (4, 24, 2, 1, 64, None), (5, 0, 1, 64, 64, None), (6, 7, 1, 4, 45, (0, 30)),
                  (7, 3, 1, 8, 64, None), (8, 12, 3, 2, 64, (20, 64))]


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("step,search,search_step,k,size,bounds", K1_TILE_POINTS)
def test_k1_tile_kernel_equals_plain_exactly_on_dyadic_images_at_every_step(
        cuda, mode, step, search, search_step, k, size, bounds):
    x = torch.tensor(_dyadic(np.random.default_rng(step), (2, size, size + 3), 4, 0.25), device=cuda)
    rows, cols = bm3d._ref_grid(size, 8, step), bm3d._ref_grid(size + 3, 8, step)
    offs = bm3d.search_offsets(search, search_step)
    g = k1.match_geometry(rows, cols, offs, 8, cuda)
    assert k1.match_kernel(g, 8, k) == "bm3d_match_tile_kernel"
    got = k1.bm3d_match(x, rows, cols, offs, 8, k, mode, geometry=g, row_valid_bounds=bounds)
    assert torch.equal(got, k1.bm3d_match_plain(x, rows, cols, offs, 8, k, mode, row_valid_bounds=bounds))


def test_k1_tile_kernel_repeats_itself_bit_for_bit(cuda):
    x = torch.tensor(_profile_batch(7), device=cuda)
    rows = bm3d._ref_grid(128, 8, 3)
    offs = bm3d.search_offsets(19, 1)
    g = k1.match_geometry(rows, rows, offs, 8, cuda)
    for k in (16, 32):
        first = k1.bm3d_match(x, rows, rows, offs, 8, k, "bf16_xla", geometry=g)
        for _ in range(50):
            assert torch.equal(k1.bm3d_match(x, rows, rows, offs, 8, k, "bf16_xla", geometry=g), first)


# Registers of the headline's kernels, as ptxas gave them on an H100
# (`cuobjdump -res-usage`): those later slices left as they were, the same
# for the earlier trees' sources and this tree's: K1's first kernel 93 (96
# at PER = 20), K1's tile kernel 80 (its six instantiations of one and two
# slots a lane; the four-slot ones for k 128 came later; its staging
# and phase 2 are now functions the span kernel shares), K2's fold 48
# (streaming) / 179 (all at once), K3's (4, 5) kernel 79; and K2's (8, 16)
# tiles, now the template's instantiation, 56 (the parent's own (8, 16)
# kernel: 64), with the same order of adds and the same bits.
UNTOUCHED_REGISTERS = {
    ("bm3d_match", r"bm3d_match_kernelILi\dELi(?:1|3|10)E"): 93,
    ("bm3d_match", r"bm3d_match_tile_kernelILi\dELi[12]EE"): 80,
    ("bm3d_match", r"bm3d_match_kernelILi\dELi20E"): 96,
    ("bm3d_aggregate", r"bm3d_aggregate_kernelILi8ELi16EE"): 56,
    ("bm3d_aggregate", r"bm3d_aggregate_fold_kernelILb0ELi2ELi2EE"): 48,
    ("bm3d_aggregate", r"bm3d_aggregate_fold_kernelILb1ELi2ELi2EE"): 179,
    ("nlm", r"nlm_kernelEPKf"): 79,
}


def test_untouched_instantiations_keep_their_registers(cuda):
    import re
    import subprocess
    from pathlib import Path

    from pnp_svrg_tpu_torch.ops.cuda import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        pytest.skip("no cuobjdump in the CUDA toolkit")
    paths = _build.build()
    for (lib, pattern), regs in UNTOUCHED_REGISTERS.items():
        text = subprocess.run([str(tool), "-res-usage", str(paths[lib])], capture_output=True,
                              text=True, check=True).stdout
        found = re.findall(r"Function (\S+):\s+REG:(\d+)", text)
        hits = [int(r) for name, r in found if re.search(pattern, name)]
        assert hits and all(r == regs for r in hits), (lib, pattern, hits)


def untouched_fingerprints(device) -> dict:
    """sha256 prefixes of what the kernels later slices left alone give on
    numpy-seeded real-valued inputs (any change in their order of adds
    changes the bits): K2's (8, 16) at the headline's geometry (B = 2,
    the fold's all-at-once form; B = 13, its streaming form) and (8, 32)
    at the reference profile's (step 3, search 19), K3's (4, 5) at B = 9
    with and without row bounds, K1's first kernel at the headline's shape
    (B = 13, 289 offsets, ``bf16_xla``) and at B = 1 in ``f32``, and K1's
    tile kernel at the reference profile's step 3 and search 19 with 16 and
    32 matches (B = 2). Run from a checkout of the earlier tree, the same
    function gives the fingerprints :data:`UNTOUCHED_FINGERPRINTS` holds."""
    import hashlib

    def digest(*ts):
        return hashlib.sha256(b"".join(np.ascontiguousarray(t.cpu().numpy()).tobytes() for t in ts)).hexdigest()[:16]

    out = {}
    for name, b, step, search, k, mode in (("k1_first_b13", 13, 4, 8, 16, "bf16_xla"),
                                           ("k1_first_b1", 1, 4, 8, 16, "f32"),
                                           ("k1_tile_k16", 2, 3, 19, 16, "bf16_xla"),
                                           ("k1_tile_k32", 2, 3, 19, 32, "bf16_xla")):
        rng = np.random.default_rng(b * 1000 + step * 100 + k)
        x = torch.tensor((load_image("13.png", 128, 128) + 0.1 * rng.standard_normal((b, 128, 128)))
                         .astype(np.float32), device=device)
        grid = bm3d._ref_grid(128, 8, step)
        out[name] = digest(k1.bm3d_match(x, grid, grid, bm3d.search_offsets(search, 1), 8, k, mode))
    for name, b, step, search, k in (("k2_8_16_b2", 2, 4, 8, 16), ("k2_8_16_b13", 13, 4, 8, 16),
                                      ("k2_8_32_b2", 2, 3, 19, 32)):
        rng = np.random.default_rng(b * 100 + k)
        grid = bm3d._ref_grid(128, 8, step)
        n = len(grid)
        offs = rng.integers(-search, search + 1, (b, n, n, k, 2))
        py = np.clip(grid[None, :, None, None] + offs[..., 0], 0, 120)
        px = np.clip(grid[None, None, :, None] + offs[..., 1], 0, 120)
        idx = (py * 121 + px).reshape(b, -1).astype(np.int32)
        est = rng.standard_normal((b, n * n * k, 64)).astype(np.float32)
        wgt = rng.uniform(0.5, 5.0, (b, n * n)).astype(np.float32)
        kai = rng.uniform(0.1, 1.0, 64).astype(np.float32)
        geom = k2.aggregate_geometry(128, 128, tuple(grid.tolist()), tuple(grid.tolist()), search, 8, device)
        args = [torch.tensor(a, device=device) for a in (idx, est, wgt, kai)]
        out[name] = digest(*k2.bm3d_aggregate(*args, 128, 128, geom))
    rng = np.random.default_rng(45)
    z = torch.tensor((load_image("13.png", 96, 80) + 0.1 * rng.standard_normal((9, 96, 80))).astype(np.float32),
                     device=device)
    h = torch.tensor(rng.uniform(0.06, 0.2, 9).astype(np.float32), device=device)
    out["k3_4_5_b9"] = digest(k3.nlm_denoise(z, h, 0.8 * h, 4, 5),
                              k3.nlm_denoise(z, h, 0.8 * h, 4, 5, row_valid_bounds=(10, 70)))
    return out



# What the untouched kernels gave before later slices: untouched_fingerprints
# run on the card from a checkout of the tree before the packed K2 and the
# cluster K3 kernel existed (K2, K3), and of the tree before the span kernel
# (K1).
UNTOUCHED_FINGERPRINTS = {"k1_first_b13": "8c32060885cf6de7", "k1_first_b1": "3bce27305ffce817",
                          "k1_tile_k16": "9114f14fe3172631", "k1_tile_k32": "c345dae18744ff93",
                          "k2_8_16_b2": "dbc3785f3b6a9d07", "k2_8_16_b13": "1296a69990bc7c8c",
                          "k2_8_32_b2": "d1ad9bdf49a12841", "k3_4_5_b9": "ccc2b23c008bf2e8"}


def test_untouched_kernels_give_their_earlier_bits(cuda):
    assert untouched_fingerprints(cuda) == UNTOUCHED_FINGERPRINTS


# K2's run-time rows (block, step, search, K): the golden oracle's BM3D
# point and chip_smoke.py's envelope rows, all on the packed kernel.
K2_RUNTIME_ROWS = [(4, 2, 3, 4), (2, 1, 3, 4), (6, 3, 6, 8), (8, 4, 8, 8), (16, 8, 8, 16), (3, 1, 5, 2),
                   (5, 5, 2, 16)]


def _k2_dyadic(rng, est, wgt, kai, cuda):
    block2 = kai.numel()
    return (torch.tensor(_dyadic(rng, tuple(est.shape), 16, 0.125) - 1.0, device=cuda),
            torch.tensor(2.0 ** rng.integers(-2, 3, tuple(wgt.shape)).astype(np.float32), device=cuda),
            torch.tensor(_dyadic(rng, block2, 4, 0.25) + 0.25, device=cuda))


@pytest.mark.parametrize("block,step,search,k", K2_RUNTIME_ROWS)
def test_k2_packed_kernel_matches_plain_at_the_runtime_rows(cuda, block, step, search, k):
    idx, est, wgt, kai, h, w, geom = _k2_stage1_args(cuda, block, step, search, k, size=96)
    assert k2.aggregate_kernel(block, k) == "bm3d_aggregate_packed_kernel"
    before = dict(k2.bm3d_aggregate.by_kernel)
    num, den = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
    torch.cuda.synchronize()
    assert k2.bm3d_aggregate.by_kernel["bm3d_aggregate_packed_kernel"] == before["bm3d_aggregate_packed_kernel"] + 1
    want_num, want_den = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    for got, want in ((num, want_num), (den, want_den)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    again = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
    assert torch.equal(again[0], num) and torch.equal(again[1], den)
    d = _k2_dyadic(np.random.default_rng(block * 10 + step), est, wgt, kai, cuda)
    got = k2.bm3d_aggregate(idx, *d, h, w, geom)
    want = k2.bm3d_aggregate_plain(idx, *d, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2_packed_kernel_repeats_itself_bit_for_bit(cuda):
    args = _k2_stage1_args(cuda, 4, 2, 3, 4, size=128)
    first = k2.bm3d_aggregate(*args)
    for _ in range(50):
        again = k2.bm3d_aggregate(*args)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.parametrize("plan", [dict(tile=2), dict(tile=5), dict(tile=16), dict(warps=1), dict(warps=8),
                                  dict(groups=1), dict(groups=2, warps=3)])
def test_k2_packed_kernel_on_other_plans(cuda, plan):
    # Any tile edge, warps a CTA and lane groups a warp give the plain
    # version's bits on dyadic values (the rows of a real stage-1 call).
    idx, est, wgt, kai, h, w, geom = _k2_stage1_args(cuda, 4, 2, 3, 4)
    grid = tuple(bm3d._ref_grid(h, 4, 2).tolist())
    plan = k2.make_packed_plan(h, w, grid, grid, 3, 4, 4, cuda, **plan)
    d = _k2_dyadic(np.random.default_rng(7), est, wgt, kai, cuda)
    got = k2.launch(k2.K2_KERNELS[1], k2._lib()[k2.K2_KERNELS[1]], idx, *d, h, w, geom, plan)
    want = k2.bm3d_aggregate_plain(idx, *d, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2_packed_kernel_adds_rows_outside_the_footprint_and_drops_rows_outside_the_table(cuda):
    # Rows anywhere in the table: most leave their tile's footprint and take
    # the fold's scan, still exact on dyadic values; rows before, just past
    # and far past the table are dropped.
    rng = np.random.default_rng(8)
    idx, est, wgt, kai, h, w, geom = _k2_stage1_args(cuda, 4, 2, 3, 4, size=48)
    d_est, d_wgt, d_kai = _k2_dyadic(rng, est, wgt, kai, cuda)
    ww = w - 3
    idx = torch.tensor(rng.integers(0, (h - 3) * ww, tuple(idx.shape)).astype(np.int32), device=cuda)
    want_num, want_den = k2.bm3d_aggregate_plain(idx, d_est, d_wgt, d_kai, h, w)
    num, den = k2.bm3d_aggregate(idx, d_est, d_wgt, d_kai, h, w, geom)
    assert torch.equal(num, want_num) and torch.equal(den, want_den)
    bad = idx.clone()
    for (b, p), row in zip(((0, 5), (1, 77), (1, idx.shape[1] - 1)), (-1, (h - 3) * ww, 2**30)):
        py, px = divmod(int(idx[b, p]), ww)
        wk = (d_wgt[b, p // 4] * d_kai).view(4, 4)
        want_num[b, py : py + 4, px : px + 4] -= d_est[b, p].view(4, 4) * wk
        want_den[b, py : py + 4, px : px + 4] -= wk
        bad[b, p] = row
    num, den = k2.bm3d_aggregate(bad, d_est, d_wgt, d_kai, h, w, geom)
    assert torch.equal(num, want_num) and torch.equal(den, want_den)


def test_k2_replaced_design_stays_reachable_by_name(cuda):
    idx, est, wgt, kai, h, w, geom = _k2_stage1_args(cuda, 4, 2, 3, 4)
    before = k2.bm3d_aggregate.launches
    got = k2.launch(k2.PREV_DESIGN, k2._lib()[k2.PREV_DESIGN], idx, est, wgt, kai, h, w, geom)
    assert k2.bm3d_aggregate.launches == before  # a launch by name counts nothing
    want = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    for g_, w_ in zip(got, want):
        assert float((g_ - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


# K3's cluster kernel: chip_smoke.py's rows and the envelope's corners.
K3_ROWS = [(7, 11), (1, 1), (11, 15), (1, 15), (11, 1), (2, 3), (4, 6), (6, 4), (8, 9), (9, 2)]


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("patch_size,patch_distance", K3_ROWS)
def test_k3_cluster_kernel_matches_plain(cuda, patch_size, patch_distance, b):
    z, h = _nlm_noise_input(cuda, b, 48, 40)
    pd = (patch_size, patch_distance)
    assert k3.nlm_kernel_name(*pd) == "nlm_cluster_kernel"
    before = dict(k3.nlm_denoise.by_kernel)
    for bounds in (None, (6, 42), (10, 11)):
        got = k3.nlm_denoise(z, h, 0.8 * h, *pd, row_valid_bounds=bounds)
        want = k3.nlm_denoise_plain(z, h, 0.8 * h, *pd, row_valid_bounds=bounds)
        assert float((got - want).abs().max()) <= 1e-5
        assert torch.equal(k3.nlm_denoise(z, h, 0.8 * h, *pd, row_valid_bounds=bounds), got)
    torch.cuda.synchronize()
    assert k3.nlm_denoise.by_kernel["nlm_cluster_kernel"] == before["nlm_cluster_kernel"] + 6
    zero = torch.zeros(b, device=cuda)
    assert torch.isnan(k3.nlm_denoise(z, zero, zero, *pd)).all()


@pytest.mark.parametrize("plan", [(1, 1, 8), (1, 8, 8), (2, 3, 8), (3, 5, 8), (8, 8, 8), (8, 1, 8), (1, 8, 4),
                                  (2, 4, 4), (16, 4, 8), (13, 2, 4)])
def test_k3_cluster_kernel_on_other_plans(cuda, plan):
    # Any split of the shifts over a cluster's CTAs and their warps sums the
    # same terms (in its own fixed order) and repeats itself.
    z, h = _nlm_noise_input(cuda, 2, 128, 128)
    want = k3.nlm_denoise_plain(z, h, h, 7, 11)
    hs, out = h.contiguous(), torch.empty_like(z)
    k3.launch(k3.K3_KERNELS[1], k3._lib(), z, hs, hs, out, 7, 11, 0, 128, plan)
    assert float((out - want).abs().max()) <= 1e-5
    again = torch.empty_like(z)
    k3.launch(k3.K3_KERNELS[1], k3._lib(), z, hs, hs, again, 7, 11, 0, 128, plan)
    assert torch.equal(out, again)


def test_k3_replaced_design_stays_reachable_by_name(cuda):
    z, h = _nlm_noise_input(cuda, 1, 128, 128)
    before = k3.nlm_denoise.launches
    out = torch.empty_like(z)
    k3.launch(k3.PREV_DESIGN, k3._lib(), z, h, h, out, 7, 11, 0, 128)
    assert k3.nlm_denoise.launches == before
    assert float((out - k3.nlm_denoise_plain(z, h, h, 7, 11)).abs().max()) <= 1e-5


# K1's span kernel (bm3d_match_span_kernel): every block 2-16 but 8 on K1's
# rules and exactly on dyadic images (with and without row bounds, and on a
# search_step sublattice), chip_smoke.py's rows off block 8 at their own
# shapes, 50 repeats bit for bit; the design it replaced stays reachable by
# name. SPAN_POINTS: block -> (step, search, k), each phase-2 form (k 1-8 a
# thread a block, 16-64 a warp) and the steps 1 to the block among them.
SPAN_POINTS = {2: (1, 3, 4), 3: (2, 5, 1), 4: (2, 3, 8), 5: (2, 4, 16), 6: (3, 6, 32), 7: (7, 2, 64),
               9: (4, 8, 4), 10: (5, 3, 2), 11: (1, 2, 16), 12: (6, 9, 8), 13: (13, 4, 32), 14: (7, 5, 64),
               15: (3, 2, 4), 16: (8, 8, 16)}
SPAN_ROWS = {"golden": (4, 2, 3, 4), "block2": (2, 1, 3, 4), "block5": (5, 2, 4, 8), "block6": (6, 3, 6, 8),
             "block16": (16, 8, 8, 16), "block4_s19": (4, 2, 19, 16)}
SPAN = "bm3d_match_span_kernel"


def _span_held_to_plain(x, rows, cols, offs, block, k, mode):
    """K1 on ``x`` through the span kernel (one launch, counted under its
    name), held to the plain version on K1's rules."""
    g = k1.match_geometry(rows, cols, offs, block, x.device)
    assert k1.match_kernel(g, block, k) == SPAN
    before = dict(k1.bm3d_match.by_kernel)
    got = k1.bm3d_match(x, rows, cols, offs, block, k, mode, geometry=g)
    torch.cuda.synchronize()
    assert k1.bm3d_match.by_kernel == before | {SPAN: before[SPAN] + 1}
    want = k1.bm3d_match_plain(x, rows, cols, offs, block, k, mode)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, cols, offs, block, mode)
    assert float(_slot_gaps(got, want, dists).max()) <= _near_tie(block)
    picked = [int(torch.isinf(dists.gather(-1, t.long())).sum()) for t in (got, want)]
    assert picked[0] == picked[1]  # as many index-0 fills


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block", list(SPAN_POINTS))
def test_k1_span_kernel_matches_plain_at_every_block(cuda, mode, block):
    step, search, k = SPAN_POINTS[block]
    x = torch.tensor(_noisy(64), device=cuda)
    rows, cols = bm3d._ref_grid(64, block, step), bm3d._ref_grid(61, block, step)
    _span_held_to_plain(x[:, :, :61].contiguous(), rows, cols, bm3d.search_offsets(search, 1), block, k, mode)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("row", list(SPAN_ROWS))
def test_k1_span_kernel_matches_plain_at_the_envelope_rows(cuda, mode, row):
    block, step, search, k = SPAN_ROWS[row]
    x = torch.tensor(_profile_batch(), device=cuda)
    rows = bm3d._ref_grid(128, block, step)
    _span_held_to_plain(x, rows, rows, bm3d.search_offsets(search, 1), block, k, mode)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("block", list(SPAN_POINTS))
def test_k1_span_kernel_equals_plain_exactly_on_dyadic_images(cuda, mode, block):
    step, search, k = SPAN_POINTS[block]
    size = 45
    x = torch.tensor(_dyadic(np.random.default_rng(block), (2, size, size + 3), 4, 0.25), device=cuda)
    rows, cols = bm3d._ref_grid(size, block, step), bm3d._ref_grid(size + 3, block, step)
    for search_step, bounds in ((1, None), (1, (5, size - 7)), (2, None), (2, (0, size - 4))):
        offs = bm3d.search_offsets(search, search_step)
        g = k1.match_geometry(rows, cols, offs, block, cuda)
        assert k1.match_kernel(g, block, k) == SPAN
        got = k1.bm3d_match(x, rows, cols, offs, block, k, mode, geometry=g, row_valid_bounds=bounds)
        assert torch.equal(got, k1.bm3d_match_plain(x, rows, cols, offs, block, k, mode, row_valid_bounds=bounds))


def test_k1_span_kernel_repeats_itself_bit_for_bit(cuda):
    x = torch.tensor(_profile_batch(16), device=cuda)
    for block, step, search, k in ((4, 2, 3, 4), (4, 2, 19, 16), (6, 3, 6, 32)):
        rows = bm3d._ref_grid(128, block, step)
        offs = bm3d.search_offsets(search, 1)
        g = k1.match_geometry(rows, rows, offs, block, cuda)
        first = k1.bm3d_match(x, rows, rows, offs, block, k, "bf16_xla", geometry=g)
        for _ in range(50):
            assert torch.equal(k1.bm3d_match(x, rows, rows, offs, block, k, "bf16_xla", geometry=g), first)


def test_k1_replaced_design_stays_reachable_by_name(cuda):
    x = torch.tensor(_profile_batch(), device=cuda)
    block, step, search, k = SPAN_ROWS["golden"]
    rows = bm3d._ref_grid(128, block, step)
    offs = bm3d.search_offsets(search, 1)
    assert k1.PREV_DESIGN == "bm3d_match_any_kernel"
    before = k1.bm3d_match.launches, dict(k1.bm3d_match.by_kernel)
    got = _k1_by_name(k1.PREV_DESIGN, x, rows, offs, block, k, "bf16_xla")
    torch.cuda.synchronize()
    assert (k1.bm3d_match.launches, k1.bm3d_match.by_kernel) == before  # a launch by name counts nothing
    want = k1.bm3d_match_plain(x, rows, rows, offs, block, k, "bf16_xla")
    dists = k1.match_distances_plain(x, rows, rows, offs, block, "bf16_xla")
    assert _multiset_agreement(got, want) >= 0.995
    assert float(_slot_gaps(got, want, dists).max()) <= _near_tie(block)


# K1-K3 past the earlier envelope (block 1 and 17-32, a step past
# the block, windows past search 24 and wider than the image, k 128; NLM
# past patch 11 and distance 15), each through the kernel its naming
# function gives, on its kernel's rules and exactly on dyadic inputs.
WIDE_K1 = {"step_past_block": (8, 10, 19, 16), "block4_step6": (4, 6, 3, 4), "search32": (8, 3, 32, 16),
           "block4_s40": (4, 2, 40, 16), "k128": (8, 3, 19, 128), "block1": (1, 1, 3, 4),
           "block24": (24, 12, 8, 16), "block32": (32, 16, 4, 16), "block4_k128": (4, 2, 19, 128),
           "block20_k64": (20, 7, 5, 64)}


def _k1_wide_held(x, rows, cols, offs, block, k, mode, bounds=None):
    g = k1.match_geometry(rows, cols, offs, block, x.device)
    kernel = k1.match_kernel(g, block, k)
    assert kernel in ("bm3d_match_tile_kernel", SPAN)
    before = dict(k1.bm3d_match.by_kernel)
    got = k1.bm3d_match(x, rows, cols, offs, block, k, mode, geometry=g, row_valid_bounds=bounds)
    torch.cuda.synchronize()
    assert k1.bm3d_match.by_kernel == before | {kernel: before[kernel] + 1}
    want = k1.bm3d_match_plain(x, rows, cols, offs, block, k, mode, row_valid_bounds=bounds)
    assert _multiset_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)
    dists = k1.match_distances_plain(x, rows, cols, offs, block, mode, row_valid_bounds=bounds)
    assert float(_slot_gaps(got, want, dists).max()) <= _near_tie(block)
    picked = [int(torch.isinf(dists.gather(-1, t.long())).sum()) for t in (got, want)]
    assert picked[0] == picked[1]
    return got


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("row", list(WIDE_K1))
def test_k1_matches_plain_past_the_earlier_envelope(cuda, mode, row):
    block, step, search, k = WIDE_K1[row]
    x = torch.tensor(_profile_batch()[:4], device=cuda)
    rows = bm3d._ref_grid(128, block, step)
    _k1_wide_held(x, rows, rows, bm3d.search_offsets(search, 1), block, k, mode)


@pytest.mark.parametrize("mode", list(k1.MODES))
@pytest.mark.parametrize("row", list(WIDE_K1))
def test_k1_equals_plain_exactly_on_dyadic_images_past_the_earlier_envelope(cuda, mode, row):
    block, step, search, k = WIDE_K1[row]
    size = max(45, block + 13)
    x = torch.tensor(_dyadic(np.random.default_rng(block + step), (2, size, size + 3), 4, 0.25), device=cuda)
    rows, cols = bm3d._ref_grid(size, block, step), bm3d._ref_grid(size + 3, block, step)
    for bounds in (None, (3, size - 5)):
        offs = bm3d.search_offsets(search, 1)
        got = k1.bm3d_match(x, rows, cols, offs, block, k, mode, row_valid_bounds=bounds)
        assert torch.equal(got, k1.bm3d_match_plain(x, rows, cols, offs, block, k, mode, row_valid_bounds=bounds))


@pytest.mark.parametrize("block,k", [(8, 16), (4, 4), (8, 128), (16, 64)])
def test_k1_takes_a_window_wider_than_the_image_through_its_reach(cuda, block, k):
    # search 48 on 40 x 44 images: offsets past H - block or W - block are
    # +inf for every block; the kernels skip them and keep the full
    # window's indices (k 128 past the finite candidates: index-0 fills).
    size = 40
    x = torch.tensor(_noisy(size + 4)[:, :size], device=cuda).contiguous()
    rows, cols = bm3d._ref_grid(size, block, 4), bm3d._ref_grid(size + 4, block, 4)
    offs = bm3d.search_offsets(48, 1)
    g = k1.match_geometry(rows, cols, offs, block, cuda)
    r = g.reach(size, size + 4)
    assert r.search == size + 4 - block and r.order.numel() < len(offs)
    for mode in k1.MODES:
        _k1_wide_held(x, rows, cols, offs, block, k, mode)
    d = torch.tensor(_dyadic(np.random.default_rng(k), (2, size, size + 4), 4, 0.25), device=cuda)
    assert torch.equal(k1.bm3d_match(d, rows, cols, offs, block, k, "f32"),
                       k1.bm3d_match_plain(d, rows, cols, offs, block, k, "f32"))


def test_k1_at_the_widest_search_at_block_8(cuda):
    search = k1.match_search_limit(8, 16)
    x = torch.tensor(_profile_batch()[:2], device=cuda)
    rows = bm3d._ref_grid(128, 8, 8)
    _k1_wide_held(x, rows, rows, bm3d.search_offsets(search, 4), 8, 16, "bf16_xla")


WIDE_K2 = [(8, 10, 19, 16), (4, 6, 3, 4), (8, 3, 19, 128), (1, 1, 3, 4), (24, 12, 8, 16), (32, 16, 4, 16),
           (17, 5, 3, 8), (4, 2, 19, 128), (8, 3, 32, 16)]


def _k2_wide_held(cuda, args, kernel, seed):
    """One K2 call on ``args`` goes to ``kernel`` and is held to the plain
    version (1e-5 of the planes' magnitude, den = 0 where it is, three
    repeats and dyadic values bit for bit)."""
    idx, est, wgt, kai, h, w, geom = args
    before = dict(k2.bm3d_aggregate.by_kernel)
    num, den = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
    torch.cuda.synchronize()
    assert k2.bm3d_aggregate.by_kernel == before | {kernel: before[kernel] + 1}
    want_num, want_den = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    for got, want in ((num, want_num), (den, want_den)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(den == 0, want_den == 0)  # gaps between blocks keep den = 0
    for _ in range(3):
        again = k2.bm3d_aggregate(idx, est, wgt, kai, h, w, geom)
        assert torch.equal(again[0], num) and torch.equal(again[1], den)
    d = _k2_dyadic(np.random.default_rng(seed), est, wgt, kai, cuda)
    got = k2.bm3d_aggregate(idx, *d, h, w, geom)
    want = k2.bm3d_aggregate_plain(idx, *d, h, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("block,step,search,k", WIDE_K2)
def test_k2_matches_plain_past_the_earlier_envelope(cuda, block, step, search, k):
    args = _k2_stage1_args(cuda, block, step, search, k, size=96)
    kernel = k2.aggregate_kernel(block, k, args[-1])  # the compiled (8, 16) kernel at 16 matches of 8 x 8
    assert kernel == ("bm3d_aggregate_kernel" if (block, k) == (8, 16) else "bm3d_aggregate_packed_kernel")
    _k2_wide_held(cuda, args, kernel, block * 10 + step)


@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("window", ["search40", "widest"])
def test_k2_takes_windows_past_the_compiled_tiles(cuda, window, k):
    # (8, 16) / (8, 32) at step 3 on 128 px images: from search 38 the
    # compiled kernel's 2 x 2 tiles pass a CTA's shared memory, so the
    # packed kernel takes the call (at K1's widest, one warp a CTA).
    search = 40 if window == "search40" else k1.match_search_limit(8, k)
    args = _k2_stage1_args(cuda, 8, 3, search, k, size=128)
    assert k2.aggregate_kernel(8, k, args[-1]) == "bm3d_aggregate_packed_kernel"
    _k2_wide_held(cuda, args, "bm3d_aggregate_packed_kernel", search + k)


def test_bm3d_refuses_a_k2_footprint_before_k1_launches(cuda):
    # Search 82 at block 8 on a 256 px image: K1 takes it, but one reference
    # block's 172 x 172 footprint passes a packed CTA's shared memory.
    x = torch.tensor(_noisy(256, b=1)[0], device=cuda)
    p = bm3d.BM3DParams(block=8, step=3, search=82, group_ht=16, group_wie=32)
    k1.check_match_envelope(8, 32, 82, 3)
    before = (k1.bm3d_match.launches, k2.bm3d_aggregate.launches)
    with pytest.raises(ValueError, match="footprint .* 172x172 needs 236672"):
        bm3d.bm3d_denoise(x, 0.1, p)
    assert (k1.bm3d_match.launches, k2.bm3d_aggregate.launches) == before


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("patch_size,patch_distance", [(13, 21), (21, 31), (7, 16), (31, 3), (12, 1), (1, 40)])
def test_k3_runtime_patch_kernel_matches_plain(cuda, patch_size, patch_distance, b):
    z, h = _nlm_noise_input(cuda, b, 48, 40)
    assert k3.nlm_kernel_name(patch_size, patch_distance) == "nlm_cluster_rt_kernel"
    for bounds in (None, (6, 42)):
        before = dict(k3.nlm_denoise.by_kernel)
        got = k3.nlm_denoise(z, h, 0.8 * h, patch_size, patch_distance, row_valid_bounds=bounds)
        torch.cuda.synchronize()
        assert k3.nlm_denoise.by_kernel["nlm_cluster_rt_kernel"] == before["nlm_cluster_rt_kernel"] + 1
        want = k3.nlm_denoise_plain(z, h, 0.8 * h, patch_size, patch_distance, row_valid_bounds=bounds)
        assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, k3.nlm_denoise(z, h, 0.8 * h, patch_size, patch_distance, row_valid_bounds=bounds))
    zero = torch.zeros(b, device=cuda)
    assert bool(torch.isnan(k3.nlm_denoise(z, zero, zero, patch_size, patch_distance)).all())


def test_k3_runtime_patch_kernel_on_other_plans(cuda):
    z, h = _nlm_noise_input(cuda, 1, 64, 56)
    fns = k3._lib()
    want = k3.nlm_denoise_plain(z, h, 0.8 * h, 13, 21)
    hs = h.expand(1).contiguous()
    for plan in ((1, 4, 8), (3, 6, 8), (16, 8, 8), (2, 4, 4)):
        out = torch.empty_like(z)
        k3.launch("nlm_cluster_rt_kernel", fns, z, hs, (0.8 * hs).contiguous(), out, 13, 21, 0, z.shape[1], plan)
        assert float((out - want).abs().max()) <= 1e-5


def test_bm3d_and_nlm_past_the_earlier_envelope_on_the_card_match_the_cpu(cuda):
    x = _noisy(64)
    for p in (bm3d.BM3DParams(block=8, step=10, search=19, group_ht=16, group_wie=32, match_dtype="bfloat16"),
              bm3d.BM3DParams(block=8, step=3, search=19, group_ht=16, group_wie=128),
              bm3d.BM3DParams(block=24, step=12, search=8, group_ht=16, group_wie=16)):
        gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p)
        cpu = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, p)
        assert float((gpu.cpu() - cpu).abs().mean()) < 1e-3
    z = torch.tensor(_noisy(48))
    den = NLMDenoiser(sigma_modifier=1.0, patch_size=13, patch_distance=21)
    got = den.denoise(z.to(cuda), torch.full((2,), 0.1, device=cuda), 0)
    assert float((got.cpu() - den.denoise(z, torch.full((2,), 0.1), 0)).abs().max()) <= 1e-5
