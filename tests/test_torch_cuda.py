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

from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import load_nlm_problem
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
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
    with pytest.raises(ValueError):  # unsupported group size: the kernel refuses
        k1.bm3d_match(x.float(), rows, rows, bm3d.search_offsets(4, 1), 8, 5)
    with pytest.raises(ValueError):  # unsupported patch edge
        k1.bm3d_match(x.float(), rows, rows, bm3d.search_offsets(4, 1), 4, 16)
    big = torch.zeros((1, 256, 256), device=cuda)
    grid = bm3d._ref_grid(256, 8, 4)
    with pytest.raises(ValueError):  # a 121 x 121 window: more offsets than K1 holds
        k1.bm3d_match(big, grid, grid, bm3d.search_offsets(60, 1), 8, 16)
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
    with pytest.raises(ValueError):
        k3.nlm_denoise(z, h, h, patch_size=5)
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
], ids=["bm3d", "nlm"])
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
