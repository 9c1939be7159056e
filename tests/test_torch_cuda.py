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
from pnp_svrg_tpu_torch.ops.cuda import bm3d_scatter as k2
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


def _set_agreement(a, b):
    a = a.reshape(-1, a.shape[-1]).cpu().numpy()
    b = b.reshape(-1, b.shape[-1]).cpu().numpy()
    return float(np.mean([len(set(p) & set(q)) / a.shape[1] for p, q in zip(a, b)]))


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
    assert _set_agreement(got, want) >= (0.999 if mode == "f32" else 0.995)


def test_k2_matches_plain_with_collisions(cuda):
    rng = np.random.default_rng(1)
    idx = torch.tensor(rng.integers(0, 200, (2, 300)).astype(np.int32), device=cuda)
    upd = torch.tensor(rng.standard_normal((2, 300, 128)).astype(np.float32), device=cuda)
    before = k2.bm3d_scatter.launches
    got = k2.bm3d_scatter(idx, upd, 200, check_bounds=True)
    torch.cuda.synchronize()
    assert k2.bm3d_scatter.launches == before + 1
    torch.testing.assert_close(got, k2.bm3d_scatter_plain(idx, upd, 200), atol=1e-5, rtol=1e-5)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((1, 32, 32), dtype=torch.float64, device=cuda)
    rows = bm3d._ref_grid(32, 8, 4)
    with pytest.raises(ValueError):
        k1.bm3d_match(x, rows, rows, bm3d.search_offsets(4, 1), 8, 16)
    with pytest.raises(ValueError):  # unsupported group size: the kernel refuses
        k1.bm3d_match(x.float(), rows, rows, bm3d.search_offsets(4, 1), 8, 5)
    with pytest.raises(ValueError):
        k2.bm3d_scatter(torch.zeros((1, 2), dtype=torch.int32, device=cuda),
                        torch.zeros((1, 2, 6), device=cuda), 4)


def _nlm_input(cuda, b):
    """The shapes and values ``chip_smoke.py`` checks K3 at: the ``13.png``
    lane's ``x_init`` after one gradient step (eta 7000), replicated to B
    lanes with per-lane h = sigma from its sigma estimate."""
    prob = load_nlm_problem(cuda)
    z = prob.x_init - 7000.0 * prob.grad_full(prob.x_init)
    h = estimate_sigma(z) * torch.linspace(1.2, 1.7, b, device=cuda)
    return z.expand(b, -1, -1).contiguous(), h


@pytest.mark.parametrize("b,bounds", [(1, None), (9, None), (9, (16, 112))])
def test_k3_matches_plain(cuda, b, bounds):
    z, h = _nlm_input(cuda, b)
    before = k3.nlm_denoise.launches
    got = k3.nlm_denoise(z, h, h, row_valid_bounds=bounds)
    torch.cuda.synchronize()
    assert k3.nlm_denoise.launches == before + 1
    want = k3.nlm_denoise_plain(z, h, h, row_valid_bounds=bounds)
    assert float((got - want).abs().max()) <= 1e-5


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
    before = k2.bm3d_scatter.launches
    gpu = bm3d.bm3d_denoise_batch(torch.tensor(x, device=cuda), 0.1, p).cpu()
    assert k2.bm3d_scatter.launches == before  # the dense path runs no scatter
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
