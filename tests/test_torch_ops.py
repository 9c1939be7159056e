"""Port parity: host helpers, metrics, wavelets, sigma estimation, sampling.

The same numpy inputs go through the JAX function (on the CPU) and its
counterpart in ``pnp_svrg_tpu_torch`` with ``device="cpu"``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pnp_svrg_tpu.ops import metrics as jmetrics
from pnp_svrg_tpu.ops import transforms as jtransforms
from pnp_svrg_tpu.ops.sigma import estimate_sigma as jax_estimate_sigma
from pnp_svrg_tpu.ops.wavelet import dwt2 as jax_dwt2
from pnp_svrg_tpu.utils.io import load_image as jax_load_image
from pnp_svrg_tpu_torch.device import default_device, resolve_device
from pnp_svrg_tpu_torch.ops import metrics, transforms
from pnp_svrg_tpu_torch.ops.sampling import sample_k_mask
from pnp_svrg_tpu_torch.ops.sigma import _masked_median, estimate_sigma
from pnp_svrg_tpu_torch.ops.wavelet import dwt2
from pnp_svrg_tpu_torch.utils.io import load_image
from test_golden_parity import dwt2_oracle, estimate_sigma_oracle


@pytest.mark.parametrize("name,h,w", [("13.png", 64, 48), ("Set12/05.png", 32, 32)])
def test_load_image_bit_identical(name, h, w):
    np.testing.assert_array_equal(load_image(name, h, w), jax_load_image(name, h, w))


@pytest.mark.parametrize("n", [4, 8, 16])
def test_transform_matrices_bit_identical(n):
    np.testing.assert_array_equal(transforms.dct_matrix(n), jtransforms.dct_matrix(n))
    np.testing.assert_array_equal(transforms.hadamard_matrix(n), jtransforms.hadamard_matrix(n))
    np.testing.assert_array_equal(transforms.kaiser2d(n, 2.0), jtransforms.kaiser2d(n, 2.0))


def test_psnr_and_ssim_match_jax(rng):
    a = rng.uniform(size=(3, 40, 36)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    got_p = metrics.psnr(torch.tensor(a), torch.tensor(b)).numpy()
    got_s = metrics.ssim(torch.tensor(a), torch.tensor(b)).numpy()
    for i in range(3):
        want_p = float(jmetrics.psnr(jnp.asarray(a[i]), jnp.asarray(b[i])))
        want_s = float(jmetrics.ssim(jnp.asarray(a[i]), jnp.asarray(b[i])))
        np.testing.assert_allclose(got_p[i], want_p, rtol=1e-6)
        np.testing.assert_allclose(got_s[i], want_s, atol=1e-5)


@pytest.mark.parametrize("shape", [(32, 32), (18, 13), (2, 33, 31)])
def test_dwt2_db2_matches_jax_and_oracle(rng, shape):
    x = rng.uniform(size=shape).astype(np.float32)
    ll, (lh, hl, hh) = dwt2(torch.tensor(x), "db2")
    got = [t.numpy() for t in (ll, lh, hl, hh)]
    jll, (jlh, jhl, jhh) = jax_dwt2(jnp.asarray(x), "db2")
    for g, want in zip(got, (jll, jlh, jhl, jhh)):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-6)
    img = x if x.ndim == 2 else x[0]
    oll, (olh, ohl, ohh) = dwt2_oracle(img.astype(np.float64), "db2")
    for g, want in zip(got, (oll, olh, ohl, ohh)):
        np.testing.assert_allclose(g if x.ndim == 2 else g[0], want, atol=1e-6)


def test_dwt2_uses_half_point_symmetric_extension():
    # db1 on [a, b, c]: the extension repeats the edge sample (pywt
    # 'symmetric'), so the last pair is (c, c) and its detail is 0.
    x = torch.tensor([[1.0, 2.0, 4.0]]).repeat(2, 1)
    ca, (_, cv, _) = dwt2(x, "db1")
    assert ca.shape == (1, 2)
    np.testing.assert_allclose(cv.numpy()[0, 1], 0.0, atol=1e-7)


def test_estimate_sigma_per_lane_matches_jax_and_oracle(rng):
    imgs = np.stack([
        rng.uniform(size=(32, 32)) + s * rng.standard_normal((32, 32))
        for s in (0.02, 0.1, 0.3)
    ]).astype(np.float32)
    got = estimate_sigma(torch.tensor(imgs)).numpy()
    want = np.asarray(jax_estimate_sigma(jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, img in zip(got, imgs):
        np.testing.assert_allclose(g, estimate_sigma_oracle(img), rtol=1e-4)


def test_estimate_sigma_even_count_takes_the_mean_of_the_middle_pair():
    # A 2x2 HH band with 4 distinct nonzero values: the median is the mean of
    # the middle two, where torch.median would return the lower one.
    vals = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    got = _masked_median(vals, vals > 0)
    assert float(got) == 2.5
    assert float(torch.median(vals)) == 2.0
    img = np.random.default_rng(3).uniform(size=(6, 6)).astype(np.float32)  # 4x4 HH
    np.testing.assert_allclose(
        estimate_sigma(torch.tensor(img)).numpy(), np.asarray(jax_estimate_sigma(jnp.asarray(img))),
        rtol=1e-5,
    )


def test_estimate_sigma_constant_image_is_zero():
    got = estimate_sigma(torch.full((2, 16, 16), 0.7))
    assert torch.all(got < 1e-6)
    vals = torch.zeros((1, 8))
    assert float(_masked_median(vals, vals > 0)) == 0.0


def test_sample_k_mask_exact_k_inside_allowed_and_uniform():
    g = torch.Generator().manual_seed(0)
    h = w = 8
    allowed = torch.zeros((h, w))
    allowed.view(-1)[::3] = 1.0  # 22 allowed cells
    n_allowed = int(allowed.sum())
    k, draws = 5, 4000
    masks = sample_k_mask((draws, h, w), k, g, allowed=allowed.expand(draws, h, w))
    assert torch.all(masks.sum(dim=(-2, -1)) == k)
    assert torch.all(masks[:, allowed == 0] == 0)
    counts = masks.sum(0)[allowed > 0].numpy()
    _, p = stats.chisquare(counts)
    assert counts.sum() == k * draws and len(counts) == n_allowed
    assert p > 1e-3, p


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
