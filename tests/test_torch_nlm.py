"""Port parity: non-local means (the plain version of kernel K3), the NLM
denoiser, and CSMRI + PnP-SVRG + NLM as a whole.

On the CPU the wrapper ``nlm_denoise`` takes its plain PyTorch version; K3
itself is held against that version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``. Inputs are made with numpy from a seed and go
through both packages; the tolerance for the denoiser is 1e-5 absolute (f32
sums in another order), and 0.05 dB for the loop's PSNR trace.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.denoisers.nlm import NLMDenoiser as JaxNLMDenoiser
from pnp_svrg_tpu.denoisers.nlm import nlm_denoise as jax_nlm_denoise
from pnp_svrg_tpu.ops.pallas.nlm_kernel import nlm_denoise_pallas
from pnp_svrg_tpu.problems import make_csmri as jax_make_csmri
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import csmri_from_numpy
from pnp_svrg_tpu_torch.denoisers import NLMDenoiser, nlm_denoise
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.utils.io import load_image
from test_golden_parity import nlm_oracle

TOL = 1e-5
H_LANES = np.asarray([0.05, 0.08, 0.12], np.float32)
S_LANES = np.asarray([0.05, 0.08, 0.0], np.float32)


def _images(shape, seed=0):
    """Smooth structure plus noise, in [0, 1]-ish, from a numpy seed."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    yy, xx = np.mgrid[:h, :w]
    clean = 0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 4.0)
    return (clean + 0.08 * rng.standard_normal(shape)).astype(np.float32)


def _max_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 48, 40)])
def test_plain_matches_jax_nlm_denoise(shape):
    x = _images(shape)
    want = jax_nlm_denoise(jnp.asarray(x), jnp.asarray(H_LANES), jnp.asarray(S_LANES))
    got = k3.nlm_denoise_plain(torch.tensor(x), torch.tensor(H_LANES), torch.tensor(S_LANES))
    assert got.shape == shape and got.dtype == torch.float32
    assert _max_err(got, want) <= TOL


def test_plain_matches_pallas_kernel_in_interpret_mode():
    x = _images((3, 32, 40), seed=1)
    want = nlm_denoise_pallas(jnp.asarray(x), jnp.asarray(H_LANES), jnp.asarray(S_LANES),
                              interpret=True)
    got = k3.nlm_denoise_plain(torch.tensor(x), torch.tensor(H_LANES), torch.tensor(S_LANES))
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("lane", range(3))
def test_plain_matches_per_pixel_oracle(lane):
    x = _images((3, 20, 24), seed=2)
    h, s = float(H_LANES[lane]), float(S_LANES[lane])
    want = nlm_oracle(x[lane].astype(np.float64), h, s)
    got = k3.nlm_denoise_plain(torch.tensor(x), torch.tensor(H_LANES), torch.tensor(S_LANES))
    assert _max_err(got[lane], want) <= TOL


def test_two_dimensional_input_and_scalar_parameters():
    x = _images((40, 32), seed=3)
    want = jax_nlm_denoise(jnp.asarray(x), 0.1, 0.06)
    got = nlm_denoise(torch.tensor(x), 0.1, 0.06)
    assert got.shape == (40, 32)
    assert _max_err(got, want) <= TOL
    batched = k3.nlm_denoise_plain(torch.tensor(x)[None], torch.tensor([0.1]), 0.06)
    torch.testing.assert_close(batched[0], got, atol=0, rtol=0)


@pytest.mark.parametrize("bounds", [(0, 40), (6, 30), (10, 11)])
def test_row_valid_bounds(bounds):
    x = _images((2, 40, 32), seed=4)
    h = np.asarray([0.08, 0.1], np.float32)
    want = jax_nlm_denoise(jnp.asarray(x), jnp.asarray(h), jnp.asarray(h),
                           row_valid_bounds=bounds)
    got = k3.nlm_denoise_plain(torch.tensor(x), torch.tensor(h), torch.tensor(h),
                               row_valid_bounds=bounds)
    assert _max_err(got, want) <= TOL


def test_h_zero_gives_nan_as_in_jax():
    x = _images((2, 32, 32), seed=5)
    h = np.asarray([0.0, 0.08], np.float32)
    want = np.asarray(jax_nlm_denoise(jnp.asarray(x), jnp.asarray(h), jnp.asarray(h)))
    got = k3.nlm_denoise_plain(torch.tensor(x), torch.tensor(h), torch.tensor(h)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all() and not np.isnan(got[1]).any()
    assert _max_err(got[1], want[1]) <= TOL


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    k3.nlm_denoise.launches = 0
    x = torch.tensor(_images((2, 32, 32), seed=6))
    got = nlm_denoise(x, torch.tensor([0.05, 0.1]), 0.05)
    torch.testing.assert_close(got, k3.nlm_denoise_plain(x, torch.tensor([0.05, 0.1]), 0.05),
                               atol=0, rtol=0)
    assert k3.nlm_denoise.launches == 0
    with pytest.raises(ValueError):
        nlm_denoise(x[None], 0.1, 0.1)  # (1, B, H, W): neither (H, W) nor (B, H, W)


@pytest.mark.parametrize("method", ["denoise", "denoise_bounded"])
def test_denoiser_sigma_contract_matches_jax(method):
    # Lane 1 has no estimate: h falls back to strength * decay**t, sigma to 0.
    x = _images((3, 32, 32), seed=7)
    est = np.asarray([0.06, 0.0, 0.09], np.float32)
    t = np.asarray([3, 5, 1], np.int32)
    mod = np.asarray([1.2, 1.45, 1.7], np.float32)
    jden = JaxNLMDenoiser(denoise_strength=0.1, sigma_modifier=jnp.asarray(mod), decay=0.9,
                          use_pallas=False)
    tden = NLMDenoiser(denoise_strength=0.1, sigma_modifier=torch.tensor(mod), decay=0.9)
    args = (jnp.asarray(x), jnp.asarray(est), jnp.asarray(t))
    targs = (torch.tensor(x), torch.tensor(est), torch.tensor(t))
    extra = ((4, 28),) if method == "denoise_bounded" else ()
    want = getattr(jden, method)(*args, *extra)
    got = getattr(tden, method)(*targs, *extra)
    assert _max_err(got, want) <= TOL
    assert tden.spatial_halo() == jden.spatial_halo() == 9


SIZE, N_OUTER, T2, MB = 48, 3, 3, 300
ETA = np.asarray([300.0, 400.0], np.float32)
MOD = np.asarray([1.2, 1.45], np.float32)


@pytest.fixture(scope="module")
def problems():
    """Two lanes of the CSMRI + NLM problem family at 48 px (13.png with the
    reference's uniform mask, and a Set12 image), built by the JAX package."""
    imgs = [load_image(p, SIZE, SIZE) for p in ("13.png", "Set12/07.png")]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jb = jax_stack_problems([
        jax_make_csmri(k, jnp.asarray(im), sample_prob=0.5, snr=10, keep_low_freq=kl)
        for k, im, kl in zip(keys, imgs, (0, 4))
    ])
    fields = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")
    tp = csmri_from_numpy({f: np.asarray(getattr(jb.problems, f)) for f in fields}, "cpu")
    return jb, tp


def _jax_masks(jb, key):
    """The batched JAX loop's minibatch masks: ``k, k_mb = split(k)`` per
    inner step, per lane ``fold_in(k_mb, lane)``."""
    k = key
    out = []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(jb.select_mb(k_mb, MB)))
    return np.stack(out).reshape((N_OUTER, T2) + out[0].shape)


@pytest.mark.parametrize("variant", ["svrg", "faithful"])
def test_csmri_nlm_loop_matches_jax(problems, variant):
    jb, tp = problems
    key = jax.random.PRNGKey(2)
    jden = JaxNLMDenoiser(sigma_modifier=jnp.asarray(MOD), use_pallas=False)
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2,
                        mini_batch_size=MB, key=key, variant=variant)
    masks = torch.tensor(_jax_masks(jb, key)) if variant == "svrg" else None
    got = pnp_svrg(tp, NLMDenoiser(sigma_modifier=torch.tensor(MOD)), torch.tensor(ETA),
                   N_OUTER, T2, MB, masks=masks, variant=variant)
    wt = np.asarray(want["psnr_per_iter"])
    gt = got["psnr_per_iter"].numpy()
    assert gt.shape == wt.shape == (1 + N_OUTER * (T2 + 1), 2)
    np.testing.assert_allclose(gt, wt, atol=0.05)
    assert np.abs(got["image"].numpy() - np.asarray(want["image"])).mean() < 1e-4
    assert np.all(gt[-1] > gt[0] + 0.5)  # the reconstruction improves on its start
