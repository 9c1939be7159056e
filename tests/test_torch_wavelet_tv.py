"""Port parity: the wavelet transforms, BayesShrink denoising and the
wavelet ("TV") denoiser against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: the two sides sum the same few filter taps per level in other
orders (XLA convolutions against slice sums), so they agree to f32
rounding: ``rtol=1e-5`` with ``atol=1e-6`` for values of order 1 that may
cancel to near zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.denoisers.tv import TVDenoiser as JaxTVDenoiser
from pnp_svrg_tpu.ops import wavelet as jw
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.ops import wavelet as tw

RTOL, ATOL = 1e-5, 1e-6
WAVELETS = ("db1", "db2", "db4")
SHAPES = [(2, 32, 32), (2, 33, 47), (1, 64, 61)]  # even, odd and mixed sizes
# One XLA compilation per call shape instead of one per eager op.
jax_idwt2 = jax.jit(jw.idwt2, static_argnums=(2, 3))
jax_wavedec2 = jax.jit(jw.wavedec2, static_argnums=(1, 2))
jax_waverec2 = jax.jit(jw.waverec2, static_argnums=(1, 2))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _image(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 31, 32, 64, 256])
def test_dwt_max_level(wavelet, n):
    assert tw.dwt_max_level(n, wavelet) == jw.dwt_max_level(n, wavelet)


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_idwt2_inverts_dwt2_like_jax(wavelet, shape):
    x = _image(shape)
    ca, det = jax.jit(jw.dwt2, static_argnums=1)(jnp.asarray(x), wavelet)
    want = jax_idwt2(ca, det, wavelet, shape[-2:])
    got = tw.idwt2(torch.tensor(np.asarray(ca)), tuple(torch.tensor(np.asarray(d)) for d in det),
                   wavelet, shape[-2:])
    _close(got, want)
    _close(got, x)  # perfect reconstruction


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wavedec2_and_waverec2_match_jax(wavelet, shape):
    x = _image(shape, 1)
    levels = max(jw.dwt_max_level(min(shape[-2:]), wavelet), 1)
    want = jax_wavedec2(jnp.asarray(x), wavelet, levels)
    got = tw.wavedec2(torch.tensor(x), wavelet, levels)
    assert len(got) == len(want) == levels + 1
    _close(got[0], want[0])
    for gd, wd in zip(got[1:], want[1:]):
        for g, w in zip(gd, wd):
            assert tuple(g.shape) == w.shape
            _close(g, w)
    # The odd intermediate shapes are re-derived from out_shape alone.
    _close(tw.waverec2(got, wavelet, shape[-2:]), jax_waverec2(want, wavelet, shape[-2:]))
    _close(tw.waverec2(got, wavelet, shape[-2:]), x)


def test_soft_threshold_and_bayes_threshold_match_jax():
    d = (_image((3, 16, 17), 2) - 0.5).astype(np.float32)
    var = np.asarray([0.001, 0.05, 1.0], np.float32).reshape(3, 1, 1)  # last: E[d^2] < var, eps branch
    t = tw._bayes_threshold(torch.tensor(d), torch.tensor(var))
    _close(t, jw._bayes_threshold(jnp.asarray(d), jnp.asarray(var)))
    _close(tw.soft_threshold(torch.tensor(d), t), jw.soft_threshold(jnp.asarray(d), np.asarray(t.numpy())))


@pytest.mark.parametrize("wavelet", WAVELETS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("per_lane", [False, True], ids=["scalar_sigma", "lane_sigma"])
def test_denoise_wavelet_bayes_matches_jax(wavelet, shape, per_lane):
    rng = np.random.default_rng(3)
    x = (_image(shape, 4) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    sigma = (0.05 + 0.1 * rng.random(shape[0])).astype(np.float32) if per_lane else np.float32(0.1)
    want = jw.denoise_wavelet_bayes(jnp.asarray(x), jnp.asarray(sigma), wavelet=wavelet)
    got = tw.denoise_wavelet_bayes(torch.tensor(x), torch.tensor(sigma), wavelet=wavelet)
    _close(got, want)


@pytest.mark.parametrize("wavelet", WAVELETS)
def test_tv_denoiser_matches_jax_with_the_sigma_fallback(wavelet):
    rng = np.random.default_rng(5)
    x = (_image((3, 40, 40), 6) + 0.1 * rng.standard_normal((3, 40, 40))).astype(np.float32)
    est = np.asarray([0.08, 0.0, 0.12], np.float32)  # lane 1 falls back to strength * decay**t
    t = np.asarray([1, 3, 2], np.int32)
    kw = {"denoise_strength": 0.2, "sigma_modifier": 1.3, "decay": 0.9, "wavelet": wavelet}
    want = JaxTVDenoiser(**kw).denoise(jnp.asarray(x), jnp.asarray(est), jnp.asarray(t))
    den = TVDenoiser(**kw)
    got = den.denoise(torch.tensor(x), torch.tensor(est), torch.tensor(t))
    _close(got, want)
    sig = den.effective_sigma(torch.tensor(est), torch.tensor(t)).numpy()
    np.testing.assert_allclose(sig, [0.08 * 1.3, 0.2 * 0.9**3, 0.12 * 1.3], rtol=1e-6)
    # Per-lane (B,) modifiers, as a tuner's grid passes them.
    mods = np.asarray([0.5, 1.0, 2.0], np.float32)
    est2 = est + 0.05
    want = JaxTVDenoiser(sigma_modifier=jnp.asarray(mods), wavelet=wavelet).denoise(
        jnp.asarray(x), jnp.asarray(est2), jnp.asarray(t))
    got = TVDenoiser(sigma_modifier=torch.tensor(mods), wavelet=wavelet).denoise(
        torch.tensor(x), torch.tensor(est2), torch.tensor(t))
    _close(got, want)
