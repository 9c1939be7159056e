"""Port parity: the CSMRI problem (gradients, fidelity, PSNR) and make_csmri."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.core.problem import snr_to_sigma as jax_snr_to_sigma
from pnp_svrg_tpu.problems import make_csmri as jax_make_csmri
from pnp_svrg_tpu_torch.convert import csmri_from_numpy, lane_params
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.core.problem import snr_to_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.utils.io import load_image

SIZE = 32


def _jax_batch():
    imgs = [load_image(p, SIZE, SIZE) for p in ("13.png", "Set12/02.png", "Set12/07.png")]
    keys = jax.random.split(jax.random.PRNGKey(3), len(imgs))
    probs = [
        jax_make_csmri(k, jnp.asarray(im), sample_prob=0.5, snr=10, keep_low_freq=kl)
        for k, im, kl in zip(keys, imgs, (0, 4, 4))
    ]
    return jax_stack_problems(probs)


@pytest.fixture(scope="module")
def pair():
    jb = _jax_batch()
    fields = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")
    arrays = {f: np.asarray(getattr(jb.problems, f)) for f in fields}
    return jb, csmri_from_numpy(arrays, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conversion_keeps_fields(pair):
    jb, tp = pair
    assert tp.batch_size == 3 and (tp.h, tp.w) == (SIZE, SIZE)
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jb.problems.y))
    np.testing.assert_array_equal(tp.m0.numpy(), np.asarray(jb.problems.m0))


def test_grad_full_f_and_psnr_match_jax(pair, rng):
    jb, tp = pair
    z = rng.uniform(size=(3, SIZE * SIZE)).astype(np.float32)
    _close(tp.grad_full(torch.tensor(z)), jb.grad_full(jnp.asarray(z)))
    # f is a sum of ~1e3 squares of order 1e-1..1e1: f32 rounding, relative.
    np.testing.assert_allclose(
        tp.f(torch.tensor(z)).numpy(), np.asarray(jb.f(jnp.asarray(z))), rtol=1e-6
    )
    np.testing.assert_allclose(
        tp.psnr(torch.tensor(z)).numpy(), np.asarray(jb.psnr(jnp.asarray(z))), atol=1e-5
    )


def test_grad_stoch_same_minibatch_matches_jax(pair, rng):
    jb, tp = pair
    z = rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32)
    mb = np.asarray(jb.select_mb(jax.random.PRNGKey(9), 200))
    assert np.all(mb.sum(axis=(1, 2)) == 200)
    _close(
        tp.grad_stoch(torch.tensor(z), torch.tensor(mb)),
        jb.grad_stoch(jnp.asarray(z), jnp.asarray(mb)),
    )


def test_full_minibatch_gradient_is_grad_full(pair, rng):
    _, tp = pair
    z = torch.tensor(rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32))
    g = tp.grad_stoch(z, tp.full_mb()) / tp.m_total()[:, None, None]
    torch.testing.assert_close(g, tp.grad_full(z), atol=1e-6, rtol=1e-5)


def test_port_select_mb_draws_k_sampled_locations(pair):
    _, tp = pair
    mb = tp.select_mb(torch.Generator().manual_seed(1), 150)
    assert torch.all(mb.sum(dim=(-2, -1)) == 150)
    assert torch.all(mb <= tp.mask)


def test_make_csmri_density_low_freq_block_and_sigma():
    img = load_image("Set12/04.png", 64, 64)
    gen = torch.Generator().manual_seed(0)
    probs = [make_csmri(img, gen, sample_prob=0.5, snr=10, keep_low_freq=4, device="cpu")
             for _ in range(4)]
    tp = stack_problems(probs)
    assert tp.y.shape == (4, 64, 64) and tp.y.dtype == torch.complex64
    density = float(tp.mask.mean())
    assert abs(density - 0.5) < 0.02, density
    low = np.r_[0:4, 61:64]
    assert torch.all(tp.mask[:, low[:, None], low[None, :]] == 1)
    # snr_to_sigma equals JAX's on the same y0 (the unsquared-norm formula).
    y0 = (tp.mask * torch.fft.fft2(tp.x)).numpy()
    want = [float(jax_snr_to_sigma(10.0, jnp.asarray(y), 64, 64)) for y in y0]
    np.testing.assert_allclose(snr_to_sigma(10.0, torch.tensor(y0), 64, 64).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tp.sigma.numpy(), want, rtol=1e-6)
    # x_init is the min-max-normalised zero-filled reconstruction.
    assert torch.allclose(tp.x_init.amin(dim=(-2, -1)), torch.zeros(4))
    assert torch.allclose(tp.x_init.amax(dim=(-2, -1)), torch.ones(4))


def test_make_csmri_needs_the_generator_on_its_device():
    img = load_image("Set12/04.png", 32, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no device="cpu": CUDA or nothing
            make_csmri(img, torch.Generator(), snr=10)
    else:
        with pytest.raises(ValueError):
            make_csmri(img, torch.Generator(), snr=10)


def test_lane_params_by_name():
    tuned = {"lanes": ["a.png", "b.png"], "eta": [1.0, 2.0], "sigma_modifier": [3.0, 4.0]}
    eta, mod = lane_params(tuned, ["b.png", "c.png"], 9.0, 8.0, device="cpu")
    assert eta.tolist() == [2.0, 9.0] and mod.tolist() == [4.0, 8.0]
