"""Port parity: phase retrieval (gradients, fidelity, the spectral
initialisation), ``sample_k_indices`` and the vector forms of the noise
helpers against the JAX package, on the CPU, and PR + BM3D end to end.

The JAX package's ``make_phase_retrieval`` builds the problems and the port
takes its fields as numpy arrays. Tolerances are stated at each comparison:
the products are f32 dot products of length N or M, summed in other orders
by XLA and by PyTorch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core import problem as jcp
from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.denoisers.bm3d import BM3DDenoiser as JaxBM3DDenoiser
from pnp_svrg_tpu.denoisers.bm3d import BM3DParams as JaxBM3DParams
from pnp_svrg_tpu.problems import pr as jpr
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import pr_from_numpy
from pnp_svrg_tpu_torch.core import problem as tcp
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.ops.sampling import sample_k_indices
from pnp_svrg_tpu_torch.problems import pr as tpr
from pnp_svrg_tpu_torch.utils.io import load_image

SIZE, NUM_MEAS = 32, 4096
FIELDS = ("a", "y", "x", "x_init", "snr", "sigma")


def _jax_problem(image="Set12/04.png", key=4):
    img = jnp.asarray(load_image(image, SIZE, SIZE))
    return jpr.make_phase_retrieval(jax.random.PRNGKey(key), img, num_meas=NUM_MEAS, snr=20)


def _port(jprob):
    return pr_from_numpy({f: np.asarray(getattr(jprob, f)) for f in FIELDS}, "cpu")


@pytest.fixture(scope="module")
def pair():
    jprob = _jax_problem()
    return jprob, _port(jprob)


def _close(got, want, what, rel=1e-5):
    # Dot products of length up to 4096 in f32: rounding relative to the
    # largest entry of the result.
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=rel,
                               atol=rel * np.abs(want).max(), err_msg=what)


def test_pr_gradients_fidelity_and_psnr_match_jax(pair):
    jprob, tp = pair
    rng = np.random.default_rng(0)
    z = rng.random((1, SIZE * SIZE)).astype(np.float32)
    idx = np.sort(rng.choice(NUM_MEAS, 500, replace=False)).astype(np.int32)
    zt, zj = torch.tensor(z), jnp.asarray(z[0])
    _close(tp.forward(zt)[0], jprob.forward(zj), "forward")
    _close(tp.grad_full(zt)[0], jprob.grad_full(zj), "grad_full")
    _close(tp.grad_stoch(zt, torch.tensor(idx)[None])[0], jprob.grad_stoch(zj, jnp.asarray(idx)),
           "grad_stoch on the same indices")
    np.testing.assert_allclose(tp.f(zt).numpy()[0], float(jprob.f(zj)), rtol=1e-5)
    np.testing.assert_allclose(tp.psnr(zt).numpy()[0], float(jprob.psnr(zj)), rtol=1e-6)
    # The full minibatch, normalised, is the full gradient.
    full = tp.grad_stoch(zt, tp.full_mb()) / tp.m_total()
    _close(full[0], jprob.grad_full(zj), "grad_stoch(full_mb) / M")
    assert tp.mb_shape(500) == (1, 500)


def test_gradients_are_nan_where_a_row_of_az_is_exactly_zero_as_in_jax(pair):
    # The amplitude weight (|t| - y) / |t| is 0/0 where a row's t = A z is
    # exactly 0 (one of the port's PR + SARAH CPU runs met such a row of its
    # 8192 at round 18). Row r of A holds 1 at pixels j and k, and z is +1
    # and -1 there and 0 elsewhere: t_r is exactly 0 in any summation order,
    # fused multiply-adds included.
    import dataclasses

    jprob, _ = pair
    r, j, k = 7, 3, 11
    a = np.array(jprob.a)
    a[r, j] = a[r, k] = 1.0
    jprob = dataclasses.replace(jprob, a=jnp.asarray(a))
    tp = _port(jprob)
    z = np.zeros((1, SIZE * SIZE), np.float32)
    z[0, j], z[0, k] = 1.0, -1.0
    zt, zj = torch.tensor(z), jnp.asarray(z[0])
    assert tp.forward(zt)[0, r] == 0 and float(jprob.forward(zj)[r]) == 0
    assert torch.isnan(tp.grad_full(zt)).all() and np.isnan(np.asarray(jprob.grad_full(zj))).all()
    idx = np.array([r - 1, r + 1, r + 2], np.int32)
    assert (tp.forward(zt)[0, idx] != 0).all()
    _close(tp.grad_stoch(zt, torch.tensor(idx)[None])[0], jprob.grad_stoch(zj, jnp.asarray(idx)),
           "grad_stoch without the zero row")


def test_spectral_init_matches_jax_on_the_same_a_and_y(pair):
    jprob, tp = pair
    x_norm = torch.linalg.vector_norm(tp.x.reshape(1, -1), dim=-1)
    xi, steps = tpr.spectral_init(tp.a, tp.y, x_norm)
    want = jpr.spectral_init(jprob.a, jprob.y, jnp.linalg.norm(jprob.x.ravel()))
    # The power iteration stops at a 1e-5 tolerance, so the two may stop one
    # step apart: compare the initialisations to 1e-4.
    _close(xi[0], want, "spectral init", rel=1e-4)
    _close(tcp.minmax_normalize(xi.reshape(1, SIZE, SIZE))[0], jprob.x_init, "x_init", rel=1e-4)
    assert 0 < int(steps[0]) < tpr.MAX_POWER_ITERS


def test_spectral_init_runs_each_lane_to_its_own_stop():
    a, b = _jax_problem(key=4), _jax_problem("13.png", key=5)
    tp = stack_problems([_port(a), _port(b)])
    x_norm = torch.linalg.vector_norm(tp.x.reshape(2, -1), dim=-1)
    xi, steps = tpr.spectral_init(tp.a, tp.y, x_norm)
    for lane, j in enumerate((a, b)):
        want = jpr.spectral_init(j.a, j.y, jnp.linalg.norm(j.x.ravel()))
        one, one_steps = tpr.spectral_init(tp.a[lane : lane + 1], tp.y[lane : lane + 1], x_norm[lane : lane + 1])
        # A lane stops where it would alone, and waits unchanged after.
        assert int(one_steps[0]) == int(steps[lane])
        assert torch.equal(one[0], xi[lane])
        _close(xi[lane], want, f"lane {lane}", rel=1e-4)


def test_make_phase_retrieval_on_the_cpu():
    img = load_image("Set12/04.png", SIZE, SIZE)
    stats = {}
    gen = torch.Generator().manual_seed(0)
    tp = tpr.make_phase_retrieval(img, gen, NUM_MEAS, snr=20, device="cpu", stats=stats)
    assert tp.a.shape == (1, NUM_MEAS, SIZE * SIZE) and tp.y.shape == (1, NUM_MEAS)
    assert float(tp.x_init.min()) == 0.0 and float(tp.x_init.max()) == 1.0
    assert 0 < stats["spectral_init_steps"] < tpr.MAX_POWER_ITERS and stats["spectral_init_s"] > 0
    # sigma from the noiseless magnitudes, by the reference's formula.
    y0 = tp.forward(tp.x)
    want = jcp.snr_to_sigma(20.0, jnp.asarray(y0.numpy()[0]), SIZE, SIZE)
    np.testing.assert_allclose(tp.sigma.numpy()[0], float(want), rtol=1e-6)
    noise = (tp.y - y0) / tp.sigma
    assert abs(float(noise.std()) - 1.0) < 0.1  # a draw of M standard normals
    # The spectral init correlates with the truth (up to the global sign
    # ambiguity of |Ax|, resolved by its min-max normalisation).
    c = np.corrcoef(tp.x_init.numpy().ravel(), img.ravel())[0, 1]
    assert abs(c) > 0.3, c
    with pytest.raises(ValueError):
        tpr.make_phase_retrieval(img, gen, 64, snr=20, sigma=0.1, device="cpu")


def test_vector_noise_helpers_reduce_per_lane():
    rng = np.random.default_rng(1)
    y0 = rng.random((3, 500)).astype(np.float32) * 10
    snr, sig = tcp.resolve_noise(torch.tensor(y0), 16, 16, 20.0, None, ndim=1)
    want = [float(jcp.snr_to_sigma(20.0, jnp.asarray(v), 16, 16)) for v in y0]
    np.testing.assert_allclose(sig.numpy(), want, rtol=1e-6)
    assert snr.shape == (3,) and torch.all(snr == 20.0)
    snr2, sig2 = tcp.resolve_noise(torch.tensor(y0), 16, 16, None, 0.3, ndim=1)
    want = [float(jcp.sigma_to_snr(jnp.asarray(0.3), jnp.asarray(v), 16, 16)) for v in y0]
    np.testing.assert_allclose(snr2.numpy(), want, rtol=1e-6)
    x = rng.random((3, 40)).astype(np.float32)
    np.testing.assert_allclose(tcp.minmax_normalize(torch.tensor(x), ndim=1).numpy(),
                               np.stack([np.asarray(jcp.minmax_normalize(jnp.asarray(v))) for v in x]),
                               rtol=1e-6)


@pytest.mark.parametrize("allowed_share", [1.0, 0.25])
def test_sample_k_indices_exact_distinct_and_allowed(allowed_share):
    gen = torch.Generator().manual_seed(2)
    m, k = 1000, 200
    allowed = (torch.rand((4, m), generator=torch.Generator().manual_seed(9)) < allowed_share).float()
    idx = sample_k_indices((4, m), k, gen, allowed=None if allowed_share == 1.0 else allowed)
    assert idx.shape == (4, k) and idx.dtype == torch.int64
    for lane in idx:
        assert len(set(lane.tolist())) == k and 0 <= int(lane.min()) and int(lane.max()) < m
    if allowed_share < 1.0:
        assert torch.all(allowed.gather(1, idx) == 1.0)
    assert not torch.equal(idx[0].sort().values, idx[1].sort().values)  # lanes draw their own


# End to end: two PR lanes (two images, each with its own A), PnP-SVRG + BM3D.
N_OUTER, T2, MB = 2, 3, 400
ETA = np.asarray([0.2, 0.15], np.float32)


@pytest.fixture(scope="module")
def lanes():
    probs = [_jax_problem(key=4), _jax_problem("13.png", key=5)]
    return jax_stack_problems(probs), stack_problems([_port(p) for p in probs])


def _denoisers():
    return (JaxBM3DDenoiser(sigma_modifier=1.0, params=JaxBM3DParams(search=4)),
            BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=4)))


def _compare(want, got):
    wt, gt = np.asarray(want["psnr_per_iter"]), got["psnr_per_iter"].numpy()
    assert gt.shape == wt.shape == (1 + N_OUTER * (T2 + 1), 2)
    np.testing.assert_allclose(gt, wt, atol=0.05)  # dB, the slice's trace tolerance
    assert np.all(gt[-1] > gt[0] + 0.5)  # the reconstruction improves on the spectral init


def test_faithful_pr_bm3d_end_to_end(lanes):
    jb, tp = lanes
    jden, tden = _denoisers()
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2, mini_batch_size=MB,
                        key=jax.random.PRNGKey(1), variant="faithful")
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, variant="faithful")
    _compare(want, got)


def test_svrg_pr_bm3d_on_injected_jax_indices(lanes):
    jb, tp = lanes
    jden, tden = _denoisers()
    key = jax.random.PRNGKey(7)
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2, mini_batch_size=MB,
                        key=key, lr_decay=0.985)
    # pnp_svrg's chain: k, k_mb = split(k) per inner step; per lane fold_in.
    k, idx = key, []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        idx.append(np.asarray(jb.select_mb(k_mb, MB)))
    idx = torch.tensor(np.stack(idx).reshape((N_OUTER, T2) + idx[0].shape))
    assert idx.shape[2:] == tp.mb_shape(MB)
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, masks=idx, lr_decay=0.985)
    _compare(want, got)
    gen = torch.Generator().manual_seed(0)  # and on the port's own generator
    own = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, generator=gen, lr_decay=0.985)
    assert np.isfinite(own["psnr_per_iter"].numpy()).all()
