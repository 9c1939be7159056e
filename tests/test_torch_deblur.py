"""Port parity: the Deblur/SR problem and its operators against the JAX
package, on the CPU, and the slice's Deblur + BM3D loop end to end.

Inputs are made with numpy from a seed (or by the JAX package's
``make_deblur``) and handed to both sides. Tolerances are stated at each
comparison; they are f32 rounding of sums taken in other orders (FFTs, the
4-point gather and the scatter-add).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.denoisers.bm3d import BM3DDenoiser as JaxBM3DDenoiser
from pnp_svrg_tpu.denoisers.bm3d import BM3DParams as JaxBM3DParams
from pnp_svrg_tpu.ops import fourier as jf
from pnp_svrg_tpu.ops import resize as jr
from pnp_svrg_tpu.problems import deblur as jd
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import deblur_from_numpy
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.ops import fourier as tf
from pnp_svrg_tpu_torch.ops import resize as tr
from pnp_svrg_tpu_torch.ops.sampling import sample_k_mask
from pnp_svrg_tpu_torch.problems import deblur as td
from pnp_svrg_tpu_torch.utils.io import load_image, resolve_data_path

SIZE = 32
FIELDS = ("y", "b", "b_adj", "x", "x_init", "ds_idx", "ds_w", "allowed", "snr", "sigma")


def _jax_problem(kernel="Minimal", scale=100, snr=20.0, image="Set12/01.png", key=0):
    img = jnp.asarray(load_image(image, SIZE, SIZE))
    if kernel.endswith(".png"):
        kernel = str(resolve_data_path(kernel))
    return jd.make_deblur(jax.random.PRNGKey(key), img, kernel=kernel, scale_percent=scale, snr=snr)


def _port(jprob):
    return deblur_from_numpy({f: np.asarray(getattr(jprob, f)) for f in FIELDS}, "cpu")


@pytest.fixture(scope="module", params=[("Minimal", 100), ("kernel25.png", 50)], ids=["minimal", "sr"])
def pair(request):
    jprob = _jax_problem(*request.param)
    return jprob, _port(jprob)


def test_fft_blur_1d_and_its_adjoint_kernel_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 900)).astype(np.float32)
    b = rng.random((3, 900)).astype(np.float32) / 900
    got = tf.fft_blur_1d(torch.tensor(a), torch.tensor(b))
    want = np.stack([np.asarray(jf.fft_blur_1d(jnp.asarray(x), jnp.asarray(k))) for x, k in zip(a, b)])
    # Products of FFTs of length 900 in f32: rounding relative to the
    # largest output, hence the atol.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    adj = tf.fft_blur_1d_adjoint_kernel(torch.tensor(b))
    want_adj = np.stack([np.asarray(jf.fft_blur_1d_adjoint_kernel(jnp.asarray(k))) for k in b])
    np.testing.assert_array_equal(adj.numpy(), want_adj)  # a permutation: exact
    # <blur(x), y> = <x, blur_adj(y)>
    y = rng.standard_normal((3, 900)).astype(np.float32)
    lhs = (got * torch.tensor(y)).sum(-1)
    rhs = (torch.tensor(a) * tf.fft_blur_1d(torch.tensor(y), adj)).sum(-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4)


@pytest.mark.parametrize("shape", [(32, 32, 16, 16), (32, 32, 32, 32), (24, 40, 12, 20), (256, 256, 128, 128)])
def test_bilinear_gather_params_are_bit_identical(shape):
    idx, wts = tr.bilinear_gather_params(*shape)
    jidx, jwts = jr.bilinear_gather_params(*shape)
    assert idx.dtype == np.int32 and wts.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(wts, np.asarray(jwts))


@pytest.mark.parametrize("shape", [(32, 32, 16, 16), (24, 40, 12, 20)])
def test_bilinear_apply_and_adjoint_match_jax(shape):
    h, w, lh, lw = shape
    idx, wts = tr.bilinear_gather_params(*shape)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((2, h * w)).astype(np.float32)
    r = rng.standard_normal((2, lh * lw)).astype(np.float32)
    ti, tw = torch.tensor(idx, dtype=torch.int64), torch.tensor(wts)
    fwd = tr.bilinear_apply(torch.tensor(v), ti, tw)
    adj = tr.bilinear_adjoint(torch.tensor(r), ti, tw, h * w)
    for lane in range(2):
        # Four products summed (gather) or up to ~8 added into a pixel
        # (scatter): f32 rounding of order-1 values.
        np.testing.assert_allclose(fwd[lane].numpy(), np.asarray(jr.bilinear_apply(v[lane], idx, wts)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(adj[lane].numpy(),
                                   np.asarray(jr.bilinear_adjoint(r[lane], idx, wts, h * w)),
                                   rtol=1e-6, atol=1e-6)
    # Adjointness: <S v, r> = <v, S^T r>, to f32 rounding of the two sums.
    np.testing.assert_allclose((fwd * torch.tensor(r)).sum(-1).numpy(),
                               (torch.tensor(v) * adj).sum(-1).numpy(), rtol=1e-5)


# The existing shapes, one where up to 4 terms meet in a pixel (30 -> 17)
# and the identity (scale_percent 100: a pixel's own residual and three
# zero-weight terms).
ADJOINT_SHAPES = [(32, 32, 16, 16), (24, 40, 12, 20), (30, 30, 17, 17), (32, 32, 32, 32)]


@pytest.mark.parametrize("shape", ADJOINT_SHAPES)
def test_bilinear_adjoint_is_bitwise_the_jax_scatter_add(shape):
    # The table lists each pixel's (sample, corner) terms in ascending
    # flattened order, the order in which XLA's CPU scatter adds them, and
    # the adjoint adds them one column at a time from zero: the same bits.
    h, w, lh, lw = shape
    idx, wts = tr.bilinear_gather_params(*shape)
    table = tr.bilinear_adjoint_table(idx, h * w)
    flat = idx.reshape(-1)
    pad = flat.size
    for pix, row in enumerate(table):
        pos = row[row != pad]
        assert (np.diff(pos) > 0).all() and (flat[pos] == pix).all()
    assert np.array_equal(np.sort(table[table != pad]), np.arange(pad))
    r = np.random.default_rng(6).standard_normal((2, lh * lw)).astype(np.float32)
    ti, tw = torch.tensor(idx, dtype=torch.int64), torch.tensor(wts)
    adj = tr.bilinear_adjoint(torch.tensor(r), ti, tw, h * w, torch.tensor(table))
    for lane in range(2):
        np.testing.assert_array_equal(adj[lane].numpy(),
                                      np.asarray(jr.bilinear_adjoint(r[lane], idx, wts, h * w)))
    if (lh, lw) == (h, w):
        np.testing.assert_array_equal(adj.numpy(), r)


def test_deblur_gradients_fidelity_and_psnr_match_jax(pair):
    jprob, tp = pair
    rng = np.random.default_rng(2)
    z = rng.random((1, SIZE * SIZE)).astype(np.float32)
    mb = np.zeros(tp.m, np.float32)
    mb[rng.choice(tp.m, tp.m // 3, replace=False)] = 1.0
    zt = torch.tensor(z)

    def close(got, want, what):
        # FFT products and the scatter-add in f32: relative to the largest
        # entry of the result.
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=what)

    close(tp.forward(zt)[0], jprob.forward(jnp.asarray(z[0])), "forward")
    close(tp.grad_full(zt)[0], jprob.grad_full(jnp.asarray(z[0])), "grad_full")
    close(tp.grad_stoch(zt, torch.tensor(mb)[None])[0],
          jprob.grad_stoch(jnp.asarray(z[0]), jnp.asarray(mb)), "grad_stoch")
    np.testing.assert_allclose(tp.f(zt).numpy()[0], float(jprob.f(jnp.asarray(z[0]))), rtol=1e-5)
    np.testing.assert_allclose(tp.psnr(zt).numpy()[0], float(jprob.psnr(jnp.asarray(z[0]))), rtol=1e-6)
    # grad_stoch over every owned measurement, normalised, is grad_full.
    full = tp.grad_stoch(zt, tp.full_mb()) / tp.m_total()[:, None]
    np.testing.assert_allclose(full.numpy(), tp.grad_full(zt).numpy(), rtol=1e-5,
                               atol=1e-6 * float(tp.grad_full(zt).abs().max()))
    assert tp.mb_shape(100) == (1, tp.m)


@pytest.mark.parametrize("kernel,scale", [("Minimal", 100), ("kernel25.png", 50), ("Identity", 50)])
def test_make_deblur_matches_jax_but_for_the_random_draws(kernel, scale):
    jprob = _jax_problem(kernel, scale, snr=5.0)
    gen = torch.Generator().manual_seed(0)
    img = load_image("Set12/01.png", SIZE, SIZE)
    tp = td.make_deblur(img, gen, kernel=kernel if kernel[0].isupper() else str(resolve_data_path(kernel)),
                        scale_percent=scale, snr=5.0, device="cpu")
    np.testing.assert_array_equal(tp.b[0].numpy(), np.asarray(jprob.b))
    np.testing.assert_array_equal(tp.b_adj[0].numpy(), np.asarray(jprob.b_adj))
    np.testing.assert_array_equal(tp.ds_idx.numpy(), np.asarray(jprob.ds_idx))
    np.testing.assert_array_equal(tp.ds_w.numpy(), np.asarray(jprob.ds_w))
    assert tp.y.shape == (1, jprob.lr_h * jprob.lr_w) and tp.x_init.shape == (1, SIZE, SIZE)
    # sigma depends on the noiseless measurements only: same as JAX.
    np.testing.assert_allclose(tp.sigma.numpy()[0], float(jprob.sigma), rtol=1e-5)
    np.testing.assert_allclose(tp.snr.numpy()[0], 5.0)
    noise = (tp.y - tp.forward(tp.x)) / tp.sigma[:, None]
    assert abs(float(noise.std()) - 1.0) < 0.15  # a draw of M standard normals
    assert 0.0 <= float(tp.x_init.min()) and float(tp.x_init.max()) < 1.0
    with pytest.raises(ValueError):
        td.make_deblur(img, gen, kernel="nope", device="cpu")


def test_port_load_kernel_image_matches_jax():
    path = str(resolve_data_path("kernel25.png"))
    np.testing.assert_array_equal(td.load_kernel_image(path, 40, 48), jd.load_kernel_image(path, 40, 48))
    np.testing.assert_array_equal(td.load_kernel_image("kernel25.png", 40, 48),
                                  jd.load_kernel_image(path, 40, 48))


def test_sample_k_mask_over_vectors():
    gen = torch.Generator().manual_seed(3)
    allowed = torch.zeros(3, 200)
    allowed[:, ::2] = 1.0
    mask = sample_k_mask((3, 200), 40, gen, allowed=allowed, ndim=1)
    assert mask.shape == (3, 200)
    assert torch.all(mask.sum(-1) == 40) and torch.all(mask <= allowed)
    assert not torch.equal(mask[0], mask[1])  # each lane draws its own


def test_stack_problems_keeps_the_shared_gather_once():
    a, b = (_port(_jax_problem("Minimal", 50, key=k)) for k in (0, 1))
    st = stack_problems([a, b])
    assert st.batch_size == 2 and st.y.shape == (2, a.m) and st.ds_idx.shape == (a.m, 4)
    torch.testing.assert_close(st.grad_full(torch.cat([a.x_init, b.x_init])),
                               torch.cat([a.grad_full(a.x_init), b.grad_full(b.x_init)]))
    other = _port(_jax_problem("Minimal", 100))
    with pytest.raises(Exception):
        stack_problems([a, other])  # different sizes


# End to end: two lanes (two images, the Minimal kernel at 50 % scale), each
# with its own step size.
N_OUTER, T2, MB = 2, 3, 200


@pytest.fixture(scope="module")
def lanes():
    probs = [_jax_problem("Minimal", 50, snr=20.0, key=0), _jax_problem("Minimal", 50, snr=20.0,
                                                                      image="13.png", key=1)]
    jb = jax_stack_problems(probs)
    tp = stack_problems([_port(p) for p in probs])
    return jb, tp


ETA = np.asarray([4e5, 3e5], np.float32)


def _denoisers():
    return (JaxBM3DDenoiser(sigma_modifier=1.5, params=JaxBM3DParams(search=4)),
            BM3DDenoiser(sigma_modifier=1.5, params=BM3DParams(search=4)))


def _compare(want, got):
    wt, gt = np.asarray(want["psnr_per_iter"]), got["psnr_per_iter"].numpy()
    assert gt.shape == wt.shape == (1 + N_OUTER * (T2 + 1), 2)
    np.testing.assert_allclose(gt, wt, atol=0.05)  # dB, the slice's trace tolerance
    assert np.all(gt[-1] > gt[0] + 1.0)  # the reconstruction improves on the random start


def test_faithful_deblur_bm3d_end_to_end(lanes):
    jb, tp = lanes
    jden, tden = _denoisers()
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2, mini_batch_size=MB,
                        key=jax.random.PRNGKey(1), variant="faithful")
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, variant="faithful")
    _compare(want, got)


def test_svrg_deblur_bm3d_on_injected_jax_masks(lanes):
    jb, tp = lanes
    jden, tden = _denoisers()
    key = jax.random.PRNGKey(7)
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2, mini_batch_size=MB,
                        key=key, lr_decay=0.9)
    # pnp_svrg's chain: k, k_mb = split(k) per inner step; per lane fold_in.
    k, masks = key, []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        masks.append(np.asarray(jb.select_mb(k_mb, MB)))
    masks = torch.tensor(np.stack(masks).reshape((N_OUTER, T2) + masks[0].shape))
    assert masks.shape[2:] == tp.mb_shape(MB)
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, masks=masks, lr_decay=0.9)
    _compare(want, got)
    with pytest.raises(ValueError):
        pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, masks=masks[..., :-1])
