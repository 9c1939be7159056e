"""Port parity for the slice as a whole: PnP-SVRG + BM3D on batched CSMRI.

The JAX ``pnp_svrg`` (on the CPU) and the port's (``device="cpu"``, plain
kernel versions) run on the same problems. ``variant="faithful"`` draws no
minibatch, so it is compared end to end; for ``variant="svrg"`` the test
replays JAX's key chain to get its minibatch masks and hands them to the
port through ``masks=``.
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
from pnp_svrg_tpu.problems import make_csmri as jax_make_csmri
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import csmri_from_numpy
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.utils.io import load_image

SIZE, N_OUTER, T2, MB = 32, 3, 3, 120
ETA = np.asarray([200.0, 150.0], np.float32)  # per-lane step sizes
MOD = np.asarray([1.0, 1.2], np.float32)


@pytest.fixture(scope="module")
def problems():
    imgs = [load_image(p, SIZE, SIZE) for p in ("Set12/05.png", "13.png")]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jb = jax_stack_problems([
        jax_make_csmri(k, jnp.asarray(im), sample_prob=0.5, snr=10, keep_low_freq=4)
        for k, im in zip(keys, imgs)
    ])
    fields = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")
    tp = csmri_from_numpy({f: np.asarray(getattr(jb.problems, f)) for f in fields}, "cpu")
    return jb, tp


def _denoisers(mod=MOD):
    return (
        JaxBM3DDenoiser(sigma_modifier=jnp.asarray(mod), params=JaxBM3DParams(search=4)),
        BM3DDenoiser(sigma_modifier=torch.tensor(mod), params=BM3DParams(search=4)),
    )


def _jax_masks(jb, key):
    """pnp_svrg's minibatch masks: ``k, k_mb = split(k)`` per inner step,
    carried across outer steps; per lane ``fold_in(k_mb, lane)``."""
    k = key
    out = []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(jb.select_mb(k_mb, MB)))
    return np.stack(out).reshape((N_OUTER, T2) + out[0].shape)


def _compare(want, got):
    wt = np.asarray(want["psnr_per_iter"])
    gt = got["psnr_per_iter"].numpy()
    assert gt.shape == wt.shape == (1 + N_OUTER * (T2 + 1), 2)
    np.testing.assert_allclose(gt, wt, atol=0.05)
    diff = np.abs(got["image"].numpy() - np.asarray(want["image"])).mean()
    assert diff < 1e-3, diff
    # The reconstruction actually improves on the zero-filled start.
    assert np.all(gt[-1] > gt[0] + 0.5)


def test_faithful_variant_end_to_end(problems):
    jb, tp = problems
    jden, tden = _denoisers()
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2,
                        mini_batch_size=MB, key=jax.random.PRNGKey(1), variant="faithful")
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, variant="faithful")
    _compare(want, got)
    assert got["psnr_before_denoise"].shape == got["sigma_est"].shape == (N_OUTER, T2, 2)
    assert torch.all(got["sigma_est"] > 0)


def test_svrg_variant_with_injected_jax_masks(problems):
    jb, tp = problems
    jden, tden = _denoisers()
    key = jax.random.PRNGKey(7)
    want = jax_pnp_svrg(jb, jden, eta=jnp.asarray(ETA), n_outer=N_OUTER, t2=T2,
                        mini_batch_size=MB, key=key, lr_decay=0.9)
    masks = torch.tensor(_jax_masks(jb, key))
    got = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, masks=masks, lr_decay=0.9)
    _compare(want, got)


def test_svrg_variant_on_the_port_generator(problems):
    _, tp = problems
    _, tden = _denoisers()
    gen = torch.Generator().manual_seed(0)
    out = pnp_svrg(tp, tden, torch.tensor(ETA), N_OUTER, T2, MB, generator=gen)
    tr = out["psnr_per_iter"].numpy()
    assert np.isfinite(tr).all() and np.all(tr[-1] > tr[0] + 0.5)
    with pytest.raises(ValueError):
        pnp_svrg(tp, tden, 1.0, N_OUTER, T2, MB)  # svrg needs a generator or masks
    with pytest.raises(ValueError):
        pnp_svrg(tp, tden, 1.0, N_OUTER, T2, MB, masks=torch.zeros((1, 1, 2, SIZE, SIZE)))


def test_diverge_latch_freezes_a_lane_with_huge_eta(problems):
    jb, tp = problems
    eta = np.asarray([200.0, 1e9], np.float32)
    jden, tden = _denoisers()
    want = np.asarray(jax_pnp_svrg(
        jb, jden, eta=jnp.asarray(eta), n_outer=N_OUTER, t2=T2, mini_batch_size=MB,
        key=jax.random.PRNGKey(1), variant="faithful", diverge_check=True,
    )["psnr_per_iter"])
    got = pnp_svrg(tp, tden, torch.tensor(eta), N_OUTER, T2, MB, variant="faithful",
                   diverge_check=True)["psnr_per_iter"].numpy()
    # Lane 1 goes negative on its first step, then every later entry repeats
    # the frozen state's PSNR; lane 0 is untouched by its neighbour.
    for tr in (got[:, 1], want[:, 1]):
        assert tr[2] < 0 and np.all(tr[2:] == tr[2])
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=0.05)
    np.testing.assert_allclose(got[2, 1], want[2, 1], rtol=1e-3)
