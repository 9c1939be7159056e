"""Port parity of the PnP loops: PnP-SVRG + BM3D on batched CSMRI, and the
other four loops on CSMRI + the wavelet "TV" denoiser and on a 32-px phase
retrieval (M = 512, two replicas of one A) + SimpleCNN.

The JAX loops (on the CPU) and the port's (``device="cpu"``, plain kernel
versions) run on the same problems. ``pnp_gd`` and
``pnp_svrg(variant="faithful")`` draw no minibatch, so they are compared end
to end; for the stochastic loops the test replays JAX's key chain to get its
minibatches (and SAGA's table slots and first minibatch) and hands them to
the port. Traces agree within 0.01 dB (0.05 dB through BM3D, whose f32 block
matching near-ties flip), images within 1e-3. The step schedule
``eta * lr_decay**i`` is held to JAX's bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms import loops as jax_loops
from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.denoisers.bm3d import BM3DDenoiser as JaxBM3DDenoiser
from pnp_svrg_tpu.denoisers.bm3d import BM3DParams as JaxBM3DParams
from pnp_svrg_tpu.denoisers.dncnn import DnCNNDenoiser as JaxDnCNNDenoiser
from pnp_svrg_tpu.denoisers.tv import TVDenoiser as JaxTVDenoiser
from pnp_svrg_tpu.problems import make_csmri as jax_make_csmri
from pnp_svrg_tpu.problems.pr import make_phase_retrieval as jax_make_phase_retrieval
from pnp_svrg_tpu_torch.algorithms import loops
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import csmri_from_numpy, pr_from_numpy
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
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
    masks, _ = _chain(jb, key, N_OUTER * T2, MB)
    return masks.reshape((N_OUTER, T2) + masks.shape[1:])


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
    masks = _jax_masks(jb, key)
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


# ---------------------------------------------------------------------------
# The step schedule, the four other loops, their latches and the dispatcher.
# ---------------------------------------------------------------------------


def _jax_schedule(eta, lr_decay, n):
    """``eta * lr_decay**i`` exactly as the JAX loops form it: inside a
    jitted scan over an f32 ``i``, from an f32 ``eta`` and ``lr_decay``."""
    eta = jnp.asarray(eta, jnp.float32)
    decay = jnp.asarray(lr_decay, jnp.float32)
    body = lambda c, i: (c, eta * decay**i)  # noqa: E731
    return np.asarray(jax.jit(lambda: jax.lax.scan(body, 0, jnp.arange(n, dtype=jnp.float32))[1])())


@pytest.mark.parametrize("eta", [0.2, 0.05, ETA], ids=["0.2", "0.05", "lanes"])
@pytest.mark.parametrize("lr_decay", [0.985, 0.99, 0.95, 1.0])
def test_step_schedule_is_bitwise_the_jax_schedule(lr_decay, eta):
    got = loops.step_schedule(torch.tensor(eta) if isinstance(eta, np.ndarray) else eta,
                              lr_decay, 30, "cpu")
    want = _jax_schedule(eta, lr_decay, 30)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


PR_SIZE, PR_MEAS = 32, 512
PR_ETA = np.asarray([0.1, 0.05], np.float32)
LOOP_N, LOOP_OUTER, LOOP_T2, HIST = 5, 2, 3, 4


@pytest.fixture(scope="module")
def pr_problems():
    """Two replicas of one 32-px PR problem (M = 512): the JAX batch stacks
    A twice, the port keeps it once."""
    img = jnp.asarray(load_image("Set12/04.png", PR_SIZE, PR_SIZE))
    jp = jax_make_phase_retrieval(jax.random.PRNGKey(4), img, num_meas=PR_MEAS, snr=20)
    jb = jax_stack_problems([jp, jp])
    one = pr_from_numpy({f: np.asarray(getattr(jp, f)) for f in ("a", "y", "x", "x_init", "snr", "sigma")},
                        "cpu")
    tp = stack_problems([one, one])
    assert tp.a.shape == (1, PR_MEAS, PR_SIZE**2) and tp.batch_size == 2
    return jb, tp


def _setup(which, problems, pr_problems):
    """(JAX batch, port batch, JAX denoiser, port denoiser, eta, minibatch)."""
    if which == "csmri_tv":
        jb, tp = problems
        return (jb, tp, JaxTVDenoiser(sigma_modifier=jnp.asarray(MOD)),
                TVDenoiser(sigma_modifier=torch.tensor(MOD)), np.asarray([400.0, 300.0], np.float32), MB)
    jb, tp = pr_problems
    return (jb, tp, JaxDnCNNDenoiser.from_pretrained("SimpleCNN", 5),
            DnCNNDenoiser.from_pretrained("SimpleCNN", 5, device="cpu"), PR_ETA, 100)


def _chain(jb, key, n, k, split=2):
    """The loops' key chain: ``k, k_mb, ... = split(k, split)`` per step,
    per lane ``fold_in(k_mb, lane)`` (``BatchedProblem.select_mb``);
    returns (n,) + mb_shape minibatches and the steps' remaining keys."""
    out, rest = [], []
    for _ in range(n):
        key, k_mb, *more = jax.random.split(key, split)
        out.append(np.asarray(jb.select_mb(k_mb, k)))
        rest.append(more)
    return torch.tensor(np.stack(out)), rest


def _run_both(algo, which, problems, pr_problems, lr_decay=0.9, eta=None, **kw):
    jb, tp, jden, tden, eta0, k = _setup(which, problems, pr_problems)
    eta = eta0 if eta is None else eta
    key = jax.random.PRNGKey(11)
    common = dict(eta=eta, lr_decay=lr_decay, **kw)
    if algo == "gd":
        jargs, targs = dict(n_iters=LOOP_N), dict(n_iters=LOOP_N)
    elif algo == "sgd":
        masks, _ = _chain(jb, key, LOOP_N, k)
        jargs = dict(n_iters=LOOP_N, mini_batch_size=k, key=key)
        targs = dict(n_iters=LOOP_N, mini_batch_size=k, masks=masks)
    elif algo == "saga":
        key_run, k0 = jax.random.split(key)
        mb0 = torch.tensor(np.asarray(jb.select_mb(k0, k)))
        masks, rest = _chain(jb, key_run, LOOP_N, k, split=3)
        slots = torch.tensor([int(jax.random.randint(r[0], (), 0, HIST)) for r in rest])
        jargs = dict(n_iters=LOOP_N, mini_batch_size=k, key=key, hist_size=HIST)
        targs = dict(n_iters=LOOP_N, mini_batch_size=k, hist_size=HIST, masks=masks, slots=slots, mb0=mb0)
    else:  # sarah, sarah_faithful
        masks, _ = _chain(jb, key, LOOP_OUTER * LOOP_T2, k)
        shape = dict(n_outer=LOOP_OUTER, t2=LOOP_T2, mini_batch_size=k,
                     variant="faithful" if algo == "sarah_faithful" else "sarah")
        jargs = dict(shape, key=key)
        targs = dict(shape, masks=masks.reshape((LOOP_OUTER, LOOP_T2) + masks.shape[1:]))
    name = algo.split("_")[0]
    want = jax_loops.run_pnp(name, jb, jden, **{**common, "eta": jnp.asarray(eta)}, **jargs)
    got = loops.run_pnp(name, tp, tden, **{**common, "eta": torch.tensor(eta)}, **targs)
    return want, got


LOOPS = ["gd", "sgd", "saga", "sarah", "sarah_faithful"]


@pytest.mark.parametrize("which", ["csmri_tv", "pr_simplecnn"])
@pytest.mark.parametrize("algo", LOOPS)
def test_loop_matches_jax_on_injected_minibatches(algo, which, problems, pr_problems):
    """``pnp_gd`` end to end; the stochastic loops on the JAX run's
    minibatches (and, for SAGA, its table slots and first minibatch)."""
    want, got = _run_both(algo, which, problems, pr_problems)
    wt, gt = np.asarray(want["psnr_per_iter"]), got["psnr_per_iter"].numpy()
    n_log = LOOP_OUTER * (LOOP_T2 + 1) if algo.startswith("sarah") else LOOP_N
    assert gt.shape == wt.shape == (1 + n_log, 2)
    assert got["algo_name"] == want["algo_name"]
    np.testing.assert_allclose(gt, wt, atol=0.01)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=1e-3)
    # Short runs at untuned steps: they need not improve, but they move.
    assert np.isfinite(gt).all() and np.all(np.abs(gt[-1] - gt[0]) > 0.1)


@pytest.mark.parametrize("algo", ["gd", "sgd", "saga", "sarah"])
def test_done_latch_freezes_a_diverging_lane(algo, problems, pr_problems):
    """Lane 1's step is huge: it goes negative and latches; its state then
    stays frozen (each later entry repeats, bar SARAH's unlatched step-1
    entries), and lane 0 runs on untouched, as in the JAX loop."""
    eta = np.asarray([400.0, 1e9], np.float32)
    want, got = _run_both(algo, "csmri_tv", problems, pr_problems, eta=eta, diverge_check=True)
    wt, gt = np.asarray(want["psnr_per_iter"]), got["psnr_per_iter"].numpy()
    np.testing.assert_allclose(gt[:, 0], wt[:, 0], atol=0.01)
    np.testing.assert_allclose(gt[:, 1], wt[:, 1], rtol=1e-3)
    latched = gt[:, 1]
    if algo == "sarah":  # drop the step-1 entries (1, 1 + (t2+1), ...)
        latched = np.delete(latched, np.arange(1, len(latched), LOOP_T2 + 1))
    first = int(np.argmax(latched < 0))
    assert first > 0 and np.all(latched[first:] == latched[first]), latched
    np.testing.assert_array_equal(got["z"][1].numpy(), got["image"][1].numpy().ravel())


def test_run_pnp_dispatches_and_tags(problems):
    _, tp = problems
    den = TVDenoiser(sigma_modifier=torch.tensor(MOD))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    kw = {"gd": dict(n_iters=1), "sgd": dict(n_iters=1, mini_batch_size=MB, generator=gen()),
          "svrg": dict(n_outer=1, t2=1, mini_batch_size=MB, generator=gen()),
          "saga": dict(n_iters=2, mini_batch_size=MB, generator=gen(), hist_size=3),
          "sarah": dict(n_outer=1, t2=1, mini_batch_size=MB, generator=gen())}
    names = {"gd": "PnP GD", "sgd": "PnP SGD", "svrg": "PnP SVRG", "saga": "PnP SAGA", "sarah": "PnP SARAH"}
    for algo, args in kw.items():
        out = loops.run_pnp(algo, tp, den, eta=100.0, **args)
        assert out["algo_name"] == names[algo]
        assert np.isfinite(out["psnr_per_iter"].numpy()).all()
    direct = loops.pnp_sgd(tp, den, 100.0, 1, MB, generator=gen())
    via = loops.run_pnp("sgd", tp, den, eta=100.0, n_iters=1, mini_batch_size=MB, generator=gen())
    assert torch.equal(direct["image"], via["image"])
    with pytest.raises(ValueError, match="unknown algorithm"):
        loops.run_pnp("adam", tp, den)
    with pytest.raises(ValueError):
        loops.pnp_sgd(tp, den, 1.0, 2, MB)  # neither a generator nor masks
    with pytest.raises(ValueError, match="together"):
        loops.pnp_saga(tp, den, 1.0, 2, MB, masks=torch.zeros((2, 2, SIZE, SIZE)))
    with pytest.raises(TypeError, match="axis object"):
        loops.pnp_saga(tp, den, 1.0, 2, MB, generator=gen(), table_axis="meas")
    with pytest.raises(ValueError, match="variant"):
        loops.pnp_sarah(tp, den, 1.0, 1, 1, MB, generator=gen(), variant="svrg")
