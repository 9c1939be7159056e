"""Port parity of the wall-clock compat API (``algorithms/compat.py``).

On a 16-px CSMRI + wavelet "TV" problem built by the JAX package (the one
``tests/test_compat_equivalence.py`` uses), in iteration-budget mode
(``max_iters``, ``tt`` far away):

* against the JAX compat API: ``pnp_gd`` end to end; the stochastic
  wrappers on minibatches replayed from the JAX compat key chain (one
  ``_KeyStream`` split a draw; SAGA's 2-way split, then a 3-way split a
  step, ``compat.py:256-273``) and handed to the port;
* against the port's own loops, mirroring ``tests/test_compat_equivalence.py``
  (the same cases and tolerances, the timing split, SARAH's live recursion).

Traces agree within 0.011 dB (compat rounds PSNRs to 2 decimals), iterates
within 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms import compat as jax_compat
from pnp_svrg_tpu.denoisers import TVDenoiser as JaxTVDenoiser
from pnp_svrg_tpu.problems import make_csmri
from pnp_svrg_tpu_torch.algorithms import compat, loops
from pnp_svrg_tpu_torch.convert import csmri_from_numpy
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser

FIELDS = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")
JDEN, TDEN = JaxTVDenoiser(sigma_modifier=1.0), TVDenoiser(sigma_modifier=1.0)
MB = 32

# (loops kwargs, compat kwargs), as tests/test_compat_equivalence.py has them.
CASES = {
    "gd": (dict(eta=50.0, n_iters=5), dict(eta=50.0, tt=1e9, max_iters=5)),
    "sgd": (dict(eta=50.0, n_iters=5, mini_batch_size=MB),
            dict(eta=50.0, tt=1e9, max_iters=5, mini_batch_size=MB)),
    "svrg": (dict(eta=50.0, n_outer=2, t2=3, mini_batch_size=MB),
             dict(eta=50.0, tt=1e9, max_iters=6, T2=3, mini_batch_size=MB)),
    "saga": (dict(eta=50.0, n_iters=5, mini_batch_size=MB, hist_size=3),
             dict(eta=50.0, tt=1e9, max_iters=5, mini_batch_size=MB, hist_size=3)),
    "sarah": (dict(eta=50.0, n_outer=2, t2=3, mini_batch_size=MB),
              dict(eta=50.0, tt=1e9, max_iters=6, T2=3, mini_batch_size=MB)),
}
OFF = dict(converge_check=False, diverge_check=False)


@pytest.fixture(scope="module")
def problems():
    """(JAX problem, one-lane port problem on the CPU)."""
    h = 16
    xx, yy = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, h))
    img = jnp.asarray(np.sin(5 * xx) * np.cos(4 * yy) * 0.4 + 0.5, jnp.float32)
    jp = make_csmri(jax.random.PRNGKey(0), img, sample_prob=0.5, snr=10)
    return jp, csmri_from_numpy({f: np.asarray(getattr(jp, f))[None] for f in FIELDS}, "cpu")


def _compare(want, got, ref_tr=None):
    wt = np.asarray(want["psnr_per_iter"] if ref_tr is None else ref_tr, np.float64)
    gt = np.asarray(got["psnr_per_iter"], np.float64)
    assert wt.shape == gt.shape, (wt.shape, gt.shape)
    np.testing.assert_allclose(gt, wt, atol=0.011)
    np.testing.assert_allclose(np.asarray(got["z"]).ravel(), np.asarray(want["z"]).ravel(), atol=1e-4)


def _jax_draws(jp, n, seed=0):
    """The JAX compat minibatches of the non-SAGA wrappers: ``_KeyStream``
    splits ``key, k = split(key)`` a draw."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jp.select_mb(k, MB))[None])
    return torch.tensor(np.stack(out))


def _jax_saga_draws(jp, n, hist, seed=0):
    """JAX compat SAGA's chain: ``key0, k_init = split(PRNGKey(seed))`` for
    the table's minibatch, then ``key, k_mb, k_slot = split(key, 3)`` a
    step, the slot ``randint(k_slot, (), 0, hist)``."""
    key, k_init = jax.random.split(jax.random.PRNGKey(seed))
    mb0 = torch.tensor(np.asarray(jp.select_mb(k_init, MB))[None])
    masks, slots = [], []
    for _ in range(n):
        key, k_mb, k_slot = jax.random.split(key, 3)
        masks.append(np.asarray(jp.select_mb(k_mb, MB))[None])
        slots.append(int(jax.random.randint(k_slot, (), 0, hist)))
    return torch.tensor(np.stack(masks)), torch.tensor(slots), mb0


@pytest.mark.parametrize("algo", ["gd", "sgd", "svrg", "svrg_faithful", "saga", "sarah", "sarah_faithful"])
def test_compat_matches_jax_compat(problems, algo):
    jp, tp = problems
    name, _, variant = algo.partition("_")
    hp = dict(CASES[name][1], **OFF)
    if variant:
        hp["variant"] = variant
    want = getattr(jax_compat, f"pnp_{name}")(jp, JDEN, **hp)
    inject = {}
    if name == "saga":
        masks, slots, mb0 = _jax_saga_draws(jp, hp["max_iters"], hp["hist_size"])
        inject = dict(masks=masks, slots=slots, mb0=mb0)
    elif name != "gd" and algo != "svrg_faithful":  # faithful SVRG draws none
        inject = dict(masks=_jax_draws(jp, hp["max_iters"]))
    got = getattr(compat, f"pnp_{name}")(tp, TDEN, **hp, **inject)
    assert got["algo_name"] == want["algo_name"]
    assert len(got["time_per_iter"]) == len(got["psnr_per_iter"])
    _compare(want, got)


def _port_draws(tp, n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([tp.select_mb(gen, MB) for _ in range(n)])


@pytest.mark.parametrize("algo", sorted(CASES))
def test_compat_matches_the_port_loops(problems, algo):
    """compat == loops at matched iteration counts and minibatches (the
    port's own draws, handed to both)."""
    _, tp = problems
    loop_hp, compat_hp = CASES[algo]
    loop_kw, compat_kw = {}, {}
    if algo in ("sgd", "saga"):
        masks = _port_draws(tp, 5)
        loop_kw = compat_kw = dict(masks=masks)
        if algo == "saga":
            slots = torch.tensor([2, 0, 1, 1, 2])
            mb0 = _port_draws(tp, 1, seed=4)[0]
            loop_kw = compat_kw = dict(masks=masks, slots=slots, mb0=mb0)
    elif algo in ("svrg", "sarah"):
        masks = _port_draws(tp, 6)
        loop_kw, compat_kw = dict(masks=masks.reshape((2, 3) + masks.shape[1:])), dict(masks=masks)
    want = loops.run_pnp(algo, tp, TDEN, **loop_hp, **loop_kw)
    got = getattr(compat, f"pnp_{algo}")(tp, TDEN, **compat_hp, **OFF, **compat_kw)
    _compare(want, got, ref_tr=want["psnr_per_iter"][:, 0].numpy())


@pytest.mark.parametrize("algo", ["sarah", "svrg"])
def test_compat_matches_the_port_loops_faithful(problems, algo):
    _, tp = problems
    loop_hp, compat_hp = CASES[algo]
    masks = _port_draws(tp, 6)
    loop_masks = masks.reshape((2, 3) + masks.shape[1:])
    want = loops.run_pnp(algo, tp, TDEN, variant="faithful", **loop_hp,
                         **({"masks": loop_masks} if algo == "sarah" else {}))
    got = getattr(compat, f"pnp_{algo}")(tp, TDEN, variant="faithful", **compat_hp, **OFF,
                                         **({"masks": masks} if algo == "sarah" else {}))
    _compare(want, got, ref_tr=want["psnr_per_iter"][:, 0].numpy())


@pytest.mark.parametrize("algo", ["sgd", "svrg"])
def test_timing_split_sums_to_time_per_iter(problems, algo):
    """Every inner ``time_per_iter`` entry is (gradient + denoise) time, so
    the two accumulators sum to the inner entries; SVRG's snapshot entries
    are in ``time_per_iter`` but in neither accumulator."""
    _, tp = problems
    hp = CASES[algo][1]
    out = getattr(compat, f"pnp_{algo}")(tp, TDEN, **hp, **OFF)
    split = out["gradient_time"] + out["denoise_time"]
    total = float(np.sum(out["time_per_iter"]))
    assert split > 0.0
    if algo == "sgd":
        np.testing.assert_allclose(split, total, rtol=1e-9)
    else:
        n_outer_entries = hp["max_iters"] // hp["T2"]
        assert total - split >= 0.0
        assert len(out["time_per_iter"]) == 1 + hp["max_iters"] + n_outer_entries


def test_sarah_canonical_recursion_is_live(problems):
    """With w_prev tracking the previous iterate, the canonical inner
    estimate moves away from the snapshot gradient: the two variants'
    trajectories part after step 1."""
    _, tp = problems
    kw = dict(eta=50.0, tt=1e9, T2=4, max_iters=4, mini_batch_size=MB, **OFF)
    tr_c = np.asarray(compat.pnp_sarah(tp, TDEN, **kw)["psnr_per_iter"])
    tr_f = np.asarray(compat.pnp_sarah(tp, TDEN, variant="faithful", **kw)["psnr_per_iter"])
    assert not np.allclose(tr_c[2:], tr_f[2:])


def test_compat_step_is_python_f64_rounded_to_f32(problems):
    """The compat step is ``eta * lr_decay**i`` in Python f64, then f32 --
    what the JAX compat API multiplies the gradient by -- and not the
    loops' f32 power (``step_schedule``), which differs at lr_decay 0.985."""
    eta, decay, n = 7000.0, 0.985, 30
    got = np.asarray([compat.compat_step(eta, decay, i) for i in range(n)], np.float32)
    # The JAX compat API's factor: its Python f64 scalar times an f32 one.
    ones = jnp.ones((), jnp.float32)
    want = np.asarray([np.asarray((eta * decay**i) * ones) for i in range(n)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sched = loops.step_schedule(eta, decay, n, "cpu").numpy()
    assert (sched != got).any()
    # And the run uses it: 30 GD steps at lr_decay 0.985 match JAX compat.
    jp, tp = problems
    hp = dict(eta=50.0, tt=1e9, max_iters=n, lr_decay=decay, **OFF)
    _compare(jax_compat.pnp_gd(jp, JDEN, **hp), compat.pnp_gd(tp, TDEN, **hp))


def test_tuner_adapters_shape_loss_and_dstrength(problems):
    _, tp = problems
    out = compat.tune_pnp_gd((100.0, 0.7), tp, TDEN, tt=1.0, converge_check=False,
                             diverge_check=True)
    assert set(out) == {"loss", "status", "z", "time_per_iter", "psnr_per_iter",
                        "gradient_time", "denoise_time", "algo_name"}
    assert out["status"] == "ok" and out["algo_name"] == "PnP GD"
    # loss = round2(PSNR(x_init)) - round2(PSNR(z)); improvement is negative.
    init = round(float(tp.psnr(tp.x_init)[0]), 2)
    final = round(float(tp.psnr(out["z"])[0]), 2)
    assert out["loss"] == pytest.approx(init - final, abs=1e-9) and out["loss"] < 0
    for p in out["psnr_per_iter"]:
        assert abs(p - round(p, 2)) < 1e-9
    # dstrength becomes sigma_modifier where the denoiser has denoise_strength.
    direct = compat.pnp_gd(tp, TVDenoiser(sigma_modifier=0.7), eta=100.0, tt=1e9, max_iters=3, **OFF)
    via = compat._make_tuner(compat.pnp_gd, ("eta", "dstrength", "max_iters"))(
        (100.0, 0.7, 3), tp, TDEN, tt=1e9, converge_check=False, diverge_check=False)
    assert torch.equal(direct["z"], via["z"])

    @dataclasses.dataclass(frozen=True)
    class NoStrength:
        """A denoiser without ``denoise_strength``: dstrength leaves it be."""

        sigma_modifier: float
        seen: list

        def denoise(self, x, sigma_est, t):
            self.seen.append(self.sigma_modifier)
            return x

    den = NoStrength(sigma_modifier=1.0, seen=[])
    compat.tune_pnp_svrg((50.0, MB, 2, 1.7), tp, den, tt=0.2)
    assert den.seen and set(den.seen) == {1.0}


def test_tuner_svrg_on_nlm_runs_the_budget(problems):
    _, tp = problems
    out = compat.tune_pnp_svrg((50.0, MB, 3, 1.0), tp, NLMDenoiser(), tt=0.5,
                               converge_check=False)
    assert len(out["psnr_per_iter"]) > 1 and np.isfinite(out["psnr_per_iter"]).all()
    assert out["gradient_time"] > 0 and out["denoise_time"] > 0


def test_wallclock_budget_and_one_lane(problems):
    _, tp = problems
    out = compat.pnp_gd(tp, TDEN, eta=50.0, tt=0.0)
    assert out["psnr_per_iter"] == [round(float(tp.psnr(tp.x_init)[0]), 2)]
    assert out["time_per_iter"] == [0.0] and out["gradient_time"] == 0.0
    with pytest.raises(ValueError, match="one-lane"):
        compat.pnp_gd(stack_problems([tp, tp]), TDEN, eta=50.0, tt=1.0)
    with pytest.raises(ValueError, match="used up"):
        compat.pnp_sgd(tp, TDEN, eta=50.0, tt=1e9, max_iters=3, mini_batch_size=MB,
                       masks=_port_draws(tp, 2), **OFF)
    with pytest.raises(ValueError, match="together"):
        compat.pnp_saga(tp, TDEN, eta=50.0, tt=1e9, mini_batch_size=MB, masks=_port_draws(tp, 2))
