"""Port parity of the tuning package (``tuning/tpe.py``, ``tuning/sweep.py``).

* TPE: for the same seed and losses the port's copy proposes bit-identical
  parameters to the JAX package's (``fmin``, ``ask`` with ``forced`` and
  ``shared_keys``, the batch mode).
* Sweeps through the deterministic loop (``algo="gd"``, CSMRI + wavelet
  "TV" at 16 px, problems built by the JAX package and carried over as
  numpy arrays): ``sweep_grid`` sequential and with ``trial_batch=2``, and
  ``sweep_grid_lockstep``, give JAX's ``best_params`` and ``best_loss``
  within 1e-3 dB.
"""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pnp_svrg_tpu.denoisers import TVDenoiser as JaxTVDenoiser
from pnp_svrg_tpu.problems import make_csmri
from pnp_svrg_tpu.tuning import sweep as jax_sweep
from pnp_svrg_tpu.tuning import tpe as jax_tpe
from pnp_svrg_tpu_torch.convert import csmri_from_numpy
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.tuning import sweep, tpe

FIELDS = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")


def _space(mod, choice=True):
    s = {"x": mod.Uniform(0.0, 1.0), "y": mod.LogUniform(1e-2, 1e2), "q": mod.QUniform(2, 20, 1)}
    if choice:
        s["c"] = mod.Choice([64, 128, 256])
    return s


def _loss(p):
    return (p["x"] - 0.3) ** 2 + (np.log10(p["y"]) - 0.5) ** 2 + 0.01 * (p["q"] - 7) ** 2 + (
        1e-3 * p.get("c", 0))


def _params(trials):
    return [t.params for t in trials.trials]


@pytest.mark.parametrize("seed", [0, 3])
def test_fmin_proposes_what_jax_proposes(seed):
    want_best, want = jax_tpe.fmin(_loss, _space(jax_tpe), max_evals=30, seed=seed)
    got_best, got = tpe.fmin(_loss, _space(tpe), max_evals=30, seed=seed)
    assert _params(got) == _params(want)  # exact equality: the same floats
    assert got.losses() == want.losses() and got_best == want_best


def test_batch_mode_proposes_what_jax_proposes():
    calls = {"jax": [], "port": []}

    def batch(name):
        def objective(params_list):
            calls[name].append(len(params_list))
            return [{"loss": _loss(p), "tag": len(calls[name])} for p in params_list]
        return objective

    kw = dict(max_evals=22, seed=1, batch_size=4, shared_keys=("q", "c"))
    _, want = jax_tpe.fmin(None, _space(jax_tpe), batch_objective=batch("jax"), **kw)
    _, got = tpe.fmin(None, _space(tpe), batch_objective=batch("port"), **kw)
    assert _params(got) == _params(want)
    assert calls["port"] == calls["jax"] == [4, 4, 4, 4, 4, 2]
    # Each round's batch shares its shared keys.
    for r in range(0, 20, 4):
        assert len({(p["q"], p["c"]) for p in _params(got)[r : r + 4]}) == 1


def test_ask_with_forced_and_shared_keys_is_jax_ask():
    states = {
        name: mod.TPEState(_space(mod), seed=7, n_startup=4, shared_keys=("q", "c"))
        for name, mod in (("jax", jax_tpe), ("port", tpe))
    }
    rng = np.random.default_rng(0)
    for _ in range(3):  # startup rounds, then TPE rounds
        for forced in ({}, {"q": 5, "c": 128}):
            props = {n: st.ask(3, forced=forced) for n, st in states.items()}
            assert props["port"] == props["jax"]
            for p in props["port"]:
                assert all(p[k] == v for k, v in forced.items())
            losses = rng.random(3)
            for n, st in states.items():
                for p, loss in zip(props[n], losses):
                    st.tell(p, {"loss": float(loss)})
    assert states["port"].best.params == states["jax"].best.params


def test_default_space_is_jax_default_space():
    for algo in ("gd", "sgd", "svrg", "saga", "sarah"):
        for m in (1024, 16384):
            want, got = jax_sweep.default_space(algo, m), sweep.default_space(algo, m)
            assert {k: vars(v) for k, v in got.items()} == {k: vars(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# Sweeps through the deterministic loop.
# ---------------------------------------------------------------------------

GD_SPACE = {"eta": (1.0, 300.0), "dstrength": (0.3, 2.0)}


def _gd_space(mod):
    return {"eta": mod.LogUniform(*GD_SPACE["eta"]), "dstrength": mod.Uniform(*GD_SPACE["dstrength"])}


@pytest.fixture(scope="module")
def problems():
    """Two (JAX problem, one-lane port problem) pairs at 16 px."""
    h = 16
    xx, yy = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, h))
    pairs = []
    for i, (a, b) in enumerate(((4, 3), (2, 5))):
        img = jnp.asarray(np.sin(a * xx) * np.cos(b * yy) * 0.4 + 0.5, jnp.float32)
        jp = make_csmri(jax.random.PRNGKey(i), img, sample_prob=0.5, snr=10)
        pairs.append((jp, csmri_from_numpy({f: np.asarray(getattr(jp, f))[None] for f in FIELDS}, "cpu")))
    return pairs


def _cells(problems, side):
    mod, den = (jax_tpe, JaxTVDenoiser) if side == "jax" else (tpe, TVDenoiser)
    return [{
        "problem": pair[0 if side == "jax" else 1], "algo": "gd",
        "denoiser_factory": lambda d, den=den: den(sigma_modifier=d),
        "problem_name": "csmri", "denoiser_name": "tv", "image": f"img{i}",
        "ratio": 0.5, "snr": 10.0, "seed": i, "space": _gd_space(mod),
    } for i, pair in enumerate(problems)]


def _same_cells(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert (g.problem_name, g.algo, g.denoiser_name, g.image, g.ratio, g.snr) == (
            w.problem_name, w.algo, w.denoiser_name, w.image, w.ratio, w.snr)
        assert g.best_params == w.best_params
        assert abs(g.best_loss - w.best_loss) < 1e-3, (g.best_loss, w.best_loss)
        assert abs(g.best_psnr - w.best_psnr) < 1e-3
        assert g.best_loss < 0  # the best trial improves on x_init


@pytest.mark.parametrize("trial_batch", [1, 2])
def test_sweep_grid_gd_gives_jax_best_params(problems, trial_batch, tmp_path):
    kw = dict(max_evals=6, n_iters=5, verbose=False, trial_batch=trial_batch)
    want = jax_sweep.sweep_grid(_cells(problems, "jax"), **kw)
    got = sweep.sweep_grid(_cells(problems, "port"), csv_path=tmp_path / "s.csv", **kw)
    _same_cells(want, got)
    rows = list(csv.DictReader(open(tmp_path / "s.csv")))
    assert [r["image"] for r in rows] == ["img0", "img1"]


def test_sweep_grid_lockstep_gd_gives_jax_best_params(problems, tmp_path):
    kw = dict(max_evals=6, n_iters=5, cand_per_round=3, verbose=False)
    want = jax_sweep.sweep_grid_lockstep(_cells(problems, "jax"), **kw)
    got = sweep.sweep_grid_lockstep(_cells(problems, "port"), csv_path=tmp_path / "l.csv", **kw)
    _same_cells(want, got)
    # max_lanes below the round's 6 lanes: two chunks, the last padded.
    again = sweep.sweep_grid_lockstep(_cells(problems, "port"), max_lanes=4, **kw)
    _same_cells(want, again)


def test_batched_cell_objective_matches_sequential(problems):
    _, tp = problems[0]
    factory = lambda d: TVDenoiser(sigma_modifier=d)  # noqa: E731
    params = [{"eta": 50.0, "dstrength": 0.7}, {"eta": 120.0, "dstrength": 1.1}]
    batched = sweep.make_batched_cell_objective("gd", tp, factory, n_iters=8)(params)
    seq = [sweep.make_cell_objective("gd", tp, factory, n_iters=8)(p) for p in params]
    for b, s in zip(batched, seq):
        np.testing.assert_allclose(b["loss"], s["loss"], atol=1e-3)


def test_lockstep_shares_statics_and_groups_by_them(problems, tmp_path, monkeypatch):
    """A stochastic lockstep sweep (SVRG) passes the leader's integer
    hyperparameters to every lane of a round as Python ints, and each cell's
    best stays inside its space."""
    calls = []
    real = sweep.run_pnp

    def spy(algo, problem, den, **kw):
        calls.append({k: v for k, v in kw.items() if k in ("n_outer", "t2", "mini_batch_size")})
        return real(algo, problem, den, **kw)

    space = {"eta": tpe.LogUniform(1.0, 500.0), "dstrength": tpe.Uniform(0.3, 2.0),
             "mini_batch_size": tpe.Choice([32, 64]), "t2": tpe.Choice([2, 3])}
    cells = [dict(c, algo="svrg", space=space) for c in _cells(problems, "port")]
    monkeypatch.setattr(sweep, "run_pnp", spy)
    out = sweep.sweep_grid_lockstep(cells, max_evals=4, n_iters=7, cand_per_round=2,
                                    csv_path=tmp_path / "l.csv", verbose=False)
    assert len(calls) == 2  # two rounds, one run each (4 lanes)
    for kw in calls:
        assert all(type(v) is int for v in kw.values())
        assert kw["n_outer"] == max(1, 7 // (kw["t2"] + 1))
    for rec in out:
        assert np.isfinite(rec.best_loss)
        assert rec.best_params["mini_batch_size"] in (32, 64) and rec.best_params["t2"] in (2, 3)
