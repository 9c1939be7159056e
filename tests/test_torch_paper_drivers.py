"""The port's paper and demo drivers (``pnp_svrg_tpu_torch/examples/
paper_csmri.py``, ``paper_deblur.py``, ``paper_pr.py``, ``pnp_csmri_demo.py``,
``rgb_csmri.py``) against the JAX scripts of the same names under
``examples/``, on the CPU.

* Call tables: each JAX script's ``main`` runs with the JAX package's loops
  replaced by recorders that return a stub output, and the port's ``main``
  with its loops replaced the same way; the rows' names and order, the loop,
  every hyperparameter and the denoiser (class, parameters, checkpoint) must
  be equal, under every flag value. paper_pr's tables are recorded at
  ``--small`` only: they do not depend on the size, and the default size
  would build a 537 MB matrix in each test worker.
* The CSV columns of the paper drivers are the JAX rows' keys.
* The committed fixture ``paper_drivers.npz`` holds the JAX package's own
  problems (a fresh JAX run rebuilds them) and the JAX CPU traces the port
  is held to on the card; here the first entries of paper_csmri's ``gd``
  anchor are held on the CPU.
* The demo and RGB scripts run end to end with ``--cpu`` at tiny sizes,
  their figures written into ``tmp_path``.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnp_svrg_tpu.denoisers.dncnn as jax_dncnn
from pnp_svrg_tpu.denoisers.bm3d import BM3DParams as JaxBM3DParams
from pnp_svrg_tpu.utils import viz as jax_viz
from pnp_svrg_tpu_torch.algorithms import loops as port_loops
from pnp_svrg_tpu_torch.convert import (
    PAPER_ANCHORS,
    PAPER_DRIVERS_FIXTURE,
    PAPER_PROBLEMS,
    PAPER_TABLES,
    checksum,
    load_paper_csmri_problem,
    load_paper_deblur_problem,
    load_paper_reference,
)
from pnp_svrg_tpu_torch.denoisers import dncnn as port_dncnn
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.utils import viz as port_viz
from pnp_svrg_tpu_torch.utils.io import load_image
from test_torch_fixture import JAX_LOOPS, jax_driver, row_names, run_jax_driver

ALGO_NAMES = {"pnp_gd": "PnP GD", "pnp_sgd": "PnP SGD", "pnp_svrg": "PnP SVRG", "pnp_saga": "PnP SAGA",
              "pnp_sarah": "PnP SARAH"}
HYPERPARAMETERS = ("eta", "n_iters", "n_outer", "t2", "mini_batch_size", "lr_decay", "hist_size", "variant")
TABLE_CASES = [
    ("paper_csmri", []), ("paper_csmri", ["--eta-scale", "ref"]),
    ("paper_deblur", []), ("paper_deblur", ["--small"]),
    ("paper_pr", ["--small"]), ("paper_pr", ["--small", "--config", "ref"]),
    ("pnp_csmri_demo", []), ("pnp_csmri_demo", ["--small"]),
]
CSV_CASES = [("paper_csmri", []), ("paper_deblur", ["--small"]), ("paper_pr", ["--small"])]
RGB_ALGOS = ("gd", "sgd", "saga", "svrg")
# The first entries of paper_csmri's gd row (13.png at 128 px, BM3D search
# 8, f32) on the fixture's problem: the port's plain CPU path against the
# JAX CPU trace; both take the same f32 steps and BM3D. The two part by
# rounding from entry 3 on and stay within the tolerance through entry 59
# (0.0090 dB there, 0.0104 at entry 60; the 198-entry maximum is 0.0309,
# inside the 0.046 dB by which one ulp of x_init moves the JAX trace itself:
# ``python tests/test_torch_fixture.py --cpu-anchors``).
ANCHOR_ENTRIES, ANCHOR_CPU_TOL_DB = 60, 0.01



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs in
    several worker processes at once, and with a thread per core in each,
    torch's small CPU ops wait on each other's threads (a 64 px RealSN-DnCNN
    denoise took 12x its one-thread time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port_driver(name):
    return importlib.import_module(f"pnp_svrg_tpu_torch.examples.{name}")


def _jax_stub(loop, problem, kw):
    p = problem.psnr(problem.x_init)
    return {"final_psnr": p, "image": problem.x_init, "z": problem.x_init.ravel(),
            "psnr_per_iter": jnp.stack([p, p]), "algo_name": ALGO_NAMES[loop]}


def _port_stub(loop, problem, kw):
    p = problem.psnr(problem.x_init)
    return {"final_psnr": p, "image": problem.x_init, "z": problem.x_init.reshape(1, -1),
            "psnr_per_iter": torch.stack([p, p]), "algo_name": ALGO_NAMES[loop]}


def _record_port_loops(monkeypatch, module) -> list:
    """The port driver's loops replaced by stub recorders; returns the list
    the calls ``(loop, problem, denoiser, kwargs, output)`` go into."""
    calls = []

    def recorder(name):
        def run(problem, denoiser, **kw):
            calls.append((name, problem, denoiser, kw, _port_stub(name, problem, kw)))
            return calls[-1][-1]
        return run

    for name in JAX_LOOPS:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, recorder(name))
    return calls


def _record_checkpoints(monkeypatch) -> dict:
    """The checkpoint names each side's CNN denoisers load, in order."""
    names = {"jax": [], "port": []}
    for side, module in (("jax", jax_dncnn), ("port", port_dncnn)):
        real = module.load_denoiser_params

        def load(name, real=real, side=side):
            names[side].append(name)
            return real(name)
        monkeypatch.setattr(module, "load_denoiser_params", load)
    return names


def _hyperparameters(real, problem, denoiser, kw) -> dict:
    bound = inspect.signature(real).bind(problem, denoiser, **kw)
    bound.apply_defaults()
    return {k: bound.arguments[k] for k in HYPERPARAMETERS if k in bound.arguments}


def _denoiser(den) -> tuple:
    """A denoiser's class and parameters, comparable across the packages."""
    name = type(den).__name__
    if name == "BM3DDenoiser":
        params = {f.name: getattr(den.params, f.name) for f in dataclasses.fields(JaxBM3DParams)}
        return (name, float(den.sigma_modifier), float(den.denoise_strength), float(den.decay), den.stages,
                params)
    if name == "DnCNNDenoiser":
        return (name, float(den.sigma_train), den.model_type, den.channels)
    if name == "MMODenoiser":
        return (name, den.channels)
    if name == "TVDenoiser":
        return (name, float(den.sigma_modifier), float(den.denoise_strength), float(den.decay), den.wavelet)
    raise AssertionError(f"unexpected denoiser {name}")


def _table(calls, real_loops) -> list:
    return [(loop, _hyperparameters(getattr(real_loops, loop), prob, den, kw), _denoiser(den))
            for loop, prob, den, kw, _ in calls]


def _run_port_main(monkeypatch, driver, argv, tmp_path):
    module = _port_driver(driver)
    calls = _record_port_loops(monkeypatch, module)
    out = ["--out", str(tmp_path / "port.png")] if driver == "pnp_csmri_demo" else \
        ["--save", str(tmp_path / "port.csv")]
    result = module.main(["--cpu", *argv, *out])
    return row_names(driver, result), calls, result


@pytest.mark.parametrize("driver,argv", TABLE_CASES, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_call_table_is_the_jax_drivers(monkeypatch, tmp_path, driver, argv):
    import pnp_svrg_tpu

    checkpoints = _record_checkpoints(monkeypatch)
    jax_names, jax_calls, jax_result = run_jax_driver(driver, argv, tmp_path, stub=_jax_stub)
    names, calls, result = _run_port_main(monkeypatch, driver, argv, tmp_path)
    assert names == jax_names and len(names) == len(calls) == len(jax_calls) > 0
    assert _table(calls, port_loops) == _table(jax_calls, pnp_svrg_tpu)
    assert checkpoints["port"] == checkpoints["jax"]
    if driver == "paper_pr":
        assert checkpoints["port"] == ["mmo_dncnn_nobn_nch1_nlev0.009", "realsn_dncnn_noise5"]
    # Every row gets its own stream seeded 1 (the JAX rows share PRNGKey(1)).
    gens = [kw.get("generator") for _, _, _, kw, _ in calls if kw.get("generator") is not None]
    assert len({id(g) for g in gens}) == len(gens)
    assert all(g.initial_seed() == 1 for g in gens)
    # One problem for every row, as in JAX (paper_pr's A is held once).
    assert len({id(c[1]) for c in calls}) == 1 and len({id(c[1]) for c in jax_calls}) == 1
    shape = tuple(np.shape(jax_calls[0][1].x_init))
    assert tuple(calls[0][1].x_init.shape) == (1,) + shape


@pytest.mark.parametrize("driver,argv", CSV_CASES, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_metrics_csv_columns_are_the_jax_rows_keys(monkeypatch, tmp_path, driver, argv):
    _, _, jax_rows = run_jax_driver(driver, argv, tmp_path, stub=_jax_stub)
    _, _, rows = _run_port_main(monkeypatch, driver, argv, tmp_path)
    with open(tmp_path / "port.csv", newline="") as f:
        header = next(csv.reader(f))
    assert header == list(jax_rows[0]) == list(rows[0])
    assert [list(r) for r in rows] == [list(r) for r in jax_rows]


@pytest.mark.parametrize("algo", RGB_ALGOS)
def test_rgb_call_is_the_jax_drivers(monkeypatch, tmp_path, algo):
    seen = {}

    def recorder(side):
        def run(image, **kw):
            seen[side] = (np.asarray(image), kw)
            return image, 0.5 * image, 0.9 * image
        return run

    jax_defaults = inspect.signature(jax_viz.reconstruct_rgb).parameters
    monkeypatch.setattr(jax_viz, "reconstruct_rgb", recorder("jax"))
    rgb = _port_driver("rgb_csmri")
    monkeypatch.setattr(rgb, "reconstruct_rgb", recorder("port"))
    argv = ["--cpu", "--algo", algo, "--size", "48"]
    jax_driver("rgb_csmri").main(argv + ["--out", str(tmp_path / "jax.png")])
    rgb.main(argv + ["--out", str(tmp_path / "port.png")])
    (jimg, jkw), (img, kw) = seen["jax"], seen["port"]
    np.testing.assert_array_equal(img, jimg)
    assert str(kw.pop("device")) == "cpu"
    assert _denoiser(kw.pop("denoiser")) == _denoiser(jkw.pop("denoiser"))
    assert kw == jkw
    for name in ("sample_prob", "snr", "seed"):
        assert inspect.signature(port_viz.reconstruct_rgb).parameters[name].default == \
            jax_defaults[name].default


@pytest.mark.parametrize("driver", list(PAPER_PROBLEMS))
def test_fixture_csmri_problems_are_the_jax_drivers(tmp_path, driver):
    _, calls, _ = run_jax_driver(driver, [], tmp_path, stub=_jax_stub)
    want = calls[0][1]
    got = load_paper_csmri_problem(driver, device="cpu")
    for name in ("y", "mask", "x", "x_init"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("m0", "snr", "sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), [np.float32(getattr(want, name))], err_msg=name)


def test_fixture_deblur_problem_is_the_jax_drivers(tmp_path):
    _, calls, _ = run_jax_driver("paper_deblur", [], tmp_path, stub=_jax_stub)
    want = calls[0][1]
    got = load_paper_deblur_problem(device="cpu")
    for name in ("y", "b", "x", "x_init"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy().reshape(np.shape(getattr(want, name))),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.sigma.numpy(), [np.float32(want.sigma)])
    with np.load(PAPER_DRIVERS_FIXTURE) as f:
        tampered = {k: f[k] for k in f.files}
    assert str(tampered["paper_deblur/y_sha256"]) == checksum(np.asarray(want.y))
    tampered["paper_deblur/y_sha256"] = np.asarray("0" * 64)
    np.savez(tmp_path / "tampered.npz", **tampered)
    with pytest.raises(RuntimeError, match="checksum"):
        load_paper_deblur_problem(device="cpu", path=tmp_path / "tampered.npz")


def test_fixture_reference_covers_every_row_and_anchor():
    ref = load_paper_reference()
    assert PAPER_DRIVERS_FIXTURE.stat().st_size < 2_000_000
    for driver, tables in PAPER_TABLES.items():
        for table in tables:
            rows = ref[driver][table]["rows"]
            assert np.isfinite(ref[driver][table]["init_psnr"])
            assert all(np.isfinite(r["final_psnr"]) and np.isfinite(r["final_ssim"]) for r in rows.values())
    assert list(ref["paper_csmri"]["auto"]["rows"]) == ["gd", "sgd", "svrg", "saga", "sarah"]
    assert list(ref["paper_csmri"]["ref"]["rows"]) == ["svrg", "sgd", "gd", "saga", "sarah"]
    assert list(ref["paper_pr"]["auto"]["rows"]) == ["svrg+bm3d", "sgd+bm3d", "gd+bm3d", "svrg+mmo", "sgd+mmo",
                                                     "gd+mmo", "sarah+realsn"]
    for (driver, table), row in PAPER_ANCHORS.items():
        trace = ref[driver][table]["rows"][row]["psnr_per_iter"]
        assert trace[0] == pytest.approx(ref[driver][table]["init_psnr"], abs=1e-5)
        assert trace[-1] == pytest.approx(ref[driver][table]["rows"][row]["final_psnr"], abs=1e-5)
    assert [len(ref[d][t]["rows"][r]["psnr_per_iter"]) for (d, t), r in PAPER_ANCHORS.items()] == [199, 199, 9, 31]
    rgb = ref["rgb_csmri"]["default"]
    assert rgb["channels_init"].shape == rgb["channels_recon"].shape == (3,)
    assert np.all(rgb["channels_recon"] > rgb["channels_init"])


def test_paper_deblur_anchor_trace_is_a_fresh_jax_run(tmp_path):
    """8 BM3D steps at 256 px (about 20 s on the CPU): the stored trace is
    what the JAX driver's row computes now."""
    import pnp_svrg_tpu

    want = load_paper_reference()["paper_deblur"]["default"]["rows"]["gd+bm3d"]["psnr_per_iter"]
    _, calls, _ = run_jax_driver("paper_deblur", [], tmp_path, stub=_jax_stub)
    loop, prob, den, kw, _ = next(c for c in calls if c[0] == "pnp_gd")
    fresh = np.asarray(getattr(pnp_svrg_tpu, loop)(prob, den, **kw)["psnr_per_iter"])
    np.testing.assert_allclose(fresh, want, atol=1e-4)


def test_paper_csmri_gd_anchor_starts_on_the_jax_trace_on_the_cpu(monkeypatch):
    """The first entries of the ``gd`` row on the JAX driver's own problem
    (the fixture's), run through the port driver's table with the plain
    BM3D path, against the JAX CPU trace."""
    driver = _port_driver("paper_csmri")
    calls = _record_port_loops(monkeypatch, driver)
    prob = load_paper_csmri_problem("paper_csmri", device="cpu")
    driver.make_runs(prob, driver.parse_args(["--cpu"]), torch.device("cpu"))["gd"]()
    loop, problem, den, kw, _ = calls[0]
    assert loop == "pnp_gd" and problem is prob and kw["n_iters"] == 198
    out = port_loops.pnp_gd(problem, den, **(kw | {"n_iters": ANCHOR_ENTRIES - 1}))
    want = load_paper_reference()["paper_csmri"]["auto"]["rows"]["gd"]["psnr_per_iter"][:ANCHOR_ENTRIES]
    np.testing.assert_allclose(out["psnr_per_iter"][:, 0].numpy(), want, atol=ANCHOR_CPU_TOL_DB)


def _small_demo_problem(args, device):
    """The demo's problem at 64 px (its --small is 128 px, about a minute of
    RealSN-DnCNN on the CPU)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return make_csmri(load_image("13.png", 64, 64), gen, sample_prob=0.5, snr=30, device=device)


def test_demo_main_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    demo = _port_driver("pnp_csmri_demo")
    monkeypatch.setattr(demo, "make_problem", _small_demo_problem)
    outs = demo.main(["--cpu", "--out", str(tmp_path / "fig" / "demo.png")])
    assert list(outs) == ["PnP-GD", "PnP-SGD", "PnP-SVRG"]
    assert (tmp_path / "fig" / "demo.png").stat().st_size > 1000
    for out in outs.values():
        assert out["image"].shape == (1, 64, 64) and torch.isfinite(out["psnr_per_iter"]).all()
    assert float(outs["PnP-GD"]["final_psnr"][0]) > float(outs["PnP-GD"]["psnr_per_iter"][0, 0])


def test_demo_falls_back_to_plain_dncnn_without_the_realsn_checkpoint(monkeypatch):
    demo = _port_driver("pnp_csmri_demo")
    real = port_dncnn.load_denoiser_params

    def load(name):
        if name.startswith("realsn"):
            raise FileNotFoundError(name)
        return real(name)

    monkeypatch.setattr(port_dncnn, "load_denoiser_params", load)
    den = demo.make_denoiser(torch.device("cpu"))
    assert (den.model_type, den.sigma_train) == ("DnCNN", 5.0)


def test_rgb_main_end_to_end_on_the_cpu(tmp_path):
    res = _port_driver("rgb_csmri").main(["--cpu", "--size", "32", "--eta", "100", "--n-outer", "3", "--t2", "4",
                                          "--mb", "128", "--out", str(tmp_path / "fig" / "rgb.png")])
    assert (tmp_path / "fig" / "rgb.png").stat().st_size > 1000
    assert res["recon"].shape == (32, 32, 3)
    assert res["psnr_recon"] > res["psnr_init"]
    assert all(r > i for r, i in zip(res["channels_recon"], res["channels_init"]))


@pytest.mark.parametrize("name", ["paper_csmri", "paper_deblur", "paper_pr", "pnp_csmri_demo", "rgb_csmri"])
def test_help_names_an_output_under_build_figures(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        _port_driver(name).parse_args(["--help"])
    assert exit_.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "--cpu" in text and "build/figures/" in text
    args = _port_driver(name).parse_args([])
    out = getattr(args, "save", None) or args.out
    assert "/build/figures/" in out
