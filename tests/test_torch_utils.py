"""The port's utilities (``pnp_svrg_tpu_torch/utils/``) against the JAX
package's ``pnp_svrg_tpu/utils/``: config, logging, profiling and the viz
and reporting helpers, on the CPU at small sizes."""

from __future__ import annotations

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pnp_svrg_tpu.utils as jax_utils
import pnp_svrg_tpu_torch.utils as port_utils
from pnp_svrg_tpu.algorithms import pnp_gd as jax_pnp_gd
from pnp_svrg_tpu.denoisers import TVDenoiser as JaxTVDenoiser
from pnp_svrg_tpu.problems import make_csmri as jax_make_csmri
from pnp_svrg_tpu.utils import config as jax_config
from pnp_svrg_tpu.utils import log as jax_log
from pnp_svrg_tpu.utils import profiling as jax_profiling
from pnp_svrg_tpu.utils import viz as jax_viz
from pnp_svrg_tpu_torch.convert import csmri_from_numpy
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.utils import config, log, profiling, viz
from pnp_svrg_tpu_torch.utils.io import resolve_data_path

CONFIG_CLASSES = ("ProblemConfig", "AlgorithmConfig", "DenoiserConfig", "MeshConfig", "SweepConfig",
                  "ExperimentConfig")
# reconstruct_rgb's mean RGB gain (reconstruction minus zero-filled PSNR,
# over the channels) over seeds 0-2 on each side: the problems' masks and
# noise come from different generators, and a single seed's gain spreads
# over 1.0-2.0 dB on either side (4.6-7.5 dB at this size), so the means
# are held within 1 dB.
RGB_GAIN_TOL_DB = 1.0
RGB_HP = dict(eta=100.0, n_outer=3, t2=4, mini_batch_size=128)



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

def test_export_list_is_the_jax_one_with_fence():
    assert port_utils.__all__ == jax_utils.__all__ + ["fence"]
    for name in port_utils.__all__:
        assert getattr(port_utils, name) is not None
    assert port_utils.REFERENCE_DATA_DIR.parts[-2:] == jax_utils.REFERENCE_DATA_DIR.parts[-2:]
    assert port_utils.SET12_DIR.parts[-2:] == jax_utils.SET12_DIR.parts[-2:]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal_the_jax_dataclasses(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
        [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def _custom(module):
    return module.ExperimentConfig(
        problem=module.ProblemConfig(kind="pr", image="Set12/04.png", h=64, w=64, num_meas=2048),
        algorithm=module.AlgorithmConfig(name="sarah", eta=0.05, variant="faithful", lr_decay=0.99),
        denoiser=module.DenoiserConfig(kind="dncnn", noise_level=15),
        mesh=module.MeshConfig(batch=2, meas=4),
        sweep=module.SweepConfig(max_evals=7, out_csv="build/x.csv"),
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_written_by_one_side_loads_in_the_other(tmp_path, writer):
    src, dst = (jax_config, config) if writer == "jax" else (config, jax_config)
    path = tmp_path / "exp.json"
    _custom(src).save(path)
    loaded = dst.ExperimentConfig.load(path)
    assert loaded == _custom(dst)
    assert loaded.to_dict() == _custom(src).to_dict()
    # Params: the same JSON layout both ways.
    src.Params({"lr": 1e-3, "epochs": 3, "nested": {"a": [1, 2]}}).save(tmp_path / "p.json")
    params = dst.Params(tmp_path / "p.json")
    assert params.dict == {"lr": 1e-3, "epochs": 3, "nested": {"a": [1, 2]}} and params.lr == 1e-3
    src.ExperimentConfig().save(tmp_path / "d.json")
    assert (tmp_path / "d.json").read_text() == json.dumps(dst.ExperimentConfig().to_dict(), indent=4, sort_keys=True)


@pytest.mark.parametrize("bad", [{"solver": {}}, {"problem": {"kind": "pr", "depth": 3}},
                                 {"algorithm": {"eta": 1.0, "n_iter": 5, "zz": 1}}])
def test_config_raises_the_same_value_errors(bad):
    with pytest.raises(ValueError) as theirs:
        jax_config.ExperimentConfig.from_dict(bad)
    with pytest.raises(ValueError) as ours:
        config.ExperimentConfig.from_dict(bad)
    assert str(ours.value) == str(theirs.value)


def test_params_behaves_as_the_jax_bag(tmp_path):
    p, q = config.Params({"a": 1}), jax_config.Params({"a": 1})
    p.b, q.b = 2, 2
    assert p.dict == q.dict and repr(p) == repr(q) and p == config.Params({"a": 1, "b": 2})
    (tmp_path / "u.json").write_text(json.dumps({"c": 3}))
    p.update(tmp_path / "u.json")
    assert p.c == 3 and config.Params.from_dict({"a": 1}) == config.Params({"a": 1})


def test_set_logger_is_idempotent_with_the_jax_formats(tmp_path):
    ours = log.set_logger(tmp_path / "sub" / "port.log", name="port_utils_test")
    again = log.set_logger(tmp_path / "sub" / "other.log", name="port_utils_test")
    theirs = jax_log.set_logger(tmp_path / "jax.log", name="jax_utils_test")
    try:
        assert again is ours and len(ours.handlers) == 2 and ours.level == logging.INFO
        assert [type(h) for h in ours.handlers] == [type(h) for h in theirs.handlers]
        assert [h.formatter._fmt for h in ours.handlers] == [h.formatter._fmt for h in theirs.handlers]
        ours.info("hello %d", 7)
        for h in ours.handlers:
            h.flush()
        text = (tmp_path / "sub" / "port.log").read_text()
        assert text.endswith(":INFO: hello 7\n") and not (tmp_path / "sub" / "other.log").exists()
    finally:
        for lg in (ours, theirs):
            for h in list(lg.handlers):
                h.close()
                lg.removeHandler(h)


def test_phase_timers_totals_counts_and_summary_equal_jax():
    ours, theirs = profiling.PhaseTimers(), jax_profiling.PhaseTimers()
    for name, sec in (("gradient", 0.25), ("denoise", 1.125), ("gradient", 0.5), ("psnr", 1e-4)):
        ours.add(name, sec)
        theirs.add(name, sec)
    assert ours.totals() == theirs.totals()
    assert ours.counts() == theirs.counts()
    assert ours.summary() == theirs.summary() == "gradient: 0.750s/2, denoise: 1.125s/1, psnr: 0.000s/1"


@pytest.mark.parametrize("mode", ["scalar", "block"])
def test_phase_timers_fence_modes_time_their_phases(mode):
    timers = profiling.PhaseTimers(fence_mode=mode)
    out = {}
    with timers.phase("matmul", fence=lambda: out["v"]):
        out["v"] = [torch.randn(64, 64) @ torch.randn(64, 64), {"c": torch.zeros(2, dtype=torch.complex64)}]
    with timers.phase("matmul", fence=out["v"]):
        pass
    with timers.phase("none"):
        pass
    assert timers.counts() == {"matmul": 2, "none": 1}
    assert all(v >= 0 for v in timers.totals().values())


def test_phase_timers_unknown_mode_raises_as_jax():
    with pytest.raises(ValueError) as theirs:
        jax_profiling.PhaseTimers(fence_mode="sync")
    with pytest.raises(ValueError) as ours:
        profiling.PhaseTimers(fence_mode="sync")
    assert str(ours.value) == str(theirs.value)


def test_trace_writes_a_file_naming_the_annotated_region(tmp_path):
    with profiling.trace(tmp_path / "tb") as prof:
        with profiling.annotate("bm3d_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "bm3d_region" for e in events)
    assert any(e.key == "bm3d_region" for e in prof.key_averages())


def test_scalar_fence_reads_one_element_of_each_tensor():
    reads = []

    class Probe(torch.Tensor):
        def reshape(self, *shape):
            reads.append(self.numel())
            return super().reshape(*shape)

    leaves = [torch.ones(3, 4).as_subclass(Probe), torch.zeros(5, dtype=torch.complex64).as_subclass(Probe),
              torch.empty(0).as_subclass(Probe), torch.tensor([True]).as_subclass(Probe)]
    assert profiling.scalar_fence({"a": leaves[0], "b": (leaves[1], [leaves[2], {"d": leaves[3]}]), "n": 3}) is None
    assert reads == [12, 5, 1]  # every tensor with elements, once; the empty one skipped


def _gd_run(n_iters=3):
    """A JAX pnp_gd run at 16 px (tests/test_viz.py's) and its problem."""
    xx, yy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    img = jnp.asarray(np.sin(4 * xx) * np.cos(3 * yy) * 0.4 + 0.5, jnp.float32)
    prob = jax_make_csmri(jax.random.PRNGKey(0), img, sample_prob=0.5, snr=10)
    out = jax_pnp_gd(prob, JaxTVDenoiser(sigma_modifier=0.7), eta=100.0, n_iters=n_iters)
    return prob, out


def _as_port(prob, out) -> tuple:
    """The JAX problem and output in the port's shapes: a one-lane CSMRI,
    ``z`` (1, N), ``image`` (1, H, W), ``psnr_per_iter`` (T, 1) tensors."""
    port_prob = csmri_from_numpy({k: np.asarray(getattr(prob, k))[None] for k in ("y", "mask", "x", "x_init")},
                                 device="cpu")
    trace = torch.tensor(np.asarray(out["psnr_per_iter"]))[:, None]
    return port_prob, {"z": torch.tensor(np.asarray(out["z"]))[None],
                       "image": torch.tensor(np.asarray(out["image"]))[None],
                       "psnr_per_iter": trace, "final_psnr": trace[-1], "algo_name": out["algo_name"]}


def test_summarize_results_and_metrics_csv_are_byte_identical(tmp_path):
    prob, out = _gd_run()
    port_prob, port_out = _as_port(prob, out)
    ours, theirs = viz.summarize_results(port_prob, port_out), jax_viz.summarize_results(prob, out)
    assert json.dumps(ours) == json.dumps(theirs)
    assert ours["n_iters"] == 3
    timed = dict(gradient_time=0.125, denoise_time=torch.tensor(0.5))
    ours = viz.summarize_results(port_prob, port_out | timed)
    theirs = jax_viz.summarize_results(prob, out | {k: float(v) for k, v in timed.items()})
    viz.write_metrics_csv([ours, ours], tmp_path / "port" / "m.csv")
    jax_viz.write_metrics_csv([theirs, theirs], tmp_path / "jax" / "m.csv")
    assert (tmp_path / "port" / "m.csv").read_bytes() == (tmp_path / "jax" / "m.csv").read_bytes()
    viz.write_metrics_csv([], tmp_path / "empty.csv")
    assert not (tmp_path / "empty.csv").exists()


def test_display_results_writes_the_figure_and_the_jax_csv(tmp_path):
    prob, out = _gd_run()
    port_prob, port_out = _as_port(prob, out)
    ours = viz.display_results(port_prob, port_out, save_results=True, save_dir=tmp_path / "port")
    theirs = jax_viz.display_results(prob, out, save_results=True, save_dir=tmp_path / "jax")
    assert json.dumps(ours) == json.dumps(theirs)  # NaN times compare as text
    assert (tmp_path / "port" / "run" / "PnP_GD.png").stat().st_size > 1000
    assert (tmp_path / "port" / "run" / "metrics.csv").read_bytes() == \
        (tmp_path / "jax" / "run" / "metrics.csv").read_bytes()


def test_show_grid_and_plot_training_curves_have_the_jax_axes(tmp_path):
    imgs = [torch.zeros(8, 8), torch.ones(8, 8), torch.full((8, 8), 0.5)]
    ours = viz.show_grid(imgs, titles=["a", "b", "c"], ncols=2)
    theirs = jax_viz.show_grid([i.numpy() for i in imgs], titles=["a", "b", "c"], ncols=2)
    assert len(ours.axes) == len(theirs.axes) == 4
    assert [a.get_title() for a in ours.axes] == [a.get_title() for a in theirs.axes]
    jsonl = tmp_path / "scalars.jsonl"
    with open(jsonl, "w") as f:
        for e in range(3):
            f.write(json.dumps({"epoch": e, "lr": 1e-3 / (10 if e >= 2 else 1), "train_loss": 1.0 / (e + 1),
                                "val_psnr": 30.0 + e, "val_ssim": 0.8 + 0.01 * e}) + "\n")
    fig = viz.plot_training_curves(jsonl, out_path=tmp_path / "curves" / "c.png")
    jfig = jax_viz.plot_training_curves(jsonl)
    assert (tmp_path / "curves" / "c.png").stat().st_size > 1000
    assert len(fig.axes) == len(jfig.axes) == 4
    assert [a.get_title() for a in fig.axes] == [a.get_title() for a in jfig.axes]
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="no records"):
        viz.plot_training_curves(tmp_path / "empty.jsonl")


def test_gif_is_byte_identical_to_jax(tmp_path):
    frames = [np.clip(np.random.default_rng(i).random((12, 10)) * 1.2 - 0.1, -0.1, 1.1).astype(np.float32)
              for i in range(4)]
    ours = viz.gif([torch.as_tensor(f) for f in frames], path=tmp_path / "port" / "a.gif", interval=80)
    theirs = jax_viz.gif([jnp.asarray(f) for f in frames], path=tmp_path / "jax" / "a.gif", interval=80)
    assert ours.read_bytes() == theirs.read_bytes()
    with Image.open(ours) as im:
        assert im.n_frames == 4
    path, html = viz.gif([torch.zeros(4, 4), torch.ones(4, 4)], path=tmp_path / "b.gif", html=True)
    assert path.exists() and "animation" in html.lower()
    assert "animation" in viz.gif([np.zeros((4, 4)), np.ones((4, 4))], html=True).lower()


def _rgb_image(size=32) -> np.ndarray:
    img = Image.open(resolve_data_path("RGB/12084.jpg")).convert("RGB")
    return np.asarray(img.resize((size, size)), np.float64) / 255.0


def _mean_gain(orig, init, recon) -> float:
    def psnr(a):
        return np.mean([-10 * np.log10(np.mean((a[..., c] - orig[..., c]) ** 2)) for c in range(3)])
    return float(psnr(recon) - psnr(init))


def test_reconstruct_rgb_improves_and_gains_as_the_jax_function():
    img = _rgb_image()
    ours, theirs = [], []
    for seed in range(3):
        orig, init, recon = viz.reconstruct_rgb(img, algo="svrg", denoiser=TVDenoiser(sigma_modifier=1.0),
                                                snr=30, seed=seed, device="cpu", **RGB_HP)
        assert orig.shape == init.shape == recon.shape == (32, 32, 3)
        np.testing.assert_array_equal(orig, img)
        assert 0.0 <= init.min() and recon.max() <= 1.0
        assert np.mean((recon - orig) ** 2) < np.mean((init - orig) ** 2)
        ours.append(_mean_gain(orig, init, recon))
        theirs.append(_mean_gain(*jax_viz.reconstruct_rgb(
            img, algo="svrg", denoiser=JaxTVDenoiser(sigma_modifier=1.0), snr=30, seed=seed, **RGB_HP)))
    assert abs(np.mean(ours) - np.mean(theirs)) <= RGB_GAIN_TOL_DB, (ours, theirs)
    # The seed names the problems and the run (TV is the default denoiser).
    first = viz.reconstruct_rgb(img, algo="svrg", snr=30, seed=1, device="cpu", **RGB_HP)
    again = viz.reconstruct_rgb(np.round(img * 255.0), algo="svrg", snr=30, seed=1, device="cpu", **RGB_HP)
    np.testing.assert_array_equal(again[1], first[1])
    np.testing.assert_array_equal(again[2], first[2])
