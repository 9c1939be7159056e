"""Port parity for denoiser training: ``pnp_svrg_tpu_torch/training`` and the
training side of ``models/`` against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
the port's; a JAX start (Flax init, ``init_u``) is carried across as Flax
variables. Tolerances:

* the patch pipeline, the batches, the checkpoint files and the weight
  conversions: bitwise;
* a train step and ``train()``: f32 convolutions, BatchNorm statistics
  (Flax's ``E[x^2] - E[x]^2`` against torch's two-pass variance) and Adam
  (optax's and torch's rounding orders) differ in the last bits, so after 5
  steps losses agree to 1e-5 relative (measured: up to 1.6e-6),
  parameters, BatchNorm statistics and ``u_state`` to 5e-6 absolute
  (measured: up to 1.1e-6 on weights of order 0.2, a few ulps);
  ``train()``'s validation PSNR to 1e-4 dB and SSIM to 1e-5;
* the committed ``exp_realsn_noise40`` state at full width: sigmas to 1e-4
  relative of the JAX CPU values in ``train_realsn_noise40.npz`` (measured
  1.9e-5), one Set12 image's PSNR to 1e-3 dB and SSIM to 1e-4 (measured
  1.7e-5 dB, 1e-5).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnp_svrg_tpu.models.convert import load_flax_npz as jax_load_flax_npz
from pnp_svrg_tpu.models.convert import save_flax_npz as jax_save_flax_npz
from pnp_svrg_tpu.models.dncnn import DnCNN as JaxDnCNN
from pnp_svrg_tpu.models.spectral_norm import init_u as jax_init_u
from pnp_svrg_tpu.training import checkpoint as jax_checkpoint
from pnp_svrg_tpu.training import data as jax_data
from pnp_svrg_tpu.training import train_dncnn as jax_train
from pnp_svrg_tpu.training import utils as jax_utils
from pnp_svrg_tpu_torch.convert import (
    TRAIN_BATCH_SEED,
    TRAIN_DIR,
    TRAIN_EXP,
    TRAIN_SN_ITERS,
    TRAIN_STEPS,
    VAL_DIR,
    checksum,
    load_train_reference,
)
from pnp_svrg_tpu_torch.models import (
    DnCNN,
    flax_init_,
    flax_variables_from_torch,
    torch_state_dict_from_flax,
    u_state_from_flax,
    u_state_to_flax,
)
from pnp_svrg_tpu_torch.models.convert import flax_layers
from pnp_svrg_tpu_torch.models.dncnn import BatchNorm
from pnp_svrg_tpu_torch.models.spectral_norm import realsn_targets, sigma_uv
from pnp_svrg_tpu_torch.training import (
    ConfigMismatch,
    TrainConfig,
    adjust_ortho_decay_rate,
    batch_psnr,
    batch_ssim,
    evaluate,
    l2_reg_normal_ortho,
    load_checkpoint,
    save_checkpoint,
    train,
)
from pnp_svrg_tpu_torch.training import data
from pnp_svrg_tpu_torch.training.train_dncnn import (
    effective_variables,
    init_u_state,
    new_optimizer,
    sn_pairs,
    train_step,
)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, STATE_ATOL = 1e-5, 5e-6
PROBE = 12
tree_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs in
    several worker processes at once, and with a thread per core in each,
    torch's small CPU ops wait on each other's threads (this file's tests
    took up to 100x their single-process time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


def _jax_start(cfg_kw: dict, seed: int = 0):
    """A JAX training start: Flax init and the ``u`` probes, as the JAX
    ``train()`` makes them."""
    cfg = jax_train.TrainConfig(**cfg_kw)
    model = JaxDnCNN(channels=cfg.channels, depth=cfg.depth, features=cfg.features, use_bn=cfg.use_bn)
    key = jax.random.PRNGKey(seed)
    variables = dict(model.init(key, jnp.zeros((1, PROBE, PROBE, cfg.channels)), train=False))
    u_state = {name: jax_init_u(jax.random.fold_in(key, i), layer["kernel"].shape[-1], hw=cfg.sn_probe_hw)
               for i, (name, layer) in enumerate(variables["params"].items()) if name.startswith("Conv_")}
    return cfg, model, variables, u_state


def _port_start(cfg_kw: dict, variables, u_state):
    cfg = TrainConfig(**cfg_kw)
    model = DnCNN(cfg.channels, cfg.depth, cfg.features, cfg.use_bn)
    model.load_state_dict(torch_state_dict_from_flax(tree_np(variables), model))
    return cfg, model, u_state_from_flax(tree_np(u_state))


def _assert_trees_close(got: dict, want: dict, atol: float):
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert {p for p, _ in got_flat} == set(want_flat)
    for path, leaf in got_flat:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(want_flat[path]), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------- patch pipeline


@pytest.mark.parametrize("shape", [(60, 50), (57, 49), (40, 40), (41, 95)])
def test_im2patch_is_bitwise_the_jax_grid(shape):
    img = np.random.default_rng(shape[0]).uniform(0, 1, shape).astype(np.float32)
    got = data.im2patch(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, jax_data.im2patch(img))


def test_the_eight_augment_modes_are_bitwise_the_jax_modes():
    p = np.random.default_rng(0).uniform(0, 1, (7, 7)).astype(np.float32)
    for m in range(8):
        np.testing.assert_array_equal(data.augment(torch.from_numpy(p), m).numpy(), jax_data.augment(p, m))
    with pytest.raises(ValueError):
        data.augment(torch.from_numpy(p), 8)
    ps = np.random.default_rng(1).uniform(0, 1, (40, 9, 9)).astype(np.float32)
    modes = np.random.default_rng(2).integers(0, 8, 40).astype(np.uint8)
    want = np.stack([jax_data.augment(q, int(m)) for q, m in zip(ps, modes)])
    np.testing.assert_array_equal(data.augment_patches(torch.from_numpy(ps), modes).numpy(), want)


@pytest.mark.parametrize("augment", [True, False])
def test_build_patch_dataset_is_bitwise_the_jax_set(augment):
    """Two Set12 images at the four scales, with the JAX package's numpy (or
    native) path on the other side."""
    want = jax_data.build_patch_dataset(VAL_DIR, max_images=2, augment_modes=augment, seed=3)
    got = data.build_patch_dataset(VAL_DIR, max_images=2, augment_modes=augment, seed=3, device="cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sigma", [25 / 255.0, (0.0, 55 / 255.0)], ids=["mode_S", "mode_B"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_are_bitwise_the_jax_batches(sigma, drop_last):
    patches = np.random.default_rng(4).uniform(0, 1, (70, 16, 16)).astype(np.float32)
    want = list(jax_data.batches(patches, 16, sigma, seed=5, drop_last=drop_last))
    got = list(data.batches(torch.from_numpy(patches), 16, sigma, seed=5, drop_last=drop_last))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for (noisy, noise), (j_noisy, j_noise) in zip(got, want):
        assert noisy.shape == (len(j_noisy), 1, 16, 16)
        np.testing.assert_array_equal(noisy.permute(0, 2, 3, 1).numpy(), j_noisy)
        np.testing.assert_array_equal(noise.permute(0, 2, 3, 1).numpy(), j_noise)


def test_load_gray_is_the_jax_copy():
    for path in (VAL_DIR / "05.png", TRAIN_DIR / "3096.jpg"):
        for scale in (1.0, 0.7):
            np.testing.assert_array_equal(data.load_gray(path, scale), jax_data.load_gray(path, scale))


# ----------------------------------------------------------- model and weights


def test_flax_variables_round_trip_and_run_in_flax():
    """The port's weights in the Flax layout: the inverse of the loader,
    bitwise, and the Flax module on them gives the port's output."""
    model = flax_init_(DnCNN(1, 4, 8, True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.modules():
            if isinstance(layer, BatchNorm):
                layer.running_mean.normal_(0, 0.1)
                layer.running_var.uniform_(0.5, 2.0)
                layer.weight.normal_(1, 0.1)
    variables = flax_variables_from_torch(model)
    again = DnCNN(1, 4, 8, True)
    again.load_state_dict(torch_state_dict_from_flax(variables, again))
    for (ka, a), (kb, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    want = JaxDnCNN(channels=1, depth=4, features=8).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    assert set(flax_variables_from_torch(DnCNN(1, 3, 8, use_bn=False))) == {"params"}


def test_u_state_layout_round_trip():
    u = {f"Conv_{i}": np.random.default_rng(i).standard_normal((1, 5, 5, c)).astype(np.float32)
         for i, c in enumerate((8, 8, 1))}
    t = u_state_from_flax(u)
    assert t["Conv_0"].shape == (1, 8, 5, 5) and t["Conv_2"].shape == (1, 1, 5, 5)
    np.testing.assert_array_equal(t["Conv_1"][0, 3].numpy(), u["Conv_1"][0, :, :, 3])
    back = u_state_to_flax(t)
    for name in u:
        np.testing.assert_array_equal(back[name], u[name])


def test_flax_init_draws_lecun_normal_truncated():
    model = flax_init_(DnCNN(1, 5, 64, True), torch.Generator().manual_seed(1))
    for _, _, layer in flax_layers(model):
        if isinstance(layer, torch.nn.Conv2d):
            w = layer.weight.detach().numpy()
            std = np.sqrt(1.0 / (9 * layer.in_channels))
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
            if w.size > 1000:
                np.testing.assert_allclose(w.std(), std, rtol=0.05)
        else:
            assert torch.equal(layer.weight, torch.ones(64)) and torch.equal(layer.bias, torch.zeros(64))
            assert torch.equal(layer.running_mean, torch.zeros(64))
            assert torch.equal(layer.running_var, torch.ones(64))


def test_batchnorm_training_mode_is_flax_batchnorm():
    """Batch statistics normalise; the running statistics move by Flax's
    rule with the biased variance (``nn.BatchNorm2d`` would store the
    unbiased one, off by n / (n - 1): 2 x 6 x 7 = 84 here)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 6, 7, 5)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    mean0, var0 = rng.standard_normal(5).astype(np.float32), rng.uniform(0.5, 2, 5).astype(np.float32)
    flax_bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale)), bn.bias.copy_(torch.tensor(bias))
        bn.running_mean.copy_(torch.tensor(mean0)), bn.running_var.copy_(torch.tensor(var0))
    got = bn.train()(_nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    evaluated = bn.eval()(_nchw(x))
    want_eval = flax_nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(evaluated.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_eval), atol=2e-6)


# --------------------------------------------------------------- the train step

STEP_CASES = {
    "bn_lip": dict(use_bn=True, lip=0.5),
    "bn_lip_bnsn": dict(use_bn=True, lip=0.5, bn_sn=1.0),
    "nobn_lip": dict(use_bn=False, lip=0.5, sn_iters=3),
    "bn_nosn": dict(use_bn=True, lip=0.0),
    "adaptive": dict(use_bn=False, depth=3, adaptive_sigmas=(2.0, 1.0, 0.25)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """5 steps from one start on the same batches: losses, parameters,
    BatchNorm statistics and ``u_state``."""
    kw = dict(dict(depth=4, features=8, batch_size=4, sn_probe_hw=PROBE, noise_level=25.0), **STEP_CASES[case])
    jcfg, jmodel, jv, ju = _jax_start(kw)
    cfg, model, u_state = _port_start(kw, jv, ju)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=jcfg.lr)
    opt_state = tx.init(jv["params"])
    step = jax_train.make_train_step(jmodel, tx, jcfg)
    opt = new_optimizer(model, cfg.lr)
    patches = np.random.default_rng(8).uniform(0, 1, (20, 16, 16)).astype(np.float32)
    for noisy, noise in list(jax_data.batches(patches, 4, 25 / 255.0, seed=9))[:5]:
        jv, opt_state, ju, j_loss = step(jv, opt_state, ju, jnp.asarray(noisy), jnp.asarray(noise))
        loss = train_step(model, opt, u_state, _nchw(noisy), _nchw(noise), cfg)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    _assert_trees_close(flax_variables_from_torch(model), tree_np(jv), STATE_ATOL)
    _assert_trees_close(u_state_to_flax(u_state), tree_np(ju), STATE_ATOL)


@pytest.mark.parametrize("case", ["bn_lip_bnsn", "adaptive", "bn_nosn"])
def test_effective_variables_match_jax(case):
    kw = dict(dict(depth=4, features=8, batch_size=4, sn_probe_hw=PROBE), **STEP_CASES[case])
    jcfg, _, jv, ju = _jax_start(kw, seed=1)
    cfg, model, u_state = _port_start(kw, jv, ju)
    want = jax_train.effective_variables(jv, ju, jcfg, n_iters=25)
    eff = effective_variables(model, u_state, cfg, n_iters=25)
    assert not eff.training and not any(p.requires_grad for p in eff.parameters())
    _assert_trees_close(flax_variables_from_torch(eff), tree_np(want), 1e-6)
    # the raw model is left as it was
    _assert_trees_close(flax_variables_from_torch(model), tree_np(jv), 0.0)


def test_realsn_training_beats_zero_predictor():
    """The round-3 collapse regression of the JAX suite on the port: with the
    spectral norm in the forward pass (lip > 0, BatchNorm on), training goes
    far under the zero-residual loss ``HW sigma^2 / 2``."""
    sigma = 50.0
    cfg = TrainConfig(depth=3, features=8, use_bn=True, lip=0.5, noise_level=sigma, batch_size=16,
                      sn_probe_hw=16, lr=2e-3)
    gen = torch.Generator().manual_seed(0)
    model = flax_init_(DnCNN(1, 3, 8, True), gen)
    u_state = init_u_state(model, 16, gen)
    opt = new_optimizer(model, cfg.lr)
    rng = np.random.default_rng(0)
    xx, yy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    pool = np.stack([np.sin(5 * xx + p) * np.cos(4 * yy + q) * 0.4 + 0.5
                     for p in np.linspace(0, 3, 16) for q in np.linspace(0, 3, 16)]).astype(np.float32)
    losses = []
    for _ in range(200):
        clean = pool[rng.integers(0, len(pool), 16)][:, None]
        noise = (sigma / 255.0 * rng.standard_normal(clean.shape)).astype(np.float32)
        losses.append(float(train_step(model, opt, u_state, torch.tensor(clean + noise), torch.tensor(noise), cfg)))
    zero_pred = 16 * 16 * (sigma / 255.0) ** 2 / 2
    assert np.mean(losses[-10:]) < 0.6 * zero_pred, (np.mean(losses[-10:]), zero_pred)


# ---------------------------------------------------------------- checkpoints


def _tiny_state():
    rng = np.random.default_rng(11)
    return {
        "variables": {"params": {"Conv_0": {"kernel": rng.standard_normal((3, 3, 1, 4)).astype(np.float32)},
                                 "BatchNorm_0": {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}},
                      "batch_stats": {"BatchNorm_0": {"mean": np.zeros(4, np.float32),
                                                      "var": np.ones(4, np.float32)}}},
        "u_state": {"Conv_0": rng.standard_normal((1, 5, 5, 4)).astype(np.float32)},
        "epoch": 3,
    }


def _same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for name in a:
        if isinstance(a[name], dict):
            fa, fb = (dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in (a[name], b[name]))
            assert set(fa) == set(fb), name
            for path in fa:
                assert fa[path].dtype == fb[path].dtype
                np.testing.assert_array_equal(fa[path], fb[path])
        else:
            assert a[name] == b[name]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_round_trip_across_packages(tmp_path, writer):
    state, cfg = _tiny_state(), TrainConfig(depth=2).as_dict()
    save = save_checkpoint if writer == "port" else jax_checkpoint.save_checkpoint
    save(tmp_path / "exp", state, cfg)
    files = sorted(p.name for p in (tmp_path / "exp").iterdir())
    assert files == ["config.json", "meta.json", "u_state.npz", "variables.npz"]
    _same_state(load_checkpoint(tmp_path / "exp", cfg), state)
    _same_state(jax_checkpoint.load_checkpoint(tmp_path / "exp", cfg), state)
    with np.load(tmp_path / "exp" / "variables.npz") as f:
        assert "variables/params/Conv_0/kernel" in f.files
    assert json.loads((tmp_path / "exp" / "meta.json").read_text()) == {"epoch": 3}


def test_checkpoint_files_are_the_jax_files(tmp_path):
    """The same state written by both packages: the same config.json and
    meta.json bytes and the same arrays under the same keys."""
    state, cfg = _tiny_state(), TrainConfig(lip=0.3, adaptive_sigmas=(1.0, 2.0)).as_dict()
    save_checkpoint(tmp_path / "port", state, cfg)
    jax_checkpoint.save_checkpoint(tmp_path / "jax", state, cfg)
    for name in ("config.json", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for name in ("variables.npz", "u_state.npz"):
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_config_guard_and_missing_checkpoint(tmp_path):
    save_checkpoint(tmp_path / "exp", {"epoch": 1}, {"depth": 17})
    with pytest.raises(ConfigMismatch):
        save_checkpoint(tmp_path / "exp", {"epoch": 2}, {"depth": 20})
    with pytest.raises(ConfigMismatch):
        load_checkpoint(tmp_path / "exp", {"depth": 20})
    with pytest.raises(jax_checkpoint.ConfigMismatch):  # the JAX guard reads the port's config.json
        jax_checkpoint.load_checkpoint(tmp_path / "exp", {"depth": 20})
    assert load_checkpoint(tmp_path / "exp", {"depth": 17}) == {"epoch": 1}
    assert load_checkpoint(tmp_path / "nope") is None


def test_train_config_as_dict_is_the_jax_config():
    for kw in ({}, {"adaptive_sigmas": (5.0, 2.0, 1.0, 0.681, 0.464, 0.316), "depth": 6},
               {"mode": "B", "blind_range": (5.0, 30.0), "lip": 0.3}):
        assert TrainConfig(**kw).as_dict() == jax_train.TrainConfig(**kw).as_dict()
    assert json.loads((TRAIN_EXP / "config.json").read_text()) == TrainConfig(
        **json.loads((TRAIN_EXP / "config.json").read_text())).as_dict()


# ------------------------------------------------------------ train() end to end


def _dirs(tmp_path):
    """One Set12 image to train on and two to validate on."""
    train_dir, val_dir = tmp_path / "train", tmp_path / "val"
    train_dir.mkdir()
    val_dir.mkdir()
    shutil.copy(VAL_DIR / "05.png", train_dir)
    for name in ("01.png", "02.png"):
        shutil.copy(VAL_DIR / name, val_dir)
    return train_dir, val_dir


def test_train_end_to_end_matches_jax(tmp_path):
    """Both ``train()``s resume one JAX-written epoch-0 checkpoint and run 2
    epochs (the milestone drops the learning rate in the second) of 3 steps:
    the same histories, checkpoints that agree, and returned effective
    networks that agree."""
    kw = dict(depth=3, features=8, use_bn=True, lip=0.5, batch_size=4, epochs=2, milestone=1,
              noise_level=25.0, sn_probe_hw=PROBE)
    jcfg, _, jv, ju = _jax_start(kw, seed=2)
    train_dir, val_dir = _dirs(tmp_path)
    start = tmp_path / "start"
    jax_checkpoint.save_checkpoint(start, {"variables": jv, "u_state": ju, "epoch": 0}, jcfg.as_dict())
    shutil.copytree(start, tmp_path / "exp_jax")
    shutil.copytree(start, tmp_path / "exp_port")
    run = dict(train_dir=train_dir, val_dir=val_dir, max_steps_per_epoch=3, verbose=False)
    j_eff, j_hist = jax_train.train(jcfg, tmp_path / "exp_jax", **run)
    eff, hist = train(TrainConfig(**kw), tmp_path / "exp_port", device="cpu", **run)
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in j_hist] == [0, 1]
    for h, jh in zip(hist, j_hist):
        assert h.keys() == jh.keys() and h["lr"] == jh["lr"]
        np.testing.assert_allclose(h["train_loss"], jh["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(h["val_psnr"], jh["val_psnr"], atol=1e-4)
        np.testing.assert_allclose(h["val_ssim"], jh["val_ssim"], atol=1e-5)
    _assert_trees_close(flax_variables_from_torch(eff), tree_np(j_eff), STATE_ATOL)
    port_ckpt = jax_checkpoint.load_checkpoint(tmp_path / "exp_port", jcfg.as_dict())
    jax_ckpt = load_checkpoint(tmp_path / "exp_jax", TrainConfig(**kw).as_dict())
    assert port_ckpt["epoch"] == jax_ckpt["epoch"] == 2
    _assert_trees_close(port_ckpt["variables"], jax_ckpt["variables"], STATE_ATOL)
    _assert_trees_close(port_ckpt["u_state"], jax_ckpt["u_state"], STATE_ATOL)
    lines = (tmp_path / "exp_port" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    # Resumed at its end, nothing is left to do.
    assert train(TrainConfig(**kw), tmp_path / "exp_port", device="cpu", **run)[1] == []


def test_train_from_a_fresh_start_and_its_guard(tmp_path):
    """The port's own start (Flax's initial values from a seeded generator):
    a finite loss, the learning-rate drop, and the config guard."""
    cfg = TrainConfig(depth=3, features=8, use_bn=False, lip=1.0, batch_size=8, epochs=2, milestone=1,
                      noise_level=25.0, sn_probe_hw=PROBE, sn_iters=5)
    train_dir, val_dir = _dirs(tmp_path)
    run = dict(train_dir=train_dir, val_dir=val_dir, max_steps_per_epoch=4, verbose=False, device="cpu")
    eff, hist = train(cfg, tmp_path / "exp", **run)
    assert [h["lr"] for h in hist] == [cfg.lr, cfg.lr / 10]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    target = realsn_targets(cfg.lip, cfg.depth)[0]
    u_state = init_u_state(eff, 16, torch.Generator().manual_seed(0))
    for name, (u, v) in sn_pairs(eff, u_state, 60).items():
        layer = dict((n, lay) for n, _, lay in flax_layers(eff))[name]
        assert float(sigma_uv(layer.weight, u, v)) < target * 1.05, name
    with pytest.raises(ConfigMismatch):
        train(TrainConfig(**{**cfg.as_dict(), "epochs": 3, "blind_range": (0.0, 55.0)}), tmp_path / "exp", **run)


def test_train_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(TrainConfig(depth=3, features=8), tmp_path / "exp", verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.build_patch_dataset(VAL_DIR, max_images=1)


# ------------------------------------------------- the committed training state

@pytest.fixture(scope="module")
def committed():
    """The committed ``exp_realsn_noise40`` state through the port's loader,
    and the JAX CPU reference of ``train_realsn_noise40.npz``."""
    cfg = TrainConfig(**json.loads((TRAIN_EXP / "config.json").read_text()))
    ckpt = load_checkpoint(TRAIN_EXP, cfg.as_dict())
    model = DnCNN(cfg.channels, cfg.depth, cfg.features, cfg.use_bn)
    model.load_state_dict(torch_state_dict_from_flax(ckpt["variables"], model))
    return cfg, model, u_state_from_flax(ckpt["u_state"]), load_train_reference()


def test_effective_variables_of_the_committed_state_match_jax(committed):
    """At full width: the 17 sigmas and the effective kernels (the raw ones
    times target / the JAX sigma) against the JAX CPU run, and one Set12
    image denoised by the effective network against the JAX ``evaluate``."""
    cfg, model, u_state, ref = committed
    uv = sn_pairs(model, u_state, TRAIN_SN_ITERS)
    convs = [(name, layer) for name, _, layer in flax_layers(model) if isinstance(layer, torch.nn.Conv2d)]
    sigmas = np.array([sigma_uv(layer.weight, *uv[name]).item() for name, layer in convs])
    np.testing.assert_allclose(sigmas, ref["sigmas"], rtol=1e-4)
    eff = effective_variables(model, u_state, cfg)
    targets = realsn_targets(cfg.lip, cfg.depth)
    eff_convs = [layer for _, _, layer in flax_layers(eff) if isinstance(layer, torch.nn.Conv2d)]
    for (name, raw), layer, target, s in zip(convs, eff_convs, targets, ref["sigmas"]):
        np.testing.assert_allclose(layer.weight.numpy(), raw.weight.detach().numpy() * (target / s),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    psnr, ssim = evaluate(eff, [data.load_gray(sorted(VAL_DIR.glob("*.png"))[0])], float(ref["val_sigma"]))
    np.testing.assert_allclose(psnr, ref["val_psnr_per_image"][0], atol=1e-3)
    np.testing.assert_allclose(ssim, ref["val_ssim_per_image"][0], atol=1e-4)


def test_the_rgb_patch_set_and_first_batches_match_the_fixture():
    """The port's ``data/RGB`` patch set (on the CPU) and its first batches
    have the checksums of the JAX package's."""
    ref = load_train_reference()
    patches = data.build_patch_dataset(TRAIN_DIR, seed=0, device="cpu")
    assert len(patches) == int(ref["n_patches"]) and checksum(patches) == ref["patches_sha256"]
    bs = int(ref["batch_size"])
    perm = np.random.default_rng(TRAIN_BATCH_SEED).permutation(len(patches))
    gen = data.batches(patches, bs, 40.0 / 255.0, seed=TRAIN_BATCH_SEED)
    for b in range(TRAIN_STEPS):
        _, noise = next(gen)
        assert checksum(patches[perm[b * bs:(b + 1) * bs]]) == ref["batch_clean_sha256"][b]
        assert checksum(noise) == ref["batch_noise_sha256"][b]


# --------------------------------------------------------------------- utilities


def test_batch_metrics_match_jax():
    rng = np.random.default_rng(12)
    clean = rng.uniform(0, 1, (3, 1, 24, 24)).astype(np.float32)
    pred = np.clip(clean + 0.05 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(batch_psnr(torch.tensor(pred), torch.tensor(clean))),
                               float(jax_utils.batch_psnr(jnp.asarray(pred), jnp.asarray(clean))), atol=1e-4)
    np.testing.assert_allclose(float(batch_ssim(torch.tensor(pred), torch.tensor(clean))),
                               float(jax_utils.batch_ssim(jnp.asarray(pred), jnp.asarray(clean))), atol=1e-5)
    rgb_pred, rgb_clean = pred.repeat(3, axis=1), clean.repeat(3, axis=1)
    rgb_pred[:, 1] = clean[:, 0]
    np.testing.assert_allclose(float(batch_psnr(torch.tensor(rgb_pred), torch.tensor(rgb_clean))),
                               float(jax_utils.batch_psnr(jnp.asarray(rgb_pred), jnp.asarray(rgb_clean))), atol=1e-4)


def test_l2_reg_normal_ortho_matches_jax_on_its_probes():
    """The JAX regulariser on a Flax parameter tree; the port on the same
    kernels (torch layout) in the JAX leaves' order, with the JAX probes."""
    _, _, jv, _ = _jax_start(dict(depth=4, features=8, use_bn=True), seed=3)
    key = jax.random.PRNGKey(13)
    want = jax_utils.l2_reg_normal_ortho(jv["params"], key)
    leaves = [leaf for leaf in jax.tree_util.tree_leaves(jv["params"]) if leaf.ndim >= 2]
    keys = jax.random.split(key, len(leaves))
    probes = [torch.tensor(np.asarray(jax.random.normal(k, (int(np.prod(w.shape[:-1])),)))) for w, k in zip(leaves, keys)]
    weights = [torch.tensor(np.asarray(w)).permute(3, 2, 0, 1) for w in leaves]
    got = l2_reg_normal_ortho(weights, probes=probes)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    drawn = l2_reg_normal_ortho(weights, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(drawn)) and float(drawn) > 0


def test_adjust_ortho_decay_rate_is_the_jax_schedule():
    for epoch in range(0, 50):
        assert adjust_ortho_decay_rate(epoch, 0.7) == jax_utils.adjust_ortho_decay_rate(epoch, 0.7)


# ----------------------------------------------------------------------- script


def _options(main) -> set:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return {w.rstrip(",") for w in out.getvalue().split() if w.startswith("--")}


def test_train_realsn_script_with_cpu(tmp_path, monkeypatch):
    """The port's script takes the JAX script's arguments (and the image
    directories), trains with ``--cpu``, and ``--export`` writes Flax
    variables that the JAX loader and Flax module read."""
    import importlib.util

    from pnp_svrg_tpu_torch.examples import train_realsn

    spec = importlib.util.spec_from_file_location("jax_train_realsn", REPO / "examples" / "train_realsn.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_opts, port_opts = _options(jax_script.main), _options(train_realsn.main)
    assert jax_opts <= port_opts and port_opts - jax_opts == {"--train-dir", "--val-dir"}

    train_dir, val_dir = _dirs(tmp_path)
    monkeypatch.setattr(train_realsn, "EXPORT_DIR", tmp_path / "export")
    model, hist = train_realsn.main(["--exp", str(tmp_path / "exp"), "--layers", "3", "--features", "8",
                                     "--epochs", "1", "--max-steps", "2", "--batchSize", "8", "--lip", "0.5",
                                     "--cpu", "--train-dir", str(train_dir), "--val-dir", str(val_dir),
                                     "--export", "smoke"])
    assert len(hist) == 1 and np.isfinite(hist[0]["val_psnr"])
    variables = jax_load_flax_npz(tmp_path / "export" / "smoke.npz")
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 16, 1)).astype(np.float32)
    want = JaxDnCNN(channels=1, depth=3, features=8).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    # and a JAX-written export loads in the port's loader
    jax_save_flax_npz(variables, tmp_path / "jax_export.npz")
    from pnp_svrg_tpu_torch.denoisers.dncnn import flax_model
    from pnp_svrg_tpu_torch.models import load_flax_npz

    again = flax_model(DnCNN(1, 3, 8), load_flax_npz(tmp_path / "jax_export.npz"), "cpu")
    with torch.no_grad():
        torch.testing.assert_close(again(_nchw(x)), got, rtol=0, atol=0)
