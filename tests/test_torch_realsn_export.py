"""The port's RealSN export checker
(``pnp_svrg_tpu_torch/examples/check_realsn_export.py``) against what the
JAX package's ``tools/check_realsn_export.py`` computes, through the JAX
functions that tool calls (its ``main`` writes beside the checkpoint, so
neither it nor anything that writes under ``checkpoints/`` runs here).

A narrow synthetic RealSN-DnCNN (depth 5, 8 features, BatchNorm) is checked
end to end on both sides; the committed ``realsn_dncnn_noise5.npz`` is held
to the stored JAX CPU run (``realsn_export_jax.npz``) on the port's own start
vectors and on the first Set12 images (the full Set12 mean is held on the
card by ``chip_smoke.py``).
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.models.dncnn import DnCNN as JaxDnCNN
from pnp_svrg_tpu.models.spectral_norm import conv_power_iteration as jax_conv_power_iteration
from pnp_svrg_tpu.models.spectral_norm import init_u as jax_init_u
from pnp_svrg_tpu_torch.convert import VAL_DIR, load_realsn_export_reference
from pnp_svrg_tpu_torch.denoisers.dncnn import CHECKPOINT_DIR
from pnp_svrg_tpu_torch.examples import check_realsn_export as checker
from pnp_svrg_tpu_torch.models.convert import save_flax_npz
from test_torch_fixture import REPO, jax_driver, jax_evaluate_per_image

TINY_DEPTH, TINY_FEATURES, TINY_NAME, LIP = 5, 8, "realsn_tiny_noise15", 0.3
# 60 f32 power-iteration steps whose convolutions sum in another order on
# each side (oneDNN's conv and conv_transpose2d against XLA's conv and its
# vjp) part by about 20 ulps (1.2e-6 relative measured): the tolerance of
# the power iteration's own parity test, tests/test_torch_spectral_norm.py.
SIGMA_RTOL = 1e-5
# 60 power-iteration steps stop short of a layer's norm by up to about 0.5 %,
# by how much depending on the start vector (noise5's Conv_0 from the
# port's first start: 0.92618 after 60 steps, 0.93118 after 2000), so the
# port's own start vectors and JAX's give estimates 2.6e-3 apart there.
OWN_START_RTOL = 5e-3
EXPORT = "realsn_dncnn_noise5"
N_VAL = 3  # the first Set12 images (256 px) of the committed export's check


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    return jax_driver("check_realsn_export", "tools")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A depth-5, 8-feature RealSN-DnCNN in the Flax layout, each kernel
    scaled to 0.99 of its per-layer target; the JAX tool's start vectors
    (``init_u(PRNGKey(100 * i + r))``, NHWC) and a validation directory of
    two Set12 images."""
    root = tmp_path_factory.mktemp("realsn")
    model = JaxDnCNN(channels=1, depth=TINY_DEPTH, features=TINY_FEATURES, use_bn=True)
    variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))))
    target = LIP ** (1.0 / TINY_DEPTH)
    inits = []
    for i in range(TINY_DEPTH):
        kern = jnp.asarray(variables["params"][f"Conv_{i}"]["kernel"])
        sigma, _ = jax_conv_power_iteration(kern, jax_init_u(jax.random.PRNGKey(7), kern.shape[-1]), 300)
        variables["params"][f"Conv_{i}"]["kernel"] = np.asarray(kern * (0.99 * target / sigma), np.float32)
        inits.append([np.asarray(jax_init_u(jax.random.PRNGKey(100 * i + r), kern.shape[-1], hw=40))
                      for r in range(3)])
    save_flax_npz(variables, root / "ckpt" / f"{TINY_NAME}.npz")
    val = root / "val"
    val.mkdir()
    for p in sorted(VAL_DIR.glob("*.png"))[:2]:
        shutil.copy(p, val / p.name)
    return {"dir": root / "ckpt", "val": val, "variables": variables, "inits": inits, "target": target}


def _as_nchw(inits) -> list:
    return [[torch.from_numpy(u.transpose(0, 3, 1, 2).copy()) for u in us] for us in inits]


def test_tiny_export_sigmas_match_jax_on_jax_start_vectors(tiny):
    rec = checker.check(TINY_NAME, LIP, dense_probe=6, device="cpu", checkpoint_dir=tiny["dir"],
                        val_dir=tiny["val"], inits=_as_nchw(tiny["inits"]))
    want = []
    for i, us in enumerate(tiny["inits"]):
        kern = jnp.asarray(tiny["variables"]["params"][f"Conv_{i}"]["kernel"])
        want.append(max(float(jax_conv_power_iteration(kern, jnp.asarray(u), n_iters=60)[0]) for u in us))
    np.testing.assert_allclose(rec["per_layer_sigma"], want, rtol=SIGMA_RTOL)
    assert rec["ok"] and rec["layers_over_target"] == []
    assert rec["per_layer_target"] == pytest.approx(tiny["target"], rel=1e-12)
    assert rec["lipschitz_product_bound"] == pytest.approx(np.prod(rec["per_layer_sigma"]), rel=1e-12)
    assert list(rec["dense_valid_svd"]) == ["0", "1", "2", "4"]  # the first 3 layers and the last


def test_tiny_export_validation_matches_jax(tiny):
    rec = checker.check(TINY_NAME, LIP, dense_probe=6, device="cpu", checkpoint_dir=tiny["dir"],
                        val_dir=tiny["val"], inits=_as_nchw(tiny["inits"]))
    model = JaxDnCNN(channels=1, depth=TINY_DEPTH, features=TINY_FEATURES, use_bn=True)
    images = [checker.load_gray(p) for p in sorted(tiny["val"].glob("*.png"))]
    want = jax_evaluate_per_image(model, jax.tree_util.tree_map(jnp.asarray, tiny["variables"]), images, 15 / 255.0)
    assert rec["noise_sigma"] == 15.0 and rec["val_set"] == "val (2 images)"
    assert abs(rec["val_psnr_db"] - want[:, 0].mean()) <= 1e-3
    assert abs(rec["val_ssim"] - want[:, 1].mean()) <= 1e-5


@pytest.mark.parametrize("layer", range(TINY_DEPTH))
def test_dense_svd_at_a_small_probe_is_the_jax_tools_bit_for_bit(tiny, jax_tool, layer):
    kern = tiny["variables"]["params"][f"Conv_{layer}"]["kernel"]
    mat = checker.unroll_multi(kern, 6)
    want = jax_tool.unroll_multi(kern, 6)
    assert mat.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(mat, want)
    assert checker.dense_sigma(kern, 6, "cpu") == np.linalg.svd(want, compute_uv=False)[0]


def test_a_layer_over_its_target_fails_the_check(tiny, tmp_path):
    variables = jax.tree_util.tree_map(np.copy, tiny["variables"])
    variables["params"]["Conv_3"]["kernel"] *= 1.2
    save_flax_npz(variables, tmp_path / f"{TINY_NAME}.npz")
    rec = checker.check(TINY_NAME, LIP, dense_probe=6, device="cpu", checkpoint_dir=tmp_path,
                        val_dir=tiny["val"], inits=_as_nchw(tiny["inits"]))
    assert not rec["ok"] and rec["layers_over_target"] == [3]
    with pytest.raises(SystemExit, match="VIOLATED"):
        checker.main([TINY_NAME, "--cpu", "--dense-probe", "6", "--checkpoint-dir", str(tmp_path),
                      "--val-dir", str(tiny["val"]), "--out-dir", str(tmp_path / "out")])


def test_main_writes_its_record_under_out_dir_and_nothing_under_checkpoints(tiny, tmp_path):
    before = {p: p.stat().st_mtime_ns for p in CHECKPOINT_DIR.rglob("*")}
    rec = checker.main([TINY_NAME, "--cpu", "--dense-probe", "6", "--checkpoint-dir", str(tiny["dir"]),
                        "--val-dir", str(tiny["val"]), "--out-dir", str(tmp_path / "out")])
    assert {p: p.stat().st_mtime_ns for p in CHECKPOINT_DIR.rglob("*")} == before
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [f"{TINY_NAME}.val.json"]
    assert not (tiny["dir"] / f"{TINY_NAME}.val.json").exists()
    assert rec["ok"]
    # By default the record goes under build/, never beside the checkpoint.
    assert checker.OUT_DIR == REPO / "build" / "realsn_export"
    assert checker.CHECKPOINT_DIR == REPO / "checkpoints"


def test_committed_export_sigmas_on_the_port_generator_are_jaxs():
    """Every layer of ``realsn_dncnn_noise5.npz`` on the port's own start
    vectors (a generator seeded 100 i + r) against the JAX tool's sigmas on
    its PRNGKey(100 i + r) start vectors, stored by the fixture."""
    variables = checker.load_flax_npz(CHECKPOINT_DIR / f"{EXPORT}.npz")
    kernels = checker.conv_kernels(variables)
    got = checker.layer_sigmas(kernels, checker.restart_inits(kernels, "cpu"))
    want = load_realsn_export_reference(EXPORT)["sigmas"]
    assert len(got) == len(want) == 17
    np.testing.assert_allclose(got, want, rtol=OWN_START_RTOL)
    assert max(got) <= checker.realsn_target(LIP, 17) * checker.LAYER_SLACK


def test_committed_export_validation_on_the_first_set12_images_is_jaxs(tmp_path):
    """The first :data:`N_VAL` Set12 images (their noise draws are the first
    of the sequence) against the JAX CPU evaluation's per-image values."""
    for p in sorted(VAL_DIR.glob("*.png"))[:N_VAL]:
        shutil.copy(p, tmp_path / p.name)
    variables = checker.load_flax_npz(CHECKPOINT_DIR / f"{EXPORT}.npz")
    model = checker.flax_model(checker.DnCNN(channels=1, depth=17, use_bn=True), variables, "cpu")
    images = [checker.load_gray(p) for p in sorted(tmp_path.glob("*.png"))]
    psnr, ssim = checker.evaluate(model, images, 5 / 255.0, seed=checker.VAL_SEED)
    ref = load_realsn_export_reference(EXPORT)
    assert abs(psnr - ref["val_psnr_per_image"][:N_VAL].mean()) <= 1e-3
    assert abs(ssim - ref["val_ssim_per_image"][:N_VAL].mean()) <= 1e-5
