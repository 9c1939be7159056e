"""Port parity for the CNN denoisers: ``models/dncnn.py``, the Flax weight
mapping of ``models/convert.py`` and ``denoisers/dncnn.py``.

The JAX package's Flax modules and denoisers (on the CPU) and the port's
(``device="cpu"``) run on the same inputs, made with numpy from a seed, and
the same weights: random Flax variables (with random BatchNorm statistics)
and the shipped ``checkpoints/*.npz``. Both sides convolve in f32 with other
summation orders; the stated tolerance is 1e-5 max abs on [0, 1] images
(the outputs are of order 1) and 2e-5 relative to the output's magnitude
for random weights, whose activations grow with depth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.denoisers.dncnn import DnCNNDenoiser as JaxDnCNNDenoiser
from pnp_svrg_tpu.denoisers.dncnn import MMODenoiser as JaxMMODenoiser
from pnp_svrg_tpu.denoisers.dncnn import load_denoiser_params as jax_load_denoiser_params
from pnp_svrg_tpu.models.dncnn import DnCNN as JaxDnCNN
from pnp_svrg_tpu.models.dncnn import MMOSimpleCNN as JaxMMOSimpleCNN
from pnp_svrg_tpu_torch.denoisers import DnCNNDenoiser, MMODenoiser
from pnp_svrg_tpu_torch.denoisers.dncnn import flax_model, load_denoiser_params
from pnp_svrg_tpu_torch.models import DnCNN, MMOSimpleCNN, model_for_type, torch_state_dict_from_flax
from pnp_svrg_tpu_torch.utils.io import load_image

TOL = 1e-5  # max abs on [0, 1] images


def _images(shape, seed=0):
    """Noisy crops of ``13.png`` in [0, 1]-ish, shaped (B, H, W)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    clean = np.stack([load_image(p, h, w) for p in ("13.png", "Set12/02.png", "Set12/05.png")][:b])
    return (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)


def _randomise_stats(variables, seed):
    """Random BatchNorm running statistics (Flax initialises mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    if "batch_stats" not in variables:
        return variables
    stats = {name: {"mean": jnp.asarray(0.1 * rng.standard_normal(v["mean"].shape), jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, v["var"].shape), jnp.float32)}
             for name, v in variables["batch_stats"].items()}
    return {**variables, "batch_stats": stats}


def _nhwc_to_nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2)


RANDOM_MODELS = {
    "dncnn_depth5": (lambda: JaxDnCNN(channels=1, depth=5), lambda: DnCNN(1, 5), 1),
    "simplecnn": (lambda: JaxDnCNN(channels=1, depth=4, use_bn=False),
                  lambda: DnCNN(1, 4, use_bn=False), 1),
    "mmo_depth4": (lambda: JaxMMOSimpleCNN(channels=1, depth=4), lambda: MMOSimpleCNN(1, 4), 1),
    "mmo_depth3_rgb": (lambda: JaxMMOSimpleCNN(channels=3, depth=3), lambda: MMOSimpleCNN(3, 3), 3),
}


@pytest.mark.parametrize("name", list(RANDOM_MODELS))
def test_models_match_flax_on_random_variables(name):
    make_jax, make_torch, ch = RANDOM_MODELS[name]
    jm = make_jax()
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 40, ch)).astype(np.float32)
    variables = _randomise_stats(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), seed=2)
    want = _nhwc_to_nchw(jm.apply(variables, jnp.asarray(x)))
    got = flax_model(make_torch(), variables, "cpu")(_nhwc_to_nchw(x))
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 2e-5 * want.abs().max(), (got - want).abs().max()


SHIPPED = ["realsn_dncnn_noise5", "dncnn_noise15", "simplecnn_noise5", "realsn_simplecnn_noise15",
           "mmo_dncnn_nobn_nch1_nlev0.01", "mmo_dncnn_nobn_nch3_nlev0.01"]


@pytest.mark.parametrize("name", SHIPPED)
def test_models_match_flax_on_the_shipped_checkpoints(name):
    variables = jax_load_denoiser_params(name)
    if name.startswith("mmo"):
        ch = 3 if "nch3" in name else 1
        jm, tm = JaxMMOSimpleCNN(channels=ch), MMOSimpleCNN(channels=ch)
        # One (H, W, 3) image for the colour network, as the MMO denoiser takes it.
        x = _images((3, 32, 32)).transpose(1, 2, 0)[None] if ch == 3 else _images((2, 32, 32))[..., None]
    else:
        kind = "DnCNN" if "dncnn" in name else "SimpleCNN"
        jm = JaxDnCNN(depth=17) if kind == "DnCNN" else JaxDnCNN(depth=4, use_bn=False)
        tm = model_for_type(kind)
        x = _images((2, 32, 32))[..., None]
    want = _nhwc_to_nchw(jm.apply(variables, jnp.asarray(x)))
    got = flax_model(tm, load_denoiser_params(name), "cpu")(_nhwc_to_nchw(x))
    assert (got - want).abs().max() <= TOL, (got - want).abs().max()


DNCNN_CASES = [("RealSN_DnCNN", 5), ("DnCNN", 15), ("SimpleCNN", 5), ("RealSN_SimpleCNN", 15)]


@pytest.mark.parametrize("batched", [False, True], ids=["hw", "bhw"])
@pytest.mark.parametrize("model_type,sigma", DNCNN_CASES)
def test_dncnn_denoiser_matches_jax(model_type, sigma, batched):
    x = _images((3, 48, 40))
    x = x if batched else x[0]
    want = np.asarray(JaxDnCNNDenoiser.from_pretrained(model_type, sigma).denoise(jnp.asarray(x)))
    den = DnCNNDenoiser.from_pretrained(model_type, sigma, device="cpu")
    got = den.denoise(torch.tensor(x), torch.tensor(0.3), torch.tensor(7)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # The sigma estimate and the step count are ignored.
    np.testing.assert_array_equal(got, den.denoise(torch.tensor(x)).numpy())


@pytest.mark.parametrize("channels,shape", [(1, (48, 40)), (1, (3, 48, 40)), (3, (48, 40, 3))],
                         ids=["hw", "bhw", "hwc"])
def test_mmo_denoiser_matches_jax(channels, shape):
    x = _images((3, 48, 40))
    x = {(48, 40): x[0], (3, 48, 40): x, (48, 40, 3): x.transpose(1, 2, 0)}[shape]
    x = x * 1.2 - 0.1  # both clips act
    want = np.asarray(JaxMMODenoiser.from_pretrained(channels, 0.01).denoise(jnp.asarray(x)))
    got = MMODenoiser.from_pretrained(channels, 0.01, device="cpu").denoise(torch.tensor(x)).numpy()
    assert got.shape == x.shape and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_weight_mapping_fails_loudly():
    variables = load_denoiser_params("simplecnn_noise5")
    model = model_for_type("SimpleCNN")
    extra = {**variables, "params": {**variables["params"], "Conv_4": variables["params"]["Conv_0"]}}
    with pytest.raises(KeyError, match="left over"):
        torch_state_dict_from_flax(extra, model)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "Conv_2"}}
    with pytest.raises(KeyError, match="Conv_2"):
        torch_state_dict_from_flax(missing, model)
    # A DnCNN checkpoint's BatchNorm variables do not fit SimpleCNN.
    with pytest.raises(KeyError, match="left over"):
        torch_state_dict_from_flax(load_denoiser_params("dncnn_noise15"), DnCNN(1, 17, use_bn=False))


def test_model_for_type_and_missing_checkpoints():
    assert model_for_type("RealSN_DnCNN").depth == 17 and model_for_type("DnCNN").use_bn
    assert model_for_type("RealSN_SimpleCNN").depth == 4 and not model_for_type("SimpleCNN").use_bn
    assert isinstance(model_for_type("DnCNN_nobn"), MMOSimpleCNN)
    with pytest.raises(ValueError, match="unknown model type"):
        model_for_type("resnet")
    with pytest.raises(FileNotFoundError):
        DnCNNDenoiser.from_pretrained("DnCNN", 7, device="cpu")
    assert DnCNNDenoiser.from_pretrained("RealSN_DnCNN", 5, device="cpu").sigma_train == 5.0
