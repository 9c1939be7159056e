"""The committed headline fixtures match the JAX package's headline run.

``pnp_svrg_tpu_torch/data/headline_csmri_128.npz`` holds the 13 headline
CSMRI problems (Set12 with variable-density masks, keys
``split(PRNGKey(0), 12)``, plus ``13.png`` with the uniform mask and
``PRNGKey(0)``) exactly as ``bench.py`` builds them with the JAX package.
``headline_masks_key2.npz`` holds the minibatch masks that ``pnp_svrg``
draws in ``bench.py``'s timed runs (``PRNGKey(2)``), bit-packed along the
last axis. The port cannot replay JAX's key streams, so it reads the
problem data and, for runs comparable lane by lane, the masks from these
files.

``csmri_nlm_masks_key2.npz`` does the same for the CSMRI + NLM lane
(``bench.py:465-506``): the one-lane ``13.png`` problem run unbatched with
``PRNGKey(2)``, whose key chain has no per-lane ``fold_in``. Beside the masks
it stores that JAX run's PSNR trace and final SSIM (``NLMDenoiser`` on its
jnp path, on the CPU), against which the port's run on the card is held.

Regenerate all three with ``python tests/test_torch_fixture.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core.batched import BatchedProblem
from pnp_svrg_tpu.denoisers.nlm import NLMDenoiser as JaxNLMDenoiser
from pnp_svrg_tpu.ops.metrics import ssim as jax_ssim
from pnp_svrg_tpu.problems import make_csmri
from pnp_svrg_tpu.problems.csmri import CSMRI
from pnp_svrg_tpu.utils.io import load_image as jax_load_image
from pnp_svrg_tpu.utils.io import set12_paths
from pnp_svrg_tpu_torch.convert import (
    HEADLINE_FIXTURE,
    HEADLINE_MASKS,
    NLM_MASKS,
    load_headline_masks,
    load_headline_problems,
    load_nlm_masks,
    load_nlm_problem,
    load_nlm_reference,
    nlm_params,
)
from pnp_svrg_tpu_torch.utils.io import load_image

SIZE = 128
SET12_KEEP_LOW_FREQ = 4  # data/set12_csmri_tuned.json config.keep_low_freq
N_OUTER, T2, MINI_BATCH, MASK_KEY = 16, 10, 4000, 2  # bench.py headline run


def build_headline_arrays() -> dict:
    """The headline problems as bench.py builds them, as numpy arrays."""
    paths = [f"Set12/{p.name}" for p in set12_paths()] + ["13.png"]
    keys = list(jax.random.split(jax.random.PRNGKey(0), len(paths) - 1))
    keys.append(jax.random.PRNGKey(0))  # the flagship lane's fixed key
    keeps = [SET12_KEEP_LOW_FREQ] * (len(paths) - 1) + [0]
    probs = [
        make_csmri(k, jnp.asarray(jax_load_image(p, SIZE, SIZE)), sample_prob=0.5,
                   snr=10, keep_low_freq=kl)
        for k, p, kl in zip(keys, paths, keeps)
    ]
    stack = lambda name: np.stack([np.asarray(getattr(p, name)) for p in probs])  # noqa: E731
    return {
        "y": stack("y").astype(np.complex64),
        "mask": stack("mask").astype(np.uint8),
        "x_init": stack("x_init").astype(np.float32),
        "sigma": stack("sigma").astype(np.float32),
        "snr": stack("snr").astype(np.float32),
        "lanes": np.asarray([Path(p).name for p in paths]),
        "paths": np.asarray(paths),
        "keep_low_freq": np.asarray(keeps, np.int32),
        "x": stack("x").astype(np.float32),
    }


def build_headline_masks(mask: np.ndarray) -> np.ndarray:
    """(n_outer, t2, B, H, W/8) packed minibatch masks of pnp_svrg's key
    chain: ``k, k_mb = split(k)`` per inner step, then per lane
    ``fold_in(k_mb, lane)`` and ``select_mb``."""
    m = jnp.asarray(mask.astype(np.float32))
    b = m.shape[0]
    zeros = jnp.zeros(b)
    bp = BatchedProblem(CSMRI(y=m, mask=m, x=m, x_init=m, m0=m.sum((1, 2)), snr=zeros,
                              sigma=zeros, h=m.shape[1], w=m.shape[2]))
    select = jax.jit(lambda k: bp.select_mb(k, MINI_BATCH))
    k = jax.random.PRNGKey(MASK_KEY)
    out = []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(select(k_mb)).astype(bool))
    masks = np.stack(out).reshape((N_OUTER, T2) + m.shape)
    return np.packbits(masks, axis=-1)


def nlm_problem():
    """The CSMRI + NLM lane's unbatched problem as bench.py:486-490 builds it."""
    img = jnp.asarray(jax_load_image("13.png", SIZE, SIZE))
    return make_csmri(jax.random.PRNGKey(0), img, sample_prob=0.5, snr=10, keep_low_freq=0)


def build_nlm_masks(mask: np.ndarray) -> np.ndarray:
    """(n_outer, t2, 1, H, W/8) packed minibatch masks of the unbatched key
    chain: ``k, k_mb = split(k)`` per inner step, then ``select_mb(k_mb)``
    on the problem itself (no ``fold_in``)."""
    m = jnp.asarray(mask.astype(np.float32))
    prob = CSMRI(y=m, mask=m, x=m, x_init=m, m0=m.sum(), snr=0.0, sigma=0.0,
                 h=m.shape[0], w=m.shape[1])
    select = jax.jit(lambda k: prob.select_mb(k, MINI_BATCH))
    k = jax.random.PRNGKey(MASK_KEY)
    out = []
    for _ in range(N_OUTER * T2):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(select(k_mb)).astype(bool))
    masks = np.stack(out).reshape((N_OUTER, T2, 1) + m.shape)
    return np.packbits(masks, axis=-1)


def run_jax_nlm() -> dict:
    """The JAX CSMRI + NLM lane (data/csmri_nlm_tuned.json, PRNGKey(2)) on
    its jnp NLM path: PSNR trace and final SSIM."""
    cfg = nlm_params()
    prob = nlm_problem()
    out = jax_pnp_svrg(
        prob, JaxNLMDenoiser(sigma_modifier=cfg["sigma_modifier"], use_pallas=False),
        eta=cfg["eta"], n_outer=cfg["n_outer"], t2=cfg["t2"], mini_batch_size=cfg["mini_batch_size"],
        lr_decay=cfg["lr_decay"], key=jax.random.PRNGKey(MASK_KEY),
    )
    return {"psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            "ssim": np.float32(jax_ssim(prob.x, out["image"]))}


@pytest.fixture(scope="module")
def rebuilt():
    return build_headline_arrays()


def test_fixture_matches_jax_headline_problems(rebuilt):
    with np.load(HEADLINE_FIXTURE) as f:
        committed = {k: f[k] for k in f.files}
    assert set(committed) == set(rebuilt) - {"x"}
    for name, arr in committed.items():
        assert arr.dtype == rebuilt[name].dtype, name
        np.testing.assert_array_equal(arr, rebuilt[name], err_msg=name)
    # The flagship lane keeps the reference's uniform mask; Set12 lanes keep
    # the low-frequency block.
    assert committed["mask"][:-1, 0, 0].all()


def test_masks_fixture_matches_jax_key_chain(rebuilt):
    with np.load(HEADLINE_MASKS) as f:
        committed = f["masks"]
    np.testing.assert_array_equal(committed, build_headline_masks(rebuilt["mask"]))
    masks = load_headline_masks(device="cpu")
    assert masks.shape == (N_OUTER, T2, 13, SIZE, SIZE) and masks.dtype == torch.float32
    assert torch.all(masks <= torch.as_tensor(rebuilt["mask"], dtype=torch.float32))


def test_port_load_image_is_bit_identical(rebuilt):
    for path, x in zip(rebuilt["paths"], rebuilt["x"]):
        np.testing.assert_array_equal(load_image(str(path), SIZE, SIZE), x)


def test_load_headline_problems_on_cpu(rebuilt):
    prob, lanes = load_headline_problems(device="cpu")
    assert lanes == list(rebuilt["lanes"])
    assert prob.y.shape == (13, SIZE, SIZE) and prob.y.dtype.is_complex
    np.testing.assert_array_equal(prob.x.numpy(), rebuilt["x"])
    np.testing.assert_array_equal(prob.y.numpy(), rebuilt["y"])
    np.testing.assert_array_equal(prob.mask.numpy(), rebuilt["mask"].astype(np.float32))
    np.testing.assert_array_equal(prob.m0.numpy(), rebuilt["mask"].sum(axis=(1, 2)))


def test_nlm_masks_fixture_matches_unbatched_key_chain():
    prob = nlm_problem()
    with np.load(NLM_MASKS) as f:
        committed = f["masks"]
    np.testing.assert_array_equal(committed, build_nlm_masks(np.asarray(prob.mask)))
    masks = load_nlm_masks(device="cpu")
    assert masks.shape == (N_OUTER, T2, 1, SIZE, SIZE) and masks.dtype == torch.float32
    lane_mask = torch.tensor(np.asarray(prob.mask), dtype=torch.float32)
    assert torch.all(masks <= lane_mask)
    assert torch.all(masks.sum(dim=(-2, -1)) == MINI_BATCH)


def test_nlm_problem_is_the_bench_lane():
    want = nlm_problem()
    got = load_nlm_problem(device="cpu")
    assert got.y.shape == (1, SIZE, SIZE)
    np.testing.assert_array_equal(got.y[0].numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.x_init[0].numpy(), np.asarray(want.x_init))
    cfg = nlm_params()
    assert (cfg["eta"], cfg["sigma_modifier"], cfg["lr_decay"]) == (7000.0, 1.2, 1.0)
    assert cfg["etas"] == [3500.0, 5000.0, 7000.0] and cfg["mods"] == [1.2, 1.45, 1.7]


def test_nlm_reference_trace_is_a_fresh_jax_run():
    ref = load_nlm_reference()
    assert ref["psnr_per_iter"].shape == (1 + N_OUTER * (T2 + 1),)
    assert np.isfinite(ref["psnr_per_iter"]).all() and 0 < ref["ssim"] <= 1
    fresh = run_jax_nlm()  # the whole 16 x 10 run: about 15 s on the CPU
    np.testing.assert_allclose(ref["psnr_per_iter"], fresh["psnr_per_iter"], atol=1e-4)
    np.testing.assert_allclose(ref["ssim"], fresh["ssim"], atol=1e-5)


if __name__ == "__main__":
    arrays = build_headline_arrays()
    arrays.pop("x")  # rebuilt by the port's load_image
    HEADLINE_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(HEADLINE_FIXTURE, **arrays)
    np.savez_compressed(HEADLINE_MASKS, masks=build_headline_masks(arrays["mask"]))
    ref = run_jax_nlm()
    np.savez_compressed(NLM_MASKS, masks=build_nlm_masks(np.asarray(nlm_problem().mask)), **ref)
    for path in (HEADLINE_FIXTURE, HEADLINE_MASKS, NLM_MASKS):
        print(f"wrote {path} ({path.stat().st_size} bytes)", file=sys.stderr)
    print(f"JAX CSMRI + NLM: final PSNR {ref['psnr_per_iter'][-1]:.4f} dB, "
          f"SSIM {float(ref['ssim']):.4f}", file=sys.stderr)
