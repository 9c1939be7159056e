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
jnp path, on the CPU), against which the port's run on the card is held,
and the trace of a 10-iteration JAX ``pnp_gd`` on the same problem, which
holds the port's ``pnp_gd`` on the card.

``deblur_256.npz`` holds the two Deblur lanes (``bench.py:602-717``) as
``make_deblur(PRNGKey(0), ...)`` builds them (``y``, ``x_init``, ``sigma``,
``snr``; for the SR lane also its kernel ``b``, since PIL's default
resampling of ``kernel25.png`` depends on the Pillow version), each lane's
minibatch masks of the unbatched ``PRNGKey(2)`` chain, bit-packed, and each
lane's JAX CPU run's PSNR trace and SSIM; the SR lane's run takes its own
matcher rounding (``matcher="pallas_interpret"``, bf16: the Pallas matcher,
interpreted on the CPU).

``pr_bm3d_128.npz`` holds the PR + BM3D lane (``bench.py:508-542``) on a
matrix A drawn from ``numpy.random.RandomState(4)`` (``convert.pr_matrix``;
A itself is 537 MB and is rebuilt on load): the JAX package's ``y``
(noise from the second half of ``split(PRNGKey(4))``, as
``make_phase_retrieval`` splits its key) and ``x_init`` (its
``spectral_init``) for that A, A's checksum, the minibatch row indices of
the unbatched ``PRNGKey(5)`` chain, and the JAX CPU run's PSNR trace and
SSIM.

``pr_sarah_realsn_128.npz`` holds the PR + SARAH + RealSN-DnCNN lane
(``bench.py:544-600``): 8 replicas of the PR fixture's problem (its ``y`` and
``x_init`` on the ``RandomState(4)`` A), the replicas' minibatch row indices
of the batched ``PRNGKey(5)`` chain (``k, k_mb = split(k)`` per inner step,
then ``fold_in(k_mb, lane)`` per lane), and the JAX CPU ``pnp_sarah`` run's
(1 + n_outer*(t2+1), 8) PSNR trace and per-replica SSIM. That run stacks A
8 times (4.3 GB).

``train_realsn_noise40.npz`` holds the JAX CPU run on the committed raw
training state ``checkpoints/exp_realsn_noise40/`` (RealSN-DnCNN, depth 17,
64 features, BatchNorm, lip 0.3, sigma 40): the 17 per-layer sigmas after 30
power iterations from its ``u_state``, ``evaluate``'s Set12 PSNR/SSIM per
image and their means, the losses of 3 steps from the raw state with a fresh
Adam at lr 1e-4 on the first 3 batches (seed 0, 128 patches) of the
``data/RGB`` patch set, and SHA-256 checksums of that patch set and of each
batch's clean patches and noise.

``paper_drivers.npz`` holds what the five paper and demo drivers
(``examples/paper_csmri.py``, ``paper_deblur.py``, ``paper_pr.py``,
``pnp_csmri_demo.py``, ``rgb_csmri.py``) do on the JAX package's CPU: the
problems of paper_csmri (``make_csmri(PRNGKey(3), 13.png 128, 0.5, snr=10)``)
and of the demo (``PRNGKey(0)``, 256 px, SNR 30) as ``csmri_from_numpy``
takes them (the mask bit-packed, the image rebuilt by ``load_image``);
SHA-256 checksums of paper_deblur's ``y`` and ``x_init``, which are those of
``deblur_256.npz``'s ``deblur_bm3d`` lane (not stored again); every row's
final PSNR and SSIM and each table's init PSNR, under each driver's default
flags and under ``--eta-scale ref`` / ``--config ref``; the PSNR traces of
the deterministic anchor rows (paper_csmri's ``gd`` under both tables,
paper_deblur's ``gd+bm3d``, the demo's ``PnP-GD``); and rgb_csmri's
per-channel PSNRs at its defaults. Each driver's ``main`` runs as the user
would run it, its loops recorded on the way (:func:`recorded_jax_loops`).

``set12_uniform_csmri_128.npz`` holds ``bench.py``'s set12_uniform lane
(``bench.py:402-463``): the headline's keys with ``keep_low_freq=0`` on every
lane, laid out as the headline fixture, plus the JAX CPU run of the lane
(``PRNGKey(2)``; its (177, 13) PSNR trace and per-lane SSIM);
``set12_uniform_masks_key2.npz`` that run's minibatch masks, as the
headline's. ``headline_variants_jax.npz`` holds the JAX CPU runs of the
f32_match and search12 lanes (``bench.py:384-400``) on the headline
problems. ``realsn_export_jax.npz`` holds what ``tools/check_realsn_export.py``
computes for the three committed RealSN-DnCNN exports, through the JAX
functions it calls (per-layer sigmas, dense singular values, Set12 PSNR and
SSIM per image).

Regenerate them all with ``python tests/test_torch_fixture.py``, or some
with ``python tests/test_torch_fixture.py headline nlm deblur pr pr_sarah
train drivers uniform variants realsn_export`` (the Deblur reference runs
take about 10 minutes on the CPU, the PR one 10, the PR + SARAH one 5, the
training one 2, the drivers one about 20, the last three about 25
together).
``python tests/test_torch_fixture.py --cpu-lanes [deblur pr_sarah pr]``
writes nothing: it runs the port's plain CPU path on the Deblur, PR and
PR + SARAH lanes' fixture problems and JAX minibatches against the stored
JAX traces, both sides' PR + SARAH lane with ``x_init`` one ulp down and
up, and both sides' PR lane with ``y`` or ``x_init`` one ulp up, to show how
far rounding alone moves those lanes' results (about an hour).
``python tests/test_torch_fixture.py --cpu-anchors`` writes nothing either:
it runs the drivers' anchor rows on the port's plain CPU path, on the JAX
drivers' problems, against the stored JAX traces, and paper_csmri's
``auto`` ``gd`` row on both sides with ``x_init`` one ulp down and up (a few
minutes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import itertools
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.algorithms.loops import pnp_gd as jax_pnp_gd
from pnp_svrg_tpu.algorithms.loops import pnp_sarah as jax_pnp_sarah
from pnp_svrg_tpu.algorithms.loops import pnp_svrg as jax_pnp_svrg
from pnp_svrg_tpu.core.batched import BatchedProblem
from pnp_svrg_tpu.core.batched import stack_problems as jax_stack_problems
from pnp_svrg_tpu.core.problem import minmax_normalize as jax_minmax_normalize
from pnp_svrg_tpu.core.problem import resolve_noise as jax_resolve_noise
from pnp_svrg_tpu.denoisers.bm3d import BM3DDenoiser as JaxBM3DDenoiser
from pnp_svrg_tpu.denoisers.bm3d import BM3DParams as JaxBM3DParams
from pnp_svrg_tpu.denoisers.bm3d import bm3d_denoise_batch as jax_bm3d_denoise_batch
from pnp_svrg_tpu.denoisers.dncnn import DnCNNDenoiser as JaxDnCNNDenoiser
from pnp_svrg_tpu.denoisers.nlm import NLMDenoiser as JaxNLMDenoiser
from pnp_svrg_tpu.ops.metrics import ssim as jax_ssim
from pnp_svrg_tpu.problems import make_csmri
from pnp_svrg_tpu.problems import make_deblur as jax_make_deblur
from pnp_svrg_tpu.problems.csmri import CSMRI
from pnp_svrg_tpu.problems.pr import PhaseRetrieval as JaxPhaseRetrieval
from pnp_svrg_tpu.problems.pr import _dot as jax_dot
from pnp_svrg_tpu.problems.pr import spectral_init as jax_spectral_init
from pnp_svrg_tpu.models.convert import load_flax_npz as jax_load_flax_npz
from pnp_svrg_tpu.models.dncnn import DnCNN as JaxDnCNN
from pnp_svrg_tpu.models.spectral_norm import conv_power_iteration as jax_conv_power_iteration
from pnp_svrg_tpu.models.spectral_norm import init_u as jax_init_u
from pnp_svrg_tpu.models.spectral_norm import power_iteration_uv as jax_power_iteration_uv
from pnp_svrg_tpu.models.spectral_norm import sigma_uv as jax_sigma_uv
from pnp_svrg_tpu.ops.metrics import psnr as jax_psnr
from pnp_svrg_tpu.ops.sigma import estimate_sigma as jax_estimate_sigma
from pnp_svrg_tpu.training import data as jax_train_data
from pnp_svrg_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from pnp_svrg_tpu.training.train_dncnn import TrainConfig as JaxTrainConfig
from pnp_svrg_tpu.training.train_dncnn import effective_variables as jax_effective_variables
from pnp_svrg_tpu.training.train_dncnn import evaluate as jax_evaluate
from pnp_svrg_tpu.training.train_dncnn import make_train_step as jax_make_train_step
from pnp_svrg_tpu.utils.io import load_image as jax_load_image
from pnp_svrg_tpu.utils.io import resolve_data_path as jax_resolve_data_path
from pnp_svrg_tpu.utils.io import set12_paths
import pnp_svrg_tpu
from pnp_svrg_tpu.utils import viz as jax_viz
from pnp_svrg_tpu_torch.convert import (
    BENCH_LANES,
    BM3D_PROFILE_LANE,
    CSMRI_BATCH_LANES,
    ENVELOPE_FIXTURE,
    HEADLINE_VARIANTS_FIXTURE,
    NLM_SKIMAGE,
    UNIFORM_FIXTURE,
    UNIFORM_MASKS,
    DEBLUR_FIXTURE,
    DEBLUR_LANES,
    HEADLINE_FIXTURE,
    HEADLINE_MASKS,
    NLM_MASKS,
    PR_CHECK_ENTRIES,
    PR_FIXTURE,
    PR_SARAH_FIXTURE,
    PR_SEED,
    REALSN_EXPORT_FIXTURE,
    PAPER_ANCHORS,
    PAPER_DRIVERS_FIXTURE,
    PAPER_PROBLEMS,
    PAPER_TABLES,
    TRAIN_BATCH_SEED,
    TRAIN_DIR,
    TRAIN_EXP,
    TRAIN_FIXTURE,
    TRAIN_SN_ITERS,
    TRAIN_STEP_LR,
    TRAIN_STEPS,
    VAL_DIR,
    bench_config,
    checksum,
    lane_params,
    load_batch_lane_reference,
    load_deblur_masks,
    load_deblur_problem,
    load_deblur_reference,
    load_envelope_reference,
    load_headline_masks,
    load_headline_problems,
    load_nlm_gd_reference,
    load_nlm_masks,
    load_nlm_problem,
    load_nlm_reference,
    load_pr_indices,
    load_pr_problem,
    load_pr_reference,
    load_pr_sarah_indices,
    load_pr_sarah_problem,
    load_pr_sarah_reference,
    load_train_reference,
    load_uniform_masks,
    load_uniform_problems,
    nlm_params,
    pr_matrix_blocks,
)
from pnp_svrg_tpu_torch.denoisers.dncnn import CHECKPOINT_DIR
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.deblur import load_kernel_image
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image

SIZE = 128
SET12_KEEP_LOW_FREQ = 4  # data/set12_csmri_tuned.json config.keep_low_freq
N_OUTER, T2, MINI_BATCH, MASK_KEY = 16, 10, 4000, 2  # bench.py headline run


def headline_jax_problems(set12_keep: int = SET12_KEEP_LOW_FREQ) -> tuple[list, list, list]:
    """(problems, paths, keep_low_freq per lane) of the 13-lane CSMRI batch as
    bench.py builds it (``bench.py:187-199``): the Set12 lanes on
    ``split(PRNGKey(0), 12)`` with ``keep_low_freq=set12_keep``, ``13.png``
    on ``PRNGKey(0)`` with the uniform mask. ``set12_keep=0`` gives the
    set12_uniform lane's problems (``bench.py:417-423``)."""
    paths = [f"Set12/{p.name}" for p in set12_paths()] + ["13.png"]
    keys = list(jax.random.split(jax.random.PRNGKey(0), len(paths) - 1))
    keys.append(jax.random.PRNGKey(0))  # the flagship lane's fixed key
    keeps = [set12_keep] * (len(paths) - 1) + [0]
    probs = [
        make_csmri(k, jnp.asarray(jax_load_image(p, SIZE, SIZE)), sample_prob=0.5,
                   snr=10, keep_low_freq=kl)
        for k, p, kl in zip(keys, paths, keeps)
    ]
    return probs, paths, keeps


def build_headline_arrays(set12_keep: int = SET12_KEEP_LOW_FREQ) -> dict:
    """The headline problems as bench.py builds them, as numpy arrays (with
    ``set12_keep=0``, the set12_uniform lane's)."""
    probs, paths, keeps = headline_jax_problems(set12_keep)
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


def run_jax_batch_lane(lane: str, probs: list, lanes: list) -> dict:
    """One of :data:`CSMRI_BATCH_LANES` (or ``"bm3d_profile"``,
    :data:`BM3D_PROFILE_LANE`) as bench.py runs it with the JAX package on
    the CPU: per-lane (eta, sigma_modifier) from its tuned JSON, its
    ``BM3DParams``, PnP-SVRG 16 x 10, minibatch 4000, ``PRNGKey(2)`` (the
    key chain :func:`build_headline_masks` replays). Returns the
    (1 + n_outer*(t2+1), B) PSNR trace and the per-lane final SSIM."""
    tuned, default_eta, default_mod, p = (BM3D_PROFILE_LANE if lane == "bm3d_profile"
                                          else CSMRI_BATCH_LANES[lane])
    eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cpu")
    batched = jax_stack_problems(probs)
    den = JaxBM3DDenoiser(sigma_modifier=jnp.asarray(mod.numpy()),
                          params=JaxBM3DParams(**dataclasses.asdict(p)))
    out = jax_pnp_svrg(batched, den, eta=jnp.asarray(eta.numpy()), n_outer=N_OUTER, t2=T2,
                       mini_batch_size=MINI_BATCH, key=jax.random.PRNGKey(MASK_KEY))
    return {"psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            "ssim": np.asarray(jax.vmap(jax_ssim)(batched.x, out["image"]), np.float32)}


def jax_first_bm3d_call(probs: list, lanes: list) -> dict:
    """One JAX BM3D call at :data:`BM3D_PROFILE_LANE`'s parameters on each
    headline lane's first denoise input as the JAX loop forms it: ``x_init``
    after one full-gradient step with the lane's eta (``v = mu`` there), and
    sigma the estimate times the lane's modifier."""
    tuned, default_eta, default_mod, p = BM3D_PROFILE_LANE
    eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cpu")
    batched = jax_stack_problems(probs)
    x = batched.x_init
    z = x - jnp.asarray(eta.numpy())[:, None, None] * batched.grad_full(x)
    sigma = jax_estimate_sigma(z) * jnp.asarray(mod.numpy())
    denoise = jax.jit(jax_bm3d_denoise_batch, static_argnames=("params", "stages"))
    out = denoise(z, sigma, params=JaxBM3DParams(**dataclasses.asdict(p)))
    return {"first_input": np.asarray(z, np.float32), "first_sigma": np.asarray(sigma, np.float32),
            "first_output": np.asarray(out, np.float32)}


def run_jax_nlm_skimage() -> dict:
    """The CSMRI + NLM lane (its tuned configuration, ``PRNGKey(2)``) with
    :data:`NLM_SKIMAGE`'s patch size and distance, on the JAX NLM's jnp
    path: PSNR trace and final SSIM."""
    cfg = nlm_params()
    prob = nlm_problem()
    den = JaxNLMDenoiser(sigma_modifier=cfg["sigma_modifier"], use_pallas=False, **NLM_SKIMAGE)
    out = jax_pnp_svrg(prob, den, eta=cfg["eta"], n_outer=cfg["n_outer"], t2=cfg["t2"],
                       mini_batch_size=cfg["mini_batch_size"], lr_decay=cfg["lr_decay"],
                       key=jax.random.PRNGKey(MASK_KEY))
    return {"psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            "ssim": np.float32(jax_ssim(prob.x, out["image"]))}


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


NLM_GD_ITERS = 10  # the short pnp_gd run stored beside the NLM masks


def run_jax_nlm_gd() -> dict:
    """JAX ``pnp_gd`` on the CSMRI + NLM lane's problem and denoiser (jnp
    NLM path) at the tuned eta, ``NLM_GD_ITERS`` iterations."""
    cfg = nlm_params()
    out = jax_pnp_gd(nlm_problem(), JaxNLMDenoiser(sigma_modifier=cfg["sigma_modifier"], use_pallas=False),
                     eta=cfg["eta"], n_iters=NLM_GD_ITERS)
    return {"gd_eta": np.float32(cfg["eta"]), "gd_n_iters": np.int64(NLM_GD_ITERS),
            "gd_psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32)}


def deblur_problem(lane: str):
    """A Deblur lane's unbatched JAX problem as bench.py builds it."""
    cfg = BENCH_LANES[lane]
    size = cfg["size"]
    kernel = cfg["kernel"]
    if kernel.endswith(".png"):
        kernel = str(jax_resolve_data_path(kernel))
    img = jnp.asarray(jax_load_image(cfg["image"], size, size))
    return jax_make_deblur(jax.random.PRNGKey(0), img, kernel=kernel,
                           scale_percent=cfg["scale_percent"], snr=cfg["snr"])


def unbatched_chain(select, n_outer: int, t2: int, key: int) -> np.ndarray:
    """(n_outer, t2, 1, ...) minibatches of pnp_svrg's unbatched key chain:
    ``k, k_mb = split(k)`` per inner step, then ``select(k_mb)``."""
    select = jax.jit(select)
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(n_outer * t2):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(select(k_mb)))
    return np.stack(out).reshape((n_outer, t2, 1) + out[0].shape)


def deblur_masks(lane: str, prob) -> np.ndarray:
    """A Deblur lane's packed (n_outer, t2, 1, M/8) masks (PRNGKey(2))."""
    cfg = bench_config(lane)
    masks = unbatched_chain(lambda k: prob.select_mb(k, cfg["mini_batch_size"]),
                            cfg["n_outer"], cfg["t2"], MASK_KEY)
    return np.packbits(masks.astype(bool), axis=-1)


def build_deblur_arrays() -> dict:
    """Both Deblur lanes' problem arrays and packed masks, keyed
    ``"<lane>/<field>"``."""
    arrays = {}
    for lane in DEBLUR_LANES:
        prob = deblur_problem(lane)
        arrays[f"{lane}/y"] = np.asarray(prob.y, np.float32)
        arrays[f"{lane}/x_init"] = np.asarray(prob.x_init, np.float32)
        arrays[f"{lane}/sigma"] = np.float32(prob.sigma)
        arrays[f"{lane}/snr"] = np.float32(prob.snr)
        if BENCH_LANES[lane]["kernel"] != "Minimal":
            arrays[f"{lane}/b"] = np.asarray(prob.b, np.float32)
        arrays[f"{lane}/masks"] = deblur_masks(lane, prob)
    return arrays


def run_jax_deblur(lane: str = "deblur_bm3d") -> dict:
    """A JAX Deblur lane (its tuned JSON, PRNGKey(2)) on the CPU: PSNR trace
    and final SSIM. The Minimal lane takes the f32 XLA matcher; the SR lane's
    Pallas matcher runs interpreted, in its own bf16 rounding."""
    cfg = bench_config(lane)
    p = cfg["params"]
    prob = deblur_problem(lane)
    matcher = "pallas_interpret" if p.matcher == "pallas" else p.matcher
    den = JaxBM3DDenoiser(sigma_modifier=cfg["sigma_modifier"], params=JaxBM3DParams(
        search=p.search, search_step=p.search_step, matcher=matcher, match_dtype=p.match_dtype))
    out = jax_pnp_svrg(prob, den, eta=cfg["eta"], n_outer=cfg["n_outer"], t2=cfg["t2"],
                       mini_batch_size=cfg["mini_batch_size"], lr_decay=cfg["lr_decay"],
                       key=jax.random.PRNGKey(MASK_KEY))
    return {f"{lane}/psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            f"{lane}/ssim": np.float32(jax_ssim(prob.x, out["image"]))}


PR_NOISE_KEY, PR_MB_KEY = 4, 5  # bench.py:520-531


def pr_matrix_numpy() -> tuple[np.ndarray, dict]:
    """The PR lane's A (8192 x 16384 float32) and its checksum, summed block
    by block as ``convert.pr_matrix`` sums it."""
    cfg = BENCH_LANES["pr_bm3d"]
    blocks = [blk for _, blk in pr_matrix_blocks(PR_SEED, cfg["num_meas"], cfg["size"] ** 2)]
    total = 0.0
    for blk in blocks:
        total += float(blk.sum(dtype=np.float64))
    a = np.concatenate(blocks)
    return a, {"a_sum": np.float64(total),
               "a_entries": np.asarray([a[r, c] for r, c in PR_CHECK_ENTRIES], np.float64)}


def pr_problem(a: np.ndarray) -> JaxPhaseRetrieval:
    """The JAX PhaseRetrieval of the PR lane on ``a``: what
    ``make_phase_retrieval(PRNGKey(4), Set12/04, 8192, snr=20)`` does after
    drawing its own A, with the JAX package's ``_dot``, ``resolve_noise``,
    ``spectral_init`` and ``minmax_normalize``."""
    cfg = BENCH_LANES["pr_bm3d"]
    size = cfg["size"]
    x = jnp.asarray(jax_load_image(cfg["image"], size, size))
    aj = jnp.asarray(a)
    y0 = jnp.abs(jax_dot(aj, x.ravel()))
    snr, sig = jax_resolve_noise(y0, size, size, cfg["snr"], None)
    _, k_noise = jax.random.split(jax.random.PRNGKey(PR_NOISE_KEY))
    y = y0 + sig * jax.random.normal(k_noise, y0.shape)
    xi = jax_spectral_init(aj, y, jnp.linalg.norm(x.ravel()))
    return JaxPhaseRetrieval(
        a=aj, y=y.astype(jnp.float32), x=x,
        x_init=jax_minmax_normalize(xi).reshape(size, size).astype(jnp.float32),
        snr=jnp.asarray(float(snr), jnp.float32), sigma=jnp.asarray(float(sig), jnp.float32),
        h=size, w=size, num_meas=cfg["num_meas"],
    )


def pr_indices(m: int) -> np.ndarray:
    """(n_outer, t2, 1, k) int16 row indices of the PR lane's unbatched
    PRNGKey(5) chain."""
    cfg = bench_config("pr_bm3d")
    prob = JaxPhaseRetrieval(a=None, y=None, x=None, x_init=None, num_meas=m)
    idx = unbatched_chain(lambda k: prob.select_mb(k, cfg["mini_batch_size"]),
                          cfg["n_outer"], cfg["t2"], PR_MB_KEY)
    return idx.astype(np.int16)


def run_jax_pr(prob) -> dict:
    """The JAX PR + BM3D lane (data/pr_tuned.json, PRNGKey(5)) on the CPU."""
    cfg = bench_config("pr_bm3d")
    den = JaxBM3DDenoiser(sigma_modifier=cfg["sigma_modifier"], params=JaxBM3DParams(search=8))
    out = jax_pnp_svrg(prob, den, eta=cfg["eta"], n_outer=cfg["n_outer"], t2=cfg["t2"],
                       mini_batch_size=cfg["mini_batch_size"], lr_decay=cfg["lr_decay"],
                       key=jax.random.PRNGKey(PR_MB_KEY))
    return {"psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            "ssim": np.float32(jax_ssim(prob.x, out["image"]))}


def build_pr_arrays() -> dict:
    """The PR fixture's arrays, the JAX reference run included."""
    a, check = pr_matrix_numpy()
    prob = pr_problem(a)
    return {
        "seed": np.int64(PR_SEED), **check,
        "y": np.asarray(prob.y, np.float32), "x_init": np.asarray(prob.x_init, np.float32),
        "sigma": np.float32(prob.sigma), "snr": np.float32(prob.snr),
        "indices": pr_indices(a.shape[0]), **run_jax_pr(prob),
    }


def pr_fixture_problem(a: np.ndarray) -> JaxPhaseRetrieval:
    """The JAX PhaseRetrieval of the PR lane on ``a`` with the PR fixture's
    ``y``, ``x_init``, ``snr`` and ``sigma`` (what :func:`pr_problem` made)."""
    cfg = BENCH_LANES["pr_bm3d"]
    size = cfg["size"]
    with np.load(PR_FIXTURE) as f:
        data = {k: f[k] for k in ("y", "x_init", "snr", "sigma")}
    return JaxPhaseRetrieval(
        a=jnp.asarray(a), y=jnp.asarray(data["y"]), x=jnp.asarray(jax_load_image(cfg["image"], size, size)),
        x_init=jnp.asarray(data["x_init"]), snr=jnp.asarray(data["snr"]), sigma=jnp.asarray(data["sigma"]),
        h=size, w=size, num_meas=cfg["num_meas"])


def pr_sarah_indices(m: int) -> np.ndarray:
    """(n_outer, t2, replicas, k) int16 row indices of the PR + SARAH lane's
    batched PRNGKey(5) chain: ``k, k_mb = split(k)`` per inner step (SARAH's
    outer round draws none), then ``BatchedProblem.select_mb``, which takes
    ``fold_in(k_mb, lane)`` per lane."""
    cfg = bench_config("pr_sarah_realsn")
    r, k_mb_size = cfg["replicas"], cfg["mini_batch_size"]
    prob = BatchedProblem(JaxPhaseRetrieval(a=None, y=jnp.zeros((r, m)), x=None, x_init=None,
                                            snr=jnp.zeros(r), sigma=jnp.zeros(r), num_meas=m))
    select = jax.jit(lambda k: prob.select_mb(k, k_mb_size))
    k = jax.random.PRNGKey(PR_MB_KEY)
    out = []
    for _ in range(cfg["n_outer"] * cfg["t2"]):
        k, k_mb = jax.random.split(k)
        out.append(np.asarray(select(k_mb)))
    return np.stack(out).reshape((cfg["n_outer"], cfg["t2"], r, k_mb_size)).astype(np.int16)


def run_jax_pr_sarah(prob) -> dict:
    """The JAX PR + SARAH + RealSN-DnCNN lane as bench.py runs it: ``replicas``
    copies of ``prob`` stacked (A 8 times), data/pr_sarah_realsn_tuned.json,
    PRNGKey(5), on the CPU: the (T, replicas) PSNR trace and per-replica SSIM."""
    cfg = bench_config("pr_sarah_realsn")
    batch = jax_stack_problems([prob] * cfg["replicas"])
    den = JaxDnCNNDenoiser.from_pretrained("RealSN_DnCNN", sigma=cfg["realsn_sigma"])
    out = jax_pnp_sarah(batch, den, eta=cfg["eta"], n_outer=cfg["n_outer"], t2=cfg["t2"],
                        mini_batch_size=cfg["mini_batch_size"], lr_decay=cfg["lr_decay"],
                        key=jax.random.PRNGKey(PR_MB_KEY), variant=cfg["variant"])
    return {"psnr_per_iter": np.asarray(out["psnr_per_iter"], np.float32),
            "ssim": np.asarray(jax.vmap(jax_ssim)(batch.x, out["image"]), np.float32)}


def build_pr_sarah_arrays() -> dict:
    """The PR + SARAH fixture's arrays, the JAX reference run included."""
    a, _ = pr_matrix_numpy()
    return {"indices": pr_sarah_indices(a.shape[0]), **run_jax_pr_sarah(pr_fixture_problem(a))}


REPO = Path(__file__).resolve().parents[1]
JAX_LOOPS = ("pnp_gd", "pnp_sgd", "pnp_svrg", "pnp_saga", "pnp_sarah")


def jax_driver(name: str, folder: str = "examples"):
    """The JAX package's script ``<folder>/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{folder}_{name}", REPO / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recorded_jax_loops(stub=None):
    """The JAX package's ``pnp_svrg_tpu.pnp_{gd,sgd,svrg,saga,sarah}`` (which
    the drivers import inside ``main``) replaced by recorders for the block.
    Yields the list of calls ``(loop, problem, denoiser, kwargs, output)``
    in call order; each recorder runs the real loop, or returns
    ``stub(loop, problem, kwargs)`` when ``stub`` is given."""
    calls = []
    real = {n: getattr(pnp_svrg_tpu, n) for n in JAX_LOOPS}

    def recorder(name):
        def run(problem, denoiser, **kw):
            out = real[name](problem, denoiser, **kw) if stub is None else stub(name, problem, kw)
            calls.append((name, problem, denoiser, kw, out))
            return out
        return run

    try:
        for name in JAX_LOOPS:
            setattr(pnp_svrg_tpu, name, recorder(name))
        yield calls
    finally:
        for name, fn in real.items():
            setattr(pnp_svrg_tpu, name, fn)


def run_jax_driver(driver: str, argv: list, out_dir, stub=None) -> tuple:
    """(row names, recorded calls, result) of the JAX driver's ``main`` with
    ``--cpu`` and ``argv``; the demo's figure goes into ``out_dir``."""
    extra = ["--out", str(Path(out_dir) / f"{driver}.png")] if driver == "pnp_csmri_demo" else []
    with recorded_jax_loops(stub) as calls:
        result = jax_driver(driver).main(["--cpu", *argv, *extra])
    return row_names(driver, result), calls, result


def row_names(driver: str, result) -> list:
    """The row names, in order, of what a driver's ``main`` returns (either
    package's): the demo's dict keys, paper_csmri's algorithms ("PnP GD" ->
    "gd"), the other drivers' ``run`` fields."""
    if driver == "pnp_csmri_demo":
        return list(result)
    if driver == "paper_csmri":
        return [r["algorithm"].split()[-1].lower() for r in result]
    return [r["run"] for r in result]


def run_jax_rgb(argv: list, out_dir) -> tuple:
    """(original, zero-filled, reconstruction) of the JAX rgb_csmri's
    ``main`` with ``--cpu`` and ``argv``, recorded from its
    ``reconstruct_rgb`` call; the figure goes into ``out_dir``."""
    got = []
    real = jax_viz.reconstruct_rgb

    def recorder(*args, **kw):
        got.append(real(*args, **kw))
        return got[-1]

    jax_viz.reconstruct_rgb = recorder
    try:
        jax_driver("rgb_csmri").main(["--cpu", *argv, "--out", str(Path(out_dir) / "rgb.png")])
    finally:
        jax_viz.reconstruct_rgb = real
    return got[0]


def channel_psnrs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(3,) PSNRs of (H, W, 3) ``a`` against ``b``, as rgb_csmri prints them."""
    return np.asarray([-10 * np.log10(float(np.mean((a[..., c] - b[..., c]) ** 2))) for c in range(3)])


def build_drivers_arrays() -> dict:
    """The drivers' fixture arrays (see the module docstring)."""
    import time

    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for driver, tables in PAPER_TABLES.items():
            for table, argv in tables.items():
                t0 = time.time()
                names, calls, _ = run_jax_driver(driver, argv, tmp)
                prob = calls[0][1]
                key = f"{driver}/{table}"
                arrays[f"{key}/rows"] = np.asarray(names)
                arrays[f"{key}/init_psnr"] = np.float32(prob.psnr(prob.x_init))
                for name, (_, p, _, _, out) in zip(names, calls):
                    arrays[f"{key}/{name}/final_psnr"] = np.float32(out["final_psnr"])
                    arrays[f"{key}/{name}/final_ssim"] = np.float32(jax_ssim(p.x, out["image"]))
                    if PAPER_ANCHORS.get((driver, table)) == name:
                        arrays[f"{key}/{name}/psnr_per_iter"] = np.asarray(out["psnr_per_iter"], np.float32)
                if driver in PAPER_PROBLEMS:
                    arrays |= {f"{driver}/{k}": v for k, v in csmri_arrays(prob).items()}
                if driver == "paper_deblur":
                    for name in ("y", "x_init"):
                        arrays[f"paper_deblur/{name}_sha256"] = np.asarray(checksum(np.asarray(getattr(prob, name))))
                del calls, prob
                print(f"JAX {key}: init {float(arrays[f'{key}/init_psnr']):.4f} dB, rows "
                      + ", ".join(f"{n} {float(arrays[f'{key}/{n}/final_psnr']):.4f}" for n in names)
                      + f" ({time.time() - t0:.0f} s)", file=sys.stderr, flush=True)
        orig, init, recon = run_jax_rgb([], tmp)
    arrays["rgb_csmri/default/channels_init"] = channel_psnrs(init, orig)
    arrays["rgb_csmri/default/channels_recon"] = channel_psnrs(recon, orig)
    return arrays


def csmri_arrays(prob) -> dict:
    """A one-lane JAX CSMRI's fields as ``load_paper_csmri_problem`` reads
    them: the mask bit-packed, no image."""
    return {"mask": np.packbits(np.asarray(prob.mask).astype(bool), axis=-1),
            "y": np.asarray(prob.y, np.complex64), "x_init": np.asarray(prob.x_init, np.float32),
            "m0": np.float32(prob.m0), "snr": np.float32(prob.snr), "sigma": np.float32(prob.sigma)}


def jax_train_state():
    """The committed raw training state through the JAX package's loader:
    (config, model, variables, u_state)."""
    cfg = JaxTrainConfig(**json.loads((TRAIN_EXP / "config.json").read_text()))
    ckpt = jax_load_checkpoint(TRAIN_EXP, cfg.as_dict())
    model = JaxDnCNN(channels=cfg.channels, depth=cfg.depth, features=cfg.features, use_bn=cfg.use_bn)
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    return cfg, model, as_jnp(ckpt["variables"]), as_jnp(ckpt["u_state"])


def jax_train_sigmas(variables, u_state) -> np.ndarray:
    """Per conv (``Conv_0`` .. ``Conv_16``), sigma of the raw kernel after
    :data:`TRAIN_SN_ITERS` power iterations from the stored ``u``."""
    out = []
    for i in range(len(u_state)):
        kernel = variables["params"][f"Conv_{i}"]["kernel"]
        u, v = jax_power_iteration_uv(kernel, u_state[f"Conv_{i}"], TRAIN_SN_ITERS)
        out.append(float(jax_sigma_uv(kernel, u, v)))
    return np.asarray(out, np.float32)


def jax_evaluate_per_image(model, variables, images, sigma: float, seed: int = 1234) -> np.ndarray:
    """(n, 2) PSNR and SSIM of each image as the JAX ``evaluate`` makes them
    (its noise draws in order, the same jitted forward pass and metrics);
    ``evaluate`` itself returns only their means."""
    rng = np.random.default_rng(seed)

    @jax.jit
    def eval_one(v, clean, noisy):
        den = jnp.clip(noisy - model.apply(v, noisy[None, ..., None])[0, ..., 0], 0.0, 1.0)
        return jnp.stack([jax_psnr(clean, den), jax_ssim(clean, den)])

    out = []
    for img in images:
        clean = jnp.asarray(img, jnp.float32)
        noisy = clean + sigma * jnp.asarray(rng.standard_normal(clean.shape), jnp.float32)
        out.append(np.asarray(eval_one(variables, clean, noisy), np.float64))
    return np.stack(out)


def jax_train_batches(patches: np.ndarray, cfg) -> list:
    """The first :data:`TRAIN_STEPS` (clean, noisy, noise) NHWC batches of the
    JAX pipeline (seed :data:`TRAIN_BATCH_SEED`); the clean patches are
    those the batch's permutation selects."""
    perm = np.random.default_rng(TRAIN_BATCH_SEED).permutation(len(patches))
    gen = jax_train_data.batches(patches, cfg.batch_size, cfg.noise_level / 255.0, seed=TRAIN_BATCH_SEED)
    out = []
    for b in range(TRAIN_STEPS):
        noisy, noise = next(gen)
        out.append((patches[perm[b * cfg.batch_size : (b + 1) * cfg.batch_size]], noisy, noise))
    return out


REALSN_EXPORTS = ("realsn_dncnn_noise5", "realsn_dncnn_noise15", "realsn_dncnn_noise40")
REALSN_LIP, REALSN_DENSE_PROBE, REALSN_DENSE_LAYERS = 0.3, 10, 3  # the JAX tool's defaults


def jax_realsn_export(name: str, images: list, checkpoint_dir: Path = CHECKPOINT_DIR) -> dict:
    """What ``tools/check_realsn_export.py`` computes for ``<name>.npz``,
    through the JAX functions it calls (its ``main`` writes beside the
    checkpoint, so it is not run): per layer the best sigma of 3 power
    iterations of 60 steps from ``init_u(PRNGKey(100 * i + r))``; the dense
    VALID operator's top singular value (numpy SVD) of the first 3 layers
    and the last; each image's PSNR and SSIM (its ``eval_one``, noise from
    ``default_rng(1234)`` in order)."""
    jax_tool_unroll_multi = jax_driver("check_realsn_export", "tools").unroll_multi
    variables = jax_load_flax_npz(Path(checkpoint_dir) / f"{name}.npz")
    params = variables["params"]
    convs = sorted((k for k in params if k.startswith("Conv_")), key=lambda s: int(s.split("_")[1]))
    sigmas, dense = [], []
    for i, conv in enumerate(convs):
        kern = jnp.asarray(params[conv]["kernel"])
        best = 0.0
        for r in range(3):
            u = jax_init_u(jax.random.PRNGKey(100 * i + r), kern.shape[-1], hw=40)
            best = max(best, float(jax_conv_power_iteration(kern, u, n_iters=60)[0]))
        sigmas.append(best)
        if i < REALSN_DENSE_LAYERS or i == len(convs) - 1:
            mat = jax_tool_unroll_multi(np.asarray(kern), REALSN_DENSE_PROBE)
            dense.append(np.linalg.svd(mat, compute_uv=False)[0])
    model = JaxDnCNN(channels=1, depth=len(convs), use_bn=any(k.startswith("BatchNorm") for k in params))
    sigma = float(name.rsplit("noise", 1)[-1])
    vals = jax_evaluate_per_image(model, jax.tree_util.tree_map(jnp.asarray, variables), images, sigma / 255.0)
    return {"sigmas": np.asarray(sigmas, np.float64), "dense": np.asarray(dense, np.float64),
            "val_psnr_per_image": vals[:, 0], "val_ssim_per_image": vals[:, 1]}


def build_train_arrays() -> dict:
    """The training fixture (module docstring) from the JAX package on the
    CPU."""
    import optax

    cfg, model, variables, u_state = jax_train_state()
    sigma = cfg.noise_level / 255.0
    eff = jax_effective_variables(variables, u_state, cfg, n_iters=TRAIN_SN_ITERS)
    images = [jax_train_data.load_gray(p) for p in sorted(VAL_DIR.glob("*.png"))]
    per_image = jax_evaluate_per_image(model, eff, images, sigma)
    psnr_mean, ssim_mean = jax_evaluate(model, eff, images, sigma)
    assert np.isclose(per_image[:, 0].mean(), psnr_mean, rtol=0, atol=1e-9), (per_image[:, 0].mean(), psnr_mean)
    patches = jax_train_data.build_patch_dataset(TRAIN_DIR, seed=cfg.seed)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    opt_state = tx.init(variables["params"])
    opt_state.hyperparams["learning_rate"] = jnp.asarray(TRAIN_STEP_LR)
    step = jax_make_train_step(model, tx, cfg)
    losses, sums = [], {"clean": [], "noise": []}
    for clean, noisy, noise in jax_train_batches(patches, cfg):
        variables, opt_state, u_state, loss = step(variables, opt_state, u_state, jnp.asarray(noisy),
                                                   jnp.asarray(noise))
        losses.append(float(loss))
        sums["clean"].append(checksum(clean))
        sums["noise"].append(checksum(noise))
    return {
        "sigmas": jax_train_sigmas(*jax_train_state()[2:]),
        "val_psnr_per_image": per_image[:, 0], "val_ssim_per_image": per_image[:, 1],
        "val_psnr": np.float64(psnr_mean), "val_ssim": np.float64(ssim_mean),
        "val_sigma": np.float64(sigma),
        "losses": np.asarray(losses, np.float32),
        "n_patches": np.int64(len(patches)), "patches_sha256": np.array(checksum(patches)),
        "batch_clean_sha256": np.array(sums["clean"]), "batch_noise_sha256": np.array(sums["noise"]),
        "batch_size": np.int64(cfg.batch_size),
    }


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


@pytest.fixture(scope="module")
def uniform_rebuilt():
    return build_headline_arrays(set12_keep=0)


def test_uniform_fixture_matches_a_fresh_jax_rebuild(uniform_rebuilt):
    with np.load(UNIFORM_FIXTURE) as f:
        committed = {k: f[k] for k in f.files}
    runs = {"set12_uniform/psnr_per_iter", "set12_uniform/ssim"}
    assert set(committed) == set(uniform_rebuilt) - {"x"} | runs
    for name in set(committed) - runs:
        assert committed[name].dtype == uniform_rebuilt[name].dtype, name
        np.testing.assert_array_equal(committed[name], uniform_rebuilt[name], err_msg=name)
    assert not committed["keep_low_freq"].any()
    # The flagship lane is the headline's own uniform lane; the Set12 lanes
    # differ from the headline's in the mask only where keep_low_freq added
    # the low-frequency block.
    with np.load(HEADLINE_FIXTURE) as f:
        np.testing.assert_array_equal(committed["mask"][-1], f["mask"][-1])
        assert not np.array_equal(committed["mask"][:-1], f["mask"][:-1])


def _bench_r05() -> dict:
    return json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]


def test_uniform_lanes_init_psnr_and_dc_lost_are_bench_r05s():
    prob, lanes = load_uniform_problems(device="cpu")
    bench = _bench_r05()
    assert lanes[:12] == bench["set12_uniform_lanes"] and lanes[12] == "13.png"
    init = prob.psnr(prob.x_init).numpy()[:12]
    np.testing.assert_allclose(init, bench["set12_uniform_init_psnr_db_per_image"], atol=0.01)
    dc_lost = [bool(v) for v in prob.mask[:12, 0, 0] == 0]
    assert dc_lost == bench["set12_uniform_dc_lost_per_image"]
    assert dc_lost == [False, True, False, True, True, True, False, False, True, False, True, True]


def test_uniform_masks_match_the_jax_key_chain(uniform_rebuilt):
    with np.load(UNIFORM_MASKS) as f:
        committed = f["masks"]
    np.testing.assert_array_equal(committed, build_headline_masks(uniform_rebuilt["mask"]))
    masks = load_uniform_masks(device="cpu")
    assert masks.shape == (N_OUTER, T2, 13, SIZE, SIZE) and masks.dtype == torch.float32
    assert torch.all(masks <= torch.as_tensor(uniform_rebuilt["mask"], dtype=torch.float32))
    # k ones, or k + 1 where two f32 uniform scores tie at the threshold
    # (``sample_k_mask``), as in the headline's masks.
    sums = masks.sum(dim=(-2, -1))
    assert torch.all((sums == MINI_BATCH) | (sums == MINI_BATCH + 1))
    # A minibatch samples only measured coefficients, so the Set12 lanes'
    # masks are not the headline's; the flagship lane's problem is the same,
    # and so are its masks.
    headline = load_headline_masks(device="cpu")
    assert not torch.equal(masks[..., :12, :, :], headline[..., :12, :, :])
    assert torch.equal(masks[..., 12, :, :], headline[..., 12, :, :])


@pytest.mark.parametrize("lane", list(CSMRI_BATCH_LANES))
def test_batch_lane_references_are_stored(lane):
    """The JAX CPU runs the card's set12_uniform, f32_match and search12
    lanes are held to (too slow to repeat here: 160 BM3D denoises of 13
    lanes each; ``python tests/test_torch_fixture.py uniform variants``
    makes them)."""
    ref = load_batch_lane_reference(lane)
    trace = ref["psnr_per_iter"]
    assert trace.shape == (1 + N_OUTER * (T2 + 1), 13) and trace.dtype == np.float32
    assert ref["ssim"].shape == (13,) and np.isfinite(trace).all()
    assert np.all(trace[-1] > trace[0])  # every lane improves on its zero-filled start
    tuned, _, _, p = CSMRI_BATCH_LANES[lane]
    assert (p.search, p.match_dtype) == {"set12_uniform": (8, "bfloat16"), "f32_match": (8, "float32"),
                                         "search12": (12, "float32")}[lane]
    # Each run starts from its problems' zero-filled images.
    prob, _ = (load_uniform_problems if lane == "set12_uniform" else load_headline_problems)(device="cpu")
    np.testing.assert_allclose(trace[0], prob.psnr(prob.x_init).numpy(), atol=1e-4)


def test_bm3d_profile_reference_is_stored_and_starts_from_the_ports_first_input():
    """The JAX CPU run of bm3d_profile (the headline problems, masks and
    tuning with the reference's own BM3D; ``python tests/test_torch_fixture.py
    envelope`` makes it) and its single BM3D call: the call's input is the
    port's own first denoise input (``x_init`` after one full-gradient step,
    the lane's eta) to f32 rounding, and its sigma the port's estimate of it
    times the lane's modifier."""
    ref = load_envelope_reference("bm3d_profile")
    trace = ref["psnr_per_iter"]
    assert trace.shape == (1 + N_OUTER * (T2 + 1), 13) and np.isfinite(trace).all()
    assert ref["ssim"].shape == (13,) and np.all(trace[-1] > trace[0])
    prob, lanes = load_headline_problems(device="cpu")
    np.testing.assert_allclose(trace[0], prob.psnr(prob.x_init).numpy(), atol=1e-4)
    tuned, default_eta, default_mod, _ = BM3D_PROFILE_LANE
    eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cpu")
    x = prob.x_init.reshape(13, -1)
    z = (x - eta[:, None] * prob.grad_full(x).reshape(x.shape)).reshape(prob.x_init.shape)
    assert ref["first_input"].shape == ref["first_output"].shape == (13, SIZE, SIZE)
    scale = np.abs(ref["first_input"]).max()
    np.testing.assert_allclose(z.numpy(), ref["first_input"], atol=1e-5 * scale)
    np.testing.assert_allclose(estimate_sigma(z).numpy() * mod.numpy(), ref["first_sigma"], rtol=1e-4)
    out = ref["first_output"]  # a denoise of an aliased image: smoother, not always closer to x
    assert np.isfinite(out).all() and np.all(np.abs(np.diff(out, axis=-1)).mean((1, 2))
                                             < np.abs(np.diff(ref["first_input"], axis=-1)).mean((1, 2)))


def test_nlm_skimage_reference_is_stored():
    """The JAX CPU run of the CSMRI + NLM lane at skimage's NLM defaults
    (``envelope``): one lane's trace from the lane's zero-filled start."""
    ref = load_envelope_reference("csmri_nlm_skimage")
    trace = ref["psnr_per_iter"]
    assert trace.shape == (1 + N_OUTER * (T2 + 1),) and np.isfinite(trace).all()
    assert trace[-1] > trace[0] and np.shape(ref["ssim"]) == ()
    np.testing.assert_allclose(trace[:1], load_nlm_reference()["psnr_per_iter"][:1], atol=0)


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


def test_nlm_gd_reference_is_a_fresh_jax_run_and_the_port_follows_it():
    ref = load_nlm_gd_reference()
    assert ref["n_iters"] == NLM_GD_ITERS and ref["psnr_per_iter"].shape == (1 + NLM_GD_ITERS,)
    fresh = run_jax_nlm_gd()  # about 10 s on the CPU
    np.testing.assert_allclose(ref["psnr_per_iter"], fresh["gd_psnr_per_iter"], atol=1e-4)
    from pnp_svrg_tpu_torch.algorithms.loops import pnp_gd
    from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser

    out = pnp_gd(load_nlm_problem("cpu"), NLMDenoiser(sigma_modifier=nlm_params()["sigma_modifier"]),
                 ref["eta"], ref["n_iters"])
    # The same tolerance as the card run of chip_smoke.py's loops phase.
    np.testing.assert_allclose(out["psnr_per_iter"][:, 0].numpy(), ref["psnr_per_iter"], atol=0.01)
    assert ref["psnr_per_iter"][-1] > ref["psnr_per_iter"][0] + 5


@pytest.fixture(scope="module")
def deblur_rebuilt():
    return build_deblur_arrays()


def test_deblur_fixture_matches_a_fresh_jax_rebuild(deblur_rebuilt):
    with np.load(DEBLUR_FIXTURE) as f:
        committed = {k: f[k] for k in f.files}
    runs = {f"{lane}/{f}" for lane in DEBLUR_LANES for f in ("psnr_per_iter", "ssim")}
    assert set(committed) == set(deblur_rebuilt) | runs
    for name, arr in deblur_rebuilt.items():
        assert committed[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(committed[name], arr, err_msg=name)


def test_deblur_sr_kernel_is_the_port_load_kernel_image():
    with np.load(DEBLUR_FIXTURE) as f:
        b = f["deblur_sr_bm3d/b"]
    size = BENCH_LANES["deblur_sr_bm3d"]["size"]
    want = load_kernel_image("kernel25.png", size, size).reshape(-1) / np.float32(size * size)
    np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("lane", DEBLUR_LANES)
def test_load_deblur_problem_and_masks_are_the_bench_lane(lane):
    want = deblur_problem(lane)
    got = load_deblur_problem(lane, device="cpu")
    for name in ("y", "b", "b_adj", "x", "x_init", "ds_idx", "ds_w", "allowed"):
        np.testing.assert_array_equal(getattr(got, name).numpy().reshape(np.shape(getattr(want, name))),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.sigma.numpy(), [float(want.sigma)])
    cfg = bench_config(lane)
    masks = load_deblur_masks(lane, device="cpu")
    assert masks.shape == (cfg["n_outer"], cfg["t2"]) + got.mb_shape(cfg["mini_batch_size"])
    assert torch.all(masks.sum(dim=-1) == cfg["mini_batch_size"])
    p = cfg["params"]
    assert (p.search, p.search_step, p.matcher, p.match_dtype) == (
        (8, 1, "xla", "float32") if lane == "deblur_bm3d" else (8, 2, "pallas", "bfloat16"))


def test_deblur_reference_trace_is_a_fresh_jax_run():
    ref = load_deblur_reference()
    cfg = bench_config("deblur_bm3d")
    assert ref["psnr_per_iter"].shape == (1 + cfg["n_outer"] * (cfg["t2"] + 1),)
    fresh = run_jax_deblur()  # 4 x 6 at 256 px: about 20 s on the CPU
    np.testing.assert_allclose(ref["psnr_per_iter"], fresh["deblur_bm3d/psnr_per_iter"], atol=1e-4)
    np.testing.assert_allclose(ref["ssim"], fresh["deblur_bm3d/ssim"], atol=1e-5)


def test_deblur_sr_reference_is_stored():
    """The SR lane's JAX CPU run (too slow to repeat here: 240 BM3D denoises
    with the Pallas matcher interpreted; ``python tests/test_torch_fixture.py
    deblur`` makes it)."""
    ref = load_deblur_reference("deblur_sr_bm3d")
    cfg = bench_config("deblur_sr_bm3d")
    trace = ref["psnr_per_iter"]
    assert trace.shape == (1 + cfg["n_outer"] * (cfg["t2"] + 1),) and trace.dtype == np.float32
    assert np.isfinite(trace).all() and 0 < ref["ssim"] <= 1
    assert trace[-1] > trace[0] + 5  # the run reconstructs
    assert load_deblur_reference()["psnr_per_iter"].shape == (1 + 4 * (6 + 1),)


def test_pr_sarah_indices_match_the_batched_key_chain():
    cfg = bench_config("pr_sarah_realsn")
    assert (cfg["eta"], cfg["lr_decay"], cfg["n_outer"], cfg["t2"], cfg["mini_batch_size"]) == (
        0.05, 0.99, 30, 8, 800)
    assert (cfg["replicas"], cfg["realsn_sigma"], cfg["variant"]) == (8, 5, "sarah")
    with np.load(PR_SARAH_FIXTURE) as f:
        committed = f["indices"]
    np.testing.assert_array_equal(committed, pr_sarah_indices(BENCH_LANES["pr_bm3d"]["num_meas"]))
    idx = load_pr_sarah_indices(device="cpu")
    assert idx.shape == (30, 8, 8, 800) and idx.dtype == torch.int64
    flat = idx.reshape(-1, 800)
    assert all(len(set(step.tolist())) == 800 for step in flat[::37])
    # fold_in gives each replica its own rows.
    assert not torch.equal(idx[0, 0, 0], idx[0, 0, 1])
    ref = load_pr_sarah_reference()
    assert ref["psnr_per_iter"].shape == (1 + 30 * 9, 8) and ref["ssim"].shape == (8,)
    assert np.isfinite(ref["psnr_per_iter"]).all() and np.all((ref["ssim"] > 0) & (ref["ssim"] <= 1))
    np.testing.assert_array_equal(ref["psnr_per_iter"][0], ref["psnr_per_iter"][0, 0])  # one x_init


def test_load_pr_sarah_problem_holds_one_a():
    # Builds the 8192 x 16384 A (537 MB, about 6 s) once for all 8 lanes.
    prob = load_pr_sarah_problem(device="cpu")
    cfg = BENCH_LANES["pr_sarah_realsn"]
    assert prob.batch_size == 8 and prob.a.shape == (1, cfg["num_meas"], cfg["size"] ** 2)
    assert prob.y.shape == (8, cfg["num_meas"]) and prob.x_init.shape == (8, 128, 128)
    with np.load(PR_FIXTURE) as f:
        np.testing.assert_array_equal(prob.y.numpy(), np.broadcast_to(f["y"], (8, cfg["num_meas"])))
    # One full gradient over the 8 lanes through the shared A equals one lane's.
    g = prob.grad_full(prob.x_init.reshape(8, -1))
    assert torch.allclose(g, g[:1].expand_as(g), rtol=1e-5, atol=1e-6)


def test_pr_indices_match_the_replayed_key_chain():
    cfg = bench_config("pr_bm3d")
    with np.load(PR_FIXTURE) as f:
        committed = f["indices"]
    np.testing.assert_array_equal(committed, pr_indices(BENCH_LANES["pr_bm3d"]["num_meas"]))
    idx = load_pr_indices(device="cpu")
    assert idx.shape == (cfg["n_outer"], cfg["t2"], 1, cfg["mini_batch_size"]) and idx.dtype == torch.int64
    assert all(len(set(step.tolist())) == cfg["mini_batch_size"] for step in idx.reshape(-1, idx.shape[-1]))
    ref = load_pr_reference()
    assert ref["psnr_per_iter"].shape == (1 + cfg["n_outer"] * (cfg["t2"] + 1),)
    assert np.isfinite(ref["psnr_per_iter"]).all() and 0 < ref["ssim"] <= 1


def test_load_pr_problem_rebuilds_a_and_the_jax_measurements(tmp_path):
    # The one test that builds the 8192 x 16384 A (537 MB, about 6 s), twice.
    prob = load_pr_problem(device="cpu")  # checks A's checksum
    cfg = BENCH_LANES["pr_bm3d"]
    assert prob.a.shape == (1, cfg["num_meas"], cfg["size"] ** 2)
    y0 = prob.forward(prob.x)[0].numpy()
    sigma = float(jax_resolve_noise(jnp.asarray(y0), cfg["size"], cfg["size"], cfg["snr"], None)[1])
    np.testing.assert_allclose(prob.sigma.numpy(), [sigma], rtol=1e-5)
    _, k_noise = jax.random.split(jax.random.PRNGKey(PR_NOISE_KEY))
    noise = np.asarray(jax.random.normal(k_noise, y0.shape))
    # |A x| is a sum of 16384 f32 products of order 1 (|y| up to ~200):
    # the two sides' summation orders differ by f32 rounding.
    np.testing.assert_allclose(prob.y[0].numpy(), y0 + sigma * noise, rtol=1e-5, atol=1e-3)
    del prob
    with np.load(PR_FIXTURE) as f:
        tampered = {k: f[k] for k in f.files}
    tampered["a_sum"] = tampered["a_sum"] + 1.0
    np.savez(tmp_path / "pr.npz", **tampered)
    with pytest.raises(RuntimeError, match="checksum"):
        load_pr_problem(device="cpu", path=tmp_path / "pr.npz")


def test_train_reference_is_a_fresh_jax_run():
    """The stored sigmas and the first Set12 image's PSNR/SSIM are what the
    JAX package computes now from the committed state (the other images'
    runs are the same code on other images; their mean is the stored
    ``evaluate`` mean)."""
    cfg, model, variables, u_state = jax_train_state()
    ref = load_train_reference()
    np.testing.assert_allclose(jax_train_sigmas(variables, u_state), ref["sigmas"], rtol=1e-6)
    eff = jax_effective_variables(variables, u_state, cfg, n_iters=TRAIN_SN_ITERS)
    first = jax_train_data.load_gray(sorted(VAL_DIR.glob("*.png"))[0])
    psnr, ssim = jax_evaluate(model, eff, [first], float(ref["val_sigma"]))
    np.testing.assert_allclose(psnr, ref["val_psnr_per_image"][0], atol=1e-4)
    np.testing.assert_allclose(ssim, ref["val_ssim_per_image"][0], atol=1e-6)
    np.testing.assert_allclose(ref["val_psnr_per_image"].mean(), ref["val_psnr"], atol=1e-9)
    np.testing.assert_allclose(ref["val_ssim_per_image"].mean(), ref["val_ssim"], atol=1e-9)
    assert len(ref["losses"]) == len(ref["batch_clean_sha256"]) == len(ref["batch_noise_sha256"]) == TRAIN_STEPS
    assert TRAIN_FIXTURE.stat().st_size < 100_000


CPU_LANE_PARTS = ("deblur", "pr_sarah", "pr")


def cpu_lanes(parts=CPU_LANE_PARTS) -> None:
    """Print the port's CPU runs of the Deblur, PR and PR + SARAH lanes on the
    JAX minibatches against the stored JAX traces; the PR + SARAH lane's
    replica means on both sides with ``x_init`` one to four ulps down and up
    (:data:`PR_SARAH_ULP_SHIFTS`), and which runs lost a replica;
    and the PR lane's final PSNR on both sides with ``y`` or ``x_init`` one
    ulp up. ``parts`` picks among :data:`CPU_LANE_PARTS`."""
    import dataclasses

    from pnp_svrg_tpu_torch.algorithms.loops import pnp_sarah, pnp_svrg
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser
    from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser

    def port_run(lane, prob, mb):
        cfg = bench_config(lane)
        den = BM3DDenoiser(sigma_modifier=cfg["sigma_modifier"], params=cfg["params"])
        return pnp_svrg(prob, den, cfg["eta"], cfg["n_outer"], cfg["t2"], cfg["mini_batch_size"],
                        masks=mb, lr_decay=cfg["lr_decay"])["psnr_per_iter"][:, 0].numpy()

    for lane in DEBLUR_LANES if "deblur" in parts else ():
        trace = port_run(lane, load_deblur_problem(lane, "cpu"), load_deblur_masks(lane, "cpu"))
        jax_trace = load_deblur_reference(lane)["psnr_per_iter"]
        print(f"port CPU {lane}: final {trace[-1]:.4f} dB, JAX {jax_trace[-1]:.4f}, "
              f"trace max |diff| {np.abs(trace - jax_trace).max():.4f}", flush=True)
    if "pr_sarah" in parts:
        cfg = bench_config("pr_sarah_realsn")
        idx = load_pr_sarah_indices("cpu")
        den = DnCNNDenoiser.from_pretrained("RealSN_DnCNN", cfg["realsn_sigma"], device="cpu")
        jax_trace = load_pr_sarah_reference()["psnr_per_iter"]
        port, jax_runs = {}, {None: jax_trace}
        for shift in (None,) + PR_SARAH_ULP_SHIFTS:
            sprob = load_pr_sarah_problem("cpu")
            if shift is not None:
                sprob = dataclasses.replace(sprob, x_init=nextafter_ulp(sprob.x_init, shift))
            out = pnp_sarah(sprob, den, cfg["eta"], cfg["n_outer"], cfg["t2"], cfg["mini_batch_size"],
                            lr_decay=cfg["lr_decay"], variant=cfg["variant"], masks=idx)
            port[shift] = out["psnr_per_iter"].numpy()
            del sprob, out
            print(f"PR + SARAH + RealSN, x_init {shift or 'as built'}: port CPU replica mean "
                  f"{port[shift][-1].mean():.4f} dB, per replica {np.round(port[shift][-1], 4).tolist()}, "
                  f"first non-finite entry per replica {first_nonfinite(port[shift])}", flush=True)
        print(f"PR + SARAH + RealSN: port CPU replica mean {port[None][-1].mean():.4f} dB, "
              f"JAX {jax_trace[-1].mean():.4f}; per replica port {np.round(port[None][-1], 4).tolist()}, "
              f"JAX {np.round(jax_trace[-1], 4).tolist()}; trace max |diff| {np.abs(port[None] - jax_trace).max():.4f}",
              flush=True)
        a, _ = pr_matrix_numpy()
        for shift in PR_SARAH_ULP_SHIFTS:
            jp = pr_fixture_problem(a)
            jp = dataclasses.replace(jp, x_init=nextafter_ulp(jp.x_init, shift))
            jax_runs[shift] = run_jax_pr_sarah(jp)["psnr_per_iter"]
            print(f"PR + SARAH + RealSN, x_init {shift}: JAX replica mean {jax_runs[shift][-1].mean():.4f} dB, "
                  f"per replica {np.round(jax_runs[shift][-1], 4).tolist()}, first non-finite entry per "
                  f"replica {first_nonfinite(jax_runs[shift])}", flush=True)
            del jp
        del a
        shifts = (None,) + PR_SARAH_ULP_SHIFTS
        for side, runs in (("JAX", jax_runs), ("port CPU", port)):
            means = np.array([runs[s][-1].mean() for s in shifts])
            diverged = [s or "as built" for s in shifts if not np.isfinite(runs[s][-1]).all()]
            finite = means[np.isfinite(means)]
            print(f"PR + SARAH + RealSN replica means over x_init {[s or 'as built' for s in shifts]}: {side} "
                  f"{np.round(means, 4).tolist()}; finite ones: mean {finite.mean():.4f}, min {finite.min():.4f}, "
                  f"max {finite.max():.4f} dB; runs with a diverged replica {len(diverged)} of {len(shifts)} "
                  f"{diverged}", flush=True)
    if "pr" not in parts:
        return
    a, _ = pr_matrix_numpy()
    jprob = pr_problem(a)
    tprob = load_pr_problem("cpu")
    idx = load_pr_indices("cpu")
    jax_trace = load_pr_reference()["psnr_per_iter"]
    for name in ("none", "y", "x_init"):
        jp, tp = jprob, tprob
        if name != "none":
            jp = dataclasses.replace(jprob, **{name: jnp.nextafter(getattr(jprob, name), jnp.inf)})
            tp = dataclasses.replace(tprob, **{name: torch.nextafter(getattr(tprob, name),
                                                                     torch.tensor(np.inf))})
        jt = run_jax_pr(jp)["psnr_per_iter"] if name != "none" else jax_trace
        tt = port_run("pr_bm3d", tp, idx)
        print(f"PR + BM3D, {name} one ulp up: JAX final {jt[-1]:.4f} dB, port CPU final {tt[-1]:.4f} dB, "
              f"trace max |diff| {np.abs(tt - jt).max():.4f}", flush=True)


def build(names) -> None:
    """Write the named fixtures (``headline``, ``nlm``, ``deblur``, ``pr``,
    ``pr_sarah``, ``train``, ``drivers``, ``uniform``, ``variants``,
    ``realsn_export``, ``envelope``)."""
    if "headline" in names or "nlm" in names:
        arrays = build_headline_arrays()
        arrays.pop("x")  # rebuilt by the port's load_image
    if "headline" in names:
        HEADLINE_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(HEADLINE_FIXTURE, **arrays)
        np.savez_compressed(HEADLINE_MASKS, masks=build_headline_masks(arrays["mask"]))
    if "nlm" in names:
        ref = run_jax_nlm()
        np.savez_compressed(NLM_MASKS, masks=build_nlm_masks(np.asarray(nlm_problem().mask)), **ref,
                            **run_jax_nlm_gd())
        print(f"JAX CSMRI + NLM: final PSNR {ref['psnr_per_iter'][-1]:.4f} dB, "
              f"SSIM {float(ref['ssim']):.4f}", file=sys.stderr)
    if "deblur" in names:
        deblur = build_deblur_arrays()
        for lane in DEBLUR_LANES:
            deblur.update(run_jax_deblur(lane))
            print(f"JAX {lane}: final PSNR {deblur[f'{lane}/psnr_per_iter'][-1]:.4f} dB, "
                  f"SSIM {float(deblur[f'{lane}/ssim']):.4f}", file=sys.stderr, flush=True)
        np.savez_compressed(DEBLUR_FIXTURE, **deblur)
    if "pr" in names:
        pr = build_pr_arrays()
        np.savez_compressed(PR_FIXTURE, **pr)
        print(f"JAX PR + BM3D: final PSNR {pr['psnr_per_iter'][-1]:.4f} dB, SSIM {float(pr['ssim']):.4f}",
              file=sys.stderr)
    if "pr_sarah" in names:
        sarah = build_pr_sarah_arrays()
        np.savez_compressed(PR_SARAH_FIXTURE, **sarah)
        final = sarah["psnr_per_iter"][-1]
        print(f"JAX PR + SARAH + RealSN: replica-mean final PSNR {final.mean():.4f} dB "
              f"(per replica {np.round(final, 4).tolist()}), mean SSIM {sarah['ssim'].mean():.4f}",
              file=sys.stderr)
    if "uniform" in names:
        probs, paths, _ = headline_jax_problems(set12_keep=0)
        arrays = build_headline_arrays(set12_keep=0)
        arrays.pop("x")
        run = run_jax_batch_lane("set12_uniform", probs, [Path(p).name for p in paths])
        np.savez_compressed(UNIFORM_FIXTURE, **arrays, **{f"set12_uniform/{k}": v for k, v in run.items()})
        np.savez_compressed(UNIFORM_MASKS, masks=build_headline_masks(arrays["mask"]))
        print(f"JAX set12_uniform: Set12 mean final PSNR {run['psnr_per_iter'][-1, :12].mean():.4f} dB, "
              f"per lane {np.round(run['psnr_per_iter'][-1], 4).tolist()}", file=sys.stderr, flush=True)
    if "variants" in names:
        probs, paths, _ = headline_jax_problems()
        variants = {}
        for lane in ("f32_match", "search12"):
            run = run_jax_batch_lane(lane, probs, [Path(p).name for p in paths])
            variants |= {f"{lane}/{k}": v for k, v in run.items()}
            print(f"JAX {lane}: Set12-VD mean final PSNR {run['psnr_per_iter'][-1, :12].mean():.4f} dB, "
                  f"flagship {run['psnr_per_iter'][-1, 12]:.4f}", file=sys.stderr, flush=True)
        np.savez_compressed(HEADLINE_VARIANTS_FIXTURE, **variants)
    if "envelope" in names:
        probs, paths, _ = headline_jax_problems()
        lanes = [Path(p).name for p in paths]
        profile = jax_first_bm3d_call(probs, lanes)
        x = np.stack([np.asarray(p.x) for p in probs])
        first_db = [float(jax_psnr(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(x, profile["first_output"])]
        print(f"JAX bm3d_profile first call: PSNR per lane {np.round(first_db, 4).tolist()}",
              file=sys.stderr, flush=True)
        skimage = run_jax_nlm_skimage()
        print(f"JAX csmri_nlm_skimage: final PSNR {skimage['psnr_per_iter'][-1]:.4f} dB, "
              f"SSIM {float(skimage['ssim']):.4f}", file=sys.stderr, flush=True)
        profile |= run_jax_batch_lane("bm3d_profile", probs, lanes)
        print(f"JAX bm3d_profile: Set12-VD mean final PSNR {profile['psnr_per_iter'][-1, :12].mean():.4f} dB, "
              f"per lane {np.round(profile['psnr_per_iter'][-1], 4).tolist()}", file=sys.stderr, flush=True)
        np.savez_compressed(ENVELOPE_FIXTURE, **{f"bm3d_profile/{k}": v for k, v in profile.items()},
                            **{f"csmri_nlm_skimage/{k}": v for k, v in skimage.items()})
    if "realsn_export" in names:
        images = [jax_train_data.load_gray(p) for p in sorted(VAL_DIR.glob("*.png"))]
        arrays = {}
        for name in REALSN_EXPORTS:
            arrays |= {f"{name}/{k}": v for k, v in jax_realsn_export(name, images).items()}
            print(f"JAX {name}: sigmas {np.round(arrays[f'{name}/sigmas'], 5).tolist()}, dense "
                  f"{np.round(arrays[f'{name}/dense'], 5).tolist()}, Set12 PSNR "
                  f"{arrays[f'{name}/val_psnr_per_image'].mean():.4f} dB, SSIM "
                  f"{arrays[f'{name}/val_ssim_per_image'].mean():.5f}", file=sys.stderr, flush=True)
        np.savez_compressed(REALSN_EXPORT_FIXTURE, **arrays)
    if "drivers" in names:
        np.savez_compressed(PAPER_DRIVERS_FIXTURE, **build_drivers_arrays())
    if "train" in names:
        train = build_train_arrays()
        np.savez_compressed(TRAIN_FIXTURE, **train)
        print(f"JAX RealSN-DnCNN sigma 40 state: Set12 PSNR {float(train['val_psnr']):.4f} dB, SSIM "
              f"{float(train['val_ssim']):.4f}, sigmas {np.round(train['sigmas'], 4).tolist()}, "
              f"losses {train['losses'].tolist()}, {int(train['n_patches'])} patches", file=sys.stderr)
    for path in (HEADLINE_FIXTURE, HEADLINE_MASKS, NLM_MASKS, DEBLUR_FIXTURE, PR_FIXTURE, PR_SARAH_FIXTURE,
                 TRAIN_FIXTURE, PAPER_DRIVERS_FIXTURE, UNIFORM_FIXTURE, UNIFORM_MASKS, HEADLINE_VARIANTS_FIXTURE,
                 REALSN_EXPORT_FIXTURE, ENVELOPE_FIXTURE):
        if path.exists():
            print(f"{path} ({path.stat().st_size} bytes)", file=sys.stderr)


FIXTURES = ("headline", "nlm", "deblur", "pr", "pr_sarah", "train", "drivers", "uniform", "variants",
            "realsn_export", "envelope")

ULP_SHIFTS = ("down", "up")  # x_init moved one ulp towards -inf / +inf
# The PR + SARAH lane's starts: one to four ulps down and up.
PR_SARAH_ULP_SHIFTS = ULP_SHIFTS + tuple(f"{d}{n}" for n in (2, 3, 4) for d in ULP_SHIFTS)


def nextafter_ulp(x, shift: str):
    """``x`` moved elementwise (a jax array or a tensor) by ``shift``: "down"
    or "up", one ulp, or "down3", "up2" and so on, that many ulps."""
    direction = shift.rstrip("0123456789")
    for _ in range(int(shift[len(direction):] or 1)):
        if isinstance(x, torch.Tensor):
            x = torch.nextafter(x, torch.full_like(x, -np.inf if direction == "down" else np.inf))
        else:
            x = jnp.nextafter(x, jnp.full_like(x, -jnp.inf if direction == "down" else jnp.inf))
    return x


def first_nonfinite(trace: np.ndarray) -> list:
    """Per replica of a (T, replicas) PSNR trace, the first non-finite
    entry, or -1."""
    bad = ~np.isfinite(trace)
    return [int(np.argmax(col)) if col.any() else -1 for col in bad.T]


def jax_paper_csmri_gd(shift: str | None = None) -> np.ndarray:
    """The JAX paper_csmri ``auto`` table's ``gd`` row (``pnp_gd``, BM3D
    search 8, modifier 1.5, eta 6000, 198 steps) on its own problem
    (``make_csmri(PRNGKey(3), 13.png 128, 0.5, snr=10)``), with ``x_init``
    moved one ulp ``shift`` ("down", "up") or kept (None): its PSNR trace."""
    prob = make_csmri(jax.random.PRNGKey(3), jnp.asarray(jax_load_image("13.png", SIZE, SIZE)),
                      sample_prob=0.5, snr=10)
    if shift is not None:
        import dataclasses

        prob = dataclasses.replace(prob, x_init=nextafter_ulp(prob.x_init, shift))
    out = jax_pnp_gd(prob, JaxBM3DDenoiser(sigma_modifier=1.5, params=JaxBM3DParams(search=8)),
                     eta=6000.0, n_iters=198)
    return np.asarray(out["psnr_per_iter"], np.float32)


def first_parting(a: np.ndarray, b: np.ndarray, tol_db: float = 1e-5) -> int:
    """The first entry at which two PSNR traces differ by more than
    ``tol_db``, or -1."""
    off = np.flatnonzero(np.abs(a - b) > tol_db)
    return int(off[0]) if off.size else -1


def cpu_anchors() -> None:
    """Print the port's plain CPU runs of the drivers' anchor rows
    (:data:`PAPER_ANCHORS`, on the JAX drivers' problems, through the port
    drivers' tables) against the stored JAX CPU traces; then paper_csmri's
    ``auto`` ``gd`` row on both sides with ``x_init`` one ulp down and one
    ulp up, to show how far rounding alone moves that row (JAX's own spread
    against the port's distance from it)."""
    import dataclasses

    from pnp_svrg_tpu_torch.convert import load_paper_csmri_problem, load_paper_deblur_problem, load_paper_reference

    cpu = torch.device("cpu")
    ref = load_paper_reference()
    for (driver, table), row in PAPER_ANCHORS.items():
        mod = importlib.import_module(f"pnp_svrg_tpu_torch.examples.{driver}")
        prob = load_paper_deblur_problem(cpu) if driver == "paper_deblur" else load_paper_csmri_problem(driver, cpu)
        trace = mod.make_runs(prob, mod.parse_args(PAPER_TABLES[driver][table] + ["--cpu"]), cpu)[row]()
        got = trace["psnr_per_iter"][:, 0].numpy()
        want = ref[driver][table]["rows"][row]["psnr_per_iter"]
        diff = np.abs(got - want)
        print(f"port CPU {driver}/{table}/{row}: {len(got)} entries, max |diff| {diff.max():.6f} dB at entry "
              f"{int(diff.argmax())}, first entry over 1e-5 dB {first_parting(got, want)}, "
              f"final {got[-1]:.4f} (JAX {want[-1]:.4f})", flush=True)
    mod = importlib.import_module("pnp_svrg_tpu_torch.examples.paper_csmri")
    args = mod.parse_args(PAPER_TABLES["paper_csmri"]["auto"] + ["--cpu"])
    prob = load_paper_csmri_problem("paper_csmri", cpu)
    jax_base = ref["paper_csmri"]["auto"]["rows"]["gd"]["psnr_per_iter"]
    np.testing.assert_array_equal(jax_paper_csmri_gd(), jax_base)  # the stored trace is this run's
    port = {None: mod.make_runs(prob, args, cpu)["gd"]()["psnr_per_iter"][:, 0].numpy()}
    jax_runs = {None: jax_base}
    for shift in ULP_SHIFTS:
        moved = dataclasses.replace(prob, x_init=nextafter_ulp(prob.x_init, shift))
        port[shift] = mod.make_runs(moved, args, cpu)["gd"]()["psnr_per_iter"][:, 0].numpy()
        jax_runs[shift] = jax_paper_csmri_gd(shift)
    for shift in (None,) + ULP_SHIFTS:
        print(f"paper_csmri/auto/gd, x_init {shift or 'as built'}: JAX final {jax_runs[shift][-1]:.6f} dB, "
              f"port CPU final {port[shift][-1]:.6f} dB; max |port - JAX| {np.abs(port[shift] - jax_runs[shift]).max():.6f}, "
              f"first entry over 1e-5 dB {first_parting(port[shift], jax_runs[shift])}", flush=True)
    spread = lambda runs: max(np.abs(a - b).max() for a, b in itertools.combinations(runs.values(), 2))  # noqa: E731
    finals = lambda runs: [float(t[-1]) for t in runs.values()]  # noqa: E731
    print(f"paper_csmri/auto/gd one-ulp spread over (as built, down, up): JAX trace {spread(jax_runs):.6f} dB, "
          f"finals {np.round(finals(jax_runs), 6).tolist()}; port CPU trace {spread(port):.6f} dB, finals "
          f"{np.round(finals(port), 6).tolist()}; JAX's first parting from its own as-built trace: "
          f"{[first_parting(jax_runs[s], jax_base) for s in ULP_SHIFTS]}", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--cpu-lanes"]:
    cpu_lanes(sys.argv[2:] or CPU_LANE_PARTS)
elif __name__ == "__main__" and sys.argv[1:] == ["--cpu-anchors"]:
    cpu_anchors()
elif __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(FIXTURES)
    if unknown:
        raise SystemExit(f"unknown fixtures {sorted(unknown)}; have {FIXTURES}")
    build(sys.argv[1:] or FIXTURES)
