"""State carried over from the JAX package: problem data, per-lane
hyperparameters and reference runs (the CNN denoisers' weights are read by
``denoisers/dncnn.py``).

* :func:`csmri_from_numpy` builds the port's batched ``CSMRI`` from the JAX
  ``CSMRI`` fields as numpy arrays.
* :func:`lane_params` slices per-lane (eta, sigma_modifier) from a tuned JSON
  by lane name (``bench.py:114-132``).
* :func:`load_headline_problems` reads the committed fixture
  ``data/headline_csmri_128.npz``: the 13 headline problems (Set12 with
  variable-density masks plus the ``13.png`` flagship lane) exactly as the
  JAX package builds them, so the port sees the reference's masks and noise
  (its generators cannot replay JAX's key streams).
* :func:`load_headline_masks` reads ``data/headline_masks_key2.npz``: the
  minibatch masks the JAX ``pnp_svrg`` draws in ``bench.py``'s timed
  headline run (``PRNGKey(2)``), for runs comparable lane by lane.
* ``bench.py``'s other lanes on a 13-lane CSMRI batch
  (:data:`CSMRI_BATCH_LANES`): :func:`load_uniform_problems` reads
  ``data/set12_uniform_csmri_128.npz``, the set12_uniform lane's problems
  (``bench.py:402-463``: the headline's keys with ``keep_low_freq=0`` on
  every lane, so each mask keeps or loses the zero frequency by coin flip),
  :func:`load_uniform_masks` the minibatch masks of the JAX run on them
  (``data/set12_uniform_masks_key2.npz``, ``PRNGKey(2)``; they differ from
  the headline's because a minibatch samples only measured coefficients),
  and :func:`load_batch_lane_reference` the JAX CPU run of set12_uniform,
  f32_match or search12 (``bench.py:383-400``, on the headline problems
  and masks; ``data/headline_variants_jax.npz``): its PSNR trace and
  per-lane SSIM.
* The CSMRI + NLM lane (``bench.py:465-506``): :func:`load_nlm_problem` is
  the one-lane problem of ``13.png`` from the headline fixture,
  :func:`nlm_params` the tuned configuration and its provenance grid from
  ``data/csmri_nlm_tuned.json``, :func:`load_nlm_masks` the minibatch masks
  of the JAX lane's run (``data/csmri_nlm_masks_key2.npz``, an unbatched key
  chain) and :func:`load_nlm_reference` that run's PSNR trace and SSIM;
  :func:`load_nlm_gd_reference` a short JAX ``pnp_gd`` run on the same
  problem, against which the port's ``pnp_gd`` is held on the card.

* The Deblur lanes (``bench.py:602-717``): :func:`bench_config` is a lane's
  tuned configuration (``data/deblur_tuned.json``,
  ``data/deblur_sr_tuned.json``) merged over ``bench.py``'s defaults, with its
  ``BM3DParams``; :func:`deblur_from_numpy` builds the port's ``Deblur``
  from JAX fields; :func:`load_deblur_problem` reads ``data/deblur_256.npz``
  (both lanes' problems as ``make_deblur(PRNGKey(0), ...)`` builds them,
  with the SR lane's kernel, whose PIL resampling depends on the Pillow
  version), :func:`load_deblur_masks` the minibatch masks of each lane's
  JAX run (``PRNGKey(2)``, the unbatched key chain) and
  :func:`load_deblur_reference` the JAX CPU run's trace of either lane (the
  SR lane's in its own matcher rounding, the Pallas matcher's bf16).
* The PR + BM3D lane (``bench.py:508-542``): its 8192 x 16384 matrix A is
  too large to commit, so both sides build it from
  ``numpy.random.RandomState(seed)`` (:func:`pr_matrix`), a stream numpy
  keeps fixed across versions. :func:`load_pr_problem` rebuilds A and checks
  it against the checksum in ``data/pr_bm3d_128.npz``, which also holds
  ``y``, ``x_init``, ``sigma`` and ``snr`` as the JAX package makes them from
  that A; :func:`load_pr_indices` reads the JAX run's minibatch row indices
  (``PRNGKey(5)``) and :func:`load_pr_reference` its PSNR trace and SSIM.
  :func:`pr_from_numpy` builds the port's ``PhaseRetrieval`` from JAX
  fields.
* The PR + SARAH + RealSN-DnCNN lane (``bench.py:544-600``, 8 replicas of
  the PR problem): :func:`load_pr_sarah_problem` is the PR fixture's problem
  in 8 lanes that hold A once, :func:`load_pr_sarah_indices` the replicas'
  minibatch row indices of the JAX run (``PRNGKey(5)``, the batched key
  chain with a ``fold_in`` per lane) and :func:`load_pr_sarah_reference`
  that JAX CPU run's trace and per-replica SSIM
  (``data/pr_sarah_realsn_128.npz``). ``BENCH_r05.json``'s 20.63 dB for
  this lane was measured on the JAX package's own A, which the port cannot
  rebuild; on the ``RandomState(4)`` A the reference is that JAX run.

* The training state (``checkpoints/exp_realsn_noise40/``, the raw state
  the JAX package's RealSN-DnCNN sigma-40 run ended on):
  :func:`load_train_reference` reads ``data/train_realsn_noise40.npz``, the
  JAX CPU run on that state: the 17 per-layer sigmas after
  :data:`TRAIN_SN_ITERS` power iterations, ``evaluate``'s Set12 PSNR/SSIM
  per image and their means at sigma 40/255, the losses of
  :data:`TRAIN_STEPS` steps from the raw state with a fresh Adam at
  :data:`TRAIN_STEP_LR` on the first batches (seed :data:`TRAIN_BATCH_SEED`)
  of the ``data/RGB`` patch set, and :func:`checksum` of that patch set and
  of each batch's clean patches and noise.

* The paper and demo drivers (``examples/paper_csmri.py``,
  ``paper_deblur.py``, ``paper_pr.py``, ``pnp_csmri_demo.py``,
  ``rgb_csmri.py``), from ``data/paper_drivers.npz``, which holds the JAX
  package's CPU runs of them: :func:`load_paper_csmri_problem` is the
  problem paper_csmri or the demo builds (``make_csmri(PRNGKey(3))`` at 128
  px, ``PRNGKey(0)`` at 256), :func:`load_paper_deblur_problem`
  paper_deblur's (the ``deblur_bm3d`` lane of ``deblur_256.npz``, checked
  against the checksums this fixture keeps of the JAX driver's ``y`` and
  ``x_init``), and :func:`load_paper_reference` every row's final PSNR and
  SSIM and each table's init PSNR under the tables of
  :data:`PAPER_TABLES`, the PSNR traces of the deterministic rows of
  :data:`PAPER_ANCHORS`, and rgb_csmri's per-channel PSNRs.
* The calls past the kernels' earlier envelope (:data:`WIDE_BM3D`,
  :data:`WIDE_NLM`): :func:`load_wide_reference` reads
  ``data/params_wide_jax.npz``, the JAX CPU outputs on their inputs.

The fixtures are written by ``python tests/test_torch_fixture.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DParams
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.ops.fourier import fft_blur_1d_adjoint_kernel
from pnp_svrg_tpu_torch.ops.resize import bilinear_adjoint_table, bilinear_gather_params
from pnp_svrg_tpu_torch.problems.csmri import CSMRI
from pnp_svrg_tpu_torch.problems.deblur import Deblur, deblur_kernel
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image, resolve_data_path

HEADLINE_FIXTURE = Path(__file__).resolve().parent / "data" / "headline_csmri_128.npz"
HEADLINE_MASKS = HEADLINE_FIXTURE.parent / "headline_masks_key2.npz"
UNIFORM_FIXTURE = HEADLINE_FIXTURE.parent / "set12_uniform_csmri_128.npz"
UNIFORM_MASKS = HEADLINE_FIXTURE.parent / "set12_uniform_masks_key2.npz"
HEADLINE_VARIANTS_FIXTURE = HEADLINE_FIXTURE.parent / "headline_variants_jax.npz"
NLM_MASKS = HEADLINE_FIXTURE.parent / "csmri_nlm_masks_key2.npz"
NLM_TUNED = DATA_DIR / "csmri_nlm_tuned.json"
NLM_LANE = "13.png"
DEBLUR_FIXTURE = HEADLINE_FIXTURE.parent / "deblur_256.npz"
PR_FIXTURE = HEADLINE_FIXTURE.parent / "pr_bm3d_128.npz"
PR_SARAH_FIXTURE = HEADLINE_FIXTURE.parent / "pr_sarah_realsn_128.npz"
TRAIN_FIXTURE = HEADLINE_FIXTURE.parent / "train_realsn_noise40.npz"
TRAIN_EXP = DATA_DIR.parent / "checkpoints" / "exp_realsn_noise40"
TRAIN_DIR, VAL_DIR = DATA_DIR / "RGB", DATA_DIR / "Set12"
TRAIN_SN_ITERS = 30  # effective_variables' power iterations
TRAIN_STEPS, TRAIN_STEP_LR, TRAIN_BATCH_SEED = 3, 1e-4, 0  # lr: the epochs after the milestone
PAPER_DRIVERS_FIXTURE = HEADLINE_FIXTURE.parent / "paper_drivers.npz"
REALSN_EXPORT_FIXTURE = HEADLINE_FIXTURE.parent / "realsn_export_jax.npz"
ENVELOPE_FIXTURE = HEADLINE_FIXTURE.parent / "params_envelope_jax.npz"
# The drivers' row tables held by the fixture: driver -> {table: its flags}.
PAPER_TABLES = {
    "paper_csmri": {"auto": [], "ref": ["--eta-scale", "ref"]},
    "paper_deblur": {"default": []},
    "paper_pr": {"auto": [], "ref": ["--config", "ref"]},
    "pnp_csmri_demo": {"default": []},
}
# The deterministic rows whose JAX CPU traces the fixture keeps: (driver, table) -> row.
PAPER_ANCHORS = {("paper_csmri", "auto"): "gd", ("paper_csmri", "ref"): "gd",
                 ("paper_deblur", "default"): "gd+bm3d", ("pnp_csmri_demo", "default"): "PnP-GD"}
# The CSMRI problems the fixture keeps: driver -> (image, size).
PAPER_PROBLEMS = {"paper_csmri": ("13.png", 128), "pnp_csmri_demo": ("13.png", 256)}

# bench.py's lanes on a 13-lane CSMRI batch besides the headline: lane ->
# (tuned JSON, default eta, default sigma_modifier, BM3DParams), as
# bench.py:402-463 (set12_uniform, on its own problems) and bench.py:383-400
# (f32_match and search12, on the headline's) run them. bench.py's
# ``timed(12)`` leaves search12 at its default match_dtype, float32.
CSMRI_BATCH_LANES = {
    "set12_uniform": ("set12_csmri_uniform_tuned.json", 6000.0, 1.0,
                      BM3DParams(search=8, match_dtype="bfloat16")),
    "f32_match": ("set12_csmri_tuned.json", 6000.0, 1.0, BM3DParams(search=8, match_dtype="float32")),
    "search12": ("set12_csmri_tuned.json", 6000.0, 1.0, BM3DParams(search=12, match_dtype="float32")),
}
# Settings off the kernels' first instantiations, each run on a lane the
# JAX package's CPU run holds (``ENVELOPE_FIXTURE``). bm3d_profile: the
# headline batch and tuning with the reference's own BM3D, ``bm3d`` 3.0.9's
# default profile (8 x 8 blocks, step 3, a 39 x 39 window, 16 matches in
# the hard-threshold stage and 32 in the Wiener stage), bf16 match
# distances as the headline's; csmri_nlm_skimage: the CSMRI + NLM lane with
# skimage's ``denoise_nl_means`` defaults (patch 7, distance 11).
BM3D_PROFILE_LANE = ("set12_csmri_tuned.json", 6000.0, 1.0,
                     BM3DParams(block=8, step=3, search=19, group_ht=16, group_wie=32,
                                match_dtype="bfloat16"))
NLM_SKIMAGE = {"patch_size": 7, "patch_distance": 11}
# One call each through the public entry points at settings past the kernels'
# earlier envelope (``WIDE_FIXTURE``, JAX CPU outputs): BM3D on the
# bm3d_profile lane's first denoise input, lanes WIDE_LANES (Set12/01 and
# 13.png), at a window past search 24, a step past the block and 128 Wiener
# matches; NLM at (13, 21) on the CSMRI + NLM lane's first denoise input.
WIDE_FIXTURE = HEADLINE_FIXTURE.parent / "params_wide_jax.npz"
WIDE_LANES = (0, 12)
WIDE_BM3D = {
    "search32": BM3DParams(block=8, step=3, search=32, group_ht=16, group_wie=32, match_dtype="bfloat16"),
    "step_past_block": BM3DParams(block=8, step=10, search=19, group_ht=16, group_wie=32,
                                  match_dtype="bfloat16"),
    "k128": BM3DParams(block=8, step=3, search=19, group_ht=16, group_wie=128, match_dtype="bfloat16"),
}
WIDE_NLM = {"patch_size": 13, "patch_distance": 21}

# bench.py's three lanes: the problem, bench.py's defaults and the tuned
# JSON merged over them (bench.py:508-542, 602-661, 663-717).
_RUN_KEYS = ("eta", "lr_decay", "sigma_modifier", "n_outer", "t2", "mini_batch_size")
BENCH_LANES = {
    "pr_bm3d": {
        "image": "Set12/04.png", "size": 128, "num_meas": 8192, "snr": 20.0,
        "tuned": "pr_tuned.json",
        "defaults": (0.2, 0.99, 1.0, 20, 8, 800),
    },
    "deblur_bm3d": {
        "image": "Set12/01.png", "size": 256, "kernel": "Minimal", "scale_percent": 100,
        "snr": 5.0, "tuned": "deblur_tuned.json",
        "defaults": (2e9, 0.6, 1.0, 4, 6, 5000),
    },
    "deblur_sr_bm3d": {
        "image": "Set12/01.png", "size": 256, "kernel": "kernel25.png", "scale_percent": 50,
        "snr": 20.0, "tuned": "deblur_sr_tuned.json",
        "defaults": (1.2, 1.0, 12.0, 24, 10, 5000),
    },
    # The PR lane's problem in 8 replicas, PnP-SARAH + RealSN-DnCNN.
    "pr_sarah_realsn": {
        "image": "Set12/04.png", "size": 128, "num_meas": 8192, "snr": 20.0,
        "tuned": "pr_sarah_realsn_tuned.json",
        "defaults": (0.05, 0.99, 1.0, 20, 8, 800),
    },
}
DEBLUR_LANES = ("deblur_bm3d", "deblur_sr_bm3d")
PR_SEED = 4  # RandomState seed of the PR lane's A
PR_BLOCK_ROWS = 512
PR_CHECK_ENTRIES = ((0, 0), (1, 7), (4095, 8191), (8191, 16383))  # (row, column) of A


def csmri_from_numpy(arrays: dict, device=None) -> CSMRI:
    """Port ``CSMRI`` from the stacked JAX fields as numpy arrays: ``y``,
    ``mask``, ``x``, ``x_init`` (B, H, W) and optional ``m0``, ``snr``,
    ``sigma`` (B,); a missing ``m0`` is counted from the mask."""
    dev = resolve_device(device)
    b = np.asarray(arrays["y"]).shape[0]

    def img(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]).astype(dtype), device=dev)

    def lane(name, default):
        a = np.asarray(arrays.get(name, default), np.float32)
        return torch.as_tensor(np.broadcast_to(a, (b,)).copy(), device=dev)

    mask = img("mask", np.float32)
    m0 = arrays.get("m0")
    return CSMRI(
        y=img("y", np.complex64),
        mask=mask,
        x=img("x", np.float32),
        x_init=img("x_init", np.float32),
        m0=mask.sum(dim=(-2, -1)) if m0 is None else lane("m0", m0),
        snr=lane("snr", 0.0),
        sigma=lane("sigma", 0.0),
    )


def lane_params(tuned, lane_names, default_eta, default_mod, device=None):
    """(B,) float32 (eta, sigma_modifier) by lane NAME from a tuned JSON
    (dict, path, or None); lanes it lacks get the defaults."""
    if isinstance(tuned, (str, os.PathLike)):
        with open(tuned) as f:
            tuned = json.load(f)
    by_name = {}
    if tuned:
        by_name = {
            n: (e, m)
            for n, e, m in zip(tuned["lanes"], tuned["eta"], tuned["sigma_modifier"])
        }
    pairs = [by_name.get(n, (default_eta, default_mod)) for n in lane_names]
    dev = resolve_device(device)
    eta = torch.tensor([p[0] for p in pairs], dtype=torch.float32, device=dev)
    mod = torch.tensor([p[1] for p in pairs], dtype=torch.float32, device=dev)
    return eta, mod


def load_headline_problems(device=None, path=HEADLINE_FIXTURE, lanes=None):
    """(CSMRI, lane names) of the committed headline problems, or of the
    named ``lanes`` only; the ground truth is reloaded with the port's
    ``load_image``."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    names = [str(n) for n in data["lanes"]]
    keep = list(range(len(names))) if lanes is None else [names.index(n) for n in lanes]
    paths = [str(data["paths"][i]) for i in keep]
    h, w = data["y"].shape[-2:]
    arrays = {
        "y": data["y"][keep],
        "mask": data["mask"][keep],
        "x": np.stack([load_image(p, h, w) for p in paths]),
        "x_init": data["x_init"][keep],
        "snr": data["snr"][keep],
        "sigma": data["sigma"][keep],
    }
    return csmri_from_numpy(arrays, device), [names[i] for i in keep]


def _unpack_masks(path, device) -> torch.Tensor:
    with np.load(path) as f:
        packed = f["masks"]
    masks = np.unpackbits(packed, axis=-1).astype(np.float32)
    return torch.as_tensor(masks, device=resolve_device(device))


def load_headline_masks(device=None, path=HEADLINE_MASKS) -> torch.Tensor:
    """(n_outer, t2, B, H, W) float32 minibatch masks of the JAX headline run,
    for ``pnp_svrg(..., masks=...)``."""
    return _unpack_masks(path, device)


def load_uniform_problems(device=None, path=UNIFORM_FIXTURE):
    """(CSMRI, lane names) of the set12_uniform lane: the 13 headline lanes
    with ``keep_low_freq=0`` on every one, as the JAX package builds them."""
    return load_headline_problems(device, path)


def load_uniform_masks(device=None, path=UNIFORM_MASKS) -> torch.Tensor:
    """(n_outer, t2, B, H, W) float32 minibatch masks of the JAX set12_uniform
    run (``PRNGKey(2)``), for ``pnp_svrg(..., masks=...)``."""
    return _unpack_masks(path, device)


def load_batch_lane_reference(lane: str) -> dict:
    """The JAX CPU run of a :data:`CSMRI_BATCH_LANES` lane on its fixture
    problems and masks: ``psnr_per_iter`` (1 + n_outer*(t2+1), B) and the
    per-lane final ``ssim`` (B,)."""
    data = _fixture(UNIFORM_FIXTURE if lane == "set12_uniform" else HEADLINE_VARIANTS_FIXTURE)
    return {"psnr_per_iter": data[f"{lane}/psnr_per_iter"], "ssim": data[f"{lane}/ssim"]}


def load_envelope_reference(lane: str, path=ENVELOPE_FIXTURE) -> dict:
    """The JAX CPU run of ``"bm3d_profile"`` (on the headline problems and
    masks) or ``"csmri_nlm_skimage"`` (on the CSMRI + NLM lane's): its PSNR
    trace ``psnr_per_iter`` and per-lane final ``ssim``; for bm3d_profile
    also one BM3D call on each lane's first denoise input as the JAX loop
    forms it, ``first_input`` (B, H, W) and ``first_sigma`` (B,), and its
    ``first_output``."""
    data = _fixture(path)
    return {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith(f"{lane}/")}


def load_wide_reference(path=WIDE_FIXTURE) -> dict:
    """The JAX CPU outputs of the calls past the earlier envelope:
    ``bm3d/lanes`` and ``bm3d/<row>/output`` for each :data:`WIDE_BM3D` row
    on those lanes of bm3d_profile's ``first_input`` with their
    ``first_sigma`` (:func:`load_envelope_reference`), and ``nlm/input``,
    ``nlm/sigma_est`` and ``nlm/output``: the CSMRI + NLM lane's first
    denoise input (``x_init`` after one full-gradient step with its tuned
    eta), its sigma estimate, and JAX's ``NLMDenoiser`` at
    :data:`WIDE_NLM` with the lane's modifier on it."""
    return _fixture(path)


def load_nlm_problem(device=None, path=HEADLINE_FIXTURE) -> CSMRI:
    """The one-lane CSMRI of the CSMRI + NLM lane: ``13.png`` at 128 px with
    the reference's uniform mask and ``PRNGKey(0)``, as ``bench.py:486-490``
    builds it (the headline fixture's last lane)."""
    return load_headline_problems(device, path, lanes=[NLM_LANE])[0]


def nlm_params(path=NLM_TUNED) -> dict:
    """The tuned CSMRI + NLM configuration: ``eta``, ``lr_decay``,
    ``sigma_modifier``, ``n_outer``, ``t2``, ``mini_batch_size``, and the
    tuner's grid ``etas`` and ``mods``."""
    with open(path) as f:
        tuned = json.load(f)
    keys = ("eta", "lr_decay", "sigma_modifier", "n_outer", "t2", "mini_batch_size")
    out = {k: tuned[k] for k in keys}
    out["etas"] = list(tuned["provenance"]["etas"])
    out["mods"] = list(tuned["provenance"]["mods"])
    return out


def load_nlm_masks(device=None, path=NLM_MASKS) -> torch.Tensor:
    """(n_outer, t2, 1, H, W) float32 minibatch masks of the JAX CSMRI + NLM
    run (``PRNGKey(2)``), for ``pnp_svrg(..., masks=...)``."""
    return _unpack_masks(path, device)


def load_nlm_reference(path=NLM_MASKS) -> dict:
    """The JAX CSMRI + NLM run on those masks: ``psnr_per_iter`` (numpy,
    ``1 + n_outer*(t2+1)`` entries) and its final ``ssim``."""
    with np.load(path) as f:
        return {"psnr_per_iter": f["psnr_per_iter"], "ssim": float(f["ssim"])}


def load_nlm_gd_reference(path=NLM_MASKS) -> dict:
    """A JAX CPU ``pnp_gd`` run of the CSMRI + NLM lane's problem and
    denoiser: its ``eta``, ``n_iters`` and ``psnr_per_iter``
    (``1 + n_iters`` entries)."""
    with np.load(path) as f:
        return {"eta": float(f["gd_eta"]), "n_iters": int(f["gd_n_iters"]),
                "psnr_per_iter": f["gd_psnr_per_iter"]}


def bench_config(lane: str) -> dict:
    """One of :data:`BENCH_LANES` with its run configuration resolved as
    ``bench.py`` resolves it: ``eta``, ``lr_decay``, ``sigma_modifier``,
    ``n_outer``, ``t2``, ``mini_batch_size`` and, for a BM3D lane,
    ``params``, the ``BM3DParams`` (search 8; the Deblur lanes take
    ``search_step``, ``matcher`` and ``match_dtype`` from their JSON), or for
    the PR + SARAH lane ``replicas``, ``realsn_sigma`` and ``variant``."""
    spec = dict(BENCH_LANES[lane])
    with open(DATA_DIR / spec["tuned"]) as f:
        tuned = json.load(f)
    cfg = dict(zip(_RUN_KEYS, spec.pop("defaults")))
    cfg.update({k: tuned[k] for k in _RUN_KEYS if k in tuned})
    for k in ("n_outer", "t2", "mini_batch_size"):
        cfg[k] = int(cfg[k])
    if lane == "pr_sarah_realsn":
        return {**spec, **cfg, "replicas": int(tuned["replicas"]),
                "realsn_sigma": int(tuned["realsn_sigma"]), "variant": str(tuned["variant"])}
    extra = {}
    if lane in DEBLUR_LANES:
        extra = {"search_step": int(tuned.get("search_step", 1)),
                 "matcher": str(tuned.get("matcher", "xla")),
                 "match_dtype": str(tuned.get("match_dtype", "float32"))}
    return {**spec, **cfg, "params": BM3DParams(search=8, **extra)}


def _lane_tensor(device):
    """numpy -> a copied tensor on ``device`` with a leading lane axis."""
    return lambda a, dtype=torch.float32: torch.tensor(np.asarray(a)[None], dtype=dtype, device=device)


def deblur_from_numpy(arrays: dict, device=None) -> Deblur:
    """A one-lane port ``Deblur`` from one JAX ``Deblur``'s fields as numpy
    arrays: ``y`` (M,), ``b`` (N,), ``x``, ``x_init`` (H, W), ``ds_idx``,
    ``ds_w`` (M, 4) and optional ``b_adj`` (derived), ``allowed`` (all
    ones), ``snr``, ``sigma`` (0). Lanes stack with ``stack_problems``."""
    dev = resolve_device(device)
    as_t = _lane_tensor(dev)
    b = as_t(np.asarray(arrays["b"]).reshape(-1))
    y = as_t(arrays["y"])
    return Deblur(
        y=y, b=b,
        b_adj=as_t(arrays["b_adj"]) if "b_adj" in arrays else fft_blur_1d_adjoint_kernel(b),
        x=as_t(arrays["x"]), x_init=as_t(arrays["x_init"]),
        ds_idx=as_t(arrays["ds_idx"], torch.int64)[0], ds_w=as_t(arrays["ds_w"])[0],
        ds_adj=torch.as_tensor(bilinear_adjoint_table(arrays["ds_idx"], b.shape[-1]), device=dev),
        allowed=as_t(arrays["allowed"]) if "allowed" in arrays else torch.ones_like(y),
        snr=as_t(arrays.get("snr", 0.0)), sigma=as_t(arrays.get("sigma", 0.0)),
    )


def pr_from_numpy(arrays: dict, device=None) -> PhaseRetrieval:
    """A one-lane port ``PhaseRetrieval`` from one JAX problem's fields as
    numpy arrays: ``a`` (M, N), ``y`` (M,), ``x``, ``x_init`` (H, W) and
    optional ``snr``, ``sigma`` (0). Lanes stack with ``stack_problems``."""
    as_t = _lane_tensor(resolve_device(device))
    return PhaseRetrieval(a=as_t(arrays["a"]), y=as_t(arrays["y"]), x=as_t(arrays["x"]),
                          x_init=as_t(arrays["x_init"]), snr=as_t(arrays.get("snr", 0.0)),
                          sigma=as_t(arrays.get("sigma", 0.0)))


def _fixture(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def load_deblur_problem(lane: str, device=None, path=DEBLUR_FIXTURE) -> Deblur:
    """The one-lane problem of a Deblur lane (``"deblur_bm3d"`` or
    ``"deblur_sr_bm3d"``) as the JAX package builds it: ``y``, ``x_init``,
    ``sigma`` and ``snr`` from the fixture, the ground truth from the
    port's ``load_image``, the kernel from ``make_minimal_kernel`` or, for
    the image kernel, the fixture."""
    cfg = BENCH_LANES[lane]
    data = _fixture(path)
    size = cfg["size"]
    n = size * size
    lr = int(size * cfg["scale_percent"] / 100)
    if f"{lane}/b" in data:
        b = data[f"{lane}/b"]
    else:
        b = deblur_kernel(cfg["kernel"], size, size).reshape(-1) / np.float32(n)
    idx, wts = bilinear_gather_params(size, size, lr, lr)
    return deblur_from_numpy({
        "y": data[f"{lane}/y"], "b": b, "x": load_image(cfg["image"], size, size),
        "x_init": data[f"{lane}/x_init"], "ds_idx": idx, "ds_w": wts,
        "snr": data[f"{lane}/snr"], "sigma": data[f"{lane}/sigma"],
    }, device)


def load_deblur_masks(lane: str, device=None, path=DEBLUR_FIXTURE) -> torch.Tensor:
    """(n_outer, t2, 1, M) float32 minibatch masks of the JAX run of a Deblur
    lane (``PRNGKey(2)``), for ``pnp_svrg(..., masks=...)``."""
    packed = _fixture(path)[f"{lane}/masks"]
    return torch.as_tensor(np.unpackbits(packed, axis=-1).astype(np.float32),
                           device=resolve_device(device))


def load_deblur_reference(lane: str = "deblur_bm3d", path=DEBLUR_FIXTURE) -> dict:
    """The JAX CPU run of a Deblur lane on its masks: ``psnr_per_iter``
    (``1 + n_outer*(t2+1)`` entries) and final ``ssim``. The SR lane's run
    took its own matcher rounding (the Pallas matcher's bf16, interpreted)."""
    data = _fixture(path)
    return {"psnr_per_iter": data[f"{lane}/psnr_per_iter"], "ssim": float(data[f"{lane}/ssim"])}


def pr_matrix_blocks(seed: int, m: int, n: int):
    """The PR lane's (m, n) Gaussian matrix as (first row, float32 block of
    :data:`PR_BLOCK_ROWS` rows), drawn row-major from
    ``numpy.random.RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    for r0 in range(0, m, PR_BLOCK_ROWS):
        yield r0, rs.standard_normal((min(PR_BLOCK_ROWS, m - r0), n)).astype(np.float32)


def pr_matrix(seed: int, m: int, n: int, device=None) -> tuple[torch.Tensor, dict]:
    """(1, m, n) float32 matrix of :func:`pr_matrix_blocks` on ``device`` and
    its checksum: ``sum`` (float64) and the ``entries`` at
    :data:`PR_CHECK_ENTRIES` that lie inside it."""
    a = torch.empty((1, m, n), dtype=torch.float32, device=resolve_device(device))
    total = 0.0
    entries = []
    for r0, block in pr_matrix_blocks(seed, m, n):
        a[0, r0 : r0 + block.shape[0]] = torch.from_numpy(block)
        total += float(block.sum(dtype=np.float64))
        entries += [float(block[r - r0, c]) for r, c in PR_CHECK_ENTRIES
                    if r0 <= r < r0 + block.shape[0]]
    return a, {"sum": total, "entries": entries}


def load_pr_problem(device=None, path=PR_FIXTURE) -> PhaseRetrieval:
    """The one-lane PR + BM3D problem: A rebuilt by :func:`pr_matrix` and
    checked against the fixture's checksum (raises on a mismatch), ``y``,
    ``x_init``, ``sigma`` and ``snr`` from the fixture, the ground truth
    from the port's ``load_image``."""
    cfg = BENCH_LANES["pr_bm3d"]
    data = _fixture(path)
    size = cfg["size"]
    a, check = pr_matrix(int(data["seed"]), cfg["num_meas"], size * size, device)
    want = data["a_entries"].tolist()
    if check["entries"] != want or abs(check["sum"] - float(data["a_sum"])) > 1e-6:
        raise RuntimeError(f"PR matrix checksum {check} differs from the fixture's "
                           f"sum {float(data['a_sum'])}, entries {want}")
    x = torch.as_tensor(load_image(cfg["image"], size, size), device=a.device)[None]
    lane = lambda k: torch.as_tensor(np.asarray(data[k], np.float32).reshape(1), device=a.device)  # noqa: E731
    return PhaseRetrieval(a=a, y=torch.as_tensor(data["y"][None], device=a.device), x=x,
                          x_init=torch.as_tensor(data["x_init"][None], device=a.device),
                          snr=lane("snr"), sigma=lane("sigma"))


def load_pr_indices(device=None, path=PR_FIXTURE) -> torch.Tensor:
    """(n_outer, t2, 1, k) int64 minibatch row indices of the JAX PR run
    (``PRNGKey(5)``), for ``pnp_svrg(..., masks=...)``."""
    return torch.as_tensor(_fixture(path)["indices"].astype(np.int64), device=resolve_device(device))


def load_pr_reference(path=PR_FIXTURE) -> dict:
    """The JAX CPU run of the PR + BM3D lane on those indices:
    ``psnr_per_iter`` and final ``ssim``."""
    data = _fixture(path)
    return {"psnr_per_iter": data["psnr_per_iter"], "ssim": float(data["ssim"])}


def load_pr_sarah_problem(device=None, path=PR_FIXTURE):
    """The PR + SARAH lane's problem: the PR fixture's one-lane problem
    (:func:`load_pr_problem`, A from ``RandomState(4)``) as
    ``replicas`` identical lanes that hold A once, (1, M, N)."""
    one = load_pr_problem(device, path)
    return stack_problems([one] * bench_config("pr_sarah_realsn")["replicas"])


def load_pr_sarah_indices(device=None, path=PR_SARAH_FIXTURE) -> torch.Tensor:
    """(n_outer, t2, replicas, k) int64 minibatch row indices of the JAX
    PR + SARAH run (``PRNGKey(5)``, per lane ``fold_in``), for
    ``pnp_sarah(..., masks=...)``."""
    return torch.as_tensor(_fixture(path)["indices"].astype(np.int64), device=resolve_device(device))


def load_pr_sarah_reference(path=PR_SARAH_FIXTURE) -> dict:
    """The JAX CPU run of the PR + SARAH lane on those indices:
    ``psnr_per_iter`` (1 + n_outer*(t2+1), replicas) and the per-replica
    final ``ssim`` (replicas,)."""
    data = _fixture(path)
    return {"psnr_per_iter": data["psnr_per_iter"], "ssim": data["ssim"]}


def checksum(a) -> str:
    """SHA-256 of an array's values as C-ordered f32 bytes (numpy array or
    tensor on any device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float32).tobytes()).hexdigest()


def load_paper_csmri_problem(driver: str, device=None, path=PAPER_DRIVERS_FIXTURE) -> CSMRI:
    """The one-lane CSMRI problem the JAX driver ``driver`` (a key of
    :data:`PAPER_PROBLEMS`) builds, the ground truth from the port's
    ``load_image``."""
    image, size = PAPER_PROBLEMS[driver]
    data = _fixture(path)
    field = lambda k: data[f"{driver}/{k}"][None]  # noqa: E731
    mask = np.unpackbits(field("mask"), axis=-1).astype(np.float32)
    return csmri_from_numpy({"y": field("y"), "mask": mask, "x": load_image(image, size, size)[None],
                             "x_init": field("x_init"), "m0": field("m0"), "snr": field("snr"),
                             "sigma": field("sigma")}, device)


def load_paper_deblur_problem(device=None, path=PAPER_DRIVERS_FIXTURE, deblur_path=DEBLUR_FIXTURE) -> Deblur:
    """paper_deblur's problem (``make_deblur(PRNGKey(0), Set12/01 256,
    "Minimal", 100, snr=5)``): the ``deblur_bm3d`` lane of the Deblur
    fixture, whose ``y`` and ``x_init`` must have the checksums the drivers'
    fixture keeps of the JAX driver's (raises otherwise)."""
    prob = load_deblur_problem("deblur_bm3d", device, deblur_path)
    data = _fixture(path)
    for name in ("y", "x_init"):
        want = str(data[f"paper_deblur/{name}_sha256"])
        if checksum(getattr(prob, name)) != want:
            raise RuntimeError(f"paper_deblur's {name} checksum differs from the JAX driver's {want}")
    return prob


def load_paper_reference(path=PAPER_DRIVERS_FIXTURE) -> dict:
    """The JAX CPU runs of the drivers: ``{driver: {table: {"init_psnr":
    float, "rows": {row: {"final_psnr", "final_ssim"[, "psnr_per_iter"]}}}}}``
    in the tables' row order, and ``["rgb_csmri"]["default"]``'s
    ``channels_init`` and ``channels_recon`` (3,) PSNRs."""
    data = _fixture(path)
    ref = {}
    for driver, tables in PAPER_TABLES.items():
        for table in tables:
            key = f"{driver}/{table}"
            rows = {}
            for name in data[f"{key}/rows"].tolist():
                fields = {f: data[f"{key}/{name}/{f}"] for f in ("final_psnr", "final_ssim", "psnr_per_iter")
                          if f"{key}/{name}/{f}" in data}
                rows[name] = {f: float(v) if v.ndim == 0 else v for f, v in fields.items()}
            ref.setdefault(driver, {})[table] = {"init_psnr": float(data[f"{key}/init_psnr"]), "rows": rows}
    ref["rgb_csmri"] = {"default": {k: data[f"rgb_csmri/default/{k}"] for k in ("channels_init", "channels_recon")}}
    return ref


def load_realsn_export_reference(name: str, path=REALSN_EXPORT_FIXTURE) -> dict:
    """What the JAX package's ``tools/check_realsn_export.py`` computes on the
    CPU for ``checkpoints/<name>.npz``: ``sigmas`` (per layer, its power
    iterations from JAX's start vectors), ``dense`` (the dense VALID
    operator's top singular value of the first 3 layers and the last, probe
    10), ``val_psnr_per_image`` and ``val_ssim_per_image`` (Set12, sorted),
    float64."""
    data = _fixture(path)
    return {k: data[f"{name}/{k}"] for k in ("sigmas", "dense", "val_psnr_per_image", "val_ssim_per_image")}


def load_train_reference(path=TRAIN_FIXTURE) -> dict:
    """The JAX CPU run on the committed training state (see the module
    docstring): numpy arrays, checksums as strings."""
    return {k: (str(v) if v.dtype.kind == "U" and v.ndim == 0 else v) for k, v in _fixture(path).items()}
