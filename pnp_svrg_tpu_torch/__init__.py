"""pnp_svrg_tpu_torch: the PyTorch/CUDA port of ``pnp_svrg_tpu``.

A second package beside the JAX reference. It imports torch, numpy and PIL
only -- never jax and nothing of ``pnp_svrg_tpu`` -- and mirrors the
reference's module names. Entry points run on CUDA unless the caller passes
``device="cpu"``; the BM3D block matching and aggregation scatter and the
non-local means denoiser run as hand-written CUDA kernels on the card
(``csrc/``, built on first use) and as their plain PyTorch versions on the
CPU.

Ported: the Set12 CSMRI + PnP-SVRG + BM3D path, with its grid-aligned
dense aggregation, the CSMRI + PnP-SVRG + NLM path, phase retrieval and
Deblur/SR with BM3D, phase retrieval + PnP-SARAH + RealSN-DnCNN, the
tuning path, denoiser training, the distributed layer, the utilities and
the paper and demo drivers -- everything the JAX package does, except
training on the reference's 400-image set (not in the repository) and
NCCL across several cards:

* ``problems.csmri`` (``CSMRI``, ``make_csmri``), ``problems.deblur``
  (``Deblur``, ``make_deblur``), ``problems.pr`` (``PhaseRetrieval``,
  ``make_phase_retrieval``, ``spectral_init``), ``core.batched.stack_problems``
* ``denoisers.bm3d`` (``BM3DParams``, ``BM3DDenoiser``, ``bm3d_denoise_batch``)
* ``denoisers.nlm`` (``NLMDenoiser``; ``nlm_denoise`` in ``ops.cuda.nlm``)
* ``denoisers.tv`` (``TVDenoiser``, the wavelet BayesShrink denoiser)
* ``denoisers.dncnn`` (``DnCNNDenoiser``, ``MMODenoiser``) on the models of
  ``models.dncnn`` with the Flax checkpoints' weights (``models.convert``)
* ``algorithms.loops``: ``pnp_gd``, ``pnp_sgd``, ``pnp_svrg``, ``pnp_saga``
  (its table sharded or not), ``pnp_sarah`` and ``run_pnp``
* ``algorithms.compat``: the reference-shaped wall-clock API (one-lane
  problems) and its ``tune_pnp_*`` adapters
* ``core.checks``: ``grad_full_check``, ``grad_stoch_check``
* ``tuning``: TPE (``tpe.py``, a copy of the numpy original) and the sweeps
  (``sweep_grid``, ``sweep_grid_lockstep``); the sweep and tuner scripts are
  ``python -m pnp_svrg_tpu_torch.examples.<name>``
* ``training``: RealSN-DnCNN training (``TrainConfig``, ``train``,
  ``evaluate``, the patch pipeline, config-guarded checkpoints in the JAX
  package's layout) on ``models.spectral_norm`` (the conv-operator spectral
  norm) and ``models.dncnn`` in training mode; the script is
  ``python -m pnp_svrg_tpu_torch.examples.train_realsn``
* ``parallel``: meshes over ``torch.distributed`` (or emulated in one
  process), measurement-split and row-sharded (halo) loops, the sharded
  phase retrieval step, ``run_batch``, ``dryrun_multichip``; the scaling
  script is ``python -m pnp_svrg_tpu_torch.examples.scaling``
* ``utils``: ``config`` (``Params``, ``ExperimentConfig``), ``log``
  (``set_logger``), ``profiling`` (``fence``, ``scalar_fence``,
  ``PhaseTimers``, ``trace`` and ``annotate`` on ``torch.profiler``) and
  ``viz`` (the metrics CSV, the figures, ``reconstruct_rgb``)
* the paper and demo drivers: ``python -m
  pnp_svrg_tpu_torch.examples.{paper_csmri,paper_deblur,paper_pr,pnp_csmri_demo,rgb_csmri}``
* ``ops``: metrics, sampling, wavelets, ``estimate_sigma``, transforms, the
  1-D FFT blur and the bilinear resize pair
* ``convert``: problem data and tuned per-lane parameters from the JAX side
"""

from pnp_svrg_tpu_torch.device import default_device, resolve_device
from pnp_svrg_tpu_torch.algorithms import compat
from pnp_svrg_tpu_torch.algorithms.compat import (
    tune_pnp_gd,
    tune_pnp_saga,
    tune_pnp_sarah,
    tune_pnp_sgd,
    tune_pnp_svrg,
)
from pnp_svrg_tpu_torch.algorithms.loops import pnp_gd, pnp_saga, pnp_sarah, pnp_sgd, pnp_svrg, run_pnp
from pnp_svrg_tpu_torch.core.checks import GradientCheckError, grad_full_check, grad_stoch_check
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams, bm3d_denoise_batch
from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser, MMODenoiser
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser, nlm_denoise
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.problems.csmri import CSMRI, make_csmri
from pnp_svrg_tpu_torch.problems.deblur import Deblur, make_deblur
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval, make_phase_retrieval

__all__ = [
    "default_device",
    "resolve_device",
    "pnp_gd",
    "pnp_sgd",
    "pnp_svrg",
    "pnp_saga",
    "pnp_sarah",
    "run_pnp",
    "compat",
    "tune_pnp_gd",
    "tune_pnp_sgd",
    "tune_pnp_svrg",
    "tune_pnp_saga",
    "tune_pnp_sarah",
    "grad_full_check",
    "grad_stoch_check",
    "GradientCheckError",
    "stack_problems",
    "BM3DDenoiser",
    "BM3DParams",
    "bm3d_denoise_batch",
    "DnCNNDenoiser",
    "MMODenoiser",
    "NLMDenoiser",
    "nlm_denoise",
    "TVDenoiser",
    "CSMRI",
    "make_csmri",
    "Deblur",
    "make_deblur",
    "PhaseRetrieval",
    "make_phase_retrieval",
]
