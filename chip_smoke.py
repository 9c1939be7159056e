#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pnp_svrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the repository root with no arguments and needs one CUDA card; it
imports no JAX. Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` of ``pnp_svrg_tpu_torch/csrc/*.cu`` for ``sm_90a``, with
   ptxas's registers and spills, the atomic opcodes in each kernel's SASS
   (none may add floats: the fixed summation orders rest on it) and the
   instruction mix of K3's shift loop;
3. kernels: K1 (block matching) and K2 (the fused aggregation: scatter and
   unfold-add) against their plain PyTorch versions at the headline shapes,
   on real inputs (the headline batch's ``x_init``, a stage-1 BM3D estimate
   and its aggregation's arguments), with CUDA-event times, the plain and
   library times and the bounds, K2 also bit for bit on dyadic values with
   the same rows and over 50 more calls on the same arguments (bit for bit
   the first, at every shape it is checked at); K1 in every rounding mode
   at 289, 81 and
   25 offsets, held slot by slot (the same offset or a near-tie), and K2
   beside the dense aggregation at the turbo4 shape;
   K1 and K2 again at B = 1 on the first BM3D input of each of the PR,
   Deblur and Deblur-SR lanes (128 px f32 at 289 offsets, 256 px f32 at
   289, 256 px ``bf16_pallas`` at 81);
   K3 (non-local means) against its plain version on real NLM inputs (the
   ``13.png`` lane's ``x_init`` after one gradient step) at B = 1 and at
   B = 9 on distinct lanes (each grid pair's own step and h), with and
   without row bounds, and NaN at ``h = 0``; K1 with row bounds at the
   spatial path's shapes (the deblur_bm3d lane's 256 px input cut into its
   two shards' halo-extended 192 x 256 blocks, bounds (32, 192) and
   (0, 160)); K1 at search 12 (625 offsets, its ``PER=20`` instantiation)
   at the search12 lane's shape, equal to its plain version on dyadic
   images and slot by slot on the lane's first BM3D input, in every mode,
   with ptxas's registers and spills for ``PER=20``; and the
   kernels at the envelope's points on the bm3d_profile lane's first
   denoise input and its stage-1 estimate (B = 13, 128 px): K1 at 1,521
   offsets with 16 and 32 matches, at 2,401 with 16, at the golden
   oracle's (block 4, 49 offsets, k 4; also with row bounds, and equal on
   dyadic images there) and at blocks 2, 5, 6, 16 and 4 with the reference
   profile's window (the span kernel's rows), every rounding mode, on its
   rules, each redesigned kernel beside the any-kernel on the same call;
   K2 at (8, 32) and (8, 16) at step 3, search 19, and at (4, 4), on its
   rules; K3 at (7, 11), (1, 1) and (11, 15) on B = 1 and B = 9, within
   1e-5, NaN at h = 0; each with its time, bound and launches; and the
   rows past the earlier envelope on the same inputs and rules (K1 at a
   step past the block, block 4 at step 6, search 32, block 4 at search 40,
   k 128, blocks 1 and 24, the widest search at block 8 and k 16; K2 at the
   first five of those with their K; K3 at (13, 21) and (21, 31), whose
   kernel reads the patch at run time); then ``wide_calls``: one
   ``BM3DDenoiser`` denoise at search 32, a step past the block and 128
   Wiener matches on two lanes of bm3d_profile's first denoise input, and
   one ``NLMDenoiser`` denoise at (13, 21) on the CSMRI + NLM lane's, each
   within 0.01 dB of the JAX CPU output on the same input
   (``params_wide_jax.npz``), its launches on the kernels the naming
   functions give; and ``convert``: the committed DnCNN, SimpleCNN and MMO
   checkpoints rebuilt as the reference's three ``.pth`` layouts in a
   temporary directory, the port's ``convert_all`` on them, and a 128 px
   Set12 denoise with each output bit for bit the committed checkpoint's;
4. parity: small faithful-variant reconstructions (BM3D, NLM and the
   wavelet "TV" denoiser) on the card against the same runs on the CPU
   (plain kernel versions), and a standalone BM3D denoise on the card;
5. headline: the 13-lane 128x128 Set12 CSMRI + PnP-SVRG (16 x 10, minibatch
   4000) + BM3D (search 8, bf16 match distances) lane: one warm-up run and
   one timed run on the port's own generator, with the kernels' launch
   counts over the timed run (which fails on any implicit host-device
   synchronisation); then one run on the JAX reference's minibatch
   masks (``headline_masks_key2.npz``), whose quality is comparable lane by
   lane with the reference's and is held to the floor; then the port's own
   stream on six more seeds, for the spread of quality across streams; then
   one more run under ``torch.profiler`` (every lane of 5-7a: its
   ``profile`` record and device ms);
6. turbo: the same with ``search_step=2`` and the Pallas matcher's bf16
   rounding;
7. turbo4: the same with ``search_step=4``, where the aggregation is the
   scatter-free dense one (no K2);
7a. set12_uniform, f32_match, search12: ``bench.py``'s other lanes on a
   13-lane batch (``bench.py:383-463``) in the headline's pattern, each held
   on the JAX run's masks to the JAX CPU run there less 0.5 dB, with its
   rate and device time beside the headline's: set12_uniform on its own problems
   (``keep_low_freq=0`` on every lane, ``set12_uniform_*.npz``; per lane the
   init PSNR, the final PSNR and whether the mask lost the zero frequency;
   the spread seeds), f32_match (f32 match distances) and search12 (625
   offsets, f32) on the headline's, without the spread seeds;
7b. bm3d_profile: the headline batch and tuning with the
   reference's own BM3D, ``bm3d`` 3.0.9's default profile (8 x 8 blocks,
   step 3, a 39 x 39 window: 1,521 offsets; 16 matches in the
   hard-threshold stage, 32 in the Wiener stage; ``bf16_xla``), in the
   headline's pattern without the spread seeds: K1 through its tile
   kernel (``bm3d_match_tile_kernel``: every one of its 320 launches, and
   the kernel's name in the profile's K1 group, the any-kernel's not),
   K2 through its (8, 32) and (8, 16) code, 320 launches each;
   two runs on the JAX masks bitwise equal, their Set12-VD mean held to the
   JAX CPU run less 0.5 dB (``params_envelope_jax.npz``), and one BM3D call
   on each lane's first denoise input as the JAX loop forms it held to the
   JAX CPU output there, each lane's PSNR within 0.01 dB;
8. csmri_nlm: the one-lane ``13.png`` CSMRI + PnP-SVRG + NLM lane
   (``bench.py:465-506``) in the same pattern; its run on the JAX lane's
   minibatch masks (``csmri_nlm_masks_key2.npz``) is held entry by entry to
   the JAX run's PSNR trace stored beside them;
8b. csmri_nlm_skimage: the same lane with skimage's NLM defaults
   (patch 7, distance 11: 529 shifts, K3's any-kernel), 160 launches; two
   runs on the JAX masks bitwise equal, every trace entry within 0.05 dB of
   the JAX CPU trace of the same run;
9. csmri_nlm_grid: the NLM tuner's chunk, 9 lanes of that problem with the
   3 x 3 (eta, sigma_modifier) grid of ``data/csmri_nlm_tuned.json``;
10. pr_bm3d, deblur_bm3d, deblur_sr_bm3d: ``bench.py``'s phase retrieval
   (Set12/04 at 128 px, M = 8192), Deblur (Set12/01 at 256 px, Minimal
   kernel) and Deblur-SR (256 -> 128 px, ``kernel25.png``) lanes with BM3D,
   one lane each (B = 1), in the same pattern (three spread seeds), on the
   problems the JAX package built (``pr_bm3d_128.npz``, ``deblur_256.npz``);
   three runs each on the JAX runs' minibatches, bitwise equal (trace and
   final iterate), whose mean is held to the lane's quality floor (Deblur: 0.5 dB under ``BENCH_r05.json``; PR and
   Deblur-SR: 0.5 dB under the JAX CPU run on the same problem and
   minibatches, whose trace is reported beside), and each problem is also
   built once through
   ``make_phase_retrieval`` or ``make_deblur`` on the card;
11. pr_sarah_realsn: ``bench.py``'s PR + PnP-SARAH + RealSN-DnCNN lane (8
   replicas of the PR problem, A held once, 30 x 8, minibatch 800,
   RealSN-DnCNN sigma 5): a warm-up and a timed run on the port's own
   generator (image-iterations/s, peak device memory), then two runs on the
   JAX run's row indices (``pr_sarah_realsn_128.npz``), whose replica-mean
   PSNR is held to the JAX CPU run's less 0.5 dB, whose first two outer
   rounds are held entry by entry to the JAX trace, and which must repeat
   each other bit for bit, trace and final iterate (cuDNN is held to
   deterministic algorithms);
12. loops: ``run_pnp`` drives GD, SGD, SAGA and SARAH (both variants) on the
   CSMRI + NLM lane's problem, each a few steps: finite traces, K3 launched
   once a denoise, and ``pnp_gd``'s trace held to a JAX CPU ``pnp_gd`` trace
   stored in the NLM fixture;
13. compat: the wall-clock compat API on the CSMRI + NLM lane's problem:
   ``compat.pnp_svrg`` for 40 inner steps against ``pnp_svrg`` 4 x 10 on
   the same minibatches (the JAX lane's), traces within 0.011 dB and
   iterates within 1e-4; ``tune_pnp_svrg`` for a 3 s budget (its inner
   steps, gradient/denoise split and loss; K3 once a denoise); and
   ``tune_pnp_svrg`` for 3 s with BM3D on the headline's ``13.png`` lane
   (K1 and K2 twice a denoise);
14. checks: ``grad_full_check`` and ``grad_stoch_check`` in float64 at
   their default tolerances on CSMRI (128 px), phase retrieval (M = 8192,
   N = 16384), Deblur (256 px) and Deblur-SR (256 -> 128 px);
15. train: RealSN-DnCNN training at full width (depth 17, 64 features,
   BatchNorm, lip 0.3, sigma 40/255, batch 128, 40 x 40 patches; the config
   of ``checkpoints/exp_realsn_noise40/``), in three parts. (a) The committed
   JAX training state through the port's ``load_checkpoint``: the 17
   per-layer sigmas after 30 power iterations against the JAX CPU values of
   ``train_realsn_noise40.npz`` (relative 1e-4), and ``evaluate`` of the
   effective network on Set12 against the JAX CPU ``evaluate`` (PSNR within
   0.01 dB, SSIM within 1e-4). (b) From that raw state with a fresh Adam at
   lr 1e-4, 3 steps on the first 3 batches of the ``data/RGB`` patch set
   (seed 0), rebuilt on the card, whose checksums and losses (relative
   1e-4) are held to the fixture; then 50 timed steps (steps/s, patches/s,
   peak memory), a profile of 10 steps (device time by cuDNN conv forward /
   dgrad / wgrad, BatchNorm, elementwise, reductions, Adam; busy share) and
   the power iteration's device time alone. (c) ``train()`` end to end from
   a fresh init, 1 epoch of 100 steps into ``build/train_smoke/``; the
   config guard refusing ``epochs=2`` on that directory; a directory seeded
   with its epoch-1 state under ``epochs=2``, which ``train()`` resumes at
   epoch 1 for 10 steps (the mean of those last 10 losses under the
   zero-predictor loss); the effective network exported in the Flax layout,
   reloaded through ``flax_model`` and evaluated to ``train()``'s PSNR;
16. parallel (``parallel/``): (a) the headline batch meas-split in two
   shards in this process, on the JAX masks split by the two row blocks,
   against the unsharded run on the same masks (its first two outer rounds,
   within 1e-3 dB plus twice the spread of the unsharded runs from
   ``x_init`` as built, one ulp down and one ulp up; four unsharded runs on
   the same masks bitwise equal; Set12-VD mean >= 25.5 dB), with both runs'
   device time; then two ranks on the one card over gloo, spawned once: (b)
   the same program, each rank one shard denoising its own replicated
   iterate (the ranks bit for bit equal with no ``broadcast``, and held to
   (a) as (a) to the unsharded run), with its ``all_reduce`` count and
   their host and device time; (c) phase retrieval with A's rows split,
   half on each rank: ``pr_grad_full_sharded`` (1e-5 relative), one
   ``sharded_pnp_step`` on two lanes (1e-3 dB) and two outer rounds of the
   meas-split PnP-SVRG on stratified row indices against the unsharded run
   on their union (its tolerance as (a)'s, from the PR problem's runs); (d) ``pnp_saga`` with its table sharded against the
   unsharded table, bit for bit, in one process and on the two ranks; (e)
   ``run_batch(..., image_shards=2)``: NLM on the csmri_nlm lane (1e-4 dB),
   BM3D on the deblur_bm3d lane (0.05 dB, >= 18.60 dB), and the row-sharded
   NLM and BM3D denoise of a 256 px image against the unsharded one; (g)
   ``examples/scaling.py`` at one rank and at two ranks on the one card (no
   scaling claim); (h) ``dryrun_multichip(2)``. Every rank's failure,
   time-out or disagreement fails the phase;
17. drivers: the paper and demo drivers (``python -m
   pnp_svrg_tpu_torch.examples.<name>``) at their full default sizes: (a)
   paper_csmri under both ``--eta-scale`` tables (13.png at 128 px, BM3D),
   paper_deblur (Set12/01 at 256 px, BM3D), paper_pr under both
   ``--config`` tables (Set12/04 at 128 px, M = 8192; BM3D, MMO and RealSN
   rows), the demo (13.png at 256 px, RealSN) and rgb_csmri (128 px, TV),
   each on the port's own problem through its ``main`` (the demo's and RGB's
   compute parts where the card's Python has no matplotlib), every row's
   final PSNR and SSIM, seconds and launches (K1 = K2 = 2 a BM3D denoise, 0
   on the other rows; K3 = 0) beside the JAX CPU row of
   ``paper_drivers.npz``; finite, and above its init PSNR wherever the JAX
   row is; (b) the deterministic anchor rows (paper_csmri's ``gd`` under
   both tables, paper_deblur's ``gd+bm3d``, the demo's ``PnP-GD``) three
   times each on the JAX driver's own problem, through the driver's row
   table, bitwise equal, every trace entry within 0.05 dB of the JAX CPU
   trace, or within 1e-3 dB plus twice the spread of the runs from
   ``x_init`` as built, one ulp down and one ulp up where that is wider
   (the stability edge amplifies rounding); (c) the utilities on the card:
   ``PhaseTimers``
   in both fence modes around a 128 px BM3D denoise (each total at least
   that call's device time, the stream idle after it), ``trace`` over one
   denoise in ``annotate("bm3d")`` naming K1, K2 and the region, and
   ``scalar_fence`` leaving the stream idle; a CSMRI row's gap to the JAX
   row is compared only where both problems' masks hold the zero frequency;
17a. check_realsn_export: ``python -m
   pnp_svrg_tpu_torch.examples.check_realsn_export`` (its ``main``) on the
   three committed RealSN-DnCNN exports, writing under ``build/``: every
   layer's spectral norm within 1.05 of its target and the product within
   1.1 of ``lip``; Set12 PSNR and SSIM and the dense SVD against the JAX
   CPU run of the JAX tool's functions (``realsn_export_jax.npz``);
18. profile: one more run each of csmri_nlm, the grid,
   pr_bm3d, deblur_sr_bm3d and pr_sarah_realsn, and one BM3D round of the
   sweep, under ``torch.profiler``: device time by kernel, grouped (the CNN
   denoiser's convolutions and BatchNorm as cuDNN's), and the device's busy
   share of the run's wall time.

Before the kernel checks, the ``sweep`` phase drives the tuning path at full
width: ``python -m pnp_svrg_tpu_torch.examples.sweep_sampratio`` (its
``main``) over the 12 Set12 images at 128 px, ratio 0.5, SNR 20, PnP-SVRG
with BM3D and with NLM, 6 TPE evaluations a cell in 2 lockstep rounds of 3
candidates: 36 lanes a round (``BASELINE.json`` configs[4], the reference's
Set12 sweep). It checks the CSV (24 cells, every best inside its space and
better than ``x_init``) and each round's launches (K1 = K2 = 2 x n_outer x
t2 under BM3D, K3 = n_outer x t2 under NLM), and reports seconds a round,
trials/s and image-iterations/s a group. The kernel checks then also hold
K1 and K2 on a BM3D round's first denoise input (B = 36) and K3 on an NLM
round's (B = 36, each lane its own h and sigma) against their plain
versions.

The tuned per-lane step sizes sit at the stability edge of the reference's
own key stream: on other minibatch streams single lanes diverge, so the
port-stream quality is reported and checked for NaN, and the quality floor
applies to the reference-minibatch run.

Every phase's record carries ``t_s``, the seconds since the script started.
Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises, and the script exits non-zero without the last line.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import gc
import importlib
import importlib.util
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.algorithms import compat
from pnp_svrg_tpu_torch.algorithms.loops import pnp_saga, pnp_sarah, pnp_svrg, run_pnp
from pnp_svrg_tpu_torch.convert import (
    BENCH_LANES,
    BM3D_PROFILE_LANE,
    CSMRI_BATCH_LANES,
    NLM_SKIMAGE,
    NLM_LANE,
    bench_config,
    lane_params,
    load_deblur_masks,
    load_deblur_problem,
    load_deblur_reference,
    load_batch_lane_reference,
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
    nlm_params,
    PAPER_ANCHORS,
    PAPER_TABLES,
    load_paper_csmri_problem,
    load_paper_deblur_problem,
    load_paper_reference,
    TRAIN_BATCH_SEED,
    TRAIN_DIR,
    TRAIN_EXP,
    TRAIN_SN_ITERS,
    TRAIN_STEP_LR,
    TRAIN_STEPS,
    VAL_DIR,
    checksum,
    load_realsn_export_reference,
    load_train_reference,
    load_uniform_masks,
    load_uniform_problems,
    load_wide_reference,
    WIDE_BM3D,
    WIDE_NLM,
)
from pnp_svrg_tpu_torch.denoisers.bm3d import (
    BM3DDenoiser,
    BM3DParams,
    bm3d_denoise,
    _aggregate,
    _aggregate_dense,
    _geometry,
    _ref_grid,
    _stage1,
    bm3d_denoise_batch,
    match_mode,
    search_offsets,
    stage1_aggregate_inputs,
)
from pnp_svrg_tpu_torch.denoisers.dncnn import CHECKPOINT_DIR, DnCNNDenoiser, MMODenoiser, flax_model
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1_module
from pnp_svrg_tpu_torch.ops.cuda.bm3d_match import (
    K1_KERNELS,
    MODES,
    bm3d_match,
    bm3d_match_plain,
    match_distances_plain,
    match_geometry,
    match_kernel,
    match_search_limit,
)
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2_module
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3_module
from pnp_svrg_tpu_torch.ops.cuda.bm3d_aggregate import (
    K2_KERNELS,
    aggregate_geometry,
    aggregate_kernel,
    bm3d_aggregate,
    bm3d_aggregate_plain,
)
from pnp_svrg_tpu_torch.ops.cuda.nlm import K3_KERNELS, nlm_denoise, nlm_denoise_plain, nlm_kernel_name
from pnp_svrg_tpu_torch.ops.metrics import psnr as image_psnr, ssim
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.problems.deblur import make_deblur
from pnp_svrg_tpu_torch.problems.pr import make_phase_retrieval
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.core.checks import grad_full_check, grad_stoch_check, widen
from pnp_svrg_tpu_torch.examples import check_realsn_export, sweep_sampratio
from pnp_svrg_tpu_torch.models import (
    DnCNN,
    flax_variables_from_torch,
    load_flax_npz,
    save_flax_npz,
    torch_state_dict_from_flax,
    u_state_from_flax,
)
from pnp_svrg_tpu_torch.models.convert import CONVERSIONS, convert_all, flax_layers
from pnp_svrg_tpu_torch.models.dncnn import MMOSimpleCNN, model_for_type
from pnp_svrg_tpu_torch.models.spectral_norm import sigma_uv
from pnp_svrg_tpu_torch.training import ConfigMismatch, TrainConfig, evaluate, load_checkpoint, save_checkpoint, train
from pnp_svrg_tpu_torch.training.data import batches, build_patch_dataset, load_gray
from pnp_svrg_tpu_torch.training.train_dncnn import effective_variables, new_optimizer, sn_pairs, train_step
from pnp_svrg_tpu_torch.tuning import sweep as sweep_module
from pnp_svrg_tpu_torch.examples import scaling
from pnp_svrg_tpu_torch.parallel import (
    bm3d_denoise_spatial,
    make_mesh,
    make_spatial_mesh,
    nlm_denoise_spatial,
    pr_grad_full_sharded,
    run_batch,
    run_batch_meas_emulated,
    shard_pr_problem,
    sharded_pnp_step,
)
from pnp_svrg_tpu_torch.parallel.dryrun import dryrun_multichip
from pnp_svrg_tpu_torch.parallel.meas import run_local
from pnp_svrg_tpu_torch.parallel.mesh import BATCH_AXIS, MEAS_AXIS, LocalAxis, spawn
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image, resolve_data_path
from pnp_svrg_tpu_torch.utils.profiling import PhaseTimers, annotate, scalar_fence, trace

N_OUTER, T2, MINI_BATCH = 16, 10, 4000
SPREAD_SEEDS = (3, 4, 5, 6, 7, 8)
# (Set12-VD mean, flagship) PSNR of the JAX package per lane, BENCH_r05.json
REF_DB = {"headline": (26.50, 25.54), "turbo": (26.86, 25.00), "turbo4": (26.20, 24.63)}
# The CSMRI lanes on a 13-lane batch: label -> (tuned JSON, default eta,
# default sigma_modifier, BM3DParams); bench.py's other three come from
# convert.CSMRI_BATCH_LANES.
CSMRI_LANES = {
    "headline": ("set12_csmri_tuned.json", 6000.0, 1.0, BM3DParams(search=8, match_dtype="bfloat16")),
    "turbo": ("set12_csmri_turbo_tuned.json", 4000.0, 1.0,
              BM3DParams(search=8, search_step=2, matcher="pallas", match_dtype="bfloat16")),
    "turbo4": ("set12_csmri_turbo4_tuned.json", 4000.0, 1.5,
               BM3DParams(search=8, search_step=4, matcher="pallas", match_dtype="bfloat16")),
} | CSMRI_BATCH_LANES | {"bm3d_profile": BM3D_PROFILE_LANE}
HEADLINE_FLOOR_DB, TURBO_FLOOR_DB, TURBO4_FLOOR_DB = 25.5, 25.86, 25.20
NLM_REF_DB, NLM_REF_SSIM = 27.09, 0.8291  # BENCH_r05.json csmri_nlm_*
NLM_FLOOR_DB, NLM_TRACE_TOL_DB = 26.59, 0.05
# bench.py's PR and Deblur lanes: the JAX package's (PSNR, SSIM),
# BENCH_r05.json, reported beside each run for information. The Deblur
# floor is 0.5 dB under it; the PR and Deblur-SR floors are 0.5 dB under
# the JAX CPU run on the fixture's problem and minibatches (the PR lane's A
# is another than BENCH_r05.json's; the SR lane's run takes the Pallas
# matcher's bf16 rounding, interpreted).
BENCH_RUNS = ("pr_bm3d", "deblur_bm3d", "deblur_sr_bm3d")
BENCH_REF = {"pr_bm3d": (28.33, 0.897), "deblur_bm3d": (19.10, 0.4902),
             "deblur_sr_bm3d": (18.69, 0.5149)}
BENCH_FLOOR_DB = {"deblur_bm3d": 18.60}
BENCH_BELOW_JAX_DB = 0.5
# The PR + SARAH + RealSN lane (bench.py:544-600): its A is the PR lane's
# RandomState(4) matrix, not the JAX package's own, so BENCH_r05.json's
# 20.63 dB replica mean does not apply; the floor is the JAX CPU run's
# replica mean on the same A and row indices, less BENCH_BELOW_JAX_DB.
SARAH_BENCH_R05_DB = 20.63
# The lane amplifies rounding: on the same indices an H100's trace and the
# JAX CPU trace agree to about 1e-5 dB through the first two outer rounds,
# then part about tenfold a round (dB apart at the end), so the path is
# pinned entry by entry over those two rounds.
SARAH_EARLY_ROUNDS, SARAH_EARLY_TOL_DB = 2, 1e-4
# The loops phase: run_pnp on the CSMRI + NLM lane's problem, a few steps each
# (K3 launches: one a denoise; SARAH denoises 1 + t2 times a round).
LOOP_RUNS = {
    "gd": ("gd", {}),
    "sgd": ("sgd", {"n_iters": 10, "mini_batch_size": MINI_BATCH}),
    "saga": ("saga", {"n_iters": 10, "mini_batch_size": MINI_BATCH, "hist_size": 50}),
    "sarah": ("sarah", {"n_outer": 2, "t2": 4, "mini_batch_size": MINI_BATCH, "variant": "sarah"}),
    "sarah_faithful": ("sarah", {"n_outer": 2, "t2": 4, "mini_batch_size": MINI_BATCH,
                                 "variant": "faithful"}),
}
GD_TRACE_TOL_DB = 0.01  # pnp_gd on the card against the JAX CPU trace
# The sweep phase: sweep_sampratio's arguments (12 images x 3 candidates =
# 36 lanes a round; BM3D and NLM, 2 rounds each) and the script's CSMRI
# search space at 128 px, which every cell's best must lie in.
SWEEP_CSV = Path(__file__).resolve().parent / "build" / "tuning" / "sweep_smoke.csv"
SWEEP_ARGV = ["--images", "12", "--size", "128", "--ratios", "0.5", "--snr", "20",
              "--algos", "svrg", "--denoisers", "bm3d", "nlm", "--max-evals", "6", "--cand", "3",
              "--n-iters", "60", "--search", "8", "--out", str(SWEEP_CSV)]
SWEEP_CELLS, SWEEP_ROUNDS, SWEEP_LANES = 24, 2, 36
SWEEP_SPACE = {"eta": (1.0, 3e4), "dstrength": (0.3, 2.0), "t2": (5, 10),
               "mini_batch_size": tuple(sorted({max(50, int(f * 128 * 128)) for f in (0.15, 0.3, 0.6)}))}
# The compat phase, on the CSMRI + NLM lane's problem and configuration: (a)
# COMPAT_ITERS inner steps against the loop (compat rounds PSNRs to 2
# decimals), (b) and (c) the tuner adapter with a COMPAT_TT-second budget.
COMPAT_ITERS, COMPAT_TRACE_TOL_DB, COMPAT_Z_TOL, COMPAT_TT = 40, 0.011, 1e-4, 3.0
CHECK_TOL = {"grad_full": 1e-4, "grad_stoch": 1e-6}  # the checks' default tolerances
BENCH_SPREAD_SEEDS = (3, 4, 5)
# The train phase: (a) the committed state's sigmas and Set12 scores against
# the JAX CPU run, (b) TRAIN_STEPS steps against its losses and then timed
# and profiled steps, (c) train() end to end under build/ (never under
# checkpoints/ or data/). TRAIN_ZERO_PRED_LOSS is the loss of predicting a
# zero residual: patch pixels x sigma^2 / 2.
TRAIN_SIGMA_RTOL, TRAIN_PSNR_TOL_DB, TRAIN_SSIM_TOL, TRAIN_LOSS_RTOL = 1e-4, 0.01, 1e-4, 1e-4
TRAIN_TIMED_STEPS, TRAIN_PROFILE_STEPS = 50, 10
TRAIN_E2E_STEPS, TRAIN_RESUME_STEPS = 100, 10
TRAIN_BUILD = Path(__file__).resolve().parent / "build" / "train_smoke"
TRAIN_ZERO_PRED_LOSS = 40 * 40 * (40.0 / 255.0) ** 2 / 2
# The train step's profile groups (group, substrings of the device kernel's
# name). Under deterministic algorithms cuDNN also convolves by FFT (cuFFT's
# fft2d_* and a complex GEMM) and by plain GEMMs; nothing else in the step
# multiplies matrices, so those count as convolution.
TRAIN_GROUPS = (
    ("conv wgrad", ("wgrad", "Wgrad")),
    ("conv dgrad (and conv_transpose)", ("dgrad", "Dgrad")),
    ("conv fprop", ("fprop", "convolve", "winograd", "implicit_gemm", "conv2d")),
    ("conv by FFT and GEMM (cuDNN)", ("fft", "gemm")),
    ("BatchNorm", ("bn_", "batch_norm", "batchnorm", "welford")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("reductions (loss, BN statistics, norms)", ("reduce",)),
    ("elementwise (ReLU, scaling, loss)", ("elementwise",)),
    ("fill/copy", ("fill", "copy", "Copy")),
)
# Every lane repeats itself bit for bit on the card (K2 and the Deblur-SR
# adjoint sum in a fixed order, cuDNN is held to deterministic algorithms),
# so every phase that runs a lane more than once requires the runs' traces
# and final iterates to be equal. The PR lane still carries a rounding
# perturbation to its end (one ulp on y or x_init moves the JAX package's
# own final PSNR by up to 0.25 dB, `python tests/test_torch_fixture.py
# --cpu-lanes`), and the floor holds the mean of the reference-minibatch
# repeats, which is their common value.
BENCH_REF_REPEATS = 3
# Tolerances that stand in for rounding noise take the spread of the runs
# from x_init as built, one ulp down and one ulp up (ULP_SHIFTS): the
# smallest perturbation, which the lanes at the stability edge amplify.
ULP_SHIFTS = ("down", "up")
# The parallel phase (``parallel/``): two ranks share the one card over gloo
# (NCCL refuses two ranks on one device), spawned once for every two-rank
# part. Tolerances: the CPU identity tests hold a sharded loop to the
# unsharded one on the union of the shards' minibatches within 1e-3 dB
# (the psum reorders sums, a rounding perturbation the tuned etas at the
# stability edge amplify), so (a), (b) and the PR run are held over their
# first two outer rounds, within 1e-3 dB plus twice the largest difference
# among the unsharded runs from x_init as built, one ulp down and up there;
# the PAR_REPEATS unsharded runs on the same minibatches must be bitwise
# equal, and so must the two ranks of (b), each of which denoises its own
# replicated iterate (no broadcast). PR gradient within 1e-5 relative,
# step within 1e-3 dB; the SAGA table bit for bit; spatial NLM within 1e-4
# dB (K3 splits warps by shape); spatial BM3D within 0.05 dB.
PAR_WORLD, PAR_TIMEOUT_S = 2, 300
PAR_IDENTITY_DB, PAR_EARLY_ROUNDS, PAR_REPEATS = 1e-3, 2, 4
PAR_PR_ROUNDS, PAR_PR_TOL_DB, PAR_PR_GRAD_RTOL = 2, 1e-3, 1e-5
PAR_SAGA_ITERS, PAR_SAGA_HIST = 10, 50
PAR_NLM_TOL_DB, PAR_BM3D_TOL_DB = 1e-4, 0.05
# The spreads and tolerances these checks had on an H100 when K2 still
# flushed its footprints with f32 atomics and the spread was that of
# repeated runs (the last such run of this script), reported beside.
ATOMIC_K2_SPREADS = {
    "a": {"early_repeat_spread_db": 0.013350, "tolerance_db": 0.027699},
    "c": {"repeat_spread_db": 0.117476, "tolerance_db": 0.235951},
    "anchors": {"paper_csmri/auto/gd": {"repeat_spread_db": 0.034845, "tolerance_db": 0.070691},
                "paper_csmri/ref/gd": {"repeat_spread_db": 0.001209, "tolerance_db": 0.05},
                "paper_deblur/default/gd+bm3d": {"repeat_spread_db": 0.030687, "tolerance_db": 0.062375},
                "pnp_csmri_demo/default/PnP-GD": {"repeat_spread_db": 0.0, "tolerance_db": 0.05}},
}
PAR_SCALING_ARGV = ["--size", "128", "--images-per-device", "2", "--n-outer", "4", "--t2", "10",
                    "--eta", "6000", "--mb", "4000", "--search", "8"]
# The drivers phase: the five paper and demo drivers at their default sizes
# on the port's own problems (gaps to the JAX CPU rows reported, not held),
# then the deterministic anchor rows DRIVER_REPEATS times on the JAX
# drivers' problems, bitwise equal, every trace entry within
# DRIVER_ANCHOR_TOL_DB of the JAX CPU trace, or within PAR_IDENTITY_DB plus
# twice the spread of the runs from x_init as built, one ulp down and up
# where that is wider: on the CPU one ulp of x_init moves the JAX package's
# own paper_csmri gd trace by 0.046 dB over its 198 steps, and the port's
# CPU path lies 0.031 dB from the JAX one there.
DRIVERS = ("paper_csmri", "paper_deblur", "paper_pr", "pnp_csmri_demo", "rgb_csmri")
DRIVER_BM3D = {"paper_csmri": True, "paper_deblur": True, "pnp_csmri_demo": False, "rgb_csmri": False}
DRIVER_REPEATS, DRIVER_ANCHOR_TOL_DB = 3, 0.05
DRIVERS_BUILD = Path(__file__).resolve().parent / "build" / "figures"
# bench.py's other lanes on a 13-lane CSMRI batch (convert.CSMRI_BATCH_LANES),
# through run_lane: set12_uniform on its own problems (keep_low_freq 0 on
# every lane) and masks, with the spread seeds; f32_match and search12 on the
# headline's, without them. Each is held on the JAX run's masks to the JAX
# CPU run there (its 12 Set12 lanes' mean) less BENCH_BELOW_JAX_DB, and
# set12_uniform's per-lane init PSNR within UNIFORM_INIT_TOL_DB of the JAX
# trace's first entry (one PSNR of the same x_init) and its lost zero
# frequencies to BENCH_r05.json's list, whose other fields are reported
# beside.
UNIFORM_INIT_TOL_DB = 1e-4
BENCH_R05 = Path(__file__).resolve().parent / "BENCH_r05.json"
# check_realsn_export on the committed RealSN-DnCNN exports: Set12 PSNR and
# SSIM against the JAX CPU evaluation (realsn_export_jax.npz), the dense SVD
# (float64 on the card, numpy on the CPU) against the JAX tool's numpy SVD.
REALSN_EXPORTS = ("realsn_dncnn_noise5", "realsn_dncnn_noise15", "realsn_dncnn_noise40")
REALSN_PSNR_TOL_DB, REALSN_SSIM_TOL, REALSN_DENSE_RTOL = 1e-3, 1e-5, 1e-6
REALSN_BUILD = Path(__file__).resolve().parent / "build" / "realsn_export"
# The kernels over the JAX package's settings. bm3d_profile (the
# headline batch with the reference's own BM3D, convert.BM3D_PROFILE_LANE)
# is held on the JAX masks to the JAX CPU run less BENCH_BELOW_JAX_DB, its
# two runs there bit for bit, and one BM3D call on each lane's first
# denoise input as the JAX loop forms it (stored in the fixture) to JAX
# CPU's output on that input: each lane's PSNR within PROFILE_CALL_TOL_DB.
# csmri_nlm_skimage (the CSMRI + NLM lane at skimage's NLM defaults) is held
# entry by entry within NLM_TRACE_TOL_DB of its JAX CPU trace, two runs bit
# for bit. The kernel rows at the envelope's points: K1 (block, step,
# search, k, image: the bm3d_profile lane's first input or its stage-1
# estimate), K2 (block, step, search, K) and K3 (patch, distance) at B = 1
# and B = 9, each on its kernel's rules.
PROFILE_CALL_TOL_DB, ENVELOPE_REPEATS = 0.01, 2
ENVELOPE_LANES = ("bm3d_profile",)  # CSMRI_LANES held to the envelope fixture
# The K1 kernel every launch of a lane's timed run must go to (match_kernel's
# choice; bm3d_match_kernel for every other BM3D lane).
LANE_K1_KERNEL = {"bm3d_profile": "bm3d_match_tile_kernel"}
ENVELOPE_K1 = {"profile_ht": (8, 3, 19, 16, "input"), "profile_wiener": (8, 3, 19, 32, "basic"),
               "search24": (8, 3, 24, 16, "input"), "golden": (4, 2, 3, 4, "input"),
               "block2": (2, 1, 3, 4, "input"), "block5": (5, 2, 4, 8, "input"), "block6": (6, 3, 6, 8, "input"),
               "block16": (16, 8, 8, 16, "input"), "block4_s19": (4, 2, 19, 16, "input")}
# K1's row with row bounds off block 8: the golden point, candidate rows
# [16, 112) of the 128 px image.
K1_BOUNDED_ROW, K1_BOUNDS = "golden", (16, 112)
ENVELOPE_K2 = {"profile_ht": (8, 3, 19, 16), "profile_wiener": (8, 3, 19, 32), "golden": (4, 2, 3, 4),
               "block2": (2, 1, 3, 4), "block6": (6, 3, 6, 8), "block8_k8": (8, 4, 8, 8),
               "block16": (16, 8, 8, 16)}
# The rows of K2's run-time path (every call off (8, 16) and (8, 32)): the
# packed kernel's.
ENVELOPE_K2_RUNTIME = {row: v for row, v in ENVELOPE_K2.items() if aggregate_kernel(v[0], v[3]) == K2_KERNELS[1]}
ENVELOPE_K3 = ((7, 11), (1, 1), (11, 15))
# The rows past the earlier envelope, on the same inputs and
# rules; no replaced design takes them, and their plain versions are timed
# over one call after one warm-up call (PLAIN_WIDE_REPS: calls, warm-up
# calls; K3's, 1-5 s each, one call after its two checking calls), K1 held
# on the row's image alone. K2's search40 and search_widest rows are the
# (8, 16) / (8, 32) calls whose 2 x 2 tiles pass a CTA's shared memory, on
# the packed kernel. Each row records its seconds.
ENVELOPE_K1_WIDE = {"step_past_block": (8, 10, 19, 16, "input"), "block4_step6": (4, 6, 3, 4, "input"),
                    "search32": (8, 3, 32, 16, "input"), "block4_s40": (4, 2, 40, 16, "input"),
                    "k128": (8, 3, 19, 128, "basic"), "block1": (1, 1, 3, 4, "input"),
                    "block24": (24, 12, 8, 16, "input"),
                    "search_widest": (8, 3, match_search_limit(8, 16), 16, "input")}
ENVELOPE_K2_WIDE = {"step_past_block": (8, 10, 19, 16), "block4_step6": (4, 6, 3, 4), "k128": (8, 3, 19, 128),
                    "block1": (1, 1, 3, 4), "block24": (24, 12, 8, 16), "search40": (8, 3, 40, 32),
                    "search_widest": (8, 3, match_search_limit(8, 16), 16)}
ENVELOPE_K3_WIDE = ((13, 21), (21, 31))
PLAIN_WIDE_REPS = (1, 1)
# The committed checkpoints the convert phase rebuilds in the reference's
# three .pth layouts, and the layout of each.
CONVERT_LAYOUTS = {"dncnn_noise5": "module.dncnn", "simplecnn_noise5": "dncnn",
                   "mmo_dncnn_nobn_nch1_nlev0.01": "pickled simple_CNN"}
# Kernel rows also carry the kernel that takes the call and, where that is
# a redesign (K1's tile and span kernels, K2's packed kernel, K3's cluster
# kernel), the replaced design's time on the same call.
REDESIGN_FIELDS = ("kernel", "prev_design_ms", "speedup_vs_prev_design")
# The K3 kernel every launch of a lane's timed run must go to (nlm_kernel
# for every other NLM lane); every K2 launch of a lane goes to the compiled
# bm3d_aggregate_kernel.
LANE_K3_KERNEL = {"csmri_nlm_skimage": K3_KERNELS[1]}
# The lane whose run launches a kernel row's shape, and the share of that
# lane's launches the shape takes (rows off every lane: 0). Each of
# bm3d_profile's denoises runs its two stages once (its launch check holds
# K1 and K2 at 2 a denoise), so each stage's shape takes half.
ROW_LANE = {"profile_ht": ("bm3d_profile", 2), "profile_wiener": ("bm3d_profile", 2),
            "p7_d11_b1": ("csmri_nlm_skimage", 1)}
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM bytes/s. Bounds are stated beside the card's name and limit.
F32_PEAK, HBM_PEAK = 67e12, 3.35e12
SFU_PER_SM_CLOCK, N_SMS = 16, 132  # expf throughput: 16 a clock on each of 132 SMs
KERNELS = {"bm3d_match": bm3d_match, "bm3d_aggregate": bm3d_aggregate, "nlm": nlm_denoise}
K2_REPEATS = 50  # more K2 calls on one call's arguments, each bit for bit the first
KERNEL_GROUPS = (  # (group, substrings of the device kernel's name)
    ("K1 bm3d_match", K1_KERNELS),
    ("K2 bm3d_aggregate", ("bm3d_aggregate_kernel", "bm3d_aggregate_fold_kernel", "bm3d_aggregate_packed_kernel")),
    ("K3 nlm", ("nlm_kernel", "nlm_any_kernel", "nlm_cluster_kernel", "nlm_cluster_rt_kernel")),
    # Before the matmul group: cuDNN's implicit-GEMM convolutions
    # (``sm80_xmma_fprop_implicit_gemm_*``) carry "gemm" too; cuBLAS's
    # matmuls are ``*_xmma_gemm_*`` with no "fprop". cuDNN's BatchNorm
    # (``cudnn::bn_fw_inf_*``) counts here as well.
    ("cuDNN conv, BN (CNN denoiser)", ("fprop", "cudnn", "convolve", "winograd")),
    ("matmul (3-D transform)", ("gemm", "cutlass")),
    ("fft", ("fft",)),
    ("gather/index", ("index", "gather", "Index")),
    ("sort/topk (sigma, sampling)", ("sort", "Sort", "topk", "radix", "bitonic")),
    ("fold (unfold-add)", ("col2im", "im2col")),
    ("fill/copy", ("fill", "copy", "Copy")),
)
# gloo stages a CUDA tensor's collective through the host: its copies.
PAR_GROUPS = (("memcpy (gloo host staging)", ("Memcpy", "memcpy")),) + KERNEL_GROUPS
SOURCES = {
    "bm3d_match": ("pnp_svrg_tpu_torch/csrc/bm3d_match.cu",
                   "pnp_svrg_tpu/ops/pallas/bm3d_match.py:52"),
    "bm3d_aggregate": ("pnp_svrg_tpu_torch/csrc/bm3d_aggregate.cu",
                       "pnp_svrg_tpu/ops/pallas/bm3d_scatter.py:39 + "
                       "pnp_svrg_tpu/denoisers/bm3d.py:288 (_unfold_table)"),
    "nlm": ("pnp_svrg_tpu_torch/csrc/nlm.cu", "pnp_svrg_tpu/ops/pallas/nlm_kernel.py:31"),
}


T_START = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line; a phase's record also gets ``t_s``, the seconds since
    the script started."""
    if "phase" in record:
        record = record | {"t_s": time.perf_counter() - T_START}
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 50, warmup: int = 25) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    ``warmup`` calls that also bring the card's clocks up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_WINDOWS = 3  # profiled windows tried before a check that needs device records fails


MARKER_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_IDLE_S = 0.02  # host seconds between the marker and the first call


def device_records(fn, calls: int) -> list:
    """The device records (kernels, fills, copies) of ``calls`` calls of
    ``fn`` under ``torch.profiler``. A short ``torch.cuda._sleep`` opens the
    window and is left out, and the calls start :data:`MARKER_IDLE_S`
    after it: the first launch in a window waits for the profiler's activity
    buffer (0.4-2.5 ms on the card's machine), and a minute into this
    script's run windows have lost records near their start (0 of one K1,
    K2 or K3 call, 49 of 50 K1 calls at 1.5 ms, 35 of 50 K3 calls), which a
    fresh process records in full."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(MARKER_IDLE_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and MARKER_KERNEL not in e.name]


LOST_RECORDS: list = []  # device_ms windows that lost records, reported in kernels_checked


def device_ms(fn, reps: int = 50, warmup: int = 10, windows: int = PROFILE_WINDOWS) -> float:
    """Device time of one call of ``fn``: the summed time of every device
    record it makes (``torch.profiler``) over ``reps`` calls, after
    ``warmup`` calls. Unlike :func:`cuda_ms` it leaves out the gaps in which
    the device waits for the host to launch the next call. The profiler has
    dropped device records on the card's machine, so a window counts only
    if it holds exactly ``reps`` times the records of one profiled call (at
    least one); else both are measured again, up to ``windows`` times. If
    none holds them all (:func:`device_records` says when that happened),
    the time is read per kernel name over every window
    (:func:`lossy_device_ms`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        one, records = device_records(fn, 1), device_records(fn, reps)
        if one and len(records) == reps * len(one):
            return sum(e.time_range.elapsed_us() for e in records) / reps / 1e3
        seen.append((one, records))
    return lossy_device_ms(seen, reps)


def lossy_device_ms(seen, reps: int) -> float:
    """One call's device time from windows that lost records: ``seen`` holds
    each window's (one-call records, ``reps``-call records). Records are
    lost, never added, so each kernel name's launches a call are the most
    any window showed (its one-call count, or its records over ``reps``,
    rounded), and at least 1 for every name any window recorded; its time is
    the mean of all its records. Every name must have kept half of its
    records over the windows. Noted in :data:`LOST_RECORDS`, with the names
    some window held short."""
    launches, times = collections.Counter(), collections.defaultdict(list)
    counts = [(collections.Counter(e.name for e in one), collections.Counter(e.name for e in many))
              for one, many in seen]
    for one, many in counts:
        for n in one.keys() | many.keys():
            launches[n] = max(launches[n], one[n], round(many[n] / reps), 1)
    for _, many in seen:
        for e in many:
            times[e.name].append(e.time_range.elapsed_us())
    short = sorted(n for n in launches
                   if any(one[n] < launches[n] or many[n] < launches[n] * reps for one, many in counts))
    n_records = sum(len(many) for _, many in seen)
    if all(len(times[n]) >= launches[n] * reps * len(seen) / 2 for n in launches) and launches:
        LOST_RECORDS.append({"windows": len(seen), "records": n_records, "calls_a_window": reps,
                             "launches_a_call": dict(launches), "names_short": short})
        return sum(k * sum(times[n]) / len(times[n]) for n, k in launches.items()) / 1e3
    raise RuntimeError(f"check failed: the profiler recorded {n_records} device records for {reps} calls "
                       f"a window of {dict(launches)} launches each, in each of {len(seen)} windows")


def multiset_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean share of each block's k indices that the other holds as often:
    a repeated index (the index-0 fill) counts each time, so equal outputs
    read 1."""
    k, s = a.shape[-1], int(max(a.max(), b.max())) + 1
    a, b = a.reshape(-1, k).long(), b.reshape(-1, k).long()
    count = lambda t: torch.zeros(t.shape[0], s, device=t.device).scatter_add_(  # noqa: E731
        1, t, torch.ones(t.shape, device=t.device))
    return float(torch.minimum(count(a), count(b)).sum(1).mean() / k)


def near_tie(block: int) -> float:
    """K1 and its plain version sum the same ``block^2`` rounded terms of a
    distance in different orders, each within ``block^2 - 1`` half-ulps
    (2**-24 relative) of the exact sum; so where they put different offsets
    in a slot, the two distances there lie within twice that of each other
    (a near-tie; 2 x 63 x 2**-24 for 8 x 8 blocks)."""
    return 2 * (block * block - 1) * 2.0**-24


NEAR_TIE = near_tie(8)


def slot_gaps(got: torch.Tensor, want: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """Per top-k slot, |D[got] - D[want]| / max of the two, in the plain
    version's distances D: 0 where the indices agree, inf where they differ
    and one is an invalid candidate. A right set in a wrong order shows here
    as a gap far above :data:`NEAR_TIE`."""
    dg, dw = (dists.gather(-1, t.long()) for t in (got, want))
    gap = torch.nan_to_num((dg - dw).abs() / torch.maximum(dg, dw), nan=0.0)  # 0/0: a tie at 0
    gap = torch.where(torch.isinf(dg) | torch.isinf(dw), torch.inf, gap)
    return torch.where(got == want, 0.0, gap)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    max_sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rec = {
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "max_sm_clock_mhz": float(max_sm_mhz),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(rec)
    return rec


def phase_build() -> dict:
    """Builds the kernels; returns ptxas's summary per library. Fails if a
    kernel's SASS holds a floating-point atomic or reduction (the fixed
    summation orders rest on that), or if the SASS cannot be read."""
    t0 = time.perf_counter()
    paths = _build.build()
    ptxas = {n: ptxas_summary(log) for n, log in _build.BUILD_LOG.items()}
    code = {n: sass(p) for n, p in paths.items()}
    atomics = {n: sass_atomics(text) for n, text in code.items()}
    floats = {n: [op for op in ops if float_atomic(op)] for n, ops in atomics.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in paths.items()}, "ptxas": ptxas,
          "sass_atomics": atomics, "sass_float_atomics": floats,
          "nlm_shift_loop_sass": sass_loop_mix(code["nlm"], "MUFU.EX2")})
    require(all(code.values()), f"no SASS for {[n for n, t in code.items() if not t]} (cuobjdump)")
    require(not any(floats.values()), f"floating-point atomics in the SASS: {floats}")
    return ptxas


def ptxas_summary(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel that ptxas
    compiled, keyed by its name and template arguments (``<mode, offsets a
    lane>`` for K1's first kernel, ``<mode, slots a lane>`` for its tile
    kernel, ``<mode, offsets a lane, block>`` for its any-kernel, ``<mode,
    keys a thread, slots a lane>`` for its span kernel, ``<block, K>`` for
    K2's tiles)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            base = re.search(r"(bm3d_match(?:_any|_tile|_span)?|bm3d_aggregate(?:_fold)?|nlm(?:_any)?)_kernel",
                             m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = (base.group(0) if base else m.group(1)) + (f"<{', '.join(args)}>" if args else "")
        elif name and "spill" in ln:
            out[name] = ln.strip()
        elif name and "registers" in ln:
            out[name] = out.get(name, "") + "; " + ln.split(":", 1)[1].strip()
    return out


def sass(lib) -> str:
    """A built library's SASS (``cuobjdump -sass``), or "" without the tool."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return ""
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout


def sass_atomics(text: str) -> dict:
    """Atomic and reduction opcodes in SASS: ``ATOMS.ADD`` is a native
    shared-memory add, ``ATOMS.CAS*`` a compare-and-swap loop; ``RED`` a
    global reduction whose result is unused."""
    return dict(collections.Counter(re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", text)))


def float_atomic(op: str) -> bool:
    """Whether an atomic opcode of :func:`sass_atomics` adds floats in an
    order the hardware picks: a float type, or a compare-and-swap (the loop
    a float add becomes where there is no native one). Integer adds (K2's
    fold counts) are exact in any order."""
    return bool(re.search(r"\.(?:BF16|F16|F32|F64)|CAS", op))


def sass_loop_mix(text: str, marker: str) -> dict:
    """The smallest loop of the SASS (a backward branch and its target) whose
    body holds ``marker``: its instruction count and opcodes. For K3,
    ``MUFU.EX2`` finds the shift loop, one shift a trip (with the
    once-a-shift-row block that resets the row masks)."""
    code = [(int(a, 16), ins.split()) for a, ins in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]+);", text)]
    code = [(a, w[1:] if w[0].startswith("@") else w) for a, w in code]
    loops = [(int(w[-1], 16), a) for a, w in code
             if w[0].startswith("BRA") and w[-1].startswith("0x") and int(w[-1], 16) < a]
    loops = [(lo, hi) for lo, hi in loops if any(lo <= a <= hi and w[0] == marker for a, w in code)]
    if not loops:
        return {}
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    body = [w[0].split(".")[0] for a, w in code if lo <= a <= hi]
    return {"instructions": len(body), "opcodes": dict(collections.Counter(body).most_common())}


def match_bounds(b: int, h: int, w: int, rows, cols, offs, lo: int = 0, hi: int | None = None,
                 block: int = 8, k: int = 16) -> dict:
    """K1's least time two ways, over the valid (reference block, offset)
    pairs of this geometry. Direct: sub, mul, add for each of a pair's
    block^2 patch terms. Separable (the Pallas kernel's form): per (image,
    offset) the squared-difference plane (sub, mul a pixel), block-wide row
    sums at the reference columns (block - 1 adds each) and block-tall
    column sums at the reference rows (block - 1 adds each), shared among
    that offset's reference blocks; counted for the valid share of them.
    Bytes: the images in, the k indices a block out. Row bounds ``[lo,
    hi)`` count only the candidates inside them."""
    nr, nc = len(rows), len(cols)
    hi = h if hi is None else hi
    # A pair is valid where its row and its column are: per offset, the
    # valid rows times the valid columns.
    offs = np.asarray(offs, np.int64).reshape(-1, 2)
    ry = np.asarray(rows, np.int64)[:, None] + offs[None, :, 0]
    cx = np.asarray(cols, np.int64)[:, None] + offs[None, :, 1]
    per_row = ((ry >= max(0, lo)) & (ry <= min(h, hi) - block)).sum(0)
    per_col = ((cx >= 0) & (cx <= w - block)).sum(0)
    valid = int((per_row * per_col).sum()) * b
    direct = valid * block * block * 3
    separable = valid * (2 * h * w + (block - 1) * h * nc + (block - 1) * nr * nc) / (nr * nc)
    nbytes = b * h * w * 4 + b * nr * nc * k * 4
    out = {"valid_pairs": valid, "direct_operations": direct, "separable_operations": separable,
           "bytes": nbytes}
    for name, ops in (("direct", direct), ("separable", separable)):
        out[f"bound_{name}_ms"] = max(ops / F32_PEAK, nbytes / HBM_PEAK) * 1e3
        out[f"bound_{name}_by"] = "operations" if ops / F32_PEAK > nbytes / HBM_PEAK else "bytes"
    return out


def check_match() -> dict:
    """K1 against its plain version at the headline shapes, on the headline
    batch's ``x_init`` and its stage-1 estimate, in every rounding mode at
    289, 81 and 25 offsets (the headline's, turbo's and turbo4's windows):
    the multiset agreement of each block's top 16, and slot by slot the
    same offset or a near-tie. Then its time at the three lanes' offset
    counts."""
    prob, _ = load_headline_problems("cuda")
    x = prob.x_init.contiguous()
    params = BM3DParams(search=8, match_dtype="bfloat16")
    basic, agg_in = stage1_aggregate_inputs(x, estimate_sigma(x), params)
    rows = _ref_grid(x.shape[-1], 8, 4)
    agreements, slots = {}, {}
    for name, img in (("x_init", x), ("basic", basic.contiguous())):
        for mode in ("f32", "bf16_xla", "bf16_pallas"):
            for ss in (1, 2, 4):
                offs = search_offsets(8, ss)
                got = bm3d_match(img, rows, rows, offs, 8, 16, mode)
                want = bm3d_match_plain(img, rows, rows, offs, 8, 16, mode)
                key = f"{name}/{mode}/{len(offs)}"
                agreements[key] = agree = multiset_agreement(got, want)
                require(agree >= (0.999 if mode == "f32" else 0.995),
                        f"K1 multiset agreement {agree} ({key})")
                gaps = slot_gaps(got, want, match_distances_plain(img, rows, rows, offs, 8, mode))
                slots[key] = {"equal_share": float((got == want).float().mean()),
                              "max_rel_gap": gaps.max().item()}
                require(slots[key]["max_rel_gap"] <= NEAR_TIE,
                        f"K1 slot gap {slots[key]['max_rel_gap']} > {NEAR_TIE} ({key})")
    # Headline configuration: bf16_xla, the full 289-offset window.
    offs = search_offsets(8, 1)
    mode = "bf16_xla"
    got = bm3d_match(x, rows, rows, offs, 8, 16, mode)
    want = bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    dists = match_distances_plain(x, rows, rows, offs, 8, mode)
    err = (dists.gather(-1, got.long()) - dists.gather(-1, want.long())).abs().max().item()
    require(math.isfinite(err), f"K1 picked an invalid candidate ({err})")
    b, h, w = x.shape
    by_offsets = {}
    for ss, lane_mode in ((1, "bf16_xla"), (2, "bf16_pallas"), (4, "bf16_pallas")):
        o = search_offsets(8, ss)
        geom = match_geometry(rows, rows, o, 8, x.device)
        call = lambda: bm3d_match(x, rows, rows, o, 8, 16, lane_mode, geometry=geom)  # noqa: E731
        by_offsets[len(o)] = {
            "mode": lane_mode, "ms": device_ms(call), "event_ms": cuda_ms(call),
            "smem_bytes": geom.smem_bytes,
            **match_bounds(b, h, w, rows, rows, o),
        }
    geom = match_geometry(rows, rows, offs, 8, x.device)
    modes_ms = {m: device_ms(lambda: bm3d_match(x, rows, rows, offs, 8, 16, m, geometry=geom))
                for m in ("f32", "bf16_xla", "bf16_pallas")}  # 289 offsets, each rounding
    head = by_offsets[len(offs)]
    plain_ms = cuda_ms(lambda: bm3d_match_plain(x, rows, rows, offs, 8, 16, mode), reps=10)
    bound = min(head["bound_direct_ms"], head["bound_separable_ms"])
    return {
        "name": "bm3d_match", "max_abs_err": err, "ms": head["ms"], "event_ms": head["event_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": head["bound_separable_by"], "library_ms": None,
        "bound_direct_ms": head["bound_direct_ms"], "bound_separable_ms": head["bound_separable_ms"],
        "multiset_agreement": agreements, "slots": slots, "near_tie": NEAR_TIE,
        "turbo_81_offsets_ms": by_offsets[81]["ms"],
        "by_offsets": by_offsets, "modes_289_offsets_ms": modes_ms,
        "shape": {"images": list(x.shape), "offsets": len(offs), "k": 16},
        "_agg_in": agg_in,
    }


def check_match_search12(ptxas: dict) -> dict:
    """K1 at search 12 (625 offsets, its ``PER=20`` instantiation) at the
    search12 lane's shape (B = 13, 128 px) against its plain version: equal
    on dyadic images in every rounding mode; slot by slot (near-ties
    allowed) on the lane's first BM3D input (``x_init`` after the first
    step) and its stage-1 estimate, every mode; the fill of spare slots
    never reached (no reference block has fewer than 16 valid candidates).
    Then its device time in the lane's mode and in each mode, the plain
    version's, the bounds, its shared memory and ptxas's line for the
    ``PER=20`` instantiations."""
    prob, lanes = load_headline_problems("cuda")
    eta, den = csmri_lane("search12", lanes)
    lane = {"prob": prob, "eta": eta[:, None],  # one a lane against the (B, N) gradient
            "cfg": {"params": den.params, "sigma_modifier": den.sigma_modifier}}
    z, sig = first_denoise_input(lane)
    p = lane["cfg"]["params"]
    basic, _ = stage1_aggregate_inputs(z, sig, p)
    b, h, w = z.shape
    rows = _ref_grid(h, 8, 4)
    offs = search_offsets(p.search, p.search_step)
    require(len(offs) == 625, f"search 12 gives {len(offs)} offsets, not 625")
    rng = np.random.default_rng(128)
    dyadic = torch.tensor((0.25 * rng.integers(0, 5, (b, h, w))).astype(np.float32), device="cuda")
    exact, checks, errs = {}, {}, {}
    for mode in ("f32", "bf16_xla", "bf16_pallas"):
        got = bm3d_match(dyadic, rows, rows, offs, 8, 16, mode)
        exact[mode] = bool(torch.equal(got, bm3d_match_plain(dyadic, rows, rows, offs, 8, 16, mode)))
        require(exact[mode], f"K1 at 625 offsets differs from its plain version on dyadic images ({mode})")
        for name, img in (("input", z), ("basic", basic.contiguous())):
            got = bm3d_match(img, rows, rows, offs, 8, 16, mode)
            want = bm3d_match_plain(img, rows, rows, offs, 8, 16, mode)
            dists = match_distances_plain(img, rows, rows, offs, 8, mode)
            key = f"{name}/{mode}"
            errs[key] = (dists.gather(-1, got.long()) - dists.gather(-1, want.long())).abs().max().item()
            checks[key] = {"multiset_agreement": multiset_agreement(got, want),
                           "equal_share": float((got == want).float().mean()),
                           "max_rel_gap": slot_gaps(got, want, dists).max().item(),
                           "invalid_picked": int(torch.isinf(dists.gather(-1, got.long())).sum())}
            require(checks[key]["max_rel_gap"] <= NEAR_TIE and checks[key]["invalid_picked"] == 0,
                    f"K1 at 625 offsets {checks[key]} ({key})")
    mode = match_mode(p)
    geom = match_geometry(rows, rows, offs, 8, z.device)
    call = lambda m=mode: bm3d_match(z, rows, rows, offs, 8, 16, m, geometry=geom)  # noqa: E731
    bounds = match_bounds(b, h, w, rows, rows, offs)
    return {
        "shape": {"images": [b, h, w], "offsets": len(offs), "k": 16, "mode": mode},
        "max_abs_err": errs[f"input/{mode}"],
        "ms": device_ms(call), "event_ms": cuda_ms(call),
        "plain_ms": cuda_ms(lambda: bm3d_match_plain(z, rows, rows, offs, 8, 16, mode), reps=10),
        "bound_ms": min(bounds["bound_direct_ms"], bounds["bound_separable_ms"]),
        "bound_by": bounds["bound_separable_by"], "library_ms": None,
        "modes_ms": {m: device_ms(lambda m=m: call(m)) for m in ("f32", "bf16_xla", "bf16_pallas")},
        "smem_bytes": geom.smem_bytes, "ctas_per_sm_by_smem": (228 * 1024) // (geom.smem_bytes + 1024),
        "exact_on_dyadic": exact, "checks": checks, "near_tie": NEAR_TIE,
        "ptxas_per20": {k: v for k, v in ptxas.get("bm3d_match", {}).items() if k.endswith(", 20>")},
        **bounds,
    }


def aggregate_work(b: int, g: int, k: int, block: int, h: int, w: int) -> tuple:
    """K2's bytes and f32 operations for ``b`` images of ``h x w`` with ``g``
    groups of ``k`` members of ``block^2`` values: its inputs (rows,
    estimates, weights, the Kaiser window) read once and the two planes
    written once; per estimate value wk, est * wk and two adds."""
    p = g * k
    nbytes = (b * p + b * p * block * block + b * g + block * block + 2 * b * h * w) * 4
    return nbytes, b * p * block * block * 4


def aggregate_record(agg_in, prev_design: bool = False, plain_reps: tuple = (50, 25)) -> dict:
    """K2 against its plain version on one call's real arguments (``num``
    and ``den`` within 1e-5 of the planes' magnitude) and, with the same
    rows, on dyadic values (bit for bit: every sum is exact in any order);
    :data:`K2_REPEATS` more calls on the real arguments bit for bit equal to
    the first; its time beside the plain version and one ``index_add_`` of
    the per-pixel terms into fresh planes (timed with the zero fill of its
    output), and the bound. ``kernel`` is the tile kernel
    :func:`aggregate_kernel` names. With ``prev_design``, where that is the
    packed kernel, the design it replaced (``bm3d_aggregate_kernel<0, 0>``
    on 2 x 2 tiles) is timed on the same arguments too, after it is held to
    the same 1e-5 and to two calls bit for bit equal. The plain version is
    timed over ``plain_reps`` = (calls, warm-up calls)."""
    idx, est, wgt, kai, h, w, geom = agg_in
    b, p, bb = est.shape
    kernel = aggregate_kernel(math.isqrt(bb), p // wgt.shape[1], geom)
    got = bm3d_aggregate(*agg_in)
    repeat_bitwise = all(all(torch.equal(a, r) for a, r in zip(got, bm3d_aggregate(*agg_in)))
                         for _ in range(K2_REPEATS))
    require(repeat_bitwise, f"K2: {K2_REPEATS} calls on the same arguments differ at {list(est.shape)}")
    gen = torch.Generator(device=idx.device).manual_seed(0)
    dyadic = lambda shape, levels, scale: scale * torch.randint(  # noqa: E731
        0, levels + 1, shape, generator=gen, device=idx.device).float()
    d_args = (idx, dyadic(est.shape, 16, 0.125) - 1.0,
              2.0 ** torch.randint(-2, 3, wgt.shape, generator=gen, device=idx.device).float(),
              dyadic(kai.shape, 4, 0.25) + 0.25, h, w)
    dyadic_equal = all(torch.equal(a, r) for a, r in zip(bm3d_aggregate(*d_args, geom),
                                                         bm3d_aggregate_plain(*d_args)))
    require(dyadic_equal, f"K2 differs from its plain version on dyadic values at {list(est.shape)}")
    want = bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    errs, scales = {}, {}
    for name, g_, w_ in zip(("num", "den"), got, want):
        errs[name] = (g_ - w_).abs().max().item()
        scales[name] = w_.abs().max().item()
        require(errs[name] <= 1e-5 * scales[name],
                f"K2 {name} max abs err {errs[name]} vs plane magnitude {scales[name]} at {list(est.shape)}")
    block = math.isqrt(bb)
    nbytes, flops = aggregate_work(b, wgt.shape[1], p // wgt.shape[1], block, h, w)
    ms = device_ms(lambda: bm3d_aggregate(*agg_in))
    event_ms = cuda_ms(lambda: bm3d_aggregate(*agg_in))
    plain_ms = cuda_ms(lambda: bm3d_aggregate_plain(idx, est, wgt, kai, h, w), *plain_reps)
    # The library yardstick: the same sums as one index_add_ of per-pixel
    # terms (made here, outside the timing) into planes zeroed in the call.
    g = wgt.shape[1]
    ww = w - block + 1
    wk = wgt[..., None, None] * kai  # (B, G, 1, block^2)
    terms = torch.cat([(est.view(b, g, -1, bb) * wk).reshape(-1),
                       wk.expand(b, g, p // g, bb).reshape(-1)])
    ky = torch.arange(block, device=idx.device).repeat_interleave(block)
    kx = torch.arange(block, device=idx.device).repeat(block)
    pix = ((idx.long() // ww)[..., None] + ky) * w + (idx.long() % ww)[..., None] + kx  # (B, P, block^2)
    pix = (pix + torch.arange(b, device=idx.device)[:, None, None] * (h * w)).reshape(-1)
    flat = torch.cat([pix, pix + b * h * w])
    lib_planes = torch.zeros(2 * b * h * w, device=idx.device).index_add_(0, flat, terms)
    lib_err = max((lib_planes.view(2, b, h, w)[i] - want[i]).abs().max().item() for i in (0, 1))
    require(lib_err <= 1e-5 * max(scales.values()), f"index_add_ yardstick err {lib_err}")
    library = lambda: torch.zeros(2 * b * h * w, device=idx.device).index_add_(0, flat, terms)  # noqa: E731
    library_ms, library_event_ms = device_ms(library), cuda_ms(library)
    plan = geom.packed(p // wgt.shape[1]) if kernel == K2_KERNELS[1] else geom
    rec = {
        "kernel": kernel,
        "max_abs_err": max(errs.values()), "max_abs_err_by_plane": errs,
        "plane_magnitude": scales, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
        "bound_ms": max(flops / F32_PEAK, nbytes / HBM_PEAK) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_PEAK >= flops / F32_PEAK else "operations",
        "bytes": nbytes, "library_ms": library_ms, "library_event_ms": library_event_ms,
        "speedup_vs_library": library_ms / ms,
        "library_max_abs_err": lib_err, "repeat_launches": K2_REPEATS,
        "repeat_bitwise": repeat_bitwise, "dyadic_bitwise": dyadic_equal,
        "smem_bytes": plan.smem_bytes, "footprint": [plan.fh, plan.fw],
        "scratch_bytes": geom.scratch_bytes(b, plan if kernel == K2_KERNELS[1] else None),
        "shape": {"idx": list(idx.shape), "est": list(est.shape), "wgt": list(wgt.shape),
                  "planes": [2, b, h, w]},
    }
    if kernel == K2_KERNELS[1]:
        rec["plan"] = {"tile": plan.tile, "warps": plan.warps, "groups": plan.groups,
                       "ctas": len(plan.tile_oy) * len(plan.tile_ox) * b}
    if prev_design and kernel == K2_KERNELS[1]:
        prev = k2_module.PREV_DESIGN
        fn = k2_module._lib()[prev]
        call_prev = lambda: k2_module.launch(prev, fn, idx, est, wgt, kai, h, w, geom)  # noqa: E731
        first = call_prev()
        c = {"max_abs_err": max((a - r).abs().max().item() for a, r in zip(first, want)),
             "repeat_bitwise": all(torch.equal(a, r) for a, r in zip(call_prev(), first))}
        require(c["max_abs_err"] <= 1e-5 * max(scales.values()) and c["repeat_bitwise"],
                f"K2's {prev} at {list(est.shape)}: {c}")
        rec |= {"prev_design": prev, "prev_design_checks": c, "prev_design_ms": device_ms(call_prev),
                "prev_design_event_ms": cuda_ms(call_prev),
                "prev_design_smem_bytes": geom.smem_bytes, "prev_design_scratch_bytes": geom.scratch_bytes(b)}
        rec["speedup_vs_prev_design"] = rec["prev_design_ms"] / ms
    return rec


def check_aggregate(agg_in) -> dict:
    """K2 on a headline stage-1 call's real arguments (:func:`aggregate_record`),
    and the dense aggregation against K2 at the turbo4 shape."""
    rec = aggregate_record(agg_in)
    h, w = agg_in[4], agg_in[5]
    # turbo4's shape: its stage-1 estimates through the dense aggregation
    # and through K2 (recorded only; turbo4 keeps the dense path).
    prob, _ = load_headline_problems("cuda")
    x = prob.x_init.contiguous()
    t4 = BM3DParams(search=8, search_step=4, matcher="pallas", match_dtype="bfloat16")
    g4 = _geometry(h, w, t4, x.device)
    e4, w4, top4, py4, px4 = _stage1(x, estimate_sigma(x), t4, g4)
    a4 = aggregate_geometry(h, w, tuple(g4.rows.tolist()), tuple(g4.cols.tolist()), 8, 8, x.device)
    dense = lambda: _aggregate_dense(e4, w4, top4, 8, 4, h, w, g4.kaiser, g4.shift_y, g4.shift_x)  # noqa: E731
    fused = lambda: _aggregate(e4, w4, py4, px4, 8, h, w, g4.kaiser, a4)[0]  # noqa: E731
    rec["turbo4_shape"] = {"dense_ms": device_ms(dense), "fused_ms": device_ms(fused),
                           "dense_event_ms": cuda_ms(dense), "fused_event_ms": cuda_ms(fused),
                           "max_abs_diff": (dense() - fused()).abs().max().item()}
    return {"name": "bm3d_aggregate", **rec}


def first_denoise_input(lane: dict) -> tuple:
    """A lane's first denoise input and sigma: ``x_init`` after the first
    PnP-SVRG step (``v = mu`` there, whatever the minibatch) with the lane's
    ``eta`` (a scalar, or (B, 1) for one a lane), and the estimate times the
    lane's modifier."""
    prob, cfg = lane["prob"], lane["cfg"]
    x = prob.x_init.reshape(prob.batch_size, -1)
    z = (x - lane["eta"] * prob.grad_full(x).reshape(x.shape)).reshape(prob.x_init.shape).contiguous()
    return z, estimate_sigma(z) * cfg["sigma_modifier"]


def check_bench_kernels(lane: dict) -> tuple:
    """K1 and K2 at a bench lane's shape (B = 1) and mode on its first BM3D
    input: K1 held slot by slot to its plain version on that image and on
    its stage-1 estimate in the lane's mode (:func:`match_record`); K2 on
    the stage-1 aggregation's arguments (:func:`aggregate_record`)."""
    z, sig = first_denoise_input(lane)
    p = lane["cfg"]["params"]
    mode = match_mode(p)
    basic, agg_in = stage1_aggregate_inputs(z, sig, p)
    k1 = match_record({"input": z, "basic": basic.contiguous()}, 8, 4, p.search, 16, mode,
                      p.search_step, modes=(mode,))
    return k1, aggregate_record(agg_in)


def nlm_input(prob, eta: float, mod: float, steps: int = 1) -> tuple:
    """A real K3 input: the ``13.png`` lane's ``x_init`` after ``steps``
    full-gradient steps with step ``eta`` (the first PnP-SVRG step, where
    ``v = mu``), each but the last followed by the NLM denoise, and the
    h = sigma the denoiser derives from its sigma estimate with modifier
    ``mod``. From two steps on, the image depends on ``mod`` too."""
    x = prob.x_init
    for s in range(steps):
        z = x - eta * prob.grad_full(x)
        h = estimate_sigma(z) * mod
        if s + 1 < steps:
            x = nlm_denoise_plain(z, h, h)
    return z, h


def nlm_bound(b: int, h: int, w: int, lo: int, hi: int, d: int, clock_hz: float,
              patch_size: int = 4) -> dict:
    """Least time of one NLM call: the valid (pixel, shift) pairs this input
    has, each 2 f32 operations for the square, the box sum over the P x P
    patch at its least (each axis P - 1 adds, or 2 for a sliding sum, which
    adds the entering term and takes the leaving one: 2 min(P - 1, 2)), 5
    for the weight and 4 for the accumulation (15 from P = 3 on), and one
    exp; the image read once and the output written once."""
    rows = sum(1 for i in range(h) for dy in range(-d, d + 1) if lo <= i + dy < hi)
    cols = sum(1 for j in range(w) for dx in range(-d, d + 1) if 0 <= j + dx < w)
    pairs = b * rows * cols
    per_pair = 2 + 2 * min(patch_size - 1, 2) + 5 + 4
    terms = {
        "operations": per_pair * pairs / F32_PEAK,
        "exp": pairs / (N_SMS * SFU_PER_SM_CLOCK * clock_hz),
        "bytes": (2 * b * h * w * 4 + 2 * b * 4) / HBM_PEAK,
    }
    top = max(terms, key=terms.get)
    return {"bound_ms": terms[top] * 1e3, "bound_by": "bytes" if top == "bytes" else "operations",
            "bound_term": top, "bound_terms_ms": {k: v * 1e3 for k, v in terms.items()}, "valid_pairs": pairs,
            "operations_per_pair": per_pair, "sm_clock_hz": clock_hz}


def nlm_check_inputs() -> dict:
    """K3's inputs at B = 1 (the csmri_nlm lane's one-step image and h) and
    B = 9 (the grid lane: each lane its own (eta, modifier) pair's two-step
    image and h, so no two lanes are equal), as {"b1": (z, h), "b9": (z, h)}."""
    cfg = nlm_params()
    prob = load_nlm_problem("cuda")
    lanes = [nlm_input(prob, e, m, 2) for e, m in itertools.product(cfg["etas"], cfg["mods"])]
    z9 = torch.cat([z for z, _ in lanes])
    require(all(bool((z9[a] != z9[c]).any()) for a, c in itertools.combinations(range(9), 2)),
            "K3 check: two grid lanes hold the same image")
    return {"b1": nlm_input(prob, cfg["eta"], cfg["sigma_modifier"]),
            "b9": (z9, torch.cat([h for _, h in lanes]))}


def nlm_times(z, h, sigma, clock_hz: float, patch_size: int = 4, patch_distance: int = 5,
              plain_ms: float | None = None) -> dict:
    """K3's device and event times on (z, h, sigma), its plain version's
    (over 10 calls, unless a caller that timed it passes ``plain_ms``), and
    the bound."""
    _, hh, ww = z.shape
    pd = (patch_size, patch_distance)
    return {
        "ms": device_ms(lambda: nlm_denoise(z, h, sigma, *pd)),
        "event_ms": cuda_ms(lambda: nlm_denoise(z, h, sigma, *pd)),
        "plain_ms": plain_ms or cuda_ms(lambda: nlm_denoise_plain(z, h, sigma, *pd), reps=10, warmup=3),
        **nlm_bound(z.shape[0], hh, ww, 0, hh, patch_distance, clock_hz, patch_size),
    }


def check_nlm(clock_hz: float) -> dict:
    """K3 against its plain version on :func:`nlm_check_inputs` with and
    without row bounds, and NaN at h = 0; then its times at both shapes
    beside the plain version and the bound."""
    inputs = nlm_check_inputs()
    (z1, h1), (z9, h9) = inputs["b1"], inputs["b9"]
    errs = {}
    cases = {"b1": (z1, h1, None), "b1_rows_16_112": (z1, h1, (16, 112)), "b9": (z9, h9, None)}
    cases |= {f"b9_rows_{lo}_{hi}": (z9, h9, (lo, hi)) for lo, hi in ((16, 112), (10, 11), (5, 5))}
    for name, (z, h, bounds) in cases.items():
        got = nlm_denoise(z, h, h, row_valid_bounds=bounds)
        want = nlm_denoise_plain(z, h, h, row_valid_bounds=bounds)
        errs[name] = (got - want).abs().max().item()
        require(errs[name] <= 1e-5, f"K3 max abs err {errs[name]} ({name})")
    zero = torch.zeros(1, device="cuda")
    got, want = nlm_denoise(z1, zero, zero), nlm_denoise_plain(z1, zero, zero)
    nan_equal = bool(torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got).all())
    require(nan_equal, "K3 at h = 0: NaN where the plain version has NaN")
    b, hh, ww = z9.shape
    times = {name: nlm_times(z, h, h, clock_hz) for name, (z, h) in inputs.items()}
    return {
        "name": "nlm", "max_abs_err": max(errs.values()), "max_abs_err_by_case": errs,
        "nan_equal_at_h0": nan_equal, **times["b9"],
        "library_ms": None, "b1": times["b1"], "h_b9": h9.tolist(),
        "shape": {"images": [b, hh, ww], "patch_size": 4, "patch_distance": 5},
    }


def profile_lane_inputs() -> tuple:
    """The bm3d_profile lane's first denoise input (B = 13, 128 px), its
    sigma, and the stage-1 estimate of the lane's BM3D on it."""
    prob, lanes = load_headline_problems("cuda")
    eta, den = csmri_lane("bm3d_profile", lanes)
    lane = {"prob": prob, "eta": eta[:, None],
            "cfg": {"params": den.params, "sigma_modifier": den.sigma_modifier}}
    z, sig = first_denoise_input(lane)
    basic, _ = stage1_aggregate_inputs(z, sig, den.params)
    return z, sig, basic.contiguous()


def match_record(imgs: dict, block: int, step: int, search: int, k: int, lane_mode: str,
                 search_step: int = 1, modes=tuple(MODES), prev_design: bool = False,
                 plain_reps: tuple = (10, 25)) -> dict:
    """K1 at one setting against its plain version, in each of ``modes`` on
    each image of ``imgs``: the multiset agreement of each
    block's k (>= 0.999 in f32, >= 0.995 in bf16), slot by slot the same
    offset or a near-tie (:func:`near_tie` of the block), and as many
    invalid picks (index-0 fills) as the plain version; then its device
    time in ``lane_mode`` on the first image, the plain version's and the
    bound. ``kernel`` is the kernel :func:`match_kernel` names for the
    call, with its shared memory (and the span kernel's tiles). With
    ``prev_design``, where that is not the any-kernel, the any-kernel (the
    design the tile and span kernels replaced) is timed on the same
    arguments too (``prev_design_ms``, its ``event_ms`` and the ratio),
    after it is held to the same rules in ``lane_mode``. The plain version
    is timed over ``plain_reps`` = (calls, warm-up calls)."""
    z = next(iter(imgs.values()))
    b, h, w = z.shape
    rows, cols = _ref_grid(h, block, step), _ref_grid(w, block, step)
    offs = search_offsets(search, search_step)
    tie = near_tie(block)
    checks, err = {}, None
    for name, img in imgs.items():
        for mode in modes:
            got = bm3d_match(img, rows, cols, offs, block, k, mode)
            want = bm3d_match_plain(img, rows, cols, offs, block, k, mode)
            dists = match_distances_plain(img, rows, cols, offs, block, mode)
            dg, dw = (dists.gather(-1, t.long()) for t in (got, want))
            key = f"{name}/{mode}"
            checks[key] = {"multiset_agreement": multiset_agreement(got, want),
                           "equal_share": float((got == want).float().mean()),
                           "max_rel_gap": slot_gaps(got, want, dists).max().item(),
                           "invalid_picked": int(torch.isinf(dg).sum()),
                           "plain_invalid_picked": int(torch.isinf(dw).sum())}
            c = checks[key]
            require(c["multiset_agreement"] >= (0.999 if mode == "f32" else 0.995)
                    and c["max_rel_gap"] <= tie and c["invalid_picked"] == c["plain_invalid_picked"],
                    f"K1 at block {block}, k {k}, {len(offs)} offsets: {c} ({key})")
            if err is None and mode == lane_mode:
                err = torch.nan_to_num((dg - dw).abs(), nan=0.0).max().item()  # inf - inf: both fills
    geom = match_geometry(rows, cols, offs, block, z.device)
    call = lambda: bm3d_match(z, rows, cols, offs, block, k, lane_mode, geometry=geom)  # noqa: E731
    bounds = match_bounds(b, h, w, rows, cols, offs, block=block, k=k)
    kernel = match_kernel(geom, block, k)
    reach = geom.reach(h, w)
    smem = {"bm3d_match_kernel": lambda: geom.smem_bytes,
            "bm3d_match_tile_kernel": lambda: geom.tile_smem_bytes(k, reach.search),
            "bm3d_match_any_kernel": lambda: geom.any_smem_bytes,
            "bm3d_match_span_kernel": lambda: geom.span(k, reach.search).smem_bytes}
    rec = {
        "shape": {"images": [b, h, w], "block": block, "step": step, "offsets": len(offs), "k": k,
                  "mode": lane_mode},
        "kernel": kernel,
        "max_abs_err": err, "ms": device_ms(call), "event_ms": cuda_ms(call),
        "plain_ms": cuda_ms(lambda: bm3d_match_plain(z, rows, cols, offs, block, k, lane_mode), *plain_reps),
        "bound_ms": min(bounds["bound_direct_ms"], bounds["bound_separable_ms"]),
        "bound_by": bounds["bound_separable_by"], "library_ms": None,
        "smem_bytes": smem[kernel](), "ctas_per_sm_by_smem": (228 * 1024) // (smem[kernel]() + 1024),
        "near_tie": tie, "checks": checks, **bounds,
    }
    if kernel == "bm3d_match_span_kernel":
        plan = geom.span(k, reach.search)
        rec["span_tiles"] = {"blocks_a_tile": plan.most, "tiles": [len(plan.row_tiles), len(plan.col_tiles)]}
    prev = k1_module.PREV_DESIGN
    if prev_design and kernel != prev:
        fn = k1_module._lib()[prev]

        def call_prev():  # through the kernel's own entry point: no launch counted
            out = torch.empty((b, len(rows), len(cols), k), dtype=torch.int32, device=z.device)
            k1_module.launch(prev, fn, z, geom, out, block, k, lane_mode, 0, h)
            return out

        got = call_prev()
        dists = match_distances_plain(z, rows, cols, offs, block, lane_mode)
        want = bm3d_match_plain(z, rows, cols, offs, block, k, lane_mode)
        c = {"multiset_agreement": multiset_agreement(got, want),
             "max_rel_gap": slot_gaps(got, want, dists).max().item()}
        require(c["multiset_agreement"] >= (0.999 if lane_mode == "f32" else 0.995) and c["max_rel_gap"] <= tie,
                f"K1's {prev} at block {block}, k {k}, {len(offs)} offsets: {c}")
        rec |= {"prev_design": prev, "prev_design_checks": c, "prev_design_ms": device_ms(call_prev),
                "prev_design_event_ms": cuda_ms(call_prev), "prev_design_smem_bytes": smem[prev]()}
        rec["speedup_vs_prev_design"] = rec["prev_design_ms"] / rec["ms"]
        # The same by CUDA events (back-to-back calls), for the rows where
        # this process's profiler lost or misread device records (device_ms).
        rec["speedup_vs_prev_design_event"] = rec["prev_design_event_ms"] / rec["event_ms"]
    return rec


def match_bounded_record(imgs: dict, block: int, step: int, search: int, k: int, lane_mode: str,
                         bounds: tuple) -> dict:
    """K1 at one setting with row bounds ``bounds`` against its plain
    version with the same bounds, in every mode: equal on dyadic images,
    and on each image of ``imgs`` the multiset agreement, slot gaps within
    the block's near-tie and as many invalid picks as the plain version;
    then its device time in ``lane_mode`` on the first image and the
    bounds' own work bound."""
    z = next(iter(imgs.values()))
    b, h, w = z.shape
    rows, cols = _ref_grid(h, block, step), _ref_grid(w, block, step)
    offs = search_offsets(search, 1)
    tie = near_tie(block)
    rng = np.random.default_rng(block)
    dyadic = torch.tensor((0.25 * rng.integers(0, 5, (b, h, w))).astype(np.float32), device=z.device)
    exact, checks, err = {}, {}, None
    for mode in MODES:
        got = bm3d_match(dyadic, rows, cols, offs, block, k, mode, row_valid_bounds=bounds)
        exact[mode] = bool(torch.equal(got, bm3d_match_plain(dyadic, rows, cols, offs, block, k, mode,
                                                             row_valid_bounds=bounds)))
        require(exact[mode], f"bounded K1 at block {block} differs from its plain version on dyadic images ({mode})")
        for name, img in imgs.items():
            got = bm3d_match(img, rows, cols, offs, block, k, mode, row_valid_bounds=bounds)
            want = bm3d_match_plain(img, rows, cols, offs, block, k, mode, row_valid_bounds=bounds)
            dists = match_distances_plain(img, rows, cols, offs, block, mode, row_valid_bounds=bounds)
            dg, dw = (dists.gather(-1, t.long()) for t in (got, want))
            c = checks[f"{name}/{mode}"] = {"multiset_agreement": multiset_agreement(got, want),
                                            "max_rel_gap": slot_gaps(got, want, dists).max().item(),
                                            "invalid_picked": int(torch.isinf(dg).sum()),
                                            "plain_invalid_picked": int(torch.isinf(dw).sum())}
            require(c["multiset_agreement"] >= (0.999 if mode == "f32" else 0.995) and c["max_rel_gap"] <= tie
                    and c["invalid_picked"] == c["plain_invalid_picked"],
                    f"bounded K1 at block {block}, bounds {bounds}: {c} ({name}/{mode})")
            if err is None and mode == lane_mode:
                err = torch.nan_to_num((dg - dw).abs(), nan=0.0).max().item()  # inf - inf: both fills
    geom = match_geometry(rows, cols, offs, block, z.device)
    call = lambda: bm3d_match(z, rows, cols, offs, block, k, lane_mode, geometry=geom,  # noqa: E731
                              row_valid_bounds=bounds)
    bnd = match_bounds(b, h, w, rows, cols, offs, *bounds, block=block, k=k)
    return {"shape": {"images": [b, h, w], "block": block, "step": step, "offsets": len(offs), "k": k,
                      "mode": lane_mode},
            "bounds": list(bounds), "kernel": match_kernel(geom, block, k), "exact_on_dyadic": exact,
            "checks": checks, "max_abs_err": err, "ms": device_ms(call), "event_ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda: bm3d_match_plain(z, rows, cols, offs, block, k, lane_mode,
                                                         row_valid_bounds=bounds), reps=10),
            "bound_ms": min(bnd["bound_direct_ms"], bnd["bound_separable_ms"]),
            "bound_by": bnd["bound_separable_by"], "library_ms": None, **bnd}


def check_envelope_kernels(clock_hz: float) -> tuple:
    """K1, K2 and K3 at the envelope's points (:data:`ENVELOPE_K1`,
    :data:`ENVELOPE_K2`, :data:`ENVELOPE_K3`) on real inputs, each held to
    its kernel's rules: K1 by :func:`match_record`; K2 by
    :func:`aggregate_record` (50 repeats bit for bit, dyadic values bit for
    bit, 1e-5 of the planes' magnitude) on the stage-1 aggregation of the
    bm3d_profile lane's first input at that setting; K3 within 1e-5 of its
    plain version with and without row bounds on the B = 1 and B = 9 NLM
    inputs, and NaN at h = 0. Returns the three kernels' rows."""
    z, sig, basic = profile_lane_inputs()
    imgs = {"input": z, "basic": basic}
    k1 = {}
    for row, (block, step, search, k, first) in ENVELOPE_K1.items():
        k1[row] = match_record({first: imgs[first]} | imgs, block, step, search, k, "bf16_xla",
                               prev_design=True)
    for row, (block, step, search, k, first) in ENVELOPE_K1_WIDE.items():
        t0 = time.perf_counter()
        k1[row] = match_record({first: imgs[first]}, block, step, search, k, "bf16_xla",
                               plain_reps=PLAIN_WIDE_REPS)
        k1[row]["seconds"] = time.perf_counter() - t0
    block, step, search, k, _ = ENVELOPE_K1[K1_BOUNDED_ROW]
    k1[K1_BOUNDED_ROW]["bounded"] = match_bounded_record(imgs, block, step, search, k, "bf16_xla", K1_BOUNDS)
    k2 = {}
    for row, (block, step, search, k) in ENVELOPE_K2.items():
        p = BM3DParams(block=block, step=step, search=search, group_ht=k, match_dtype="bfloat16")
        _, agg_in = stage1_aggregate_inputs(z, sig, p)
        k2[row] = aggregate_record(agg_in, prev_design=True) | {"block": block, "k": k, "step": step,
                                                                "search": search}
    for row, (block, step, search, k) in ENVELOPE_K2_WIDE.items():
        t0 = time.perf_counter()
        p = BM3DParams(block=block, step=step, search=search, group_ht=k, match_dtype="bfloat16")
        _, agg_in = stage1_aggregate_inputs(z, sig, p)
        k2[row] = aggregate_record(agg_in, plain_reps=PLAIN_WIDE_REPS) | {
            "block": block, "k": k, "step": step, "search": search, "seconds": time.perf_counter() - t0}
        del agg_in
    inputs = nlm_check_inputs()
    k3 = {}
    for pd in ENVELOPE_K3 + ENVELOPE_K3_WIDE:
        wide = pd in ENVELOPE_K3_WIDE
        for lanes, (x, h) in inputs.items():
            t0 = time.perf_counter()
            errs = {}
            for bounds in (None, (16, 112)):
                got = nlm_denoise(x, h, h, *pd, row_valid_bounds=bounds)
                want = nlm_denoise_plain(x, h, h, *pd, row_valid_bounds=bounds)
                errs[str(bounds)] = (got - want).abs().max().item()
            require(max(errs.values()) <= 1e-5, f"K3 max abs err {errs} at {pd}, {lanes}")
            zero = torch.zeros(x.shape[0], device="cuda")
            nan = bool(torch.isnan(nlm_denoise(x, zero, zero, *pd)).all())
            require(nan, f"K3 at h = 0 not NaN everywhere at {pd}")
            repeat = bool(torch.equal(nlm_denoise(x, h, h, *pd), nlm_denoise(x, h, h, *pd)))
            require(repeat, f"K3: two calls differ at {pd}, {lanes}")
            b, hh, ww = x.shape
            fns = k3_module._lib()
            hs = h.expand(b).contiguous()
            if wide:  # no replaced design takes these
                k3[f"p{pd[0]}_d{pd[1]}_{lanes}"] = {
                    "shape": {"images": list(x.shape), "patch_size": pd[0], "patch_distance": pd[1]},
                    "kernel": nlm_kernel_name(*pd),
                    "plan": list(k3_module.device_plan(fns, x.device, b, hh, ww, *pd)),
                    "max_abs_err": max(errs.values()), "max_abs_err_by_bounds": errs, "nan_at_h0": nan,
                    "repeat_bitwise": repeat, "library_ms": None,
                    **nlm_times(x, h, h, clock_hz, *pd, plain_ms=cuda_ms(
                        lambda: nlm_denoise_plain(x, h, h, *pd), reps=1, warmup=0)),
                    "seconds": time.perf_counter() - t0}
                continue

            def call_prev(x=x, hs=hs, pd=pd, fns=fns):  # through the kernel's own entry: no launch counted
                out = torch.empty_like(x)
                k3_module.launch(k3_module.PREV_DESIGN, fns, x, hs, hs, out, *pd, 0, x.shape[1])
                return out

            prev_err = (call_prev() - nlm_denoise_plain(x, h, h, *pd)).abs().max().item()
            require(prev_err <= 1e-5, f"K3's {k3_module.PREV_DESIGN} max abs err {prev_err} at {pd}, {lanes}")
            rec = k3[f"p{pd[0]}_d{pd[1]}_{lanes}"] = {
                "shape": {"images": list(x.shape), "patch_size": pd[0], "patch_distance": pd[1]},
                "kernel": nlm_kernel_name(*pd),
                "plan": list(k3_module.device_plan(fns, x.device, b, hh, ww, *pd)),
                "max_abs_err": max(errs.values()), "max_abs_err_by_bounds": errs, "nan_at_h0": nan,
                "repeat_bitwise": repeat, **nlm_times(x, h, h, clock_hz, *pd), "library_ms": None,
                "prev_design": k3_module.PREV_DESIGN, "prev_design_max_abs_err": prev_err,
                "prev_design_ms": device_ms(call_prev), "prev_design_event_ms": cuda_ms(call_prev)}
            rec["speedup_vs_prev_design"] = rec["prev_design_ms"] / rec["ms"]
    return k1, k2, k3


def check_wide_calls() -> dict:
    """One call each through the public entry points past the kernels'
    earlier envelope, held to the JAX CPU output on the same input
    (``params_wide_jax.npz``): ``BM3DDenoiser.denoise`` at each
    :data:`WIDE_BM3D` row on its lanes of bm3d_profile's first denoise
    input, ``NLMDenoiser.denoise`` at :data:`WIDE_NLM` on the CSMRI + NLM
    lane's; each lane's PSNR within :data:`PROFILE_CALL_TOL_DB`, the
    largest pixel difference reported, and each call's K1, K2 and K3
    launches by kernel those the naming functions give."""
    ref = load_wide_reference()
    env = load_envelope_reference("bm3d_profile")
    lanes = ref["bm3d/lanes"]
    prob, _ = load_headline_problems("cuda")
    clean = prob.x[torch.as_tensor(lanes, device="cuda").long()]
    z = torch.as_tensor(env["first_input"][lanes], device="cuda")
    sig = torch.as_tensor(env["first_sigma"][lanes], device="cuda")
    h, w = z.shape[1:]
    out = {}

    def held(row, got, want, clean_, expect):
        port, jax_db = lane_psnr(clean_, got), lane_psnr(clean_, want)
        gap = float(np.abs(port - jax_db).max())
        launches = {"bm3d_match": {k: v for k, v in bm3d_match.by_kernel.items() if v},
                    "bm3d_aggregate": {k: v for k, v in bm3d_aggregate.by_kernel.items() if v},
                    "nlm": {k: v for k, v in nlm_denoise.by_kernel.items() if v}}
        out[row] = {"port_psnr_db": port.tolist(), "jax_cpu_psnr_db": jax_db.tolist(), "max_abs_db": gap,
                    "max_abs_diff": (got - want).abs().max().item(), "launches_by_kernel": launches,
                    "expected_launches": expect}
        require(gap <= PROFILE_CALL_TOL_DB, f"wide call {row}: {gap:.4f} dB off JAX CPU's on a lane")
        require(launches == expect, f"wide call {row}: launches {launches}, expected {expect}")

    for row, p in WIDE_BM3D.items():
        g = _geometry(h, w, p, z.device)
        expect = {"bm3d_match": collections.Counter(), "bm3d_aggregate": collections.Counter(), "nlm": {}}
        for k in (p.group_ht, p.group_wie):
            expect["bm3d_match"][match_kernel(g.match, p.block, k)] += 1
            expect["bm3d_aggregate"][aggregate_kernel(p.block, k, g.agg)] += 1
        _zero_counts()
        got = BM3DDenoiser(params=p).denoise(z, sig, torch.zeros((), device="cuda"))
        torch.cuda.synchronize()
        held(row, got, torch.as_tensor(ref[f"bm3d/{row}/output"], device="cuda"), clean,
             {k: dict(v) for k, v in expect.items()})
    nprob = load_nlm_problem("cuda")
    cfg = nlm_params()
    zn, est = (torch.as_tensor(ref[f"nlm/{k}"], device="cuda") for k in ("input", "sigma_est"))
    _zero_counts()
    got = NLMDenoiser(sigma_modifier=cfg["sigma_modifier"], **WIDE_NLM).denoise(zn, est, 0)
    torch.cuda.synchronize()
    held("nlm", got, torch.as_tensor(ref["nlm/output"], device="cuda"), nprob.x,
         {"bm3d_match": {}, "bm3d_aggregate": {}, "nlm": {nlm_kernel_name(**WIDE_NLM): 1}})
    emit({"phase": "wide_calls", "lanes": lanes.tolist(), "calls": out,
          "params": {row: dataclasses.asdict(p) for row, p in WIDE_BM3D.items()} | {"nlm": WIDE_NLM}})
    return out


def lane_psnr(clean: torch.Tensor, img: torch.Tensor) -> np.ndarray:
    """PSNR (dB) of each (H, W) lane of ``img`` against ``clean``."""
    return image_psnr(clean.reshape(img.shape), img).reshape(-1).cpu().numpy()


def reference_checkpoint(name: str, variables: dict):
    """What the reference's ``.pth`` of checkpoint ``name`` holds, made from
    its Flax ``variables`` (the inverse of ``models/convert.py``'s mapping):
    a ``module.dncnn.N.*`` state dict of an ``nn.DataParallel`` (DnCNN), a
    ``dncnn.N.*`` state dict (SimpleCNN), or a whole ``nn.DataParallel`` of a
    ``models.basic_models.simple_CNN`` (MMO), pickled against stub modules
    that :func:`run_convert` removes again."""
    depth = sum(name.startswith("Conv_") for name in variables["params"])
    features = variables["params"]["Conv_0"]["kernel"].shape[-1]
    layout = CONVERT_LAYOUTS[name]
    if layout == "pickled simple_CNN":
        model = MMOSimpleCNN(channels=1, depth=depth, features=features)
        model.load_state_dict(torch_state_dict_from_flax(variables, model))
        convs = [m for m in model.net if isinstance(m, torch.nn.Conv2d)]

        class simple_CNN(torch.nn.Module):  # noqa: N801 (reference class name)
            def __init__(self):
                super().__init__()
                self.in_conv, self.out_conv = convs[0], convs[-1]
                self.conv_list = torch.nn.ModuleList(convs[1:-1])

        simple_CNN.__module__, simple_CNN.__qualname__ = "models.basic_models", "simple_CNN"
        pkg, basic = types.ModuleType("models"), types.ModuleType("models.basic_models")
        basic.simple_CNN, pkg.basic_models = simple_CNN, basic
        sys.modules["models"], sys.modules["models.basic_models"] = pkg, basic
        return torch.nn.DataParallel(simple_CNN())
    model = DnCNN(channels=1, depth=depth, features=features, use_bn="batch_stats" in variables)
    sd = {k.replace("net.", "dncnn.", 1): v for k, v in torch_state_dict_from_flax(variables, model).items()}
    return {f"module.{k}": v for k, v in sd.items()} if layout == "module.dncnn" else sd


def run_convert(card: str) -> dict:
    """The ``.pth`` conversion through the port's ``convert_all``: the
    committed checkpoints of :data:`CONVERT_LAYOUTS` rebuilt in the
    reference's three layouts under a temporary reference tree, converted
    into a temporary directory (every other source missing, and skipped),
    each output array for array the committed file, and one 128 px Set12
    image (Set12/01 with noise of sigma 5/255 from a numpy seed) denoised on
    the card with each output and with the committed checkpoint, bit for
    bit equal."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    clean = load_image("Set12/01.png", 128, 128)
    x = torch.tensor((clean + 5.0 / 255.0 * rng.standard_normal(clean.shape)).astype(np.float32), device="cuda")
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, out_dir = Path(tmp) / "reference", Path(tmp) / "out"
        try:
            for name in CONVERT_LAYOUTS:
                src = root / CONVERSIONS[name]
                src.parent.mkdir(parents=True, exist_ok=True)
                torch.save(reference_checkpoint(name, load_flax_npz(CHECKPOINT_DIR / f"{name}.npz")), src)
            for mod in ("models.basic_models", "models"):
                sys.modules.pop(mod, None)  # the loader takes its own stub path
            converted = convert_all(out_dir, root)
        finally:
            for mod in ("models.basic_models", "models"):
                sys.modules.pop(mod, None)
        require(converted == list(CONVERT_LAYOUTS), f"convert_all converted {converted}")
        for name in converted:
            with np.load(CHECKPOINT_DIR / f"{name}.npz") as want, np.load(out_dir / f"{name}.npz") as got:
                arrays_equal = sorted(got.files) == sorted(want.files) and all(
                    np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want.files)
            outs = []
            for path in (CHECKPOINT_DIR / f"{name}.npz", out_dir / f"{name}.npz"):
                variables = load_flax_npz(path)
                if name.startswith("mmo_"):
                    den = MMODenoiser(model=flax_model(MMOSimpleCNN(channels=1), variables, "cuda"))
                else:
                    kind = "DnCNN" if name.startswith("dncnn") else "SimpleCNN"
                    den = DnCNNDenoiser(model=flax_model(model_for_type(kind), variables, "cuda"),
                                        sigma_train=5.0, model_type=kind)
                outs.append(den.denoise(x))
            bitwise = bool(torch.equal(*outs))
            rec[name] = {"layout": CONVERT_LAYOUTS[name], "arrays_equal": arrays_equal, "denoise_bitwise": bitwise,
                         "psnr_db": float(lane_psnr(torch.as_tensor(clean, device="cuda"), outs[1])[0])}
            require(arrays_equal and bitwise, f"convert {name}: {rec[name]}")
    rec = {"phase": "convert", "checkpoints": rec, "seconds": time.perf_counter() - t0, "card": card}
    emit(rec)
    return rec


def faithful_parity(den, eta: float) -> dict:
    """A 2-lane 32 px faithful-variant run (deterministic) on the card against
    the same run on the CPU."""
    gen = torch.Generator().manual_seed(0)
    probs = [make_csmri(load_image(p, 32, 32), gen, 0.5, snr=10, keep_low_freq=4, device="cpu")
             for p in ("Set12/01.png", "13.png")]
    cpu = stack_problems(probs)
    cuda = type(cpu)(**{k: v.cuda() for k, v in vars(cpu).items()})
    runs = [pnp_svrg(p, den, eta, 2, 3, 100, variant="faithful") for p in (cpu, cuda)]
    tr_cpu, tr_gpu = (r["psnr_per_iter"].cpu().numpy() for r in runs)
    return {"trace_max_abs_db": float(np.abs(tr_cpu - tr_gpu).max()),
            "image_mean_abs_diff": float((runs[0]["image"] - runs[1]["image"].cpu()).abs().mean()),
            "finite": bool(np.isfinite(tr_gpu).all()),
            "final_psnr_db": [float(v) for v in tr_gpu[-1]]}


def phase_parity() -> None:
    """Small faithful-variant reconstructions with BM3D, NLM and the wavelet
    "TV" denoiser: the card against the CPU (the kernels against their plain
    versions, and the TV denoiser's plain PyTorch on both); and a standalone BM3D
    denoise on the card that must clearly improve a noisy image."""
    bm3d = faithful_parity(BM3DDenoiser(sigma_modifier=2.0, params=BM3DParams(search=4)), 3000.0)
    nlm = faithful_parity(NLMDenoiser(sigma_modifier=1.2), 400.0)
    tv = faithful_parity(TVDenoiser(sigma_modifier=0.7), 400.0)
    clean = torch.tensor(load_image("13.png", 128, 128), device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(0)
    noisy = clean + 0.1 * torch.randn(clean.shape, generator=gen, device="cuda")
    out = bm3d_denoise_batch(noisy, 0.1, BM3DParams(search=8, match_dtype="bfloat16"))
    mse_noisy = float(((noisy - clean) ** 2).mean())
    mse_den = float(((out - clean) ** 2).mean())
    emit({"phase": "parity", "trace_max_abs_db": bm3d["trace_max_abs_db"],
          "image_mean_abs_diff": bm3d["image_mean_abs_diff"], "nlm": nlm, "tv": tv,
          "bm3d_mse_noisy": mse_noisy, "bm3d_mse_denoised": mse_den})
    for name, rec in (("BM3D", bm3d), ("NLM", nlm), ("TV", tv)):
        require(rec["finite"] and rec["trace_max_abs_db"] < 0.05 and rec["image_mean_abs_diff"] < 1e-3,
                f"{name} card vs CPU: trace {rec['trace_max_abs_db']} dB, "
                f"image {rec['image_mean_abs_diff']}")
    require(mse_den < 0.5 * mse_noisy, f"BM3D denoise mse {mse_den} vs noisy {mse_noisy}")


def lane_quality(prob, out, check: bool = True) -> dict:
    """Per-lane final PSNR and SSIM, and the PSNR trace; ``check`` fails the
    run on any non-finite value."""
    psnr = out["final_psnr"].cpu().numpy()
    ssims = ssim(prob.x, out["image"]).cpu().numpy()
    trace = out["psnr_per_iter"].cpu().numpy()
    require(not check or np.isfinite(np.concatenate([psnr, ssims, trace.ravel()])).all(),
            "non-finite PSNR/SSIM")
    require(out["image"].shape == prob.x.shape, "image shape")
    return {"per_lane_psnr_db": [float(v) for v in psnr],
            "per_lane_ssim": [float(v) for v in ssims], "_trace": trace}


def bitwise_repeats(outs) -> bool:
    """Whether runs of one lane on the same inputs gave the same bits: PSNR
    trace and final iterate."""
    return all(torch.equal(o["psnr_per_iter"], outs[0]["psnr_per_iter"]) and torch.equal(o["z"], outs[0]["z"])
               for o in outs[1:])


def ulp_shifted(prob, shift: str):
    """``prob`` with ``x_init`` moved one ulp ``"down"`` or ``"up"`` in every
    entry: the smallest perturbation of a run, whose spread over the runs
    from ``x_init`` as built, down and up stands in for rounding noise."""
    to = torch.full_like(prob.x_init, -math.inf if shift == "down" else math.inf)
    return dataclasses.replace(prob, x_init=torch.nextafter(prob.x_init, to))


def quality(prob, out, lanes, refs, check: bool = True) -> dict:
    """Set12 quality of a run against the JAX package's (Set12-VD mean,
    flagship) ``refs``."""
    q = lane_quality(prob, out, check)
    psnr, ssims = np.asarray(q["per_lane_psnr_db"]), np.asarray(q["per_lane_ssim"])
    n_set12 = len(lanes) - 1
    return {
        "set12_vd_mean_psnr_db": float(psnr[:n_set12].mean()),
        "set12_vd_min_psnr_db": float(psnr[:n_set12].min()),
        "set12_vd_mean_ssim": float(ssims[:n_set12].mean()),
        "flagship_psnr_db": float(psnr[-1]), "flagship_ssim": float(ssims[-1]),
        "delta_set12_vd_mean_db": float(psnr[:n_set12].mean()) - refs[0],
        "delta_flagship_db": float(psnr[-1]) - refs[1],
        "per_lane_psnr_db": q["per_lane_psnr_db"],
    }


def drive(prob, den, eta, lr_decay: float = 1.0, n_outer: int = N_OUTER, t2: int = T2,
          mini_batch: int = MINI_BATCH):
    """:func:`timed` runs of a PnP-SVRG lane. Returns (run, output, steady s,
    first s, launches)."""

    def run(seed=None, masks=None):
        gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        return pnp_svrg(prob, den, eta, n_outer, t2, mini_batch, generator=gen, masks=masks,
                        lr_decay=lr_decay)

    return (run,) + timed(run)


def check_k1_kernels(label: str, k1_kernels: dict, launches: dict, profiled=None) -> None:
    """Every K1 launch of a lane's timed run went to its kernel
    (:data:`LANE_K1_KERNEL`), and ``profiled`` (the K1 kernel names its
    profile recorded), where given, names that kernel alone."""
    want = LANE_K1_KERNEL.get(label, "bm3d_match_kernel")
    expect = dict.fromkeys(K1_KERNELS, 0) | {want: launches["bm3d_match"]}
    require(k1_kernels == expect, f"{label}: K1 launches by kernel {k1_kernels}, expected {expect}")
    if profiled is not None:
        require(profiled == [want], f"{label}: the profile's K1 kernels {profiled}, expected [{want!r}]")


def timed(run) -> tuple:
    """A warm-up ``run(seed=1)``, then the timed ``run(seed=2)`` on the port's
    generator with every kernel's launches counted from 0 and any implicit
    host-device synchronisation an error. Returns (output, steady s, first
    s, launches)."""
    t0 = time.perf_counter()
    run(seed=1)  # warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # the loop must never wait for the device
    try:
        out = run(seed=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
    return out, steady, first, launches


def csmri_lane(label: str, lanes) -> tuple:
    """A :data:`CSMRI_LANES` lane's per-lane eta (on the card) and its BM3D
    denoiser."""
    tuned, default_eta, default_mod, params = CSMRI_LANES[label]
    eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cuda")
    return eta, BM3DDenoiser(sigma_modifier=mod, params=params)


def run_lane(label: str, expect: dict, prob, lanes, ref_masks, floor_db: float | None = None,
             seeds=SPREAD_SEEDS, headline: dict | None = None, extra=None) -> dict:
    """A :data:`CSMRI_LANES` lane in the headline's pattern: a warm-up, the
    timed run on the port's stream (launches counted, no host sync), the run
    on the JAX run's masks ``ref_masks``, the spread ``seeds``, and the
    profile of one more run (emitted; the record's device ms); every run's
    PSNR and SSIM must be finite but the spread seeds'. With a
    ``floor_db`` the quality is reported against :data:`REF_DB`; without,
    against the JAX CPU run on ``ref_masks`` (a lane of
    ``CSMRI_BATCH_LANES``), and the floor is that run's Set12 mean less
    :data:`BENCH_BELOW_JAX_DB`. ``headline`` (the headline's record) puts
    its rate and device ms beside; ``extra(prob, lanes, ref, jax_trace)``
    returns more fields and the checks on them, as (condition, message)
    pairs. A lane of :data:`ENVELOPE_LANES` is held to its JAX CPU run in
    the envelope fixture, and its run on ``ref_masks`` is made
    :data:`ENVELOPE_REPEATS` times, which must repeat bit for bit."""
    eta, den = csmri_lane(label, lanes)
    run, out, steady, first, launches = drive(prob, den, eta)
    k1_kernels = dict(bm3d_match.by_kernel)  # the timed run's, as launches
    k2_k3_kernels = kernel_launches()
    envelope = label in ENVELOPE_LANES
    ref_repeats = ENVELOPE_REPEATS if envelope else 1
    jax_trace = None
    if floor_db is None:
        load = load_envelope_reference if envelope else load_batch_lane_reference
        jax_trace = load(label)["psnr_per_iter"]
        refs = (float(jax_trace[-1, :-1].mean()), float(jax_trace[-1, -1]))
        floor_db = refs[0] - BENCH_BELOW_JAX_DB
    else:
        refs = REF_DB[label]
    own = quality(prob, out, lanes, refs)
    ref_outs = [run(masks=ref_masks) for _ in range(ref_repeats)]
    ref_out = ref_outs[0]
    ref = quality(prob, ref_out, lanes, refs)
    if jax_trace is not None:
        trace = ref_out["psnr_per_iter"].cpu().numpy()
        ref |= {"jax_cpu_set12_mean_psnr_db": refs[0], "jax_cpu_per_lane_psnr_db": jax_trace[-1].tolist(),
                "trace_max_abs_db_vs_jax_cpu": float(np.abs(trace - jax_trace).max())}
    spread = {2: own} | {s: quality(prob, run(seed=s), lanes, refs, check=False) for s in seeds}
    keys = ("set12_vd_mean_psnr_db", "set12_vd_min_psnr_db", "flagship_psnr_db")
    rec = {
        "phase": label, "lanes": len(lanes), "steady_s": steady, "first_s": first,
        "image_iters_per_s": len(lanes) * N_OUTER * (T2 + 1) / steady,
        "launches": launches, "k1_kernels": k1_kernels, "k2_k3_kernels": k2_k3_kernels,
        "reference_minibatches": ref, "floor_db": floor_db, "port_stream_seed2": own,
        "port_stream_seeds": {s: [q[k] for k in keys] for s, q in spread.items()},
        "port_stream_seeds_fields": keys,
        "port_stream_mean_of_set12_vd_means": float(np.mean([q[keys[0]] for q in spread.values()])),
        "params": den.params.__dict__, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    prof = phase_profile(label, lambda: run(seed=3))
    rec |= {"device_ms": prof["device_kernel_ms"], "device_busy_share": prof["device_busy_share"],
            "profile_k1_kernels": prof["kernel_names"].get(KERNEL_GROUPS[0][0], []),
            "profile_k2_kernels": prof["kernel_names"].get(KERNEL_GROUPS[1][0], [])}
    if headline is not None:
        rec["headline"] = {k: headline[k] for k in ("image_iters_per_s", "device_ms", "device_busy_share")}
    checks = []
    if ref_repeats > 1:
        rec["ref_repeats"], rec["repeat_bitwise"] = ref_repeats, bitwise_repeats(ref_outs)
        checks.append((rec["repeat_bitwise"], f"{ref_repeats} runs on the JAX masks differ"))
    if extra is not None:
        fields, checks = extra(prob, lanes, ref, jax_trace)
        rec |= fields
    emit(rec)
    require(launches == expect, f"{label}: launches {launches}, expected {expect}")
    check_k1_kernels(label, k1_kernels, launches, rec["profile_k1_kernels"])
    check_k2_k3_kernels(label, k2_k3_kernels, launches)
    require(K2_KERNELS[1] not in rec["profile_k2_kernels"], f"{label}: the profile ran {K2_KERNELS[1]}")
    require(ref["set12_vd_mean_psnr_db"] >= floor_db,
            f"{label}: Set12-VD mean {ref['set12_vd_mean_psnr_db']:.4f} dB on the JAX masks < {floor_db:.4f}")
    for cond, what in checks:
        require(cond, f"{label}: {what}")
    return rec


def uniform_fields(prob, lanes, ref, jax_trace) -> tuple:
    """set12_uniform's per-lane record as ``bench.py:439-455`` makes it:
    init PSNR, final PSNR (on the JAX masks) and whether the mask lost the
    zero frequency, with the means and BENCH_r05.json's fields beside; and
    its checks: init PSNR within :data:`UNIFORM_INIT_TOL_DB` of the JAX
    trace's first entry, the lost zero frequencies equal to BENCH_r05.json's."""
    n_set12 = len(lanes) - 1
    init = prob.psnr(prob.x_init).cpu().numpy()[:n_set12]
    final = np.asarray(ref["per_lane_psnr_db"][:n_set12])
    bench = json.loads(BENCH_R05.read_text())["parsed"]
    u = {
        "lanes": lanes[:n_set12], "psnr_db_per_image": final.tolist(), "init_psnr_db_per_image": init.tolist(),
        "dc_lost_per_image": [bool(v) for v in (prob.mask[:n_set12, 0, 0] == 0).cpu()],
        "mean_psnr_db": float(final.mean()), "min_psnr_db": float(final.min()),
        "mean_ssim": ref["set12_vd_mean_ssim"], "mean_init_psnr_db": float(init.mean()),
        "mean_delta_db": float((final - init).mean()),
        "init_max_abs_db_vs_jax_cpu": float(np.abs(init - jax_trace[0, :n_set12]).max()),
        "bench_r05": {k.removeprefix("set12_uniform_"): v for k, v in bench.items()
                      if k.startswith("set12_uniform_")},
    }
    checks = [
        (u["init_max_abs_db_vs_jax_cpu"] <= UNIFORM_INIT_TOL_DB,
         f"init PSNR {u['init_max_abs_db_vs_jax_cpu']:.2e} dB off the JAX trace's"),
        (u["dc_lost_per_image"] == u["bench_r05"]["dc_lost_per_image"],
         f"lost zero frequencies {u['dc_lost_per_image']}, BENCH_r05.json "
         f"{u['bench_r05']['dc_lost_per_image']}"),
    ]
    return {"set12_uniform": u}, checks


def nlm_lane():
    """The CSMRI + NLM lane: one lane of ``13.png`` with the tuned (eta,
    sigma_modifier); returns (problem, denoiser, eta, config)."""
    cfg = nlm_params()
    eta = torch.tensor(cfg["eta"], device="cuda")  # made here: a copy in the loop would sync
    return load_nlm_problem("cuda"), NLMDenoiser(sigma_modifier=cfg["sigma_modifier"]), eta, cfg


def run_nlm_lane() -> dict:
    """The CSMRI + NLM lane, held on the JAX lane's masks to its stored trace."""
    prob, den, eta, cfg = nlm_lane()
    run, out, steady, first, launches = drive(prob, den, eta, cfg["lr_decay"])
    k2_k3_kernels = kernel_launches()
    own = lane_quality(prob, out)
    ref_run = lane_quality(prob, run(masks=load_nlm_masks("cuda")))
    jax_trace = load_nlm_reference()["psnr_per_iter"]
    dtrace = float(np.abs(ref_run.pop("_trace")[:, 0] - jax_trace).max())
    own.pop("_trace")
    spread = {s: lane_quality(prob, run(seed=s), check=False)["per_lane_psnr_db"][0]
              for s in SPREAD_SEEDS}
    ref_psnr = ref_run["per_lane_psnr_db"][0]
    rec = {
        "phase": "csmri_nlm", "lanes": 1, "steady_s": steady, "first_s": first,
        "image_iters_per_s": N_OUTER * (T2 + 1) / steady, "launches": launches,
        "k2_k3_kernels": k2_k3_kernels,
        "reference_minibatches": {
            "psnr_db": ref_psnr, "ssim": ref_run["per_lane_ssim"][0],
            "delta_psnr_db": ref_psnr - NLM_REF_DB, "delta_ssim": ref_run["per_lane_ssim"][0] - NLM_REF_SSIM,
            "trace_max_abs_db_vs_jax": dtrace,
        },
        "port_stream_seed2": {"psnr_db": own["per_lane_psnr_db"][0], "ssim": own["per_lane_ssim"][0]},
        "port_stream_seeds_psnr_db": spread,
        "config": {k: cfg[k] for k in ("eta", "lr_decay", "sigma_modifier")},
    }
    emit(rec)
    denoises = N_OUTER * T2
    expect = {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": denoises}
    require(launches == expect, f"csmri_nlm: launches {launches}, expected {expect}")
    check_k2_k3_kernels("csmri_nlm", k2_k3_kernels, launches)
    require(ref_psnr >= NLM_FLOOR_DB, f"csmri_nlm: PSNR {ref_psnr:.2f} dB < {NLM_FLOOR_DB}")
    require(dtrace <= NLM_TRACE_TOL_DB, f"csmri_nlm: trace {dtrace:.4f} dB off the JAX trace")
    return rec


def profile_first_call(prob, lanes, ref, jax_trace) -> tuple:
    """bm3d_profile's ``extra``: one BM3D call of the lane's parameters on
    each lane's first denoise input as the JAX loop forms it (the fixture's
    ``first_input`` and ``first_sigma``) against JAX CPU's ``first_output``:
    each lane's PSNR within :data:`PROFILE_CALL_TOL_DB`, the largest pixel
    difference reported."""
    jax_ref = load_envelope_reference("bm3d_profile")
    z, sig, want = (torch.as_tensor(jax_ref[k], device="cuda")
                    for k in ("first_input", "first_sigma", "first_output"))
    got = bm3d_denoise_batch(z, sig, BM3D_PROFILE_LANE[3])
    port, jax_db = prob.psnr(got).cpu().numpy(), prob.psnr(want).cpu().numpy()
    gap = float(np.abs(port - jax_db).max())
    f = {"first_call": {"port_psnr_db": port.tolist(), "jax_cpu_psnr_db": jax_db.tolist(),
                        "max_abs_db": gap, "max_abs_diff": (got - want).abs().max().item()}}
    return f, [(gap <= PROFILE_CALL_TOL_DB, f"one BM3D call {gap:.4f} dB off JAX CPU's on a lane")]


def run_nlm_skimage_lane() -> dict:
    """The CSMRI + NLM lane at skimage's NLM defaults (:data:`NLM_SKIMAGE`):
    a warm-up and a timed run on the port's stream (launches counted), then
    :data:`ENVELOPE_REPEATS` runs on the JAX lane's masks, bitwise equal and
    each entry of their trace within :data:`NLM_TRACE_TOL_DB` of the JAX CPU
    trace of the same run; then a profile of one more run."""
    prob, _, eta, cfg = nlm_lane()
    den = NLMDenoiser(sigma_modifier=cfg["sigma_modifier"], **NLM_SKIMAGE)
    run, out, steady, first, launches = drive(prob, den, eta, cfg["lr_decay"])
    k2_k3_kernels = kernel_launches()
    own = lane_quality(prob, out)
    masks = load_nlm_masks("cuda")
    outs = [run(masks=masks) for _ in range(ENVELOPE_REPEATS)]
    ref_run = lane_quality(prob, outs[0])
    jax_ref = load_envelope_reference("csmri_nlm_skimage")
    dtrace = float(np.abs(ref_run.pop("_trace")[:, 0] - jax_ref["psnr_per_iter"]).max())
    own.pop("_trace")
    rec = {
        "phase": "csmri_nlm_skimage", "lanes": 1, "denoiser": NLM_SKIMAGE, "steady_s": steady,
        "first_s": first, "image_iters_per_s": N_OUTER * (T2 + 1) / steady, "launches": launches,
        "k2_k3_kernels": k2_k3_kernels,
        "reference_minibatches": {
            "psnr_db": ref_run["per_lane_psnr_db"][0], "ssim": ref_run["per_lane_ssim"][0],
            "jax_cpu_psnr_db": float(jax_ref["psnr_per_iter"][-1]), "jax_cpu_ssim": float(jax_ref["ssim"]),
            "trace_max_abs_db_vs_jax": dtrace},
        "repeat_bitwise": bitwise_repeats(outs),
        "port_stream_seed2": {"psnr_db": own["per_lane_psnr_db"][0], "ssim": own["per_lane_ssim"][0]},
        "config": {k: cfg[k] for k in ("eta", "lr_decay", "sigma_modifier")},
    }
    prof = phase_profile("csmri_nlm_skimage", lambda: run(seed=3))
    rec |= {"device_ms": prof["device_kernel_ms"], "device_busy_share": prof["device_busy_share"],
            "profile_k3_kernels": prof["kernel_names"].get(KERNEL_GROUPS[2][0], [])}
    emit(rec)
    expect = {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": N_OUTER * T2}
    require(launches == expect, f"csmri_nlm_skimage: launches {launches}, expected {expect}")
    check_k2_k3_kernels("csmri_nlm_skimage", k2_k3_kernels, launches)
    require(rec["profile_k3_kernels"] == [K3_KERNELS[1]],
            f"csmri_nlm_skimage: the profile's K3 kernels {rec['profile_k3_kernels']}")
    require(rec["repeat_bitwise"], "csmri_nlm_skimage: runs on the JAX masks differ")
    require(dtrace <= NLM_TRACE_TOL_DB, f"csmri_nlm_skimage: trace {dtrace:.4f} dB off the JAX trace")
    return rec


def nlm_grid():
    """The NLM tuner's chunk: 9 lanes of the ``13.png`` problem with the
    3 x 3 (eta, sigma_modifier) grid; returns (problem, denoiser, eta, pairs)."""
    cfg = nlm_params()
    prob = stack_problems([load_nlm_problem("cuda")] * 9)
    pairs = list(itertools.product(cfg["etas"], cfg["mods"]))
    eta = torch.tensor([e for e, _ in pairs], device="cuda")
    mod = torch.tensor([m for _, m in pairs], device="cuda")
    return prob, NLMDenoiser(sigma_modifier=mod), eta, pairs


def run_nlm_grid() -> dict:
    prob, den, eta, pairs = nlm_grid()
    _, out, steady, first, launches = drive(prob, den, eta)
    k2_k3_kernels = kernel_launches()
    q = lane_quality(prob, out, check=False)
    q.pop("_trace")
    rec = {
        "phase": "csmri_nlm_grid", "lanes": len(pairs), "steady_s": steady, "first_s": first,
        "image_iters_per_s": len(pairs) * N_OUTER * (T2 + 1) / steady, "launches": launches,
        "k2_k3_kernels": k2_k3_kernels, "pairs_eta_mod": pairs, **q,
    }
    emit(rec)
    expect = {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": N_OUTER * T2}
    require(launches == expect, f"csmri_nlm_grid: launches {launches}, expected {expect}")
    check_k2_k3_kernels("csmri_nlm_grid", k2_k3_kernels, launches)
    return rec


def bench_lane(label: str) -> dict:
    """One of ``bench.py``'s PR and Deblur lanes on the card: its
    configuration, the fixture's problem (the JAX package's), the denoiser,
    ``eta`` as a device tensor (a copy in the loop would sync), the JAX
    run's minibatches and, where the fixture has one, its trace."""
    cfg = bench_config(label)
    if label == "pr_bm3d":
        prob, ref_mb, jax_ref = load_pr_problem("cuda"), load_pr_indices("cuda"), load_pr_reference()
    else:
        prob, ref_mb = load_deblur_problem(label, "cuda"), load_deblur_masks(label, "cuda")
        jax_ref = load_deblur_reference(label)
    return {"label": label, "cfg": cfg, "prob": prob, "ref_mb": ref_mb, "jax_ref": jax_ref,
            "den": BM3DDenoiser(sigma_modifier=cfg["sigma_modifier"], params=cfg["params"]),
            "eta": torch.tensor(cfg["eta"], device="cuda")}


def bench_run(lane: dict, seed: int):
    """A run of the lane on the port's generator (seed ``seed``)."""
    cfg = lane["cfg"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return pnp_svrg(lane["prob"], lane["den"], lane["eta"], cfg["n_outer"], cfg["t2"],
                    cfg["mini_batch_size"], generator=gen, lr_decay=cfg["lr_decay"])


def entry_point_build(lane: dict) -> dict:
    """The lane's problem built once through the normal entry point on the
    card (a CUDA generator: other noise and, for PR, another A than the
    fixture's). Deblur: its noiseless forward of the ground truth against
    the fixture problem's, at f32 tolerance; PR: the spectral
    initialisation's steps and seconds."""
    spec, prob = BENCH_LANES[lane["label"]], lane["prob"]
    size = spec["size"]
    img = load_image(spec["image"], size, size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    if lane["label"] == "pr_bm3d":
        stats = {}
        built = make_phase_retrieval(img, gen, spec["num_meas"], snr=spec["snr"], device="cuda",
                                     stats=stats)
        torch.cuda.synchronize()
        x0 = built.x_init
        rec = {**stats, "x_init_range": [float(x0.min()), float(x0.max())],
               "init_psnr_db": float(built.psnr(x0)[0])}
        require(bool(torch.isfinite(x0).all()) and rec["x_init_range"] == [0.0, 1.0],
                f"pr_bm3d: make_phase_retrieval's x_init {rec['x_init_range']}")
        del built
    else:
        kernel = spec["kernel"]
        if kernel.endswith(".png"):
            kernel = str(resolve_data_path(kernel))
        built = make_deblur(img, gen, kernel=kernel, scale_percent=spec["scale_percent"],
                            snr=spec["snr"], device="cuda")
        torch.cuda.synchronize()
        want = prob.forward(prob.x)
        diff = (built.forward(prob.x) - want).abs().max().item()
        scale = want.abs().max().item()
        rec = {"forward_max_abs_diff": diff, "forward_magnitude": scale,
               "sigma": float(built.sigma[0]), "fixture_sigma": float(prob.sigma[0])}
        require(diff <= 1e-5 * scale, f"{lane['label']}: make_deblur forward {diff} vs {scale}")
        require(abs(rec["sigma"] - rec["fixture_sigma"]) <= 1e-4 * rec["fixture_sigma"],
                f"{lane['label']}: make_deblur sigma {rec['sigma']} vs {rec['fixture_sigma']}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run_bench_lane(lane: dict) -> dict:
    """A PR or Deblur lane in the ``drive`` pattern; its runs on the JAX
    run's minibatches (:data:`BENCH_REF_REPEATS`) are held, by their mean, to
    the lane's floor."""
    label, cfg, prob = lane["label"], lane["cfg"], lane["prob"]
    torch.cuda.reset_peak_memory_stats()
    run, out, steady, first, launches = drive(prob, lane["den"], lane["eta"], cfg["lr_decay"],
                                              cfg["n_outer"], cfg["t2"], cfg["mini_batch_size"])
    k1_kernels = dict(bm3d_match.by_kernel)  # the timed run's, as launches
    k2_k3_kernels = kernel_launches()
    own = lane_quality(prob, out)
    own.pop("_trace")
    ref_outs = [run(masks=lane["ref_mb"]) for _ in range(BENCH_REF_REPEATS)]
    ref_run = lane_quality(prob, ref_outs[0])
    trace = ref_run.pop("_trace")[:, 0]
    repeats = [lane_quality(prob, o)["per_lane_psnr_db"][0] for o in ref_outs]
    repeat_bitwise = bitwise_repeats(ref_outs)
    spread = {s: lane_quality(prob, run(seed=s), check=False)["per_lane_psnr_db"][0]
              for s in BENCH_SPREAD_SEEDS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ref_db, ref_ssim = BENCH_REF[label]
    psnr, ssim_ = ref_run["per_lane_psnr_db"][0], ref_run["per_lane_ssim"][0]
    mean_psnr = float(np.mean(repeats))
    ref = {"psnr_db": psnr, "ssim": ssim_, "repeats_psnr_db": repeats,
           "repeats_mean_psnr_db": mean_psnr, "repeat_bitwise": repeat_bitwise,
           "bench_r05_psnr_db": ref_db,
           "delta_psnr_db_vs_bench_r05": psnr - ref_db, "delta_ssim_vs_bench_r05": ssim_ - ref_ssim}
    floor = BENCH_FLOOR_DB.get(label)
    if lane["jax_ref"] is not None:
        jax_trace = lane["jax_ref"]["psnr_per_iter"]
        ref |= {"jax_cpu_psnr_db": float(jax_trace[-1]), "jax_cpu_ssim": lane["jax_ref"]["ssim"],
                "delta_psnr_db_vs_jax_cpu": psnr - float(jax_trace[-1]),
                "trace_max_abs_db_vs_jax_cpu": float(np.abs(trace - jax_trace).max())}
        if floor is None:
            floor = float(jax_trace[-1]) - BENCH_BELOW_JAX_DB
    iters = cfg["n_outer"] * (cfg["t2"] + 1)
    rec = {
        "phase": label, "lanes": 1, "steady_s": steady, "first_s": first,
        "image_iters_per_s": iters / steady, "launches": launches, "k1_kernels": k1_kernels,
        "k2_k3_kernels": k2_k3_kernels, "reference_minibatches": ref, "floor_db": floor,
        "port_stream_seed2": {"psnr_db": own["per_lane_psnr_db"][0], "ssim": own["per_lane_ssim"][0]},
        "port_stream_seeds_psnr_db": spread, "peak_mem_gb": peak_gb,
        "config": {k: cfg[k] for k in ("eta", "lr_decay", "sigma_modifier", "n_outer", "t2",
                                       "mini_batch_size")} | {"params": cfg["params"].__dict__},
        "entry_point": entry_point_build(lane),
    }
    emit(rec)
    denoises = cfg["n_outer"] * cfg["t2"]
    expect = {"bm3d_match": 2 * denoises, "bm3d_aggregate": 2 * denoises, "nlm": 0}
    require(launches == expect, f"{label}: launches {launches}, expected {expect}")
    check_k1_kernels(label, k1_kernels, launches)
    check_k2_k3_kernels(label, k2_k3_kernels, launches)
    require(repeat_bitwise, f"{label}: {len(repeats)} runs on the JAX run's minibatches differ: {repeats}")
    require(mean_psnr >= floor, f"{label}: mean PSNR of {len(repeats)} runs on the JAX run's "
                                f"minibatches {mean_psnr:.2f} dB < {floor:.2f}")
    return rec


def sarah_lane() -> dict:
    """The PR + SARAH + RealSN lane on the card: its configuration, the 8
    replicas holding one A, the RealSN-DnCNN denoiser, ``eta`` as a device
    tensor, the JAX run's row indices and its reference."""
    cfg = bench_config("pr_sarah_realsn")
    return {"cfg": cfg, "prob": load_pr_sarah_problem("cuda"),
            "den": DnCNNDenoiser.from_pretrained("RealSN_DnCNN", cfg["realsn_sigma"], device="cuda"),
            "eta": torch.tensor(cfg["eta"], device="cuda"), "ref_mb": load_pr_sarah_indices("cuda"),
            "jax_ref": load_pr_sarah_reference()}


def sarah_run(lane: dict, seed=None, masks=None):
    cfg = lane["cfg"]
    gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
    return pnp_sarah(lane["prob"], lane["den"], lane["eta"], cfg["n_outer"], cfg["t2"],
                     cfg["mini_batch_size"], generator=gen, masks=masks, lr_decay=cfg["lr_decay"],
                     variant=cfg["variant"])


def run_sarah_lane(lane: dict, card: str, mem_before_gb: float) -> dict:
    """PR + SARAH + RealSN at full width: a warm-up and a timed run on the
    port's generator (launches counted, no host-device sync allowed), then
    two runs on the JAX run's row indices, whose replica-mean PSNR is held to
    the JAX CPU run's less :data:`BENCH_BELOW_JAX_DB` and which must agree
    exactly; the lane's peak device memory above what was allocated before
    it was built (``mem_before_gb``): one A (537 MB) and the run's working
    set, under the 4.3 GB that 8 copies of A would take."""
    cfg, prob = lane["cfg"], lane["prob"]
    require(prob.a.shape[0] == 1 and prob.batch_size == cfg["replicas"], "pr_sarah_realsn: one A for all lanes")
    a_gb = prob.a.numel() * 4 / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, steady, first, launches = timed(lambda seed: sarah_run(lane, seed=seed))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own = lane_quality(prob, out)
    own_trace = own.pop("_trace")
    ref_outs = [sarah_run(lane, masks=lane["ref_mb"]) for _ in range(2)]
    repeat_equal = bitwise_repeats(ref_outs)
    refs = [lane_quality(prob, o) for o in ref_outs]
    trace = refs[0].pop("_trace")
    refs[1].pop("_trace")
    jax_trace, jax_ssim = lane["jax_ref"]["psnr_per_iter"], lane["jax_ref"]["ssim"]
    psnr = np.asarray(refs[0]["per_lane_psnr_db"])
    jax_mean = float(jax_trace[-1].mean())
    early = 1 + SARAH_EARLY_ROUNDS * (cfg["t2"] + 1)
    early_diff = float(np.abs(trace[:early] - jax_trace[:early]).max())
    floor = jax_mean - BENCH_BELOW_JAX_DB
    iters = cfg["replicas"] * cfg["n_outer"] * (cfg["t2"] + 1)
    rec = {
        "phase": "pr_sarah_realsn", "lanes": cfg["replicas"], "card": card,
        "steady_s": steady, "first_s": first, "image_iters_per_s": iters / steady,
        "image_iters": iters, "launches": launches, "peak_mem_gb": peak_gb, "a_gb": a_gb,
        "lane_peak_mem_gb": peak_gb - mem_before_gb, "mem_before_lane_gb": mem_before_gb,
        "reference_minibatches": {
            "replica_mean_psnr_db": float(psnr.mean()), "replica_min_psnr_db": float(psnr.min()),
            "per_replica_psnr_db": refs[0]["per_lane_psnr_db"], "per_replica_ssim": refs[0]["per_lane_ssim"],
            "mean_ssim": float(np.mean(refs[0]["per_lane_ssim"])),
            "jax_cpu_replica_mean_psnr_db": jax_mean,
            "jax_cpu_per_replica_psnr_db": [float(v) for v in jax_trace[-1]],
            "jax_cpu_per_replica_ssim": [float(v) for v in jax_ssim],
            "delta_replica_mean_db_vs_jax_cpu": float(psnr.mean()) - jax_mean,
            "trace_max_abs_db_vs_jax_cpu": float(np.abs(trace - jax_trace).max()),
            f"trace_max_abs_db_vs_jax_cpu_first_{early}_entries": early_diff,
            "first_entry_off_by_0.01_db_vs_jax_cpu": int(np.argmax(np.abs(trace - jax_trace).max(1) > 0.01)),
            "repeat_replica_mean_psnr_db": float(np.mean(refs[1]["per_lane_psnr_db"])),
            "repeat_bitwise": repeat_equal,
            "bench_r05_psnr_db_other_a": SARAH_BENCH_R05_DB,
        },
        "floor_db": floor,
        "port_stream_seed2": {"replica_mean_psnr_db": float(np.mean(own["per_lane_psnr_db"])),
                              "per_replica_psnr_db": own["per_lane_psnr_db"],
                              "final_trace_entries": [float(v) for v in own_trace[-1]]},
        "config": {k: cfg[k] for k in ("eta", "lr_decay", "n_outer", "t2", "mini_batch_size",
                                       "replicas", "realsn_sigma", "variant")},
    }
    emit(rec)
    require(launches == {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": 0},
            f"pr_sarah_realsn: launches {launches}, expected none")
    require(repeat_equal, "pr_sarah_realsn: two runs on the same row indices differ (trace or iterate)")
    require(early_diff <= SARAH_EARLY_TOL_DB,
            f"pr_sarah_realsn: the first {early} trace entries are {early_diff:.2e} dB off the JAX trace")
    require(float(psnr.mean()) >= floor,
            f"pr_sarah_realsn: replica mean {psnr.mean():.2f} dB < {floor:.2f} (JAX CPU {jax_mean:.2f})")
    require(peak_gb - mem_before_gb < cfg["replicas"] * a_gb,
            f"pr_sarah_realsn: the lane's peak memory {peak_gb - mem_before_gb:.2f} GB "
            f"is not under {cfg['replicas']} copies of A")
    return rec


def run_loops() -> dict:
    """``run_pnp`` drives GD, SGD, SAGA and SARAH (both variants) on the
    CSMRI + NLM lane's problem: finite traces, K3 launched once a denoise,
    and ``pnp_gd``'s trace held to the JAX CPU ``pnp_gd`` trace entry by
    entry within :data:`GD_TRACE_TOL_DB`."""
    prob, den, _, _ = nlm_lane()
    gd_ref = load_nlm_gd_reference()
    eta = torch.tensor(gd_ref["eta"], device="cuda")
    runs = {}
    for label, (algo, kw) in LOOP_RUNS.items():
        kw = dict(kw, n_iters=gd_ref["n_iters"]) if algo == "gd" else kw
        denoises = kw.get("n_iters", kw.get("n_outer", 0) * (1 + kw.get("t2", 0)))
        gen = torch.Generator(device="cuda").manual_seed(2)
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_pnp(algo, prob, den, eta=eta, generator=gen, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: k.launches for n, k in KERNELS.items()}
        trace = out["psnr_per_iter"][:, 0].cpu().numpy()
        runs[label] = {"algo_name": out["algo_name"], "seconds": seconds, "launches": launches,
                       "expected_k3": denoises, "trace_psnr_db": [float(v) for v in trace], **kw}
        require(np.isfinite(trace).all(), f"loops/{label}: non-finite trace")
        require(launches == {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": denoises},
                f"loops/{label}: launches {launches}, expected K3 = {denoises}")
        if algo == "gd":
            dtrace = float(np.abs(trace - gd_ref["psnr_per_iter"]).max())
            runs[label]["trace_max_abs_db_vs_jax_cpu"] = dtrace
            runs[label]["jax_cpu_trace_psnr_db"] = [float(v) for v in gd_ref["psnr_per_iter"]]
            require(dtrace <= GD_TRACE_TOL_DB, f"loops/gd: trace {dtrace:.4f} dB off the JAX trace")
    emit({"phase": "loops", "eta": gd_ref["eta"], "runs": runs})
    return runs


def run_sweep(card: str) -> dict:
    """The tuning path at full width: ``sweep_sampratio.main`` on the card,
    every ``run_pnp`` call of the sweep observed (its group, lanes,
    arguments, seconds until its PSNRs are on the host, and launches). The
    launch counts are set to 0 just before the sweep and read just after;
    each round must launch K1 = K2 = 2 x n_outer x t2 (BM3D) or K3 =
    n_outer x t2 (NLM) and nothing else."""
    calls = []
    real = sweep_module.run_pnp

    def observed(algo, problem, den, **kw):
        before = {n: k.launches for n, k in KERNELS.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(algo, problem, den, **kw)
        out["final_psnr"].cpu()
        calls.append({"group": "bm3d" if isinstance(den, BM3DDenoiser) else "nlm",
                      "lanes": problem.batch_size, "seconds": time.perf_counter() - t0,
                      "n_outer": kw["n_outer"], "t2": kw["t2"], "mini_batch_size": kw["mini_batch_size"],
                      "launches": {n: k.launches - before[n] for n, k in KERNELS.items()},
                      "args": (algo, problem, den, kw)})
        return out

    for k in KERNELS.values():
        k.launches = 0
    sweep_module.run_pnp = observed
    try:
        t0 = time.perf_counter()
        results = sweep_sampratio.main(SWEEP_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sweep_module.run_pnp = real
    launches = {n: k.launches for n, k in KERNELS.items()}
    with open(SWEEP_CSV, newline="") as f:
        rows = list(csv.DictReader(f))
    groups = {}
    for g in ("bm3d", "nlm"):
        rounds = [c for c in calls if c["group"] == g]
        cells = [r for r in results if r.denoiser_name == g]
        seconds = sum(c["seconds"] for c in rounds)
        iters = sum(c["lanes"] * c["n_outer"] * (c["t2"] + 1) for c in rounds)
        groups[g] = {
            "rounds": len(rounds), "lanes": [c["lanes"] for c in rounds],
            "seconds_per_round": [c["seconds"] for c in rounds],
            "trials_per_s": sum(c["lanes"] for c in rounds) / seconds,
            "image_iters_per_s": iters / seconds, "image_iters": iters,
            "round_config": [{k: c[k] for k in ("n_outer", "t2", "mini_batch_size")} for c in rounds],
            "launches_per_round": [c["launches"] for c in rounds],
            "launches": {n: sum(c["launches"][n] for c in rounds) for n in KERNELS},
            "best_loss_db": {r.image: r.best_loss for r in cells},
            "best_psnr_db": {r.image: r.best_psnr for r in cells},
            "best_params": {r.image: r.best_params for r in cells},
        }
    rec = {"phase": "sweep", "card": card, "argv": SWEEP_ARGV[:-2], "wall_s": wall,
           "cells": len(results), "csv_rows": len(rows), "launches": launches, "groups": groups}
    emit(rec)
    require(len(results) == SWEEP_CELLS and len(rows) == SWEEP_CELLS,
            f"sweep: {len(results)} cells, {len(rows)} CSV rows, expected {SWEEP_CELLS}")
    for c in calls:
        d = c["n_outer"] * c["t2"]
        want = ({"bm3d_match": 2 * d, "bm3d_aggregate": 2 * d, "nlm": 0} if c["group"] == "bm3d"
                else {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": d})
        require(c["launches"] == want, f"sweep/{c['group']}: round launches {c['launches']}, expected {want}")
    require(launches == {n: sum(c["launches"][n] for c in calls) for n in KERNELS},
            f"sweep: launches {launches} outside its rounds")
    for g, rec_g in groups.items():
        require(rec_g["rounds"] == SWEEP_ROUNDS and set(rec_g["lanes"]) == {SWEEP_LANES},
                f"sweep/{g}: rounds {rec_g['rounds']} of lanes {rec_g['lanes']}")
    for r in results:
        p = r.best_params
        inside = (SWEEP_SPACE["eta"][0] <= p["eta"] <= SWEEP_SPACE["eta"][1]
                  and SWEEP_SPACE["dstrength"][0] <= p["dstrength"] <= SWEEP_SPACE["dstrength"][1]
                  and p["t2"] in SWEEP_SPACE["t2"] and p["mini_batch_size"] in SWEEP_SPACE["mini_batch_size"])
        require(inside, f"sweep/{r.denoiser_name}/{r.image}: best {p} outside the space")
        require(math.isfinite(r.best_psnr) and r.best_loss < 0,
                f"sweep/{r.denoiser_name}/{r.image}: best PSNR {r.best_psnr}, loss {r.best_loss}")
    rec["_first_round"] = {g: next(c["args"] for c in calls if c["group"] == g) for g in groups}
    return rec


def sweep_lane(args) -> dict:
    """A sweep round's first call as a lane for :func:`first_denoise_input`:
    its stacked problems, denoiser, (B, 1) eta on the card and params."""
    _, prob, den, kw = args
    return {"label": f"sweep_{'bm3d' if isinstance(den, BM3DDenoiser) else 'nlm'}", "prob": prob,
            "cfg": {"params": getattr(den, "params", None), "sigma_modifier": den.sigma_modifier},
            "eta": kw["eta"].to("cuda")[:, None]}


def check_nlm_at_sweep(args, clock_hz: float) -> dict:
    """K3 against its plain version on an NLM round's first denoise input
    (B = 36, each lane its own h = sigma), with its times and bound."""
    z, h = first_denoise_input(sweep_lane(args))
    require(len(set(h.tolist())) == z.shape[0], "K3 at the sweep shape: two lanes share h")
    got, want = nlm_denoise(z, h, h), nlm_denoise_plain(z, h, h)
    err = (got - want).abs().max().item()
    require(err <= 1e-5, f"K3 max abs err {err} at the sweep shape")
    return {"shape": {"images": list(z.shape), "patch_size": 4, "patch_distance": 5},
            "max_abs_err": err, **nlm_times(z, h, h, clock_hz), "library_ms": None,
            "h": h.tolist()}


def run_compat(card: str) -> dict:
    """The compat API on the card, on the CSMRI + NLM lane's problem: (a)
    ``compat.pnp_svrg`` against the loop on the JAX lane's first 4 x 10
    minibatches; (b) ``tune_pnp_svrg`` for a 3 s budget (the divergence
    check on, the convergence check off); (c) the same with BM3D (the
    headline's parameters and the ``13.png`` lane's tuned eta and
    modifier). Launches are counted from 0 over each call."""
    prob, den, _, cfg = nlm_lane()
    eta, mb, t2, decay = float(cfg["eta"]), int(cfg["mini_batch_size"]), int(cfg["t2"]), cfg["lr_decay"]
    n_outer = COMPAT_ITERS // t2
    masks = load_nlm_masks("cuda")[:n_outer]
    loop = pnp_svrg(prob, den, torch.tensor(eta, device="cuda"), n_outer, t2, mb, masks=masks,
                    lr_decay=decay)

    def counted(fn):
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: k.launches for n, k in KERNELS.items()}

    a, a_s, a_launches = counted(lambda: compat.pnp_svrg(
        prob, den, eta=eta, tt=1e9, T2=t2, mini_batch_size=mb, lr_decay=decay,
        max_iters=COMPAT_ITERS, converge_check=False, diverge_check=False,
        masks=masks.reshape((-1,) + tuple(masks.shape[2:]))))
    loop_trace = loop["psnr_per_iter"][:, 0].cpu().numpy()
    dtrace = float(np.abs(np.asarray(a["psnr_per_iter"]) - loop_trace).max())
    dz = (a["z"] - loop["z"].reshape(-1)).abs().max().item()

    def tuner_record(out, seconds, launches, denoises):
        entries = len(out["time_per_iter"]) - 1
        return {"inner_iters": denoises, "snapshots": entries - denoises, "seconds": seconds,
                "gradient_time_s": out["gradient_time"], "denoise_time_s": out["denoise_time"],
                "time_per_iter_sum_s": float(np.sum(out["time_per_iter"])), "loss_db": out["loss"],
                "psnr_first_last_db": [out["psnr_per_iter"][0], out["psnr_per_iter"][-1]],
                "launches": launches, "tt_s": COMPAT_TT}

    # The convergence check off: with it the reference's rounded-PSNR test
    # stops within a second, and the budget is what (b) and (c) measure.
    b, b_s, b_launches = counted(lambda: compat.tune_pnp_svrg(
        [eta, mb, t2, 1.0], prob, den, tt=COMPAT_TT, converge_check=False))
    eta13, mod13 = lane_params(DATA_DIR / "set12_csmri_tuned.json", [NLM_LANE], 6000.0, 1.0, "cpu")
    bden = BM3DDenoiser(params=BM3DParams(search=8, match_dtype="bfloat16"))
    c, c_s, c_launches = counted(lambda: compat.tune_pnp_svrg(
        [float(eta13[0]), mb, t2, float(mod13[0])], prob, bden, tt=COMPAT_TT, converge_check=False))
    rec = {
        "phase": "compat", "card": card,
        "a_vs_loop": {"inner_iters": COMPAT_ITERS, "trace_max_abs_db_vs_loop": dtrace,
                      "z_max_abs_diff_vs_loop": dz, "seconds": a_s, "launches": a_launches,
                      "gradient_time_s": a["gradient_time"], "denoise_time_s": a["denoise_time"],
                      "psnr_last_db": a["psnr_per_iter"][-1], "loop_psnr_last_db": float(loop_trace[-1])},
        "b_tune_nlm": tuner_record(b, b_s, b_launches, b_launches["nlm"]),
        "c_tune_bm3d": tuner_record(c, c_s, c_launches, c_launches["bm3d_match"] // 2)
        | {"eta": float(eta13[0]), "dstrength": float(mod13[0])},
    }
    emit(rec)
    require(dtrace <= COMPAT_TRACE_TOL_DB, f"compat (a): trace {dtrace} dB off the loop's")
    require(dz <= COMPAT_Z_TOL, f"compat (a): iterate {dz} off the loop's")
    require(a_launches == {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": COMPAT_ITERS},
            f"compat (a): launches {a_launches}")
    for name, r in (("b", rec["b_tune_nlm"]), ("c", rec["c_tune_bm3d"])):
        n = r["inner_iters"]
        require(n > 0 and r["snapshots"] in (-(-n // t2), -(-n // t2) + 1),
                f"compat ({name}): {n} inner steps and {r['snapshots']} snapshots")
        require(math.isfinite(r["loss_db"]), f"compat ({name}): loss {r['loss_db']}")
    require(b_launches == {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": b_launches["nlm"]},
            f"compat (b): launches {b_launches}")
    n_c = rec["c_tune_bm3d"]["inner_iters"]
    require(c_launches == {"bm3d_match": 2 * n_c, "bm3d_aggregate": 2 * n_c, "nlm": 0},
            f"compat (c): launches {c_launches}")
    return rec


def run_checks(bench: dict, card: str) -> dict:
    """The gradient checks in float64 on the card, on each problem at its
    lane's size: CSMRI (the ``13.png`` lane, 128 px), phase retrieval (M =
    8192, N = 16384: A widened is 1.07 GB), Deblur (256 px) and Deblur-SR
    (256 -> 128 px)."""
    probs = {"csmri_128": load_nlm_problem("cuda"), "pr_8192x16384": bench["pr_bm3d"]["prob"],
             "deblur_256": bench["deblur_bm3d"]["prob"],
             "deblur_sr_256_to_128": bench["deblur_sr_bm3d"]["prob"]}
    errs = {}
    for name, prob in probs.items():
        t0 = time.perf_counter()
        full = grad_full_check(prob, raise_on_fail=False)
        stoch = grad_stoch_check(widen(prob), raise_on_fail=False)
        errs[name] = {"grad_full": full, "grad_stoch": stoch, "seconds": time.perf_counter() - t0,
                      "n": prob.n, "m": prob.m}
    emit({"phase": "checks", "card": card, "dtype": "float64", "tol": CHECK_TOL, "problems": errs})
    for name, e in errs.items():
        for check, tol in CHECK_TOL.items():
            require(e[check] <= tol, f"checks/{name}: {check} error {e[check]} > {tol}")
    return errs


def run_realsn_export(card: str) -> dict:
    """The ``check_realsn_export`` phase: the checker's ``main`` on each
    committed RealSN-DnCNN export, on the card, into ``build/``. Each must
    pass its own check (every layer within 1.05 of its target, the product
    within 1.1 of ``lip``: ``main`` raises otherwise) and lie within
    :data:`REALSN_PSNR_TOL_DB` / :data:`REALSN_SSIM_TOL` of the JAX CPU
    evaluation's Set12 means and within :data:`REALSN_DENSE_RTOL` of its
    dense singular values; its sigmas' distance from JAX's (other start
    vectors) and the committed ``.val.json`` values are reported beside.
    Returns the launches (none: cuDNN) for the ``kernels`` line."""
    recs, lanes = {}, {}
    for name in REALSN_EXPORTS:
        rec, launches, seconds = _counted(lambda name=name: check_realsn_export.main(
            [name, "--lip", "0.3", "--out-dir", str(REALSN_BUILD)]))
        jax = load_realsn_export_reference(name)
        committed = json.loads((CHECKPOINT_DIR / f"{name}.val.json").read_text())
        dense = np.asarray(list(rec["dense_valid_svd"].values()))
        target, sigmas = rec["per_layer_target"], np.asarray(rec["per_layer_sigma"])
        recs[name] = {
            "seconds": seconds, "launches": launches, "ok": rec["ok"],
            "max_sigma_over_target": float(sigmas.max() / target),
            "lipschitz_product_bound": rec["lipschitz_product_bound"], "lip": rec["lip"],
            "sigmas_max_rel_vs_jax_cpu": float(np.abs(sigmas / jax["sigmas"] - 1).max()),
            "dense_valid_svd": rec["dense_valid_svd"],
            "dense_max_rel_vs_jax_cpu": float(np.abs(dense / jax["dense"] - 1).max()),
            "val_psnr_db": rec["val_psnr_db"], "val_ssim": rec["val_ssim"],
            "jax_cpu_val_psnr_db": float(jax["val_psnr_per_image"].mean()),
            "jax_cpu_val_ssim": float(jax["val_ssim_per_image"].mean()),
            "committed_val_json": {k: committed[k] for k in ("val_psnr_db", "val_ssim")},
            "psnr_db_vs_committed": rec["val_psnr_db"] - committed["val_psnr_db"],
        }
        lanes[f"check_realsn_export/{name}"] = {"launches": launches}
    emit({"phase": "check_realsn_export", "card": card, "exports": recs})
    for name, r in recs.items():
        require(r["max_sigma_over_target"] <= check_realsn_export.LAYER_SLACK
                and r["lipschitz_product_bound"] <= r["lip"] * check_realsn_export.PRODUCT_SLACK,
                f"check_realsn_export/{name}: {r['max_sigma_over_target']:.4f} x target, product "
                f"{r['lipschitz_product_bound']:.5f}")
        require(abs(r["val_psnr_db"] - r["jax_cpu_val_psnr_db"]) <= REALSN_PSNR_TOL_DB
                and abs(r["val_ssim"] - r["jax_cpu_val_ssim"]) <= REALSN_SSIM_TOL,
                f"check_realsn_export/{name}: Set12 {r['val_psnr_db']:.5f} dB / {r['val_ssim']:.6f}, JAX CPU "
                f"{r['jax_cpu_val_psnr_db']:.5f} / {r['jax_cpu_val_ssim']:.6f}")
        require(r["dense_max_rel_vs_jax_cpu"] <= REALSN_DENSE_RTOL,
                f"check_realsn_export/{name}: dense SVD {r['dense_max_rel_vs_jax_cpu']:.2e} off JAX's")
        require(r["launches"] == {n: 0 for n in KERNELS}, f"check_realsn_export/{name}: {r['launches']}")
    return lanes


def conv_flop_per_step(model, batch: int, hw: int) -> float:
    """Operations of one training step's convolutions: each conv's forward
    product (2 x B x H x W x C_in x C_out x 9), the same again for its weight
    gradient and for its input gradient, except the first conv's, whose input
    needs none."""
    per = [2.0 * batch * hw * hw * c.in_channels * c.out_channels * c.kernel_size[0] * c.kernel_size[1]
           for _, _, c in flax_layers(model) if isinstance(c, torch.nn.Conv2d)]
    return 3 * sum(per) - per[0]


def run_train(card: str) -> dict:
    """RealSN-DnCNN training at full width, parts (a), (b) and (c) of the
    module docstring. Every check raises; returns the three parts' records
    (each with its kernel launches, which must be none)."""
    ref = load_train_reference()
    cfg = TrainConfig(**json.loads((TRAIN_EXP / "config.json").read_text()))
    val_images = [load_gray(p) for p in sorted(VAL_DIR.glob("*.png"))]
    sigma = cfg.noise_level / 255.0
    host = json.loads((CHECKPOINT_DIR / "realsn_dncnn_noise40.val.json").read_text())
    parts = {}

    # (a) Resume the committed JAX training state.
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    ckpt = load_checkpoint(TRAIN_EXP, cfg.as_dict())
    model = DnCNN(cfg.channels, cfg.depth, cfg.features, cfg.use_bn)
    model.load_state_dict(torch_state_dict_from_flax(ckpt["variables"], model))
    model.to("cuda")
    u_state = u_state_from_flax(ckpt["u_state"], "cuda")
    uv = sn_pairs(model, u_state, TRAIN_SN_ITERS)
    sigmas = np.array([float(sigma_uv(layer.weight, *uv[name]).detach())
                       for name, _, layer in flax_layers(model) if isinstance(layer, torch.nn.Conv2d)])
    sigma_rel = float(np.abs(sigmas / ref["sigmas"] - 1).max())
    eff = effective_variables(model, u_state, cfg, n_iters=TRAIN_SN_ITERS)
    psnr_db, ssim_v = evaluate(eff, val_images, sigma)
    parts["resume"] = {
        "seconds": time.perf_counter() - t0, "epoch": ckpt["epoch"], "sigmas": sigmas.tolist(),
        "sigma_max_rel_vs_jax_cpu": sigma_rel, "set12_psnr_db": psnr_db, "set12_ssim": ssim_v,
        "jax_cpu_set12_psnr_db": float(ref["val_psnr"]), "jax_cpu_set12_ssim": float(ref["val_ssim"]),
        "delta_psnr_db_vs_jax_cpu": psnr_db - float(ref["val_psnr"]),
        "delta_ssim_vs_jax_cpu": ssim_v - float(ref["val_ssim"]),
        "training_host_set12_psnr_db": host["val_psnr_db"], "training_host_set12_ssim": host["val_ssim"],
        "launches": {n: k.launches for n, k in KERNELS.items()},
    }
    emit({"phase": "train", "part": "a_resume", "card": card, **parts["resume"]})
    require(sigma_rel <= TRAIN_SIGMA_RTOL, f"train/a: sigmas {sigma_rel:.2e} relative off the JAX CPU's")
    require(abs(psnr_db - float(ref["val_psnr"])) <= TRAIN_PSNR_TOL_DB,
            f"train/a: Set12 PSNR {psnr_db:.4f} dB, JAX CPU {float(ref['val_psnr']):.4f}")
    require(abs(ssim_v - float(ref["val_ssim"])) <= TRAIN_SSIM_TOL,
            f"train/a: Set12 SSIM {ssim_v:.5f}, JAX CPU {float(ref['val_ssim']):.5f}")

    # (b) Steps at full width from the raw state, a fresh Adam at lr 1e-4.
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    patches = build_patch_dataset(TRAIN_DIR, seed=cfg.seed, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(len(patches) == int(ref["n_patches"]) and checksum(patches) == str(ref["patches_sha256"]),
            f"train/b: the data/RGB patch set ({len(patches)} patches) differs from the JAX package's")
    perm = np.random.default_rng(TRAIN_BATCH_SEED).permutation(len(patches))
    gen = batches(patches, cfg.batch_size, sigma, seed=TRAIN_BATCH_SEED)
    opt = new_optimizer(model, TRAIN_STEP_LR)
    losses = []
    for b in range(TRAIN_STEPS):
        noisy, noise = next(gen)
        clean = patches[torch.from_numpy(perm[b * cfg.batch_size:(b + 1) * cfg.batch_size]).cuda()]
        require(checksum(clean) == ref["batch_clean_sha256"][b] and checksum(noise) == ref["batch_noise_sha256"][b],
                f"train/b: batch {b}'s clean patches or noise differ from the JAX package's")
        losses.append(float(train_step(model, opt, u_state, noisy, noise, cfg)))
    loss_rel = float(np.abs(np.array(losses) / ref["losses"] - 1).max())
    step = lambda: train_step(model, opt, u_state, *next(gen), cfg)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        last = step()
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flop = conv_flop_per_step(model, cfg.batch_size, patches.shape[-1])
    prof = phase_profile("train_step", lambda: [step() for _ in range(TRAIN_PROFILE_STEPS)], TRAIN_GROUPS)
    # cuDNN's FFT algorithms launch a varying number of kernels a call, so the
    # power iteration's device time is read from one profiled window of
    # calls, not through device_ms's per-call record count.
    sn_records = device_records(lambda: sn_pairs(model, u_state, cfg.sn_iters), TRAIN_PROFILE_STEPS)
    sn_ms = sum(e.time_range.elapsed_us() for e in sn_records) / TRAIN_PROFILE_STEPS / 1e3
    conv_ms = sum(v for g, v in prof["groups_ms"].items() if g.startswith("conv")) / TRAIN_PROFILE_STEPS
    parts["steps"] = {
        "batch_size": cfg.batch_size, "n_patches": len(patches), "patch_set_gb": patches.numel() * 4 / 1e9,
        "patch_set_build_s": build_s, "losses": losses, "jax_cpu_losses": ref["losses"].tolist(),
        "loss_max_rel_vs_jax_cpu": loss_rel, "batch_checksums_equal": True,
        "timed_steps": TRAIN_TIMED_STEPS, "timed_s": timed_s, "steps_per_s": TRAIN_TIMED_STEPS / timed_s,
        "patches_per_s": TRAIN_TIMED_STEPS * cfg.batch_size / timed_s, "last_loss": float(last),
        "peak_mem_gb": peak_gb, "mem_held_before_steps_gb": held_gb,
        "conv_tflop_per_step": flop / 1e12,
        "device_ms_per_step": prof["device_kernel_ms"] / TRAIN_PROFILE_STEPS,
        "conv_device_ms_per_step": conv_ms, "conv_tflops": flop / conv_ms / 1e9,
        "conv_share_of_f32_peak": flop / conv_ms / 1e-3 / F32_PEAK,
        "sn_power_iteration_device_ms_per_step": sn_ms, "busy_share": prof["device_busy_share"],
        "launches": {n: k.launches for n, k in KERNELS.items()},
    }
    emit({"phase": "train", "part": "b_steps", "card": card, **parts["steps"]})
    require(loss_rel <= TRAIN_LOSS_RTOL, f"train/b: losses {losses} {loss_rel:.2e} relative off the JAX CPU's")
    require(math.isfinite(float(last)), "train/b: non-finite loss in the timed steps")
    del patches, gen, model, opt, eff

    # (c) train() end to end from a fresh init, under build/.
    for k in KERNELS.values():
        k.launches = 0
    shutil.rmtree(TRAIN_BUILD, ignore_errors=True)
    cfg1, cfg2 = (dataclasses.replace(cfg, epochs=e) for e in (1, 2))
    run_kw = {"train_dir": TRAIN_DIR, "val_dir": VAL_DIR, "verbose": False, "device": "cuda"}
    t0 = time.perf_counter()
    _, hist1 = train(cfg1, TRAIN_BUILD / "epochs1", max_steps_per_epoch=TRAIN_E2E_STEPS, **run_kw)
    first_s = time.perf_counter() - t0
    try:
        train(cfg2, TRAIN_BUILD / "epochs1", **run_kw)
        refused = False
    except ConfigMismatch:
        refused = True
    save_checkpoint(TRAIN_BUILD / "epochs2", load_checkpoint(TRAIN_BUILD / "epochs1", cfg1.as_dict()),
                    cfg2.as_dict())
    t0 = time.perf_counter()
    eff2, hist2 = train(cfg2, TRAIN_BUILD / "epochs2", max_steps_per_epoch=TRAIN_RESUME_STEPS, **run_kw)
    resume_s = time.perf_counter() - t0
    export = TRAIN_BUILD / "realsn_dncnn_noise40_smoke.npz"
    save_flax_npz(flax_variables_from_torch(eff2), export)
    reloaded = flax_model(DnCNN(cfg.channels, cfg.depth, cfg.features, cfg.use_bn), load_flax_npz(export), "cuda")
    export_psnr, export_ssim = evaluate(reloaded, val_images, sigma)
    parts["train"] = {
        "steps_epoch0": TRAIN_E2E_STEPS, "history_first_call": hist1, "first_call_s": first_s,
        "guard_refused_epochs2": refused, "history_resumed_call": hist2, "resumed_call_s": resume_s,
        "resumed_at_epoch": hist2[0]["epoch"] if hist2 else None,
        "zero_predictor_loss": TRAIN_ZERO_PRED_LOSS, "export": str(export.relative_to(TRAIN_BUILD.parents[1])),
        "export_set12_psnr_db": export_psnr, "export_set12_ssim": export_ssim,
        "launches": {n: k.launches for n, k in KERNELS.items()},
    }
    emit({"phase": "train", "part": "c_train", "card": card, **parts["train"]})
    require(len(hist1) == 1 and hist1[0]["epoch"] == 0, f"train/c: first call's history {hist1}")
    require(refused, "train/c: the config guard let epochs=2 resume an epochs=1 experiment")
    require(len(hist2) == 1 and hist2[0]["epoch"] == 1, f"train/c: the resumed call's history {hist2}")
    l0, l1 = hist1[0]["train_loss"], hist2[0]["train_loss"]
    require(math.isfinite(l0) and math.isfinite(l1) and l1 < l0,
            f"train/c: mean losses {l0} (epoch 0) then {l1} (its last {TRAIN_RESUME_STEPS} steps) do not fall")
    require(l1 < TRAIN_ZERO_PRED_LOSS, f"train/c: last {TRAIN_RESUME_STEPS} steps' mean loss {l1} is not "
            f"under the zero predictor's {TRAIN_ZERO_PRED_LOSS:.3f}")
    require(abs(export_psnr - hist2[0]["val_psnr"]) <= 1e-6,
            f"train/c: the reloaded export gives {export_psnr} dB, train() {hist2[0]['val_psnr']}")
    for part in parts.values():
        require(part["launches"] == {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": 0},
                f"train: kernel launches {part['launches']}, expected none")
    return parts


def check_match_bounded(lane: dict) -> dict:
    """K1 with row bounds at both shards' spatial shapes of the deblur_bm3d
    lane (256 px, search 8, halo 32): the halo-extended 192 x 256 blocks of
    its first denoise input, shard 0 with bounds (32, 192) and shard 1 with
    (0, 160), held to the plain version slot by slot; time, plain time and
    bound at shard 0's."""
    z, _ = first_denoise_input(lane)
    p = lane["cfg"]["params"]
    mode = match_mode(p, bounded=True)
    halo = BM3DDenoiser(params=p).spatial_halo()
    h, w = z.shape[-2:]
    rows_ = h // PAR_WORLD
    xp = torch.nn.functional.pad(z, (0, 0, halo, halo), mode="reflect")
    ext_h = rows_ + 2 * halo
    offs = search_offsets(p.search, p.search_step)
    rows, cols = _ref_grid(ext_h, 8, 4), _ref_grid(w, 8, 4)
    shards = {}
    for s_ in range(PAR_WORLD):
        ext = xp[:, s_ * rows_:s_ * rows_ + ext_h].contiguous()
        bounds = (halo if s_ == 0 else 0, ext_h - halo if s_ == PAR_WORLD - 1 else ext_h)
        got = bm3d_match(ext, rows, cols, offs, 8, 16, mode, row_valid_bounds=bounds)
        want = bm3d_match_plain(ext, rows, cols, offs, 8, 16, mode, row_valid_bounds=bounds)
        dists = match_distances_plain(ext, rows, cols, offs, 8, mode, row_valid_bounds=bounds)
        gaps = slot_gaps(got, want, dists)
        err = (dists.gather(-1, got.long()) - dists.gather(-1, want.long())).abs()
        err = torch.nan_to_num(err, nan=0.0).max().item()  # inf - inf: both picked invalid fills
        rec = {"shape": [1, ext_h, w], "bounds": list(bounds), "mode": mode,
               "multiset_agreement": multiset_agreement(got, want),
               "equal_share": float((got == want).float().mean()),
               "max_rel_gap": gaps.max().item(), "max_abs_err": err}
        require(rec["multiset_agreement"] >= 0.999, f"bounded K1 multiset agreement {rec}")
        require(rec["max_rel_gap"] <= NEAR_TIE, f"bounded K1 slot gap {rec}")
        require(math.isfinite(err), f"bounded K1 picked an invalid candidate {rec}")
        geom = match_geometry(rows, cols, offs, 8, z.device)
        call = lambda: bm3d_match(ext, rows, cols, offs, 8, 16, mode, geometry=geom,  # noqa: E731
                                  row_valid_bounds=bounds)
        bnd = match_bounds(1, ext_h, w, rows, cols, offs, *bounds)
        rec |= {"ms": device_ms(call), "event_ms": cuda_ms(call),
                "plain_ms": cuda_ms(lambda: bm3d_match_plain(ext, rows, cols, offs, 8, 16, mode,
                                                             row_valid_bounds=bounds), reps=10),
                "bound_ms": min(bnd["bound_direct_ms"], bnd["bound_separable_ms"]),
                "bound_by": bnd["bound_separable_by"], "library_ms": None, **bnd}
        shards[f"shard{s_}"] = rec
    # The unbounded call at the whole image (256 x 256) beside it.
    rows_full = _ref_grid(h, 8, 4)
    geom = match_geometry(rows_full, cols, offs, 8, z.device)
    full_ms = device_ms(lambda: bm3d_match(z, rows_full, cols, offs, 8, 16, mode, geometry=geom))
    return {**shards["shard0"], "shards": shards, "unsharded_256_ms": full_ms}


def meas_split_masks(masks: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) + masks.shape: 0/1 minibatch masks (..., H, W) split into the
    meas shards' blocks of rows (each shard's the mask and its rows)."""
    h = masks.shape[-2]
    owner = torch.arange(h, device=masks.device) // (h // n)
    return torch.stack([masks * (owner == s_).to(masks.dtype)[:, None] for s_ in range(n)])


def pr_stratified_indices(m: int, n: int, lead: tuple, k: int, seed: int = 0) -> tuple:
    """Row indices for a meas-split PR run: per step, ``k / n`` of each
    shard's ``m / n`` rows (numpy ``RandomState(seed)``), local to the shard,
    (n,) + lead + (1, k / n); and their union in global rows, lead + (1, k)."""
    rs = np.random.RandomState(seed)
    steps, rows = int(np.prod(lead)), m // n
    local = np.stack([[rs.choice(rows, k // n, replace=False) for _ in range(steps)]
                      for _ in range(n)]).reshape((n,) + lead + (1, k // n))
    union = np.concatenate([local[s_] + s_ * rows for s_ in range(n)], axis=-1)
    dev = torch.device("cuda")
    return torch.as_tensor(local, device=dev), torch.as_tensor(union, device=dev)


def saga_injection(nlm_masks: torch.Tensor, n: int) -> dict:
    """SAGA's injected minibatches for the meas-split csmri_nlm problem: the
    JAX lane's masks of the first outer round as the steps, the next
    round's first as ``mb0``, split into the shards' rows, and the slots."""
    slots = np.random.RandomState(0).randint(0, PAR_SAGA_HIST, PAR_SAGA_ITERS)
    return {"masks": meas_split_masks(nlm_masks[0, :PAR_SAGA_ITERS], n),
            "mb0": meas_split_masks(nlm_masks[1, 0], n),
            "slots": torch.as_tensor(slots, device="cuda")}


def _counts() -> dict:
    return {n: k.launches for n, k in KERNELS.items()}


# K1's, K2's and K3's launches by kernel over the whole run (TALLY), and the
# share of them made where the span, packed and cluster kernels may run
# (ALLOWED: the kernel rows and the csmri_nlm_skimage lane); no other
# launch may go to one of those three.
TALLY, ALLOWED = collections.Counter(), collections.Counter()
REDESIGNED_OFF_LANES = (K1_KERNELS[3], K2_KERNELS[1], K3_KERNELS[1], K3_KERNELS[2])


def _fold_tally() -> None:
    """Add K1's, K2's and K3's launches by kernel to :data:`TALLY` and set
    them to 0."""
    TALLY.update(bm3d_match.by_kernel)
    TALLY.update(bm3d_aggregate.by_kernel)
    TALLY.update(nlm_denoise.by_kernel)
    bm3d_match.by_kernel = dict.fromkeys(K1_KERNELS, 0)
    bm3d_aggregate.by_kernel = dict.fromkeys(K2_KERNELS, 0)
    nlm_denoise.by_kernel = dict.fromkeys(K3_KERNELS, 0)


def allowed(run):
    """``run()``, its K1, K2 and K3 launches counted in :data:`ALLOWED`."""
    _fold_tally()
    before = TALLY.copy()
    out = run()
    _fold_tally()
    ALLOWED.update(TALLY - before)
    return out


def kernel_launches() -> dict:
    """K2's and K3's launches by kernel since the counts were set to 0."""
    return {"bm3d_aggregate": dict(bm3d_aggregate.by_kernel), "nlm": dict(nlm_denoise.by_kernel)}


def check_k2_k3_kernels(label: str, kernels: dict, launches: dict) -> None:
    """Every K2 launch of a lane's timed run went to bm3d_aggregate_kernel,
    every K3 launch to the lane's kernel (:data:`LANE_K3_KERNEL`)."""
    want = {"bm3d_aggregate": dict.fromkeys(K2_KERNELS, 0) | {K2_KERNELS[0]: launches["bm3d_aggregate"]},
            "nlm": dict.fromkeys(K3_KERNELS, 0) | {LANE_K3_KERNEL.get(label, K3_KERNELS[0]): launches["nlm"]}}
    require(kernels == want, f"{label}: K2 and K3 launches by kernel {kernels}, expected {want}")


def _zero_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    _fold_tally()
    torch.cuda.synchronize()


def _counted(run) -> tuple:
    """(output, launches, seconds) of one ``run()``, counts set to 0 just before."""
    _zero_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, _counts(), time.perf_counter() - t0


def _parallel_rank(rank: int, pr_inputs: dict) -> dict:
    """Every two-rank part of the parallel phase on one rank; both ranks on
    card 0. Returns numpy and numbers only."""
    torch.cuda.set_device(0)
    mesh = make_mesh((1, PAR_WORLD))
    meas = mesh.axis(MEAS_AXIS)
    out = {}
    # (b) the headline batch, meas-split over the two ranks
    prob, lanes = load_headline_problems("cuda")
    eta, den = csmri_lane("headline", lanes)
    masks = meas_split_masks(load_headline_masks("cuda"), PAR_WORLD)
    run = lambda: run_batch("svrg", prob, den, mesh=mesh, masks=masks, eta=eta,  # noqa: E731
                            n_outer=N_OUTER, t2=T2, mini_batch_size=MINI_BATCH)
    run()  # warm-up
    torch.cuda.synchronize()
    meas.reset()
    o, launches, wall = _counted(run)
    b = {"trace": o["psnr_per_iter"].cpu().numpy(), "z": o["z"].cpu().numpy(), "wall_s": wall, "launches": launches,
         "calls": dict(meas.calls), "host_s": dict(meas.host_s)}
    meas.reset()
    if rank == 0:
        b["profile"] = profile_run("parallel_b_meas_rank0", run, PAR_GROUPS, host_ops=False)
    else:
        run()
        torch.cuda.synchronize()
    b["profiled_calls"], b["profiled_host_s"] = dict(meas.calls), dict(meas.host_s)
    out["b"] = b
    del prob, masks, o
    # (c) phase retrieval: A's rows split, half a rank
    lane = bench_lane("pr_bm3d")
    cfg = lane["cfg"]
    mine = shard_pr_problem(lane["prob"], mesh)
    mine2 = [stack_problems([mine[0]] * 2)]  # two lanes on the same half of A, held once
    m_total = lane["prob"].m
    del lane["prob"]
    gc.collect()
    torch.cuda.empty_cache()
    z = torch.as_tensor(pr_inputs["z"], device="cuda")
    z2 = torch.as_tensor(pr_inputs["z2"], device="cuda")
    c = {"a_gb_on_rank": sum(p.a.numel() for p in mine) * 4 / 1e9,
         "grad": pr_grad_full_sharded(mine, z, mesh).cpu().numpy()}
    zs, psnr = sharded_pnp_step(mesh, lane["den"], cfg["eta"])(mine2, z2)
    c["step_psnr"], c["step_z"] = psnr.cpu().numpy(), zs.cpu().numpy()
    idx = torch.as_tensor(pr_inputs["idx"], device="cuda")
    o = run_local(pnp_svrg, mine, meas, LocalAxis(BATCH_AXIS, 1), lane["den"], 0, 2.0 * m_total,
                  dict(masks=idx, eta=lane["eta"], n_outer=PAR_PR_ROUNDS, t2=cfg["t2"],
                       mini_batch_size=cfg["mini_batch_size"], lr_decay=cfg["lr_decay"]))
    c["trace"] = o["psnr_per_iter"].cpu().numpy()[:, 0]
    out["c"] = c
    del mine, mine2, lane
    gc.collect()
    torch.cuda.empty_cache()
    # (d) SAGA's table over the two ranks
    nprob, nden, neta, ncfg = nlm_lane()
    nmasks = load_nlm_masks("cuda")
    inj = saga_injection(nmasks, PAR_WORLD)
    d = {}
    for shards_ in (PAR_WORLD, 1):
        o, launches, _ = _counted(lambda: run_batch(
            "saga", nprob, nden, mesh=mesh, eta=neta, n_iters=PAR_SAGA_ITERS,
            mini_batch_size=MINI_BATCH, hist_size=PAR_SAGA_HIST,
            table_axis=MEAS_AXIS if shards_ > 1 else None, table_shards=shards_, **inj))
        d[f"table_shards_{shards_}"] = {"z": o["z"].cpu().numpy(), "launches": launches}
    out["d"] = d
    # (e) row-sharded denoising over a (1, 2) (batch, spatial) mesh
    smesh = make_spatial_mesh((1, PAR_WORLD))
    spatial = smesh.axis("spatial")
    o, launches, wall = _counted(lambda: run_batch(
        "svrg", nprob, nden, mesh=smesh, image_shards=PAR_WORLD, masks=nmasks[None], eta=neta,
        lr_decay=ncfg["lr_decay"], n_outer=N_OUTER, t2=T2, mini_batch_size=MINI_BATCH))
    e = {"nlm": {"trace": o["psnr_per_iter"].cpu().numpy()[:, 0], "launches": launches,
                 "wall_s": wall, "all_gather_calls": spatial.calls["all_gather"]}}
    dl = bench_lane("deblur_bm3d")
    dcfg = dl["cfg"]
    spatial.reset()
    o, launches, wall = _counted(lambda: run_batch(
        "svrg", dl["prob"], dl["den"], mesh=smesh, image_shards=PAR_WORLD, masks=dl["ref_mb"][None],
        eta=dl["eta"], lr_decay=dcfg["lr_decay"], n_outer=dcfg["n_outer"], t2=dcfg["t2"],
        mini_batch_size=dcfg["mini_batch_size"]))
    e["bm3d"] = {"final_psnr": float(o["final_psnr"][0]), "launches": launches, "wall_s": wall,
                 "all_gather_calls": spatial.calls["all_gather"]}
    zd, sig = first_denoise_input(dl)
    nlm_sp = nlm_denoise_spatial(zd[0], sig[0], sig[0], smesh)
    bm_sp = bm3d_denoise_spatial(zd[0], sig[0], smesh, params=dcfg["params"])
    e["denoise_256"] = {
        "nlm_max_abs_diff": (nlm_sp - nlm_denoise(zd[0], sig[0], sig[0])).abs().max().item(),
        "bm3d_max_abs_diff": (bm_sp - bm3d_denoise(zd[0], sig[0], dcfg["params"])).abs().max().item(),
    }
    out["e"] = e
    # (g) the scaling driver, at widths 1 and 2 (ranks on the one card)
    out["g"] = scaling.run(rank, scaling._parser().parse_args(PAR_SCALING_ARGV + ["--devices", "1", "2"]))
    # (h) the dry run
    out["h"] = dryrun_multichip(PAR_WORLD)
    return out


def _max_db(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _spread(traces) -> float:
    """The largest difference between any two of the runs' traces."""
    return max(_max_db(a, b) for a, b in itertools.combinations(traces, 2))


def run_parallel(card: str, prob, lanes, ref_masks, bench: dict) -> dict:
    """The ``parallel`` phase: (a) the headline meas-split in this process
    (emulated) against the unsharded run on the same JAX masks; references
    for the two-rank parts; then one spawn of two ranks on the card for
    (b)-(e), (g) and (h), each held to its reference. Returns the parts'
    launches for the ``kernels`` line."""
    clock = [time.perf_counter()]
    seconds = {}

    def lap(part):
        seconds[part] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()

    eta, den = csmri_lane("headline", lanes)
    split = meas_split_masks(ref_masks, PAR_WORLD)
    unsharded = lambda: pnp_svrg(prob, den, eta, N_OUTER, T2, MINI_BATCH, masks=ref_masks)  # noqa: E731
    emulated = lambda: run_batch_meas_emulated(  # noqa: E731
        pnp_svrg, prob, den, PAR_WORLD, masks=split, eta=eta, n_outer=N_OUTER, t2=T2,
        mini_batch_size=MINI_BATCH)
    early = 1 + PAR_EARLY_ROUNDS * (T2 + 1)
    us_out = [unsharded() for _ in range(PAR_REPEATS)]
    us = [u["psnr_per_iter"].cpu().numpy() for u in us_out]
    us_bitwise = bitwise_repeats(us_out)
    del us_out
    u1 = us[0]
    us_ulp = [u1] + [pnp_svrg(ulp_shifted(prob, shift), den, eta, N_OUTER, T2, MINI_BATCH, masks=ref_masks)
                     ["psnr_per_iter"].cpu().numpy() for shift in ULP_SHIFTS]
    o, launches_a, wall_a = _counted(emulated)
    trace_a = o["psnr_per_iter"].cpu().numpy()
    tol_ab = PAR_IDENTITY_DB + 2 * _spread([u[:early] for u in us_ulp])
    q_a = quality(prob, o, lanes, REF_DB["headline"])
    prof_u = profile_run("headline_unsharded_ref_masks", unsharded, host_ops=False)
    prof_a = profile_run("parallel_a_meas_emulated", emulated, host_ops=False)
    a = {"early_trace_max_abs_db_vs_unsharded": _max_db(trace_a[:early], u1[:early]),
         "unsharded_repeats": PAR_REPEATS, "repeat_bitwise": us_bitwise,
         "early_unsharded_repeat_max_abs_db": _spread([u[:early] for u in us]),
         "early_ulp_spread_db": _spread([u[:early] for u in us_ulp]),
         "trace_max_abs_db_vs_unsharded": _max_db(trace_a, u1),
         "unsharded_repeat_max_abs_db": _spread(us), "ulp_spread_db": _spread(us_ulp),
         "early_entries": early, "tolerance_db": tol_ab,
         "tolerance_rule": "1e-3 dB + 2 x the early spread of the runs from x_init as built, one ulp down, up",
         "atomic_k2": ATOMIC_K2_SPREADS["a"],
         "set12_vd_mean_psnr_db": q_a["set12_vd_mean_psnr_db"],
         "flagship_psnr_db": q_a["flagship_psnr_db"], "launches": launches_a, "wall_s": wall_a,
         "device_ms": prof_a["device_kernel_ms"], "unsharded_device_ms": prof_u["device_kernel_ms"],
         "groups_ms": prof_a["groups_ms"], "unsharded_groups_ms": prof_u["groups_ms"],
         "busy_share": prof_a["device_busy_share"], "unsharded_busy_share": prof_u["device_busy_share"]}
    lap("a")
    # References of the two-rank parts, in this process.
    pr = bench["pr_bm3d"]
    full, pcfg = pr["prob"], pr["cfg"]
    z = full.x_init.reshape(1, -1)
    z2 = torch.cat([z, 0.5 * z + 0.25])
    one = make_mesh((1, 1), emulate=True)
    step_z, step_psnr = sharded_pnp_step(one, pr["den"], pcfg["eta"])(
        shard_pr_problem(stack_problems([full] * 2), one), z2)
    idx_local, idx_union = pr_stratified_indices(full.m, PAR_WORLD, (PAR_PR_ROUNDS, pcfg["t2"]),
                                                 pcfg["mini_batch_size"])
    pr_run = lambda problem: pnp_svrg(problem, pr["den"], pr["eta"], PAR_PR_ROUNDS, pcfg["t2"],  # noqa: E731
                                      pcfg["mini_batch_size"], masks=idx_union, lr_decay=pcfg["lr_decay"])
    pr_outs = [pr_run(full) for _ in range(PAR_REPEATS)]
    pr_traces = [o_["psnr_per_iter"].cpu().numpy()[:, 0] for o_ in pr_outs]
    pr_bitwise = bitwise_repeats(pr_outs)
    del pr_outs
    pr_trace = pr_traces[0]
    pr_ulp = [pr_trace] + [pr_run(ulp_shifted(full, shift))["psnr_per_iter"].cpu().numpy()[:, 0]
                           for shift in ULP_SHIFTS]
    tol_c = PAR_PR_TOL_DB + 2 * _spread(pr_ulp)
    pr_grad = full.grad_full(z).cpu().numpy()
    gc.collect()
    torch.cuda.empty_cache()
    lap("c_references")
    nprob, nden, neta, ncfg = nlm_lane()
    nmasks = load_nlm_masks("cuda")
    inj = saga_injection(nmasks, PAR_WORLD)
    saga_emu = {}
    for shards_ in (PAR_WORLD, 1):
        o, launches, _ = _counted(lambda: run_batch_meas_emulated(
            pnp_saga, nprob, nden, PAR_WORLD, eta=neta,
            n_iters=PAR_SAGA_ITERS, mini_batch_size=MINI_BATCH, hist_size=PAR_SAGA_HIST,
            table_axis=MEAS_AXIS if shards_ > 1 else None, table_shards=shards_, **inj))
        saga_emu[shards_] = (o["z"].cpu().numpy(), launches)
    nlm_ref = pnp_svrg(nprob, nden, neta, N_OUTER, T2, MINI_BATCH, masks=nmasks,
                       lr_decay=ncfg["lr_decay"])["psnr_per_iter"].cpu().numpy()[:, 0]
    dl = bench["deblur_bm3d"]
    dcfg = dl["cfg"]
    deblur_ref = float(pnp_svrg(dl["prob"], dl["den"], dl["eta"], dcfg["n_outer"], dcfg["t2"],
                                dcfg["mini_batch_size"], masks=dl["ref_mb"],
                                lr_decay=dcfg["lr_decay"])["final_psnr"][0])
    lap("d_e_references")
    scaling_1 = scaling.run(0, scaling._parser().parse_args(PAR_SCALING_ARGV + ["--devices", "1"]))
    lap("g_world_1")
    # The two ranks.
    ranks = spawn(_parallel_rank, PAR_WORLD, "gloo",
                  ({"z": z.cpu().numpy(), "z2": z2.cpu().numpy(), "idx": idx_local.cpu().numpy()},),
                  PAR_TIMEOUT_S)
    lap("two_ranks")
    r0 = ranks[0]
    b = {k: v for k, v in r0["b"].items() if k not in ("trace", "z", "profile")}
    b |= {"early_trace_max_abs_db_vs_emulated": max(_max_db(r["b"]["trace"][:early], trace_a[:early])
                                                     for r in ranks),
          "trace_max_abs_db_vs_emulated": max(_max_db(r["b"]["trace"], trace_a) for r in ranks),
          "trace_max_abs_db_vs_unsharded": max(_max_db(r["b"]["trace"], u1) for r in ranks),
          "set12_vd_mean_psnr_db": float(r0["b"]["trace"][-1, :len(lanes) - 1].mean()),
          "ranks_equal": all(np.array_equal(ranks[0]["b"][k], ranks[1]["b"][k]) for k in ("trace", "z")),
          "broadcast_calls": [r["b"]["calls"]["broadcast"] for r in ranks],
          "launches_rank1": ranks[1]["b"]["launches"],
          "device_ms": r0["b"]["profile"]["device_kernel_ms"],
          "busy_share": r0["b"]["profile"]["device_busy_share"],
          "groups_ms": r0["b"]["profile"]["groups_ms"], "wall_ms_profiled": r0["b"]["profile"]["wall_ms"]}
    c = {"a_gb_on_rank": r0["c"]["a_gb_on_rank"],
         "grad_max_rel_err": max(float(np.abs(r["c"]["grad"] - pr_grad).max() / np.abs(pr_grad).max())
                                 for r in ranks),
         "step_psnr_db": [float(v) for v in r0["c"]["step_psnr"]],
         "step_unsharded_psnr_db": [float(v) for v in step_psnr.cpu().numpy()],
         "step_max_abs_db": max(_max_db(r["c"]["step_psnr"], step_psnr.cpu().numpy()) for r in ranks),
         "run_rounds": PAR_PR_ROUNDS, "run_tolerance_db": tol_c,
         "run_tolerance_rule": "1e-3 dB + 2 x the spread of the runs from x_init as built, one ulp down, up",
         "run_unsharded_repeats": PAR_REPEATS, "run_repeat_bitwise": pr_bitwise,
         "run_unsharded_repeat_max_abs_db": _spread(pr_traces), "run_ulp_spread_db": _spread(pr_ulp),
         "atomic_k2": ATOMIC_K2_SPREADS["c"],
         "run_trace_max_abs_db": max(_max_db(r["c"]["trace"], pr_trace) for r in ranks),
         "run_trace_abs_db_by_entry": np.abs(r0["c"]["trace"] - pr_trace).tolist(),
         "run_repeat_abs_db_by_entry": np.abs(pr_traces[1] - pr_trace).tolist(),
         "run_unsharded_trace_db": pr_trace.tolist(),
         "run_final_psnr_db": float(r0["c"]["trace"][-1]), "run_unsharded_final_psnr_db": float(pr_trace[-1])}
    d = {"emulated_bitwise": bool(np.array_equal(saga_emu[PAR_WORLD][0], saga_emu[1][0])),
         "ranks_bitwise": all(np.array_equal(r["d"][f"table_shards_{PAR_WORLD}"]["z"],
                                             r["d"]["table_shards_1"]["z"]) for r in ranks),
         "ranks_equal_emulated": all(np.array_equal(r["d"][f"table_shards_{PAR_WORLD}"]["z"],
                                                    saga_emu[PAR_WORLD][0]) for r in ranks),
         "ranks_max_abs_vs_emulated": max(float(np.abs(r["d"][f"table_shards_{PAR_WORLD}"]["z"]
                                                      - saga_emu[PAR_WORLD][0]).max()) for r in ranks),
         "launches_emulated": saga_emu[PAR_WORLD][1],
         "launches_rank0": r0["d"][f"table_shards_{PAR_WORLD}"]["launches"]}
    e = {"nlm_trace_max_abs_db": max(_max_db(r["e"]["nlm"]["trace"], nlm_ref) for r in ranks),
         "nlm_launches_rank0": r0["e"]["nlm"]["launches"], "nlm_wall_s": r0["e"]["nlm"]["wall_s"],
         "nlm_all_gather_calls": r0["e"]["nlm"]["all_gather_calls"],
         "bm3d_final_psnr_db": [r["e"]["bm3d"]["final_psnr"] for r in ranks],
         "bm3d_unsharded_final_psnr_db": deblur_ref,
         "bm3d_launches_rank0": r0["e"]["bm3d"]["launches"], "bm3d_wall_s": r0["e"]["bm3d"]["wall_s"],
         "bm3d_all_gather_calls": r0["e"]["bm3d"]["all_gather_calls"],
         "denoise_256": [r["e"]["denoise_256"] for r in ranks]}
    rec = {"phase": "parallel", "card": card, "world": PAR_WORLD, "backend": "gloo",
           "seconds": seconds, "a_meas_emulated": a, "b_meas_two_ranks": b, "c_pr_two_ranks": c,
           "d_saga_table": d, "e_spatial_two_ranks": e,
           "g_scaling": {"world_1": scaling_1, "two_ranks_one_card": r0["g"],
                         "label": "two ranks on one card: no scaling claim"},
           "h_dryrun_multichip_2": r0["h"]}
    emit(rec)
    require(us_bitwise and pr_bitwise, f"parallel: {PAR_REPEATS} unsharded runs on the same minibatches "
                                       f"differ (headline {us_bitwise}, PR {pr_bitwise})")
    require(a["early_trace_max_abs_db_vs_unsharded"] <= tol_ab, f"parallel/a: trace {a} off the unsharded run")
    require(a["set12_vd_mean_psnr_db"] >= HEADLINE_FLOOR_DB, f"parallel/a: Set12-VD mean {a}")
    require(b["ranks_equal"], "parallel/b: the two ranks' traces or iterates differ")
    require(b["broadcast_calls"] == [0, 0], f"parallel/b: broadcasts {b['broadcast_calls']}: each rank denoises")
    require(b["early_trace_max_abs_db_vs_emulated"] <= tol_ab, f"parallel/b: trace {b} off (a)")
    require(c["grad_max_rel_err"] <= PAR_PR_GRAD_RTOL, f"parallel/c: gradient {c}")
    require(c["step_max_abs_db"] <= PAR_PR_TOL_DB, f"parallel/c: step {c}")
    require(c["run_trace_max_abs_db"] <= tol_c, f"parallel/c: run {c}")
    require(d["emulated_bitwise"] and d["ranks_bitwise"], f"parallel/d: SAGA table {d}")
    require(e["nlm_trace_max_abs_db"] <= PAR_NLM_TOL_DB, f"parallel/e: NLM {e}")
    require(all(abs(v - deblur_ref) <= PAR_BM3D_TOL_DB and v >= BENCH_FLOOR_DB["deblur_bm3d"]
                for v in e["bm3d_final_psnr_db"]), f"parallel/e: BM3D {e}")
    require(len(r0["g"]) == 2 and len(scaling_1) == 1, f"parallel/g: scaling rows {r0['g']}, {scaling_1}")
    denoises, bm3d_denoises = N_OUTER * T2, dcfg["n_outer"] * dcfg["t2"]
    expect = {
        "a_meas_emulated": (launches_a, 2 * denoises, 2 * denoises, 0),
        "b_meas_rank0": (r0["b"]["launches"], 2 * denoises, 2 * denoises, 0),
        "b_meas_rank1": (ranks[1]["b"]["launches"], 2 * denoises, 2 * denoises, 0),
        "d_saga_rank0": (d["launches_rank0"], 0, 0, PAR_SAGA_ITERS),
        "e_nlm_rank0": (r0["e"]["nlm"]["launches"], 0, 0, denoises),
        "e_bm3d_rank0": (r0["e"]["bm3d"]["launches"], 2 * bm3d_denoises, 2 * bm3d_denoises, 0),
    }
    for part, (got, k1_, k2_, k3_) in expect.items():
        want = {"bm3d_match": k1_, "bm3d_aggregate": k2_, "nlm": k3_}
        require(got == want, f"parallel/{part}: launches {got}, expected {want}")
    return {f"parallel/{part}": {"launches": got} for part, (got, *_rest) in expect.items()}


def _denoises(out) -> int:
    """Denoise calls of one loop run: one a logged step, plus SARAH's
    step-1 point a round."""
    sig = out["sigma_est"]
    steps = sig.numel() // sig.shape[-1]
    return steps + (sig.shape[0] if out["algo_name"] == "PnP SARAH" else 0)


@contextlib.contextmanager
def _counted_rows(mod):
    """Within the block, every row of the driver ``mod``'s table (the
    callables of ``make_runs``; rgb_csmri's ``run``) runs under
    :func:`_counted`. Yields the dict row -> (output, launches, seconds),
    which also gets the rows' problem under ``"_problem"``."""
    got = {}
    entry = "make_runs" if hasattr(mod, "make_runs") else "run"
    real = getattr(mod, entry)

    def keep(name, fn):
        got[name] = _counted(fn)
        return got[name][0]

    def make_runs(prob, args, device):
        got["_problem"] = prob
        return {name: (lambda name=name, fn=fn: keep(name, fn)) for name, fn in real(prob, args, device).items()}

    def run(args, device=None):
        return keep(args.algo, lambda: real(args, device))

    setattr(mod, entry, make_runs if entry == "make_runs" else run)
    try:
        yield got
    finally:
        setattr(mod, entry, real)


def _driver_table(driver: str, mod, table: str, flags: list, dev, figures: bool) -> dict:
    """One table of a driver on the card through its ``main`` (the demo's
    and rgb_csmri's compute parts without matplotlib); its rows' records."""
    figure = driver in ("pnp_csmri_demo", "rgb_csmri")
    with _counted_rows(mod) as got:
        if figure and not figures:
            args = mod.parse_args(flags)
            if driver == "rgb_csmri":
                mod.run(args, dev)
            else:
                prob = mod.make_problem(args, dev)
                for fn in mod.make_runs(prob, args, dev).values():
                    fn()
        else:
            out = DRIVERS_BUILD / f"{driver}_{table}.{'png' if figure else 'csv'}"
            mod.main(flags + ["--out" if figure else "--save", str(out)])
    return got


def _driver_rows(driver: str, table: str, got: dict, ref: dict) -> dict:
    """The records of one table's rows, each held to its checks."""
    records = {}
    if driver == "rgb_csmri":
        jax = ref["rgb_csmri"]["default"]
        for name, (res, launches, sec) in got.items():
            label = f"{driver}/{table}/{name}"
            rec = {"psnr_init_db": res["psnr_init"], "psnr_recon_db": res["psnr_recon"],
                   "channels_init_db": res["channels_init"], "channels_recon_db": res["channels_recon"],
                   "seconds": sec, "launches": launches,
                   "jax_cpu": {"channels_init_db": jax["channels_init"].tolist(),
                               "channels_recon_db": jax["channels_recon"].tolist()},
                   "gap_db_vs_jax_cpu": (np.asarray(res["channels_recon"]) - jax["channels_recon"]).tolist()}
            require(np.isfinite(res["channels_recon"] + res["channels_init"] + [sec]).all(),
                    f"drivers/{label}: non-finite")
            require(all(r > i for r, i, jr, ji in zip(res["channels_recon"], res["channels_init"],
                                                      jax["channels_recon"], jax["channels_init"]) if jr > ji),
                    f"drivers/{label}: a channel not above its zero-filled PSNR")
            require(launches == {n: 0 for n in KERNELS}, f"drivers/{label}: launches {launches}, expected none")
            records[name] = rec
        return records
    prob = got.pop("_problem")
    init = float(prob.psnr(prob.x_init)[0])
    jref = ref[driver][table]
    # A CSMRI row's gap to JAX's is compared only where both problems' masks
    # hold the zero frequency (a uniform mask misses it by coin flip, which
    # costs about 4 dB, bench.py:439-455).
    dc = {}
    if hasattr(prob, "mask"):
        dc = {"dc_sampled": bool(prob.mask[0, 0, 0]),
              "jax_dc_sampled": bool(load_paper_csmri_problem(driver, "cpu").mask[0, 0, 0])}
    comparable = all(dc.values())
    for name, (out, launches, sec) in got.items():
        label = f"{driver}/{table}/{name}"
        final = float(out["final_psnr"][0])
        ssim_v = float(ssim(prob.x, out["image"])[0])
        jax = jref["rows"][name]
        bm3d = DRIVER_BM3D.get(driver, name.endswith("+bm3d"))
        k12 = 2 * _denoises(out) if bm3d else 0
        want = {"bm3d_match": k12, "bm3d_aggregate": k12, "nlm": 0}
        records[name] = {
            "algo_name": out["algo_name"], "final_psnr_db": final, "final_ssim": ssim_v, "init_psnr_db": init,
            "iters": out["psnr_per_iter"].shape[0] - 1, "denoises": _denoises(out), "seconds": sec,
            "launches": launches,
            "jax_cpu": {"final_psnr_db": jax["final_psnr"], "final_ssim": jax["final_ssim"],
                        "init_psnr_db": jref["init_psnr"]}, **dc}
        if comparable:
            records[name]["gap_db_vs_jax_cpu"] = final - jax["final_psnr"]
        else:
            records[name]["gap_not_compared"] = "a mask misses the zero frequency"
        require(all(math.isfinite(v) for v in (final, ssim_v, init, sec)), f"drivers/{label}: non-finite")
        if jax["final_psnr"] > jref["init_psnr"]:
            require(final > init, f"drivers/{label}: {final:.4f} dB, not above its init {init:.4f} "
                                  f"(the JAX CPU row is)")
        require(launches == want, f"drivers/{label}: launches {launches}, expected {want}")
    return records


def _driver_anchors(ref: dict, dev) -> dict:
    """(b): each deterministic anchor row :data:`DRIVER_REPEATS` times on the
    JAX driver's own problem through the port driver's table, against the
    JAX CPU trace."""
    anchors = {}
    for (driver, table), row in PAPER_ANCHORS.items():
        mod = importlib.import_module(f"pnp_svrg_tpu_torch.examples.{driver}")
        args = mod.parse_args(PAPER_TABLES[driver][table])
        prob = (load_paper_deblur_problem(dev) if driver == "paper_deblur"
                else load_paper_csmri_problem(driver, dev))
        want = ref[driver][table]["rows"][row]["psnr_per_iter"]
        outs, launches, seconds = [], [], []
        for _ in range(DRIVER_REPEATS):
            out, counts, sec = _counted(mod.make_runs(prob, args, dev)[row])
            outs.append(out)
            launches.append(counts)
            seconds.append(sec)
        traces = [out["psnr_per_iter"][:, 0].cpu().numpy() for out in outs]
        repeat_bitwise = bitwise_repeats(outs)
        del outs
        ulp = [traces[0]] + [mod.make_runs(ulp_shifted(prob, shift), args, dev)[row]()["psnr_per_iter"][:, 0]
                             .cpu().numpy() for shift in ULP_SHIFTS]
        label = f"{driver}/{table}/{row}"
        require(len(traces[0]) == len(want), f"drivers/{label}: {len(traces[0])} entries, JAX {len(want)}")
        spread = _spread(ulp)
        widened = PAR_IDENTITY_DB + 2 * spread > DRIVER_ANCHOR_TOL_DB
        tol = PAR_IDENTITY_DB + 2 * spread if widened else DRIVER_ANCHOR_TOL_DB
        off = [_max_db(t, want) for t in traces]
        anchors[label] = {
            "entries": len(want), "max_abs_db_vs_jax_cpu": off, "repeat_bitwise": repeat_bitwise,
            "repeat_spread_db": _spread(traces), "ulp_spread_db": spread, "tolerance_db": tol,
            "rule": "1e-3 dB + 2 x the spread of the runs from x_init as built, one ulp down, up"
                    if widened else "0.05 dB",
            "ulp_final_psnr_db": [float(t[-1]) for t in ulp],
            "atomic_k2": ATOMIC_K2_SPREADS["anchors"].get(label),
            "final_psnr_db": [float(t[-1]) for t in traces], "jax_cpu_final_psnr_db": float(want[-1]),
            "seconds": seconds, "launches": launches[0]}
        require(repeat_bitwise, f"drivers/{label}: {DRIVER_REPEATS} runs differ (trace or iterate)")
        require(max(off) <= tol, f"drivers/{label}: trace {max(off):.4f} dB off the JAX CPU trace "
                                 f"(tolerance {tol:.4f}, spread {spread:.4f})")
        require(all(c == launches[0] for c in launches), f"drivers/{label}: launches {launches}")
    return anchors


def _driver_utilities(dev) -> dict:
    """(c): ``PhaseTimers`` in both fence modes, ``trace`` + ``annotate`` and
    ``scalar_fence`` around 128 px BM3D denoises on the card."""
    x = load_paper_csmri_problem("paper_csmri", dev).x_init
    sigma = estimate_sigma(x)
    params = BM3DParams(search=8)
    fn = lambda: bm3d_denoise_batch(x, sigma, params)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    rec = {}
    for mode in ("scalar", "block"):
        # The profiler has returned no device record at all for one call on
        # the card's machine (see device_ms): such a window is measured again
        # with fresh timers, so the total and the device time stay one call's.
        for window in range(1, PROFILE_WINDOWS + 1):
            timers = PhaseTimers(fence_mode=mode)
            box = []

            def timed():
                with timers.phase("bm3d", fence=lambda: box[-1]):
                    box.append(fn())
                box.append(torch.cuda.current_stream().query())

            records = device_records(timed, 1)  # that call's device records
            if records:
                break
        call_ms = sum(e.time_range.elapsed_us() for e in records) / 1e3
        with timers.phase("bm3d_unfenced"):  # for contrast: the host's enqueue only
            fn()
        torch.cuda.synchronize()
        total_ms = timers.totals()["bm3d"] * 1e3
        rec[f"phase_timers_{mode}"] = {"total_ms": total_ms, "call_device_ms": call_ms,
                                       "device_records": len(records), "profile_windows": window,
                                       "stream_idle_after": box[-1],
                                       "unfenced_total_ms": timers.totals()["bm3d_unfenced"] * 1e3,
                                       "summary": timers.summary()}
        require(len(records) > 0 and total_ms >= call_ms and box[-1],
                f"drivers/utilities: PhaseTimers({mode!r}) {total_ms:.4f} ms against the call's device "
                f"{call_ms:.4f} ms ({len(records)} device records, {window} windows), "
                f"stream idle after: {box[-1]}")
    logdir = DRIVERS_BUILD.parent / "drivers_trace"
    for window in range(1, PROFILE_WINDOWS + 1):  # a trace without device events is taken again
        shutil.rmtree(logdir, ignore_errors=True)
        with trace(logdir):
            with annotate("bm3d"):
                fn()
        files = sorted(logdir.glob("*.pt.trace.json"))
        require(len(files) == 1, f"drivers/utilities: trace files {files}")
        events = json.loads(files[0].read_text())["traceEvents"]
        kernels = {k: sum(k in e.get("name", "") for e in events if e.get("cat") == "kernel")
                   for k in ("bm3d_match_kernel", "bm3d_aggregate_kernel")}
        if all(kernels.values()):
            break
    names = {e.get("name", "") for e in events}
    rec["trace"] = {"file": str(files[0].relative_to(DRIVERS_BUILD.parents[1])), "bytes": files[0].stat().st_size,
                    "kernel_events": kernels, "region": "bm3d" in names, "profile_windows": window}
    require("bm3d" in names and all(kernels.values()), f"drivers/utilities: trace {rec['trace']}")
    a = torch.randn(2048, 2048, device=dev)
    b = a @ a @ a @ a
    c = torch.zeros(2, dtype=torch.complex64, device=dev) + 1j
    busy = not torch.cuda.current_stream().query()
    scalar_fence({"b": [b], "c": (c,), "n": 3})
    rec["scalar_fence"] = {"stream_busy_before": busy, "stream_idle_after": torch.cuda.current_stream().query()}
    require(rec["scalar_fence"]["stream_idle_after"], "drivers/utilities: scalar_fence left the stream busy")
    return rec


def run_drivers(card: str) -> dict:
    """The ``drivers`` phase (see the module docstring): (a) every driver's
    tables at its default size, (b) the anchors, (c) the utilities. Returns
    the rows' launches for the ``kernels`` line, as ``drivers/<driver>/<row>``
    (``... (ref)`` for the ``ref`` tables)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    ref = load_paper_reference()
    figures = importlib.util.find_spec("matplotlib") is not None
    rows, seconds, lanes = {}, {}, {}
    for driver in DRIVERS:
        mod = importlib.import_module(f"pnp_svrg_tpu_torch.examples.{driver}")
        for table, flags in PAPER_TABLES.get(driver, {"default": []}).items():
            t_table = time.perf_counter()
            got = _driver_table(driver, mod, table, flags, dev, figures)
            seconds[f"{driver}/{table}"] = time.perf_counter() - t_table
            rows[f"{driver}/{table}"] = _driver_rows(driver, table, got, ref)
            suffix = "" if table in ("auto", "default") else f" ({table})"
            lanes |= {f"drivers/{driver}/{name}{suffix}": {"launches": r["launches"]}
                      for name, r in rows[f"{driver}/{table}"].items()}
            del got
            gc.collect()
            torch.cuda.empty_cache()
    t_rows = time.perf_counter() - t0
    anchors = _driver_anchors(ref, dev)
    t_anchors = time.perf_counter() - t0 - t_rows
    utilities = _driver_utilities(dev)
    emit({"phase": "drivers", "card": card,
          "figures": f"written under {DRIVERS_BUILD.relative_to(DRIVERS_BUILD.parents[1])}/" if figures
          else "matplotlib absent on the card",
          "rows": rows, "table_seconds": seconds, "anchors": anchors, "utilities": utilities,
          "seconds": {"rows": t_rows, "anchors": t_anchors, "total": time.perf_counter() - t0}})
    return lanes


def phase_profile(label: str, run, table=KERNEL_GROUPS) -> dict:
    """Device time by kernel over one run of ``run()`` (port stream), summed
    by the first group of ``table`` whose substrings the kernel's name
    holds; emitted."""
    rec = profile_run(label, run, table)
    emit(rec)
    return rec


def profile_run(label: str, run, table=KERNEL_GROUPS, host_ops: bool = True) -> dict:
    """:func:`phase_profile`'s record, not emitted; ``host_ops=False`` traces
    the device only (less to record and sort afterwards)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        group = next((g for g, keys in table if any(k in e.name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us()
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    names: dict[str, set] = {}  # the kernels' own names in each of K1-K3's groups
    for e in kernels:
        for group, keys in table:
            hit = next((k for k in keys if k in e.name), None)
            if hit is not None:
                if group.startswith("K"):
                    names.setdefault(group, set()).add(hit)
                break
    rec = {
        "phase": "profile", "lane": label, "wall_ms": wall_us / 1e3,
        "device_kernel_ms": total_us / 1e3,
        "device_busy_share": total_us / wall_us, "kernel_launches": len(kernels),
        "groups_ms": {g: v / 1e3 for g, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "kernel_names": {g: sorted(v) for g, v in names.items()},
        "top_kernels_ms": {n: v / 1e3 for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]},
    }
    return rec


def main() -> None:
    dev = phase_device()
    card = dev["kind"]
    ptxas = phase_build()
    bench = {label: bench_lane(label) for label in BENCH_RUNS}
    sweep = run_sweep(dev["nvidia_smi"])
    first_round = sweep.pop("_first_round")
    k1 = check_match()
    k2 = check_aggregate(k1.pop("_agg_in"))
    at_lanes = {label: check_bench_kernels(lane) for label, lane in bench.items()}
    at_lanes["sweep_bm3d"] = check_bench_kernels(sweep_lane(first_round["bm3d"]))
    k1["bench_shapes"] = {label: r[0] for label, r in at_lanes.items()}
    k1["bounded"] = check_match_bounded(bench["deblur_bm3d"])
    k1["bench_shapes"]["search12"] = check_match_search12(ptxas)
    k2["bench_shapes"] = {label: r[1] for label, r in at_lanes.items()}
    k3 = check_nlm(dev["max_sm_clock_mhz"] * 1e6)
    k3["bench_shapes"] = {"sweep_nlm": check_nlm_at_sweep(first_round["nlm"], dev["max_sm_clock_mhz"] * 1e6)}
    for rec, rows in zip((k1, k2, k3), allowed(lambda: check_envelope_kernels(dev["max_sm_clock_mhz"] * 1e6))):
        rec["bench_shapes"] |= rows
    emit({"phase": "kernels_checked", "bm3d_match": k1, "bm3d_aggregate": k2, "nlm": k3,
          "device_ms_lost_records": LOST_RECORDS})
    allowed(check_wide_calls)
    run_convert(dev["nvidia_smi"])
    phase_parity()

    prob, lanes = load_headline_problems("cuda")
    ref_masks = load_headline_masks("cuda")
    with_k2 = {"bm3d_match": 2 * N_OUTER * T2, "bm3d_aggregate": 2 * N_OUTER * T2, "nlm": 0}
    head = run_lane("headline", with_k2, prob, lanes, ref_masks, HEADLINE_FLOOR_DB)
    lanes_run = {
        "headline": head,
        "turbo": run_lane("turbo", with_k2, prob, lanes, ref_masks, TURBO_FLOOR_DB),
        "turbo4": run_lane("turbo4", with_k2 | {"bm3d_aggregate": 0}, prob, lanes, ref_masks, TURBO4_FLOOR_DB),
    }
    uprob, ulanes = load_uniform_problems("cuda")
    lanes_run["set12_uniform"] = run_lane("set12_uniform", with_k2, uprob, ulanes, load_uniform_masks("cuda"),
                                          headline=head, extra=uniform_fields)
    del uprob
    for label in ("f32_match", "search12"):
        lanes_run[label] = run_lane(label, with_k2, prob, lanes, ref_masks, seeds=(), headline=head)
    lanes_run["bm3d_profile"] = run_lane("bm3d_profile", with_k2, prob, lanes, ref_masks, seeds=(),
                                         headline=head, extra=profile_first_call)
    lanes_run["csmri_nlm"] = run_nlm_lane()
    lanes_run["csmri_nlm_skimage"] = allowed(run_nlm_skimage_lane)
    lanes_run["csmri_nlm_grid"] = run_nlm_grid()
    lanes_run |= {label: run_bench_lane(lane) for label, lane in bench.items()}
    mem_before_gb = torch.cuda.memory_allocated() / 1e9
    sarah = sarah_lane()
    lanes_run["pr_sarah_realsn"] = run_sarah_lane(sarah, dev["nvidia_smi"], mem_before_gb)
    lanes_run |= {f"loops/{label}": rec for label, rec in run_loops().items()}
    lanes_run |= {f"sweep_{g}": rec for g, rec in sweep["groups"].items()}
    compat_rec = run_compat(dev["nvidia_smi"])
    lanes_run |= {f"compat/{k}": compat_rec[k] for k in ("a_vs_loop", "b_tune_nlm", "c_tune_bm3d")}
    run_checks(bench, dev["nvidia_smi"])
    lanes_run |= {f"train/{part}": rec for part, rec in run_train(dev["nvidia_smi"]).items()}
    lanes_run |= run_parallel(dev["nvidia_smi"], prob, lanes, ref_masks, bench)
    lanes_run |= run_drivers(dev["nvidia_smi"])
    lanes_run |= run_realsn_export(dev["nvidia_smi"])

    nprob, nden, neta, ncfg = nlm_lane()
    ngen = torch.Generator(device="cuda").manual_seed(3)
    phase_profile("csmri_nlm", lambda: pnp_svrg(nprob, nden, neta, N_OUTER, T2, MINI_BATCH,
                                                generator=ngen, lr_decay=ncfg["lr_decay"]))
    gprob, gden, geta, _ = nlm_grid()
    ggen = torch.Generator(device="cuda").manual_seed(3)
    phase_profile("csmri_nlm_grid",
                  lambda: pnp_svrg(gprob, gden, geta, N_OUTER, T2, MINI_BATCH, generator=ggen))
    for label in ("pr_bm3d", "deblur_sr_bm3d"):
        phase_profile(label, lambda: bench_run(bench[label], 3))
    phase_profile("pr_sarah_realsn", lambda: sarah_run(sarah, seed=3))
    algo, sprob, sden, skw = first_round["bm3d"]
    gen = torch.Generator(device="cuda").manual_seed(skw["generator"].initial_seed())
    phase_profile("sweep_bm3d_round", lambda: run_pnp(algo, sprob, sden, **(skw | {"generator": gen})))

    # K3's times are at B = 9, so its launches are the grid lane's (B = 9);
    # its B = 1 record (csmri_nlm) stands beside them. The records at the PR
    # and Deblur lanes' shapes (K1, K2; B = 1) and at the sweep's (K1, K2 and
    # K3; B = 36) carry those lanes' launches.
    main_lane = {"bm3d_match": "headline", "bm3d_aggregate": "headline", "nlm": "csmri_nlm_grid"}
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for rec in (k1, k2, k3):
        name = rec["name"]
        src, replaces = SOURCES[name]
        by_lane = {lane: r["launches"][name] for lane, r in lanes_run.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_lane[main_lane[name]], "launches_by_lane": by_lane,
            **{k: rec[k] for k in fields}, "card": dev["nvidia_smi"],
        })
        shapes = kernels[-1]["bench_shapes"] = {}
        for label, r in rec["bench_shapes"].items():
            lane, share = ROW_LANE.get(label, (label, 1))
            shapes[label] = {"launches": by_lane.get(lane, 0) // share, "shape": r["shape"],
                             **{k: r[k] for k in fields + REDESIGN_FIELDS if k in r}}
    kernels[0]["bounded"] = {  # K1 with row bounds: the spatial BM3D path's, per rank
        "launches": lanes_run["parallel/e_bm3d_rank0"]["launches"]["bm3d_match"],
        "shape": {k: k1["bounded"][k] for k in ("shape", "bounds", "mode")},
        **{k: k1["bounded"][k] for k in fields}}
    kernels[-1]["b1"] = {"launches": lanes_run["csmri_nlm"]["launches"]["nlm"],
                         **{k: k3["b1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    # K1's block-8 tile kernel, whose path is bm3d_profile's (its rows from
    # the K1 record, its launches from the lanes' K1 launches by kernel).
    tile_rows = {label: r for label, r in kernels[0]["bench_shapes"].items()
                 if r.get("kernel") == "bm3d_match_tile_kernel"}
    tile_by_lane = {lane: r["k1_kernels"]["bm3d_match_tile_kernel"] for lane, r in lanes_run.items()
                    if "k1_kernels" in r}
    ht = tile_rows["profile_ht"]
    kernels.insert(1, {
        "name": "bm3d_match_tile", "route": "cuda", "source": SOURCES["bm3d_match"][0],
        "replaces": SOURCES["bm3d_match"][1], "launches": tile_by_lane["bm3d_profile"],
        "launches_by_lane": tile_by_lane, **{k: ht[k] for k in fields + REDESIGN_FIELDS},
        "card": dev["nvidia_smi"], "bench_shapes": tile_rows})
    # K1's span kernel and K2's packed kernel (the paths off block 8 and
    # off (8, 16) / (8, 32): no lane runs them; their rows are the
    # envelope's, golden first) and K3's cluster kernel (csmri_nlm_skimage's
    # path; its row that lane's shape, B = 1 at (7, 11)).
    for name, group, kernel, main in (("bm3d_match_span", "bm3d_match", K1_KERNELS[3], "golden"),
                                      ("bm3d_aggregate_packed", "bm3d_aggregate", K2_KERNELS[1], "golden"),
                                      ("nlm_cluster", "nlm", K3_KERNELS[1], "p7_d11_b1"),
                                      ("nlm_cluster_rt", "nlm", K3_KERNELS[2], "p13_d21_b1")):
        rows = {label: r for label, r in next(k for k in kernels if k["name"] == group)["bench_shapes"].items()
                if r.get("kernel") == kernel}
        rows = {main: rows.pop(main)} | rows
        # nlm_cluster_rt_kernel replaced no design: it has no prev-design keys.
        redesign = REDESIGN_FIELDS[:1] if kernel == K3_KERNELS[2] else REDESIGN_FIELDS
        key = "k1_kernels" if group == "bm3d_match" else "k2_k3_kernels"
        by_lane = {lane: (r[key] if key == "k1_kernels" else r[key][group])[kernel]
                   for lane, r in lanes_run.items() if key in r}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[group][0], "replaces": SOURCES[group][1],
            "launches": by_lane.get(ROW_LANE.get(main, ("",))[0], 0), "launches_by_lane": by_lane,
            **{k: rows[main][k] for k in fields + redesign}, "card": dev["nvidia_smi"],
            "bench_shapes": rows})
        if kernel == K1_KERNELS[3]:  # with row bounds
            bounded = k1["bench_shapes"][K1_BOUNDED_ROW]["bounded"]
            kernels[-1]["bounded"] = {"launches": 0, **{k: bounded[k] for k in ("shape", "bounds", "kernel") + fields}}
    _fold_tally()
    stray = {k: TALLY[k] - ALLOWED[k] for k in REDESIGNED_OFF_LANES}
    emit({"phase": "k2_k3_kernels", "tally": dict(TALLY), "allowed": dict(ALLOWED), "stray": stray})
    require(not any(stray.values()), f"K1 / K2 / K3 launches on the redesigned kernels outside their rows: {stray}")
    for k in kernels:
        shapes = [k] + list(k.get("bench_shapes", {}).values()) + [k.get("bounded", k)]
        require(all(math.isfinite(r[f]) for r in shapes for f in ("ms", "plain_ms", "bound_ms")),
                f"{k['name']} times")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
