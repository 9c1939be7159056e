#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pnp_svrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the repository root with no arguments and needs one CUDA card; it
imports no JAX. Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` of ``pnp_svrg_tpu_torch/csrc/*.cu`` for ``sm_90a``;
3. kernels: K1 (block matching) and K2 (aggregation scatter) against their
   plain PyTorch versions at the headline shapes, on real inputs (the
   headline batch's ``x_init`` and a stage-1 BM3D estimate and its update
   rows), with CUDA-event times, the plain and library times and the bound;
4. parity: a small reconstruction on the card against the same run on the
   CPU (plain kernel versions), and a standalone BM3D denoise on the card;
5. headline: the 13-lane 128x128 Set12 CSMRI + PnP-SVRG (16 x 10, minibatch
   4000) + BM3D (search 8, bf16 match distances) lane: one warm-up run and
   one timed run on the port's own generator, with the kernels' launch
   counts over the timed run (which fails on any implicit host-device
   synchronisation); then one run on the JAX reference's minibatch
   masks (``headline_masks_key2.npz``), whose quality is comparable lane by
   lane with the reference's and is held to the floor; then the port's own
   stream on six more seeds, for the spread of quality across streams;
6. turbo: the same with ``search_step=2`` and the Pallas matcher's bf16
   rounding;
7. profile: one more headline run under ``torch.profiler``: device time by
   kernel, grouped, and the device's busy share of the run's wall time.

The tuned per-lane step sizes sit at the stability edge of the reference's
own key stream: on other minibatch streams single lanes diverge, so the
port-stream quality is reported and checked for NaN, and the quality floor
applies to the reference-minibatch run.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises, and the script exits non-zero without the last line.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import lane_params, load_headline_masks, load_headline_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import (
    BM3DDenoiser,
    BM3DParams,
    _ref_grid,
    bm3d_denoise_batch,
    search_offsets,
    stage1_scatter_inputs,
)
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda.bm3d_match import (
    bm3d_match,
    bm3d_match_plain,
    match_distances_plain,
)
from pnp_svrg_tpu_torch.ops.cuda.bm3d_scatter import bm3d_scatter, bm3d_scatter_plain
from pnp_svrg_tpu_torch.ops.metrics import ssim
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image

N_OUTER, T2, MINI_BATCH = 16, 10, 4000
SPREAD_SEEDS = (3, 4, 5, 6, 7, 8)
SET12_VD_REF_DB, FLAGSHIP_REF_DB = 26.50, 25.54  # JAX package, BENCH_r05.json
HEADLINE_FLOOR_DB, TURBO_FLOOR_DB = 25.5, 25.86
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM bytes/s. Bounds are stated beside the card's name and limit.
F32_PEAK, HBM_PEAK = 67e12, 3.35e12
KERNEL_GROUPS = (  # (group, substrings of the device kernel's name)
    ("K1 bm3d_match", ("bm3d_match_kernel",)),
    ("K2 bm3d_scatter", ("bm3d_scatter_kernel",)),
    ("matmul (3-D transform)", ("gemm", "cutlass")),
    ("fft", ("fft",)),
    ("gather/index", ("index", "gather", "Index")),
    ("sort/topk (sigma, sampling)", ("sort", "Sort", "topk", "radix", "bitonic")),
    ("fold (unfold-add)", ("col2im", "im2col")),
    ("fill/copy", ("fill", "copy", "Copy")),
)
SOURCES = {
    "bm3d_match": ("pnp_svrg_tpu_torch/csrc/bm3d_match.cu",
                   "pnp_svrg_tpu/ops/pallas/bm3d_match.py:52"),
    "bm3d_scatter": ("pnp_svrg_tpu_torch/csrc/bm3d_scatter.cu",
                     "pnp_svrg_tpu/ops/pallas/bm3d_scatter.py:39"),
}


def emit(record: dict) -> None:
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


def set_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    k = a.shape[-1]
    a = a.reshape(-1, k).cpu().numpy()
    b = b.reshape(-1, k).cpu().numpy()
    return float(np.mean([len(set(p) & set(q)) / k for p, q in zip(a, b)]))


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rec = {
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(rec)
    return rec


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in paths.items()},
          "ptxas": {n: [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln][:4]
                    for n, log in _build.BUILD_LOG.items()}})


def check_match() -> dict:
    """K1 against its plain version at the headline shapes."""
    prob, _ = load_headline_problems("cuda")
    x = prob.x_init.contiguous()
    params = BM3DParams(search=8, match_dtype="bfloat16")
    basic, scatter_in = stage1_scatter_inputs(x, estimate_sigma(x), params)
    rows = _ref_grid(x.shape[-1], 8, 4)
    agreements = {}
    for name, img in (("x_init", x), ("basic", basic.contiguous())):
        for mode in ("f32", "bf16_xla", "bf16_pallas"):
            for ss in (1, 2):
                offs = search_offsets(8, ss)
                got = bm3d_match(img, rows, rows, offs, 8, 16, mode)
                want = bm3d_match_plain(img, rows, rows, offs, 8, 16, mode)
                agree = set_agreement(got, want)
                agreements[f"{name}/{mode}/step{ss}"] = agree
                require(agree >= (0.999 if mode == "f32" else 0.995),
                        f"K1 set agreement {agree} ({name}, {mode}, step {ss})")
    # Headline configuration: bf16_xla, the full 289-offset window.
    offs = search_offsets(8, 1)
    mode = "bf16_xla"
    got = bm3d_match(x, rows, rows, offs, 8, 16, mode)
    want = bm3d_match_plain(x, rows, rows, offs, 8, 16, mode)
    dists = match_distances_plain(x, rows, rows, offs, 8, mode)
    err = (dists.gather(-1, got.long()) - dists.gather(-1, want.long())).abs().max().item()
    b, h, w = x.shape
    valid = sum(
        1 for r in rows for c in rows for dy, dx in offs
        if 0 <= r + dy <= h - 8 and 0 <= c + dx <= w - 8
    ) * b
    flops = valid * 64 * 3  # sub, mul, add per patch term
    nbytes = x.numel() * 4 + got.numel() * 4
    bound = max(flops / F32_PEAK, nbytes / HBM_PEAK) * 1e3
    ms = cuda_ms(lambda: bm3d_match(x, rows, rows, offs, 8, 16, mode))
    plain_ms = cuda_ms(lambda: bm3d_match_plain(x, rows, rows, offs, 8, 16, mode), reps=10)
    turbo_offs = search_offsets(8, 2)
    turbo_ms = cuda_ms(lambda: bm3d_match(x, rows, rows, turbo_offs, 8, 16, "bf16_pallas"))
    return {
        "name": "bm3d_match", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations" if flops / F32_PEAK > nbytes / HBM_PEAK else "bytes",
        "library_ms": None, "set_agreement": agreements, "turbo_81_offsets_ms": turbo_ms,
        "shape": {"images": list(x.shape), "offsets": len(offs), "k": 16},
        "_scatter_in": scatter_in,
    }


def check_scatter(scatter_in) -> dict:
    """K2 against its plain version on a stage-1 call's real update rows."""
    idx, upd, table_rows = scatter_in
    got = bm3d_scatter(idx, upd, table_rows, check_bounds=True)
    want = bm3d_scatter_plain(idx, upd, table_rows)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    require(err <= 1e-5 * scale, f"K2 max abs err {err} vs row magnitude {scale}")
    b, p, w = upd.shape
    nbytes = idx.numel() * 4 + upd.numel() * 4 + b * table_rows * w * 4
    flops = upd.numel()
    ms = cuda_ms(lambda: bm3d_scatter(idx, upd, table_rows))
    plain_ms = cuda_ms(lambda: bm3d_scatter_plain(idx, upd, table_rows))
    flat_idx = (idx.long() + torch.arange(b, device=idx.device)[:, None] * table_rows).reshape(-1)
    flat_upd = upd.reshape(b * p, w)
    table = torch.zeros((b * table_rows, w), device=upd.device)
    library_ms = cuda_ms(lambda: table.index_add_(0, flat_idx, flat_upd))
    return {
        "name": "bm3d_scatter", "max_abs_err": err, "max_rel_err": err / scale, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(flops / F32_PEAK, nbytes / HBM_PEAK) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_PEAK >= flops / F32_PEAK else "operations",
        "library_ms": library_ms,
        "shape": {"idx": list(idx.shape), "upd": list(upd.shape), "table_rows": table_rows},
    }


def phase_parity() -> None:
    """A small faithful-variant reconstruction (deterministic): the card's
    kernels against the CPU's plain versions; and a standalone BM3D denoise
    on the card that must clearly improve a noisy image."""
    gen = torch.Generator().manual_seed(0)
    probs = [make_csmri(load_image(p, 32, 32), gen, 0.5, snr=10, keep_low_freq=4, device="cpu")
             for p in ("Set12/01.png", "13.png")]
    cpu = stack_problems(probs)
    cuda = type(cpu)(**{k: v.cuda() for k, v in vars(cpu).items()})
    den = BM3DDenoiser(sigma_modifier=2.0, params=BM3DParams(search=4))
    runs = [pnp_svrg(p, den, 3000.0, 2, 3, 100, variant="faithful") for p in (cpu, cuda)]
    tr_cpu, tr_gpu = (r["psnr_per_iter"].cpu().numpy() for r in runs)
    diff = float((runs[0]["image"] - runs[1]["image"].cpu()).abs().mean())
    dtrace = float(np.abs(tr_cpu - tr_gpu).max())
    clean = torch.tensor(load_image("13.png", 128, 128), device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(0)
    noisy = clean + 0.1 * torch.randn(clean.shape, generator=gen, device="cuda")
    out = bm3d_denoise_batch(noisy, 0.1, BM3DParams(search=8, match_dtype="bfloat16"))
    mse_noisy = float(((noisy - clean) ** 2).mean())
    mse_den = float(((out - clean) ** 2).mean())
    emit({"phase": "parity", "trace_max_abs_db": dtrace, "image_mean_abs_diff": diff,
          "bm3d_mse_noisy": mse_noisy, "bm3d_mse_denoised": mse_den})
    require(np.isfinite(tr_gpu).all() and dtrace < 0.05 and diff < 1e-3,
            f"card vs CPU: trace {dtrace} dB, image {diff}")
    require(mse_den < 0.5 * mse_noisy, f"BM3D denoise mse {mse_den} vs noisy {mse_noisy}")


def quality(prob, out, lanes, check: bool = True) -> dict:
    """Quality of a run; ``check`` fails it on any non-finite value."""
    psnr = out["final_psnr"].cpu().numpy()
    ssims = ssim(prob.x, out["image"]).cpu().numpy()
    trace = out["psnr_per_iter"].cpu().numpy()
    require(not check or np.isfinite(np.concatenate([psnr, ssims, trace.ravel()])).all(),
            "non-finite PSNR/SSIM")
    require(out["image"].shape == prob.x.shape, "image shape")
    n_set12 = len(lanes) - 1
    return {
        "set12_vd_mean_psnr_db": float(psnr[:n_set12].mean()),
        "set12_vd_min_psnr_db": float(psnr[:n_set12].min()),
        "set12_vd_mean_ssim": float(ssims[:n_set12].mean()),
        "flagship_psnr_db": float(psnr[-1]), "flagship_ssim": float(ssims[-1]),
        "delta_set12_vd_mean_db": float(psnr[:n_set12].mean()) - SET12_VD_REF_DB,
        "delta_flagship_db": float(psnr[-1]) - FLAGSHIP_REF_DB,
        "per_lane_psnr_db": [float(v) for v in psnr],
    }


def run_lane(label: str, tuned_json: str, default_eta: float, params: BM3DParams,
             floor_db: float, prob, lanes, ref_masks) -> dict:
    eta, mod = lane_params(DATA_DIR / tuned_json, lanes, default_eta, 1.0, device="cuda")
    den = BM3DDenoiser(sigma_modifier=mod, params=params)

    def run(seed=None, masks=None):
        gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        return pnp_svrg(prob, den, eta, N_OUTER, T2, MINI_BATCH, generator=gen, masks=masks)

    t0 = time.perf_counter()
    run(seed=1)  # warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    bm3d_match.launches = 0
    bm3d_scatter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # the loop must never wait for the device
    try:
        out = run(seed=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {"bm3d_match": bm3d_match.launches, "bm3d_scatter": bm3d_scatter.launches}
    own = quality(prob, out, lanes)
    ref = quality(prob, run(masks=ref_masks), lanes)
    spread = {2: own} | {s: quality(prob, run(seed=s), lanes, check=False) for s in SPREAD_SEEDS}
    keys = ("set12_vd_mean_psnr_db", "set12_vd_min_psnr_db", "flagship_psnr_db")
    rec = {
        "phase": label, "lanes": len(lanes), "steady_s": steady, "first_s": first,
        "image_iters_per_s": len(lanes) * N_OUTER * (T2 + 1) / steady,
        "launches": launches, "reference_minibatches": ref, "port_stream_seed2": own,
        "port_stream_seeds": {s: [q[k] for k in keys] for s, q in spread.items()},
        "port_stream_seeds_fields": keys,
        "port_stream_mean_of_set12_vd_means": float(np.mean([q[keys[0]] for q in spread.values()])),
        "params": params.__dict__, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(rec)
    denoises = N_OUTER * T2
    require(launches == {"bm3d_match": 2 * denoises, "bm3d_scatter": 2 * denoises},
            f"{label}: launches {launches}, expected {2 * denoises} each")
    require(ref["set12_vd_mean_psnr_db"] >= floor_db,
            f"{label}: Set12-VD mean {ref['set12_vd_mean_psnr_db']:.2f} dB < {floor_db}")
    return rec


def phase_profile(prob, lanes) -> dict:
    """Device time by kernel over one headline run (port stream)."""
    from torch.profiler import ProfilerActivity, profile

    eta, mod = lane_params(DATA_DIR / "set12_csmri_tuned.json", lanes, 6000.0, 1.0, device="cuda")
    den = BM3DDenoiser(sigma_modifier=mod, params=BM3DParams(search=8, match_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pnp_svrg(prob, den, eta, N_OUTER, T2, MINI_BATCH, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in e.name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us()
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    rec = {
        "phase": "profile", "wall_ms": wall_us / 1e3, "device_kernel_ms": total_us / 1e3,
        "device_busy_share": total_us / wall_us, "kernel_launches": len(kernels),
        "groups_ms": {g: v / 1e3 for g, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {n: v / 1e3 for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }
    emit(rec)
    return rec


def main() -> None:
    dev = phase_device()
    card = dev["kind"]
    phase_build()
    k1 = check_match()
    k2 = check_scatter(k1.pop("_scatter_in"))
    emit({"phase": "kernels_checked", "bm3d_match": k1, "bm3d_scatter": k2})
    phase_parity()

    prob, lanes = load_headline_problems("cuda")
    ref_masks = load_headline_masks("cuda")
    head = run_lane("headline", "set12_csmri_tuned.json", 6000.0,
                    BM3DParams(search=8, match_dtype="bfloat16"), HEADLINE_FLOOR_DB,
                    prob, lanes, ref_masks)
    turbo = run_lane("turbo", "set12_csmri_turbo_tuned.json", 4000.0,
                     BM3DParams(search=8, search_step=2, matcher="pallas", match_dtype="bfloat16"),
                     TURBO_FLOOR_DB, prob, lanes, ref_masks)

    phase_profile(prob, lanes)

    kernels = []
    for rec in (k1, k2):
        src, replaces = SOURCES[rec["name"]]
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src, "replaces": replaces,
            "launches": head["launches"][rec["name"]],
            "turbo_launches": turbo["launches"][rec["name"]],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "card": dev["nvidia_smi"],
        })
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")), f"{k['name']} times")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
