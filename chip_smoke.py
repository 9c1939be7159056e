#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pnp_svrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs from the repository root with no arguments and needs one CUDA card; it
imports no JAX. Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` of ``pnp_svrg_tpu_torch/csrc/*.cu`` for ``sm_90a``, with
   ptxas's registers and spills, the atomics in K2's SASS and the
   instruction mix of K3's shift loop;
3. kernels: K1 (block matching) and K2 (the fused aggregation: scatter and
   unfold-add) against their plain PyTorch versions at the headline shapes,
   on real inputs (the headline batch's ``x_init``, a stage-1 BM3D estimate
   and its aggregation's arguments), with CUDA-event times, the plain and
   library times and the bounds; K1 in every rounding mode at 289, 81 and
   25 offsets, held slot by slot (the same offset or a near-tie), and K2
   beside the dense aggregation at the turbo4 shape;
   K3 (non-local means) against its plain version on real NLM inputs (the
   ``13.png`` lane's ``x_init`` after one gradient step) at B = 1 and at
   B = 9 on distinct lanes (each grid pair's own step and h), with and
   without row bounds, and NaN at ``h = 0``;
4. parity: small faithful-variant reconstructions (BM3D and NLM) on the card
   against the same runs on the CPU (plain kernel versions), and a
   standalone BM3D denoise on the card;
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
7. turbo4: the same with ``search_step=4``, where the aggregation is the
   scatter-free dense one (no K2);
8. csmri_nlm: the one-lane ``13.png`` CSMRI + PnP-SVRG + NLM lane
   (``bench.py:465-506``) in the same pattern; its run on the JAX lane's
   minibatch masks (``csmri_nlm_masks_key2.npz``) is held entry by entry to
   the JAX run's PSNR trace stored beside them;
9. csmri_nlm_grid: the NLM tuner's chunk, 9 lanes of that problem with the
   3 x 3 (eta, sigma_modifier) grid of ``data/csmri_nlm_tuned.json``;
10. profile: one more run each of headline, turbo4, csmri_nlm and the grid
   under ``torch.profiler``: device time by kernel, grouped, and the
   device's busy share of the run's wall time.

The tuned per-lane step sizes sit at the stability edge of the reference's
own key stream: on other minibatch streams single lanes diverge, so the
port-stream quality is reported and checked for NaN, and the quality floor
applies to the reference-minibatch run.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises, and the script exits non-zero without the last line.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.convert import (
    lane_params,
    load_headline_masks,
    load_headline_problems,
    load_nlm_masks,
    load_nlm_problem,
    load_nlm_reference,
    nlm_params,
)
from pnp_svrg_tpu_torch.denoisers.bm3d import (
    BM3DDenoiser,
    BM3DParams,
    _aggregate,
    _aggregate_dense,
    _geometry,
    _ref_grid,
    _stage1,
    bm3d_denoise_batch,
    search_offsets,
    stage1_aggregate_inputs,
)
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda.bm3d_match import (
    bm3d_match,
    bm3d_match_plain,
    match_distances_plain,
    match_geometry,
)
from pnp_svrg_tpu_torch.ops.cuda.bm3d_aggregate import (
    aggregate_geometry,
    bm3d_aggregate,
    bm3d_aggregate_plain,
)
from pnp_svrg_tpu_torch.ops.cuda.nlm import nlm_denoise, nlm_denoise_plain
from pnp_svrg_tpu_torch.ops.metrics import ssim
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image

N_OUTER, T2, MINI_BATCH = 16, 10, 4000
SPREAD_SEEDS = (3, 4, 5, 6, 7, 8)
# (Set12-VD mean, flagship) PSNR of the JAX package per lane, BENCH_r05.json
REF_DB = {"headline": (26.50, 25.54), "turbo": (26.86, 25.00), "turbo4": (26.20, 24.63)}
HEADLINE_FLOOR_DB, TURBO_FLOOR_DB, TURBO4_FLOOR_DB = 25.5, 25.86, 25.20
NLM_REF_DB, NLM_REF_SSIM = 27.09, 0.8291  # BENCH_r05.json csmri_nlm_*
NLM_FLOOR_DB, NLM_TRACE_TOL_DB = 26.59, 0.05
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM bytes/s. Bounds are stated beside the card's name and limit.
F32_PEAK, HBM_PEAK = 67e12, 3.35e12
SFU_PER_SM_CLOCK, N_SMS = 16, 132  # expf throughput: 16 a clock on each of 132 SMs
KERNELS = {"bm3d_match": bm3d_match, "bm3d_aggregate": bm3d_aggregate, "nlm": nlm_denoise}
KERNEL_GROUPS = (  # (group, substrings of the device kernel's name)
    ("K1 bm3d_match", ("bm3d_match_kernel",)),
    ("K2 bm3d_aggregate", ("bm3d_aggregate_kernel",)),
    ("K3 nlm", ("nlm_kernel",)),
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
    "bm3d_aggregate": ("pnp_svrg_tpu_torch/csrc/bm3d_aggregate.cu",
                       "pnp_svrg_tpu/ops/pallas/bm3d_scatter.py:39 + "
                       "pnp_svrg_tpu/denoisers/bm3d.py:288 (_unfold_table)"),
    "nlm": ("pnp_svrg_tpu_torch/csrc/nlm.cu", "pnp_svrg_tpu/ops/pallas/nlm_kernel.py:31"),
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


def device_records(fn, calls: int) -> list:
    """The device records (kernels, fills, copies) of ``calls`` calls of
    ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 50, warmup: int = 10, windows: int = 3) -> float:
    """Device time of one call of ``fn``: the summed time of every device
    record it makes (``torch.profiler``) over ``reps`` calls, after
    ``warmup`` calls. Unlike :func:`cuda_ms` it leaves out the gaps in which
    the device waits for the host to launch the next call. The profiler has
    dropped device records on the card's machine, so a window counts only
    if it holds exactly ``reps`` times the records of one profiled call (at
    least one); else both are measured again, up to ``windows`` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        per_call = len(device_records(fn, 1))
        records = device_records(fn, reps)
        if per_call > 0 and len(records) == reps * per_call:
            return sum(e.time_range.elapsed_us() for e in records) / reps / 1e3
    raise RuntimeError(f"check failed: the profiler recorded {len(records)} device records "
                       f"for {reps} calls of {per_call} each, in each of {windows} windows")


def multiset_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean share of each block's k indices that the other holds as often:
    a repeated index (the index-0 fill) counts each time, so equal outputs
    read 1."""
    k, s = a.shape[-1], int(max(a.max(), b.max())) + 1
    a, b = a.reshape(-1, k).long(), b.reshape(-1, k).long()
    count = lambda t: torch.zeros(t.shape[0], s, device=t.device).scatter_add_(  # noqa: E731
        1, t, torch.ones(t.shape, device=t.device))
    return float(torch.minimum(count(a), count(b)).sum(1).mean() / k)


# K1 and its plain version sum the same 64 rounded terms of a distance in
# different orders, each within 63 half-ulps (2**-24 relative) of the exact
# sum; so where they put different offsets in a slot, the two distances
# there lie within twice that of each other (a near-tie).
NEAR_TIE = 2 * 63 * 2.0**-24


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


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in paths.items()},
          "ptxas": {n: ptxas_summary(log) for n, log in _build.BUILD_LOG.items()},
          "sass_atomics": sass_atomics(sass(paths["bm3d_aggregate"])),
          "nlm_shift_loop_sass": sass_loop_mix(sass(paths["nlm"]), "MUFU.EX2")})


def ptxas_summary(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel that ptxas
    compiled, keyed by its name and template arguments (``<mode, offsets a
    lane>`` for K1)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            base = re.search(r"(bm3d_match|bm3d_aggregate|nlm)_kernel", m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
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


def match_bounds(b: int, h: int, w: int, rows, cols, offs) -> dict:
    """K1's least time two ways, over the valid (reference block, offset)
    pairs of this geometry. Direct: sub, mul, add for each of a pair's 64
    patch terms. Separable (the Pallas kernel's form): per (image, offset)
    the squared-difference plane (sub, mul a pixel), 8-wide row sums at the
    reference columns (7 adds each) and 8-tall column sums at the reference
    rows (7 adds each), shared among that offset's reference blocks; counted
    for the valid share of them. Bytes: the images in, the indices out."""
    nr, nc = len(rows), len(cols)
    valid = sum(
        1 for r in rows for c in cols for dy, dx in offs
        if 0 <= r + dy <= h - 8 and 0 <= c + dx <= w - 8
    ) * b
    direct = valid * 64 * 3
    separable = valid * (2 * h * w + 7 * h * nc + 7 * nr * nc) / (nr * nc)
    nbytes = b * h * w * 4 + b * nr * nc * 16 * 4
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


def check_aggregate(agg_in) -> dict:
    """K2 against its plain version on a stage-1 call's real arguments; its
    time beside the plain version, one ``index_add_`` of the per-pixel terms
    into fresh planes (both timed with the zero fill of their output) and
    the bound; and the dense aggregation against K2 at the turbo4 shape."""
    idx, est, wgt, kai, h, w, geom = agg_in
    b, p, bb = est.shape
    got = bm3d_aggregate(*agg_in)
    want = bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    errs, scales = {}, {}
    for name, g_, w_ in zip(("num", "den"), got, want):
        errs[name] = (g_ - w_).abs().max().item()
        scales[name] = w_.abs().max().item()
        require(errs[name] <= 1e-5 * scales[name],
                f"K2 {name} max abs err {errs[name]} vs plane magnitude {scales[name]}")
    nbytes = (idx.numel() + est.numel() + wgt.numel() + kai.numel() + 2 * b * h * w) * 4
    flops = est.numel() * 4  # wk, est * wk, two adds
    ms = device_ms(lambda: bm3d_aggregate(*agg_in))
    event_ms = cuda_ms(lambda: bm3d_aggregate(*agg_in))
    plain_ms = cuda_ms(lambda: bm3d_aggregate_plain(idx, est, wgt, kai, h, w))
    # The library yardstick: the same sums as one index_add_ of per-pixel
    # terms (made here, outside the timing) into planes zeroed in the call.
    g = wgt.shape[1]
    ww = w - 7
    wk = wgt[..., None, None] * kai  # (B, G, 1, 64)
    terms = torch.cat([(est.view(b, g, -1, bb) * wk).reshape(-1),
                       wk.expand(b, g, p // g, bb).reshape(-1)])
    ky, kx = torch.arange(8, device=idx.device).repeat_interleave(8), torch.arange(8, device=idx.device).repeat(8)
    pix = ((idx.long() // ww)[..., None] + ky) * w + (idx.long() % ww)[..., None] + kx  # (B, P, 64)
    pix = (pix + torch.arange(b, device=idx.device)[:, None, None] * (h * w)).reshape(-1)
    flat = torch.cat([pix, pix + b * h * w])
    lib_planes = torch.zeros(2 * b * h * w, device=idx.device).index_add_(0, flat, terms)
    lib_err = max((lib_planes.view(2, b, h, w)[i] - want[i]).abs().max().item() for i in (0, 1))
    require(lib_err <= 1e-5 * max(scales.values()), f"index_add_ yardstick err {lib_err}")
    library = lambda: torch.zeros(2 * b * h * w, device=idx.device).index_add_(0, flat, terms)  # noqa: E731
    library_ms, library_event_ms = device_ms(library), cuda_ms(library)
    del flat, terms, pix
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
    turbo4 = {"dense_ms": device_ms(dense), "fused_ms": device_ms(fused),
              "dense_event_ms": cuda_ms(dense), "fused_event_ms": cuda_ms(fused),
              "max_abs_diff": (dense() - fused()).abs().max().item()}
    return {
        "name": "bm3d_aggregate", "max_abs_err": max(errs.values()), "max_abs_err_by_plane": errs,
        "plane_magnitude": scales, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
        "bound_ms": max(flops / F32_PEAK, nbytes / HBM_PEAK) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_PEAK >= flops / F32_PEAK else "operations",
        "bytes": nbytes, "library_ms": library_ms, "library_event_ms": library_event_ms,
        "library_max_abs_err": lib_err,
        "smem_bytes": geom.smem_bytes, "footprint": [geom.fh, geom.fw],
        "turbo4_shape": turbo4,
        "shape": {"idx": list(idx.shape), "est": list(est.shape), "wgt": list(wgt.shape),
                  "planes": [2, b, h, w]},
    }


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


def nlm_bound(b: int, h: int, w: int, lo: int, hi: int, d: int, clock_hz: float) -> dict:
    """Least time of one NLM call: the valid (pixel, shift) pairs this input
    has, each about 17 f32 operations (2 for the square, 6 for the separable
    box sums, 5 for the weight, 4 for the accumulation) and one exp; the image
    read once and the output written once."""
    rows = sum(1 for i in range(h) for dy in range(-d, d + 1) if lo <= i + dy < hi)
    cols = sum(1 for j in range(w) for dx in range(-d, d + 1) if 0 <= j + dx < w)
    pairs = b * rows * cols
    terms = {
        "operations": 17 * pairs / F32_PEAK,
        "exp": pairs / (N_SMS * SFU_PER_SM_CLOCK * clock_hz),
        "bytes": (2 * b * h * w * 4 + 2 * b * 4) / HBM_PEAK,
    }
    top = max(terms, key=terms.get)
    return {"bound_ms": terms[top] * 1e3, "bound_by": "bytes" if top == "bytes" else "operations",
            "bound_terms_ms": {k: v * 1e3 for k, v in terms.items()}, "valid_pairs": pairs,
            "sm_clock_hz": clock_hz}


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
    times = {}
    for name, (z, h) in inputs.items():
        times[name] = {
            "ms": device_ms(lambda: nlm_denoise(z, h, h)),
            "event_ms": cuda_ms(lambda: nlm_denoise(z, h, h)),
            "plain_ms": cuda_ms(lambda: nlm_denoise_plain(z, h, h), reps=10, warmup=3),
            **nlm_bound(z.shape[0], hh, ww, 0, hh, 5, clock_hz),
        }
    return {
        "name": "nlm", "max_abs_err": max(errs.values()), "max_abs_err_by_case": errs,
        "nan_equal_at_h0": nan_equal, **times["b9"],
        "library_ms": None, "b1": times["b1"], "h_b9": h9.tolist(),
        "shape": {"images": [b, hh, ww], "patch_size": 4, "patch_distance": 5},
    }


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
    """Small faithful-variant reconstructions with BM3D and with NLM: the
    card's kernels against the CPU's plain versions; and a standalone BM3D
    denoise on the card that must clearly improve a noisy image."""
    bm3d = faithful_parity(BM3DDenoiser(sigma_modifier=2.0, params=BM3DParams(search=4)), 3000.0)
    nlm = faithful_parity(NLMDenoiser(sigma_modifier=1.2), 400.0)
    clean = torch.tensor(load_image("13.png", 128, 128), device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(0)
    noisy = clean + 0.1 * torch.randn(clean.shape, generator=gen, device="cuda")
    out = bm3d_denoise_batch(noisy, 0.1, BM3DParams(search=8, match_dtype="bfloat16"))
    mse_noisy = float(((noisy - clean) ** 2).mean())
    mse_den = float(((out - clean) ** 2).mean())
    emit({"phase": "parity", "trace_max_abs_db": bm3d["trace_max_abs_db"],
          "image_mean_abs_diff": bm3d["image_mean_abs_diff"], "nlm": nlm,
          "bm3d_mse_noisy": mse_noisy, "bm3d_mse_denoised": mse_den})
    for name, rec in (("BM3D", bm3d), ("NLM", nlm)):
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


def drive(prob, den, eta, lr_decay: float = 1.0):
    """A warm-up run, then the timed run on the port's generator (seed 2)
    with every kernel's launches counted from 0 and any implicit host-device
    synchronisation an error. Returns (run, output, steady s, first s,
    launches)."""

    def run(seed=None, masks=None):
        gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        return pnp_svrg(prob, den, eta, N_OUTER, T2, MINI_BATCH, generator=gen, masks=masks,
                        lr_decay=lr_decay)

    t0 = time.perf_counter()
    run(seed=1)  # warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # the loop must never wait for the device
    try:
        out = run(seed=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items()}
    return run, out, steady, first, launches


def run_lane(label: str, tuned_json: str, default_eta: float, default_mod: float,
             params: BM3DParams, floor_db: float, expect: dict, prob, lanes, ref_masks) -> dict:
    eta, mod = lane_params(DATA_DIR / tuned_json, lanes, default_eta, default_mod, device="cuda")
    den = BM3DDenoiser(sigma_modifier=mod, params=params)
    run, out, steady, first, launches = drive(prob, den, eta)
    refs = REF_DB[label]
    own = quality(prob, out, lanes, refs)
    ref = quality(prob, run(masks=ref_masks), lanes, refs)
    spread = {2: own} | {s: quality(prob, run(seed=s), lanes, refs, check=False) for s in SPREAD_SEEDS}
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
    require(launches == expect, f"{label}: launches {launches}, expected {expect}")
    require(ref["set12_vd_mean_psnr_db"] >= floor_db,
            f"{label}: Set12-VD mean {ref['set12_vd_mean_psnr_db']:.2f} dB < {floor_db}")
    return rec


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
    require(ref_psnr >= NLM_FLOOR_DB, f"csmri_nlm: PSNR {ref_psnr:.2f} dB < {NLM_FLOOR_DB}")
    require(dtrace <= NLM_TRACE_TOL_DB, f"csmri_nlm: trace {dtrace:.4f} dB off the JAX trace")
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
    q = lane_quality(prob, out, check=False)
    q.pop("_trace")
    rec = {
        "phase": "csmri_nlm_grid", "lanes": len(pairs), "steady_s": steady, "first_s": first,
        "image_iters_per_s": len(pairs) * N_OUTER * (T2 + 1) / steady, "launches": launches,
        "pairs_eta_mod": pairs, **q,
    }
    emit(rec)
    expect = {"bm3d_match": 0, "bm3d_aggregate": 0, "nlm": N_OUTER * T2}
    require(launches == expect, f"csmri_nlm_grid: launches {launches}, expected {expect}")
    return rec


def phase_profile(label: str, run) -> dict:
    """Device time by kernel over one run of ``run()`` (port stream)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        "phase": "profile", "lane": label, "wall_ms": wall_us / 1e3,
        "device_kernel_ms": total_us / 1e3,
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
    k2 = check_aggregate(k1.pop("_agg_in"))
    k3 = check_nlm(dev["max_sm_clock_mhz"] * 1e6)
    emit({"phase": "kernels_checked", "bm3d_match": k1, "bm3d_aggregate": k2, "nlm": k3})
    phase_parity()

    prob, lanes = load_headline_problems("cuda")
    ref_masks = load_headline_masks("cuda")
    with_k2 = {"bm3d_match": 2 * N_OUTER * T2, "bm3d_aggregate": 2 * N_OUTER * T2, "nlm": 0}
    lanes_run = {
        "headline": run_lane("headline", "set12_csmri_tuned.json", 6000.0, 1.0,
                             BM3DParams(search=8, match_dtype="bfloat16"), HEADLINE_FLOOR_DB,
                             with_k2, prob, lanes, ref_masks),
        "turbo": run_lane("turbo", "set12_csmri_turbo_tuned.json", 4000.0, 1.0,
                          BM3DParams(search=8, search_step=2, matcher="pallas",
                                     match_dtype="bfloat16"),
                          TURBO_FLOOR_DB, with_k2, prob, lanes, ref_masks),
        "turbo4": run_lane("turbo4", "set12_csmri_turbo4_tuned.json", 4000.0, 1.5,
                           BM3DParams(search=8, search_step=4, matcher="pallas",
                                      match_dtype="bfloat16"),
                           TURBO4_FLOOR_DB, with_k2 | {"bm3d_aggregate": 0}, prob, lanes,
                           ref_masks),
        "csmri_nlm": run_nlm_lane(),
        "csmri_nlm_grid": run_nlm_grid(),
    }

    for label, tuned, default_eta, default_mod, params in (
        ("headline", "set12_csmri_tuned.json", 6000.0, 1.0,
         BM3DParams(search=8, match_dtype="bfloat16")),
        ("turbo4", "set12_csmri_turbo4_tuned.json", 4000.0, 1.5,
         BM3DParams(search=8, search_step=4, matcher="pallas", match_dtype="bfloat16")),
    ):
        eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cuda")
        den = BM3DDenoiser(sigma_modifier=mod, params=params)
        gen = torch.Generator(device="cuda").manual_seed(3)
        phase_profile(label, lambda: pnp_svrg(prob, den, eta, N_OUTER, T2, MINI_BATCH, generator=gen))
    nprob, nden, neta, ncfg = nlm_lane()
    ngen = torch.Generator(device="cuda").manual_seed(3)
    phase_profile("csmri_nlm", lambda: pnp_svrg(nprob, nden, neta, N_OUTER, T2, MINI_BATCH,
                                                generator=ngen, lr_decay=ncfg["lr_decay"]))
    gprob, gden, geta, _ = nlm_grid()
    ggen = torch.Generator(device="cuda").manual_seed(3)
    phase_profile("csmri_nlm_grid",
                  lambda: pnp_svrg(gprob, gden, geta, N_OUTER, T2, MINI_BATCH, generator=ggen))

    # K3's times are at B = 9, so its launches are the grid lane's (B = 9);
    # its B = 1 record (csmri_nlm) stands beside them.
    main_lane = {"bm3d_match": "headline", "bm3d_aggregate": "headline", "nlm": "csmri_nlm_grid"}
    kernels = []
    for rec in (k1, k2, k3):
        name = rec["name"]
        src, replaces = SOURCES[name]
        by_lane = {lane: r["launches"][name] for lane, r in lanes_run.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": by_lane[main_lane[name]], "launches_by_lane": by_lane,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "card": dev["nvidia_smi"],
        })
    kernels[-1]["b1"] = {"launches": lanes_run["csmri_nlm"]["launches"]["nlm"],
                         **{k: k3["b1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")), f"{k['name']} times")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
