"""Time K1's tile and span kernels against the design they replaced, and
against variants of their source, on the card.

    python -m pnp_svrg_tpu_torch.examples.k1_variants [--part tile|span|rank|rt|parts]

Part ``tile`` (block 8).

The shapes are the reference BM3D profile's two K1 settings on the
bm3d_profile lane's real inputs (the headline batch, B = 13 at 128 px, after
the lane's first PnP-SVRG step): block 8, step 3, search 19 (1,521
offsets), ``bf16_xla``, with 16 matches on the first denoise input
(``profile_ht``) and 32 on its stage-1 estimate (``profile_wiener``); and
search 24 (2,401 offsets, 16 matches, ``search24``). At each,
``bm3d_match_tile_kernel`` ("tile") and ``bm3d_match_any_kernel`` ("any",
through its own entry ``bm3d_match_any_launch``) are timed in turns (tile,
any, any, tile), then each variant of ``csrc/bm3d_match.cu`` beside the tile
kernel (variant, tile, tile, variant): ``four_warps`` (``kTileWarps = 4``),
``chunk_32`` and ``chunk_128`` (``kChunk``), ``two_ctas`` (launch bounds
asking ptxas for two CTAs an SM, not three), ``f32_region`` (mode 1 stages
its region as f32 and packs each bf16 pair where it uses it, not as packed
pairs), and ``ascending``, the built kernel visiting the offsets in
ascending index order, not nearest the window's centre first
(``visit_order``). Each timing is the summed device
records of 50 calls under ``torch.profiler`` (and their count a call, which
shows a lost record). Each build is held to the plain version first: the
multiset agreement of each block's matches, and slot by slot the same offset
or a near-tie (two distances within 2 x 63 x 2**-24 of each other). Prints
one JSON line a shape, then ptxas's lines for each build's tile kernel and
the card's name and power limit.

Part ``span`` (every other block): ``bm3d_match_span_kernel`` ("span") at
``chip_smoke.py``'s K1 rows off block 8 (:data:`SPAN_ROWS`: block, step,
search, k) on the same first denoise input, held to the plain version in
every mode (the rules above, with the near-tie of the block's own terms;
and equal on dyadic images), then timed against the any-kernel ("any") in
turns (span, any, any, span) in ``bf16_xla`` and in ``f32``, and beside
each of :data:`SPAN_VARIANTS` of its source (variant, span, span, variant;
in ``f32`` for the ``f32_`` ones, else in ``bf16_xla``): ``two_ctas`` (launch bounds asking for two CTAs an SM, not
three), ``warp_merge`` (k up to 8 merged as k 16 and more are, a warp a
block with a ballot, not a thread a block), ``f32_ref_registers`` (modes 0
and 2 keep the reference row in registers for a chunk, not read it from
shared memory for each offset), ``chunk_128`` (``kChunk``), ``ascending`` (the offsets in
ascending index order) and ``half_tiles`` (tiles of at most half the
blocks :func:`span_most` allows: more, smaller CTAs). Each row's line also
carries the plain version's time (CUDA events over 10 calls), the bounds
(``chip_smoke.match_bounds``) and the plan.

Part ``rank`` (k 128): ``bm3d_match_tile_kernel`` at the ``k128`` row
(block 8, step 3, search 19, on the stage-1 estimate) and
``bm3d_match_span_kernel`` at ``block4_k128`` (block 4, step 2, search
19), each merging by ranks ("new"), against the four-slot design each
replaced ("replaced": ``bm3d_match_tile_slots_kernel``,
``bm3d_match_span_serial_kernel``) in turns (new, replaced, replaced, new),
then beside :data:`RANK_VARIANTS` (variant, new, new, variant): the tile
kernel on tiles of 81 blocks (``one_cta``: one CTA an SM, its plan before)
or of as many as let two CTAs share an SM (``two_ctas``; :func:`k1.tile_most`
takes three), and the source with chunks of 128 offsets (``chunk_128``).

Part ``rt`` (block 1 and 17-32): ``bm3d_match_pixel_kernel`` at ``block1``
(step 1, search 3, k 4), ``bm3d_match_span_rt_kernel`` at ``block24`` (step
12, search 8, k 16), ``block17`` (step 1, search 5, k 16) and ``block1_k16``,
against ``bm3d_match_span_serial_kernel`` (the serial run-time phase 1) in
turns, block 1 also against the run-time span kernel at k 4 (``span_rt``:
the span kernel's distance buffer and thread merge, a warp an offset), and
beside :data:`RT_VARIANTS`: launch bounds asking for two or four CTAs an
SM, not three (``rt_two_ctas``, ``rt_four_ctas``), every tile through the chunks and the
several-column trees (``no_one_column``: no one-block path, no one-column
tree), and a one-block tile's warp forming one offset at a time, not two
(``one_in_flight``), and a one-block tile reading its reference row's bf16
pairs from shared memory for each offset, not holding them in registers
(``ref_in_smem``). Both parts hold every name to the plain version in
every mode first and time in ``bf16_xla``, each timing by
``chip_smoke.device_ms`` (profiler windows, which tolerate a lost record)
and by CUDA events (``event_ms``).

Part ``parts`` (the windows staged in parts): ``search32`` (block 8,
step 3, search 32), ``search_widest`` (search 95, 36,481 offsets) and
``block4_s40`` (block 4, step 2, search 40), k 16, on the first denoise
input (:data:`PART_ROWS`): the plan the call takes ("plan":
:meth:`k1.MatchGeometry.tile` / ``.span`` with the reach) against the
one-part plan, the design it replaced ("one_part", in turns: plan,
one_part, one_part, plan), then beside other plans (:data:`PART_PLANS`,
each on its own tiles): the parts cut where the tiles' live offsets begin
and end, split to at most w offsets an axis ("width_w"), square parts of
edge e, the centre one centred ("square_e"), and bands of e dy values
across the whole dx range ("band_e"); and beside :data:`PART_VARIANTS` of the
source (``no_dead_parts``: every part visited; ``host_made``: the
dead-part test read from bits the host adds to each part's row of the
table, :func:`host_made_table`, not made in the kernel). Each is held to
the plain version first (all three modes for the plan and the one-part
plan, ``bf16_xla`` for the rest); each line carries per name the parts,
cut points, blocks a tile, tiles, shared memory and the host's cost of its
visits (:meth:`k1.MatchGeometry.visit_cost`).

Parts ``tile`` and ``span`` run by default. Variants build into
``build/pnp_svrg_tpu_torch/variants/`` with the port's ``nvcc`` flags.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess

import numpy as np

import torch

from pnp_svrg_tpu_torch.convert import BM3D_PROFILE_LANE, lane_params, load_headline_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import _ref_grid, search_offsets, stage1_aggregate_inputs
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.utils.io import DATA_DIR

VARIANTS = {  # name -> [(text of the built source, its replacement), ...]
    "four_warps": [("constexpr int kTileWarps = 8;", "constexpr int kTileWarps = 4;")],
    "chunk_32": [("constexpr int kChunk = 64;", "constexpr int kChunk = 32;")],
    "chunk_128": [("constexpr int kChunk = 64;", "constexpr int kChunk = 128;")],
    "two_ctas": [("__launch_bounds__(kTileWarps * 32, 3)", "__launch_bounds__(kTileWarps * 32, 2)")],
    "f32_region": [  # mode 1 stages f32 values rounded to bf16 and packs each pair where it is used
        ("  if (MODE == 1) {\n    const int half = reg_n / 2;", "  if (false) {\n    const int half = reg_n / 2;"),
        ("      region[(q / reg_n) * pitch + q % reg_n] = pixel(ry0 - search + q / reg_n, rx0 - search + q % reg_n);",
         "      region[(q / reg_n) * pitch + q % reg_n] = MODE == 1 ? round_bf16(pixel(ry0 - search + q / reg_n, "
         "rx0 - search + q % reg_n)) : pixel(ry0 - search + q / reg_n, rx0 - search + q % reg_n);"),
        ("          ref2[xx / 2] = pair_at(search + lane, search)[xx / 2];",
         "          ref2[xx / 2] = pack_bf16x2(ref_at[xx], ref_at[xx + 1]);"),
        ("            sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);",
         "            sq_terms2<1>(ref2[xx / 2], pack_bf16x2(cand[xx], cand[xx + 1]), 0.f, 0.f, 0.f, 0.f, t[xx], "
         "t[xx + 1]);"),
    ],
}
SPAN_VARIANTS = {
    "two_ctas": [("PNP_SPAN_KERNEL(bm3d_match_span_kernel, kSpanCompiled, 3)",
                  "PNP_SPAN_KERNEL(bm3d_match_span_kernel, kSpanCompiled, 2)")],
    "warp_merge": [("  const bool by_threads = K <= 8;", "  const bool by_threads = false;"),
                   ("      if (K <= 4)\n        merge_chunk_threads<4>", "      if (false)\n        merge_chunk_threads<4>"),
                   ("      else if (K <= 8)\n        merge_chunk_threads<8>",
                    "      else if (false)\n        merge_chunk_threads<8>"),
                   ("{ return K <= 4 ? 4 : K <= 8 ? 8 : K; }", "{ return K; }")],
    "f32_ref_registers": [  # modes 0 and 2 keep the reference row in registers for the chunk
        ("  if constexpr (PAIRS) {\n#pragma unroll\n    for (int xx = 0; xx < kTileSpan; xx += 2) ref2[xx / 2]",
         "  float ref[kTileSpan];\n#pragma unroll\n  for (int xx = 0; xx < kTileSpan; ++xx) ref[xx] = ref_at[xx];\n"
         "  if constexpr (PAIRS) {\n#pragma unroll\n    for (int xx = 0; xx < kTileSpan; xx += 2) ref2[xx / 2]"),
        ("          sq_terms2<2>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx]",
         "          sq_terms2<2>(0u, 0u, ref[xx], ref[xx + 1], cand[xx]"),
        ("          sq_terms2<0>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx]",
         "          sq_terms2<0>(0u, 0u, ref[xx], ref[xx + 1], cand[xx]")],
    "chunk_128": [("constexpr int kChunk = 64;", "constexpr int kChunk = 128;")],
}
RANK_VARIANTS = {"chunk_128": [("constexpr int kChunk = 64;", "constexpr int kChunk = 128;")]}
PART_VARIANTS = {
    "no_dead_parts": [("  return ry0 + __ldg(pt + 2) <= cand_hi", "  return true || ry0 + __ldg(pt + 2) <= cand_hi")],
    # The dead-part test made on the host: each part's row of the table
    # carries the row tiles and the column tiles that take it, as bits
    # (host_made_table); the kernel reads its tile's bits.
    "host_made": [("constexpr int kPartCols = 6;", "constexpr int kPartCols = 8;"),
                  ("  return ry0 + __ldg(pt + 2) <= cand_hi",
                   "  return ((__ldg(pt + 6) >> blockIdx.y) & (__ldg(pt + 7) >> blockIdx.x) & 1) != 0;\n"
                   "  (void)(ry0 + __ldg(pt + 2) <= cand_hi"),
                  ("         rx1 + __ldg(pt + 5) >= 0;", "         rx1 + __ldg(pt + 5) >= 0);")]}
# (block, step, search, k, image) of chip_smoke.py's rows the parts design
# takes, and the other plans each is timed on.
PART_ROWS = {"search32": (8, 3, 32, 16, "input"), "search_widest": (8, 3, 95, 16, "input"),
             "block4_s40": (4, 2, 40, 16, "input")}
PART_PLANS = {"search32": {"width": (27, 37), "square": (25,)},
              "search_widest": {"width": (19, 27), "square": (27, 49), "band": (9,)},
              "block4_s40": {"width": (21, 41), "square": (29,), "band": (5,)}}
RT_VARIANTS = {"rt_two_ctas": [("constexpr int kRtMinCtas = 3;", "constexpr int kRtMinCtas = 2;")],
               "rt_four_ctas": [("constexpr int kRtMinCtas = 3;", "constexpr int kRtMinCtas = 4;")],
               "no_one_column": [("  const bool one_col = p.cmask == 1u;", "  const bool one_col = false;"),
                                 ("    if (block > 16 && nt == 1 && K <= 32) {", "    if (false) {")],
               "one_in_flight": [("constexpr int kOneInFlight = 2;", "constexpr int kOneInFlight = 1;")],
               "ref_in_smem": [  # a one-block tile reads its reference pairs from shared memory, not registers
                   ("  unsigned ref2[PAIRS ? kTileSpan / 2 : 1];\n  if constexpr (PAIRS) {\n#pragma unroll\n"
                    "    for (int xx = 0; xx < kTileSpan; xx += 2)\n      ref2[xx / 2] = p.pairs[((p.search & 1) * "
                    "p.reg_n + p.search + lane) * p.pp + (p.search >> 1) + xx / 2];\n  }",
                    "  const unsigned* ref2 = p.pairs + ((p.search & 1) * p.reg_n + p.search + lane) * p.pp + "
                    "(p.search >> 1);")]}
# (block, step, search, k, image) of chip_smoke.py's rows for the parts
# rank and rt (and two more off the lanes' settings).
RANK_ROWS = {"k128": (8, 3, 19, 128, "basic"), "block4_k128": (4, 2, 19, 128, "basic")}
RT_ROWS = {"block1": (1, 1, 3, 4, "input"), "block24": (24, 12, 8, 16, "input"), "block17": (17, 1, 5, 16, "input"),
           "block1_k16": (1, 1, 3, 16, "input")}
SHAPES = {"profile_ht": (19, 16, "input"), "profile_wiener": (19, 32, "basic"), "search24": (24, 16, "input")}
# chip_smoke.ENVELOPE_K1's rows off block 8: (block, step, search, k).
SPAN_ROWS = {"golden": (4, 2, 3, 4), "block2": (2, 1, 3, 4), "block5": (5, 2, 4, 8), "block6": (6, 3, 6, 8),
             "block16": (16, 8, 8, 16), "block4_s19": (4, 2, 19, 16)}
REPS = 50
NEAR_TIE = 2 * 63 * 2.0**-24  # 8 x 8 terms a distance, summed in two orders


def build_variants(variants: dict, kernel: str | None) -> tuple:
    """(name -> ``kernel``'s bound entry in each variant's library, or with
    ``kernel`` None every entry it has (:func:`k1.bind`), name -> ptxas's
    output of its build)."""
    src = (_build.SRC_DIR / "bm3d_match.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ({"built": []} | variants).items():  # "built" for ptxas's lines only
        text = src
        for old, new in edits:
            if old not in text:  # an edit of a shared helper or line changes both kernels
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{kernel or 'all'}_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{kernel or 'all'}_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{logs[name]}")
        if name != "built":
            bound = k1.bind(ctypes.CDLL(str(so)))
            fns[name] = bound if kernel is None else bound[kernel]
    return fns, logs


def kernel_ptxas(log: str, kernel: str = "bm3d_match_tile_kernel") -> dict:
    """ptxas's register and spill lines for each instantiation of
    ``kernel`` in a build's output, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = out.get(name, "") + ln.strip() + "; "
    return out


def first_input() -> tuple:
    """The bm3d_profile lane's first denoise input (``x_init`` after its
    first step, ``v = mu`` there, B = 13 at 128 px), the sigma its BM3D
    takes there and the lane's BM3D parameters."""
    prob, lanes = load_headline_problems("cuda")
    tuned, default_eta, default_mod, params = BM3D_PROFILE_LANE
    eta, mod = lane_params(DATA_DIR / tuned, lanes, default_eta, default_mod, device="cuda")
    x = prob.x_init.reshape(prob.batch_size, -1)
    z = (x - eta[:, None] * prob.grad_full(x).reshape(x.shape)).reshape(prob.x_init.shape).contiguous()
    return z, estimate_sigma(z) * mod, params


def lane_inputs() -> dict:
    """:func:`first_input`'s image and the stage-1 estimate of the lane's
    BM3D on it."""
    z, sigma, params = first_input()
    basic, _ = stage1_aggregate_inputs(z, sigma, params)
    return {"input": z, "basic": basic.contiguous()}


def device_ms(fn) -> tuple:
    """(summed device time of one call of ``fn`` over :data:`REPS` calls,
    device records per call)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    records = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in records) / REPS / 1e3, len(records) / REPS


def held_to_plain(got: torch.Tensor, want: torch.Tensor, dists: torch.Tensor) -> dict:
    """The K1 rules: multiset agreement, the largest relative gap between
    the distances where the two put different offsets in a slot, and the
    invalid candidates each picked."""
    k, s = got.shape[-1], dists.shape[-1]
    count = lambda t: torch.zeros(t.numel() // k, s, device=t.device).scatter_add_(  # noqa: E731
        1, t.reshape(-1, k).long(), torch.ones(t.numel() // k, k, device=t.device))
    dg, dw = (dists.gather(-1, t.long()) for t in (got, want))
    gap = torch.nan_to_num((dg - dw).abs() / torch.maximum(dg, dw), nan=0.0)
    gap = torch.where(torch.isinf(dg) | torch.isinf(dw), torch.inf, gap)
    return {"multiset_agreement": float(torch.minimum(count(got), count(want)).sum(1).mean() / k),
            "max_rel_gap": torch.where(got == want, 0.0, gap).max().item(),
            "equal_share": float((got == want).float().mean()),
            "invalid_picked": int(torch.isinf(dg).sum()), "plain_invalid_picked": int(torch.isinf(dw).sum())}


def time_tile(imgs: dict) -> dict:
    """Part ``tile``: prints a line a shape; returns ptxas's lines."""
    built = k1._lib()
    variants, logs = build_variants(VARIANTS, "bm3d_match_tile_kernel")
    fns = {"tile": ("bm3d_match_tile_kernel", built["bm3d_match_tile_kernel"]),
           "any": ("bm3d_match_any_kernel", built["bm3d_match_any_kernel"])}
    fns |= {name: ("bm3d_match_tile_kernel", fn) for name, fn in variants.items()}
    fns["ascending"] = fns["tile"]
    mode = "bf16_xla"
    for label, (search, k, which) in SHAPES.items():
        x = imgs[which]
        b, h, w = x.shape
        rows = _ref_grid(h, 8, 3)
        offs = search_offsets(search, 1)
        g = k1.match_geometry(rows, rows, offs, 8, x.device)
        ascending = torch.arange(len(offs), dtype=torch.int32, device=x.device)
        geoms = {"ascending": dataclasses.replace(g, tile_order=ascending, tile_offsets=g.offsets_t)}
        want = k1.bm3d_match_plain(x, rows, rows, offs, 8, k, mode)
        dists = k1.match_distances_plain(x, rows, rows, offs, 8, mode)

        def call(name, x=x, g=g, k=k, geoms=geoms):
            kernel, fn = fns[name]
            out = torch.empty((b, len(rows), len(rows), k), dtype=torch.int32, device=x.device)
            k1.launch(kernel, fn, x, geoms.get(name, g), out, 8, k, mode, 0, h)
            return out

        rec = {"shape": label, "images": [b, h, w], "offsets": len(offs), "k": k, "mode": mode,
               "dispatch": k1.match_kernel(g, 8, k), "tile_smem_bytes": g.tile_smem_bytes(k),
               "tiles": [g.row_tiles.shape[0], g.col_tiles.shape[0]]}
        for name in fns:
            rec[name] = held_to_plain(call(name), want, dists)
            rec[name]["near_tie_ok"] = rec[name]["max_rel_gap"] <= NEAR_TIE
        times = {name: [] for name in fns}
        for name in ("tile", "any", "any", "tile"):
            times[name].append(device_ms(lambda name=name: call(name)))
        for name in [*variants, "ascending"]:
            for v in (name, "tile", "tile", name):
                times[v].append(device_ms(lambda v=v: call(v)))
        for name in fns:
            rec[name]["ms"] = [t for t, _ in times[name]]
            rec[name]["records_a_call"] = [r for _, r in times[name]]
        print(json.dumps(rec), flush=True)
    return {name: kernel_ptxas(log) for name, log in logs.items()}


def plain_ms(fn, reps: int = 10) -> float:
    """CUDA events over ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_span(imgs: dict) -> dict:
    """Part ``span``: prints a line a row; returns ptxas's lines."""
    from chip_smoke import match_bounds, near_tie

    built = k1._lib()
    variants, logs = build_variants(SPAN_VARIANTS, "bm3d_match_span_kernel")
    fns = {"span": ("bm3d_match_span_kernel", built["bm3d_match_span_kernel"]),
           "any": (k1.PREV_DESIGN, built[k1.PREV_DESIGN])}
    fns |= {name: ("bm3d_match_span_kernel", fn) for name, fn in variants.items()}
    fns["ascending"] = fns["half_tiles"] = fns["span"]
    x = imgs["input"]
    b, h, w = x.shape
    dyadic = torch.tensor((0.25 * np.random.default_rng(16).integers(0, 5, (b, h, w))).astype(np.float32),
                          device=x.device)
    for label, (block, step, search, k) in SPAN_ROWS.items():
        rows = _ref_grid(h, block, step)
        offs = search_offsets(search, 1)
        g = k1.match_geometry(rows, rows, offs, block, x.device)
        ascending = torch.arange(len(offs), dtype=torch.int32, device=x.device)
        half = k1.span_plan(rows, rows, block, search, k, x.device, most=max(1, k1.span_most(search, k) // 2))
        geoms = {"ascending": dataclasses.replace(g, tile_order=ascending, tile_offsets=g.offsets_t, plans={}),
                 "half_tiles": dataclasses.replace(g, plans={k: half})}

        def call(name, mode, img=x, rows=rows, g=g, k=k, block=block, geoms=geoms):
            kernel, fn = fns[name]
            out = torch.empty((b, len(rows), len(rows), k), dtype=torch.int32, device=img.device)
            k1.launch(kernel, fn, img, geoms.get(name, g), out, block, k, mode, 0, h)
            return out

        plan = g.span(k)
        rec = {"row": label, "images": [b, h, w], "block": block, "step": step, "offsets": len(offs), "k": k,
               "dispatch": k1.match_kernel(g, block, k), "span_smem_bytes": plan.smem_bytes,
               "blocks_a_tile": plan.most, "tiles": [plan.row_tiles.shape[0], plan.col_tiles.shape[0]],
               "near_tie": near_tie(block), **match_bounds(b, h, w, rows, rows, offs, block=block, k=k)}
        for mode in k1.MODES:
            want = k1.bm3d_match_plain(x, rows, rows, offs, block, k, mode)
            dists = k1.match_distances_plain(x, rows, rows, offs, block, mode)
            names = fns if mode != "bf16_pallas" else ("span", "any")
            rec[mode] = {name: held_to_plain(call(name, mode), want, dists) for name in names}
            exact = torch.equal(call("span", mode, dyadic),
                                k1.bm3d_match_plain(dyadic, rows, rows, offs, block, k, mode))
            rec[mode]["span"]["exact_on_dyadic"] = exact
            for name in names:
                rec[mode][name]["near_tie_ok"] = rec[mode][name]["max_rel_gap"] <= near_tie(block)
        for mode in ("bf16_xla", "f32"):
            times = {name: [] for name in fns}
            for name in ("span", "any", "any", "span"):
                times[name].append(device_ms(lambda name=name: call(name, mode)))
            for name in [*variants, "ascending", "half_tiles"]:
                if name.startswith("f32_") == (mode == "f32"):  # the f32 path's variants in f32, the rest in bf16
                    for v in (name, "span", "span", name):
                        times[v].append(device_ms(lambda v=v: call(v, mode)))
            for name, t in times.items():
                if t:
                    rec[mode][name]["ms"] = [v for v, _ in t]
                    rec[mode][name]["records_a_call"] = [r for _, r in t]
            rec[mode]["plain_ms"] = plain_ms(lambda: k1.bm3d_match_plain(x, rows, rows, offs, block, k, mode))
        print(json.dumps(rec), flush=True)
    return {name: kernel_ptxas(log, "bm3d_match_span_kernel") for name, log in logs.items()}


def time_against_replaced(imgs: dict, rows: dict, extra: dict, variants: dict, plans) -> dict:
    """Parts ``rank`` and ``rt``: each row's kernel ("new") against the
    design it replaced and ``extra`` (name -> kernel launched by name), and
    beside each variant: source ``variants`` built, and ``plans(label, g, k,
    search)`` -> {name: plan} (the kernel's own on other tiles). Prints a
    line a row; returns ptxas's lines of the variants' builds."""
    from chip_smoke import cuda_ms, device_ms as window_ms, match_bounds, near_tie

    built = k1._lib()
    var_fns, logs = build_variants(variants, None)
    for label, (block, step, search, k, which) in rows.items():
        x = imgs[which]
        b, h, w = x.shape
        rows_ = _ref_grid(h, block, step)
        offs = search_offsets(search, 1)
        g = k1.match_geometry(rows_, rows_, offs, block, x.device)
        kernel = k1.match_kernel(g, block, k)
        fns = {"new": (kernel, built[kernel], g), "replaced": (k1.prev_design(kernel, k), None, g)}
        fns |= {name: (kern, None, g) for name, kern in extra.get(label, {}).items()}
        if kernel != "bm3d_match_pixel_kernel":  # the variants edit the tile and span kernels
            fns |= {name: (kernel, bound[kernel], g) for name, bound in var_fns.items()}
        for name, plan in plans(label, g, k, search).items():
            key = ("tile", k, search) if kernel == "bm3d_match_tile_kernel" else (k, search)
            fns[name] = (kernel, built[kernel], dataclasses.replace(g, plans={key: plan}))

        def call(name, mode, img=x, fns=fns, rows_=rows_, k=k, block=block):
            kern, fn, geom = fns[name]
            out = torch.empty((b, len(rows_), len(rows_), k), dtype=torch.int32, device=img.device)
            k1.launch(kern, fn or built[kern], img, geom, out, block, k, mode, 0, h)
            return out

        rec = {"row": label, "images": [b, h, w], "block": block, "step": step, "offsets": len(offs), "k": k,
               "kernel": kernel, "replaced": fns["replaced"][0], "near_tie": near_tie(block),
               "plans": {name: [fns[name][2].tile(k).most if kernel == "bm3d_match_tile_kernel" else
                                fns[name][2].span(k).most] for name in fns if name in ("new",) or name in
                         plans(label, g, k, search)},
               **match_bounds(b, h, w, rows_, rows_, offs, block=block, k=k)}
        for mode in k1.MODES:
            want = k1.bm3d_match_plain(x, rows_, rows_, offs, block, k, mode)
            dists = k1.match_distances_plain(x, rows_, rows_, offs, block, mode)
            rec[mode] = {name: held_to_plain(call(name, mode), want, dists) for name in fns}
            for name in fns:
                rec[mode][name]["near_tie_ok"] = rec[mode][name]["max_rel_gap"] <= near_tie(block)
        mode = "bf16_xla"
        order = ["new", "replaced", "replaced", "new"] + [v for name in fns if name not in ("new", "replaced")
                                                          for v in (name, "new", "new", name)]
        ms = {name: [] for name in fns}
        events = {name: [] for name in fns}
        for v in order:  # device time by windows of the profiler (lost records tolerated), and by events
            ms[v].append(window_ms(lambda v=v: call(v, mode)))
            events[v].append(cuda_ms(lambda v=v: call(v, mode)))
        for name in fns:
            rec[mode][name]["ms"], rec[mode][name]["event_ms"] = ms[name], events[name]
        rec["plain_ms"] = plain_ms(lambda: k1.bm3d_match_plain(x, rows_, rows_, offs, block, k, mode), reps=2)
        print(json.dumps(rec), flush=True)
    return {name: {kernel: kernel_ptxas(log, kernel) for kernel in ("bm3d_match_tile_kernel", "bm3d_match_span_kernel",
                                                                    "bm3d_match_span_rt_kernel")}
            for name, log in logs.items()}


def rank_plans(label, g, k, search) -> dict:
    """The tile kernel at k 128 on tiles of 81 blocks (one CTA an SM) and of
    as many as let two share an SM."""
    if g.block != 8:
        return {}
    two = max(m for m in range(1, k1.TILE_MAX + 1) if k1.tile_smem_bytes(search, k, m) <= k1.TILE_BUDGETS[1])
    out = {}
    for name, most in (("one_cta", k1.TILE_MAX), ("two_ctas", two)):
        rt, ct, used = k1._cut(g.rows, g.cols, 8, most)
        out[name] = k1._plan(rt, ct, used, k1.tile_smem_bytes(search, k, used), g.rows_t.device)
    return out


def square_cuts(offsets, edge: tuple) -> tuple:
    """Cut points of bands of ``edge`` = (dy, dx) values along each axis of
    ``offsets``, the centre band from -(edge // 2): square parts, the
    centre part centred."""
    offs = np.asarray(offsets).reshape(-1, 2)
    return tuple(tuple(range(-(e // 2) + e * -(-(int(offs[:, a].min()) + e // 2) // e), int(offs[:, a].max()) + 1, e))
                 for a, e in enumerate(edge))


def host_made_table(g, plan, h: int, w: int):
    """``plan`` with its parts table widened by two columns for the
    ``host_made`` variant: the bits of the row tiles whose rows plus the
    part's dy reach the image's candidate rows, and of the column tiles
    whose columns plus its dx reach its columns (the two halves of
    :func:`k1.parts_live`, on the whole image)."""
    t = plan.parts.table.cpu().numpy().astype(np.int64)
    bits = [sum(((first + t[:, lo] <= last_c) & (last + t[:, lo + 1] >= 0)).astype(np.int64) << i
                for i, (first, last) in enumerate(g._spans(tiles, grid)))
            for tiles, grid, lo, last_c in ((plan.row_tiles, g.rows, 2, h - g.block),
                                             (plan.col_tiles, g.cols, 4, w - g.block))]
    wide = np.concatenate([t, np.stack(bits, 1)], 1).astype(np.int32)
    table = torch.as_tensor(np.ascontiguousarray(wide), device=plan.row_tiles.device)
    return dataclasses.replace(plan, parts=dataclasses.replace(plan.parts, table=table))


def time_parts(imgs: dict) -> dict:
    """Part ``parts``: prints a line a row; returns ptxas's lines of the
    variants' builds."""
    from chip_smoke import cuda_ms, device_ms as window_ms, match_bounds, near_tie

    built = k1._lib()
    var_fns, logs = build_variants(PART_VARIANTS, None)
    for label, (block, step, search, k, which) in PART_ROWS.items():
        x = imgs[which]
        b, h, w = x.shape
        rows = _ref_grid(h, block, step)
        offs = search_offsets(search, 1)
        g = k1.match_geometry(rows, rows, offs, block, x.device)
        kernel = k1.match_kernel(g, block, k)
        r = g.reach(h, w)
        tile = kernel == "bm3d_match_tile_kernel"
        plans = {"plan": g.tile(k, reach=r) if tile else g.span(k, reach=r),
                 "one_part": g.tile(k, r.search) if tile else g.span(k, r.search)}
        for form, edges in PART_PLANS[label].items():
            for e in edges:
                cuts = (None if form == "width" else
                        square_cuts(r.host[0], (e, e) if form == "square" else (e, 2 * r.search + 1)))
                plans[f"{form}_{e}"] = g.tile_parts(k, r, e, cuts) if tile else g.span_parts(k, r, e, cuts)
        fns = {name: (built[kernel], plan) for name, plan in plans.items()}
        if plans["plan"].parts is not None:  # the variants edit the parts path
            fns |= {name: (bound[kernel], host_made_table(g, plans["plan"], h, w) if name == "host_made" else
                           plans["plan"]) for name, bound in var_fns.items()}

        def call(name, mode, fns=fns, rows=rows, k=k, block=block, g=g, x=x):
            fn, plan = fns[name]
            out = torch.empty((b, len(rows), len(rows), k), dtype=torch.int32, device=x.device)
            k1.launch(kernel, fn, x, g, out, block, k, mode, 0, h, plan=plan)
            return out

        def describe(p):
            table = None if p.parts is None else p.parts.table.cpu().numpy()
            return {"parts": 0 if p.parts is None else len(table), "cuts": None if p.parts is None else p.parts.cuts,
                    "blocks_a_tile": p.most, "tiles": [len(p.row_tiles), len(p.col_tiles)],
                    "smem_bytes": p.smem_bytes, "ctas_per_sm_by_smem": (228 * 1024) // (p.smem_bytes + 1024),
                    "visit_cost": g.visit_cost(p.row_tiles, p.col_tiles, table, r)}

        rec = {"row": label, "images": [b, h, w], "block": block, "step": step, "offsets": len(offs), "k": k,
               "kernel": kernel, "near_tie": near_tie(block), "plans": {n: describe(p) for n, p in plans.items()},
               **match_bounds(b, h, w, rows, rows, offs, block=block, k=k)}
        for mode in k1.MODES:
            want = k1.bm3d_match_plain(x, rows, rows, offs, block, k, mode)
            dists = k1.match_distances_plain(x, rows, rows, offs, block, mode)
            names = fns if mode == "bf16_xla" else ("plan", "one_part")
            rec[mode] = {name: held_to_plain(call(name, mode), want, dists) for name in names}
            for name in names:
                rec[mode][name]["near_tie_ok"] = rec[mode][name]["max_rel_gap"] <= near_tie(block)
        mode = "bf16_xla"
        order = ["plan", "one_part", "one_part", "plan"] + [v for name in fns if name not in ("plan", "one_part")
                                                            for v in (name, "plan", "plan", name)]
        ms = {name: [] for name in fns}
        events = {name: [] for name in fns}
        for v in order:
            ms[v].append(window_ms(lambda v=v: call(v, mode), reps=10 if v == "one_part" else 50))
            events[v].append(cuda_ms(lambda v=v: call(v, mode), reps=10 if v == "one_part" else 50, warmup=3))
        for name in fns:
            rec[mode][name]["ms"], rec[mode][name]["event_ms"] = ms[name], events[name]
        print(json.dumps(rec), flush=True)
    return {name: {kern: kernel_ptxas(log, kern) for kern in ("bm3d_match_tile_kernel", "bm3d_match_span_kernel")}
            for name, log in logs.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("tile", "span", "rank", "rt", "parts"), action="append")
    parts = ap.parse_args(argv).part or ["tile", "span"]
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA card")
    imgs = lane_inputs()
    run = {"tile": time_tile, "span": time_span,
           "rank": lambda im: time_against_replaced(im, RANK_ROWS, {}, RANK_VARIANTS, rank_plans),
           "rt": lambda im: time_against_replaced(im, RT_ROWS, {"block1": {"span_rt": "bm3d_match_span_rt_kernel"}},
                                                  RT_VARIANTS, lambda *a: {}),
           "parts": time_parts}
    ptxas = {part: run[part](imgs) for part in parts}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"ptxas": ptxas}), flush=True)
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
