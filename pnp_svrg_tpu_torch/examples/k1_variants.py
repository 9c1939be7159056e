"""Time K1's block-8 tile kernel against the design it replaced, and against
variants of its source, on the card.

    python -m pnp_svrg_tpu_torch.examples.k1_variants

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
the card's name and power limit. Variants build into
``build/pnp_svrg_tpu_torch/variants/`` with the port's ``nvcc`` flags. Needs
a CUDA card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess

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
        ("        ref2[xx / 2] = pair_at(search + lane, search)[xx / 2];",
         "        ref2[xx / 2] = pack_bf16x2(ref_at[xx], ref_at[xx + 1]);"),
        ("          sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);",
         "          sq_terms2<1>(ref2[xx / 2], pack_bf16x2(cand[xx], cand[xx + 1]), 0.f, 0.f, 0.f, 0.f, t[xx], "
         "t[xx + 1]);"),
    ],
}
SHAPES = {"profile_ht": (19, 16, "input"), "profile_wiener": (19, 32, "basic"), "search24": (24, 16, "input")}
REPS = 50
NEAR_TIE = 2 * 63 * 2.0**-24  # 8 x 8 terms a distance, summed in two orders


def build_variants() -> tuple:
    """(name -> the tile kernel's bound entry in each variant's library,
    name -> ptxas's output of its build)."""
    src = (_build.SRC_DIR / "bm3d_match.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ({"built": []} | VARIANTS).items():  # "built" for ptxas's lines only
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in the source")
            text = text.replace(old, new)
        cu = out_dir / f"bm3d_match_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"bm3d_match_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{logs[name]}")
        if name != "built":
            fns[name] = k1.bind(ctypes.CDLL(str(so)))["bm3d_match_tile_kernel"]
    return fns, logs


def tile_ptxas(log: str) -> dict:
    """ptxas's register and spill lines for each instantiation of the tile
    kernel in a build's output, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "bm3d_match_tile_kernel" in ln else None
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA card")
    built = k1._lib()
    variants, logs = build_variants()
    fns = {"tile": ("bm3d_match_tile_kernel", built["bm3d_match_tile_kernel"]),
           "any": ("bm3d_match_any_kernel", built["bm3d_match_any_kernel"])}
    fns |= {name: ("bm3d_match_tile_kernel", fn) for name, fn in variants.items()}
    fns["ascending"] = fns["tile"]
    imgs = lane_inputs()
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"ptxas": {name: tile_ptxas(log) for name, log in logs.items()}}), flush=True)
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
