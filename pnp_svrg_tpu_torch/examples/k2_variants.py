"""Time K2's design choices on the card.

    python -m pnp_svrg_tpu_torch.examples.k2_variants [--part compiled|runtime] [--row NAME ...]

Part ``runtime``: the run-time path, every call but block 8 with K 16 or
32, at the rows ``chip_smoke.py`` checks (:data:`ROWS`: block, step,
search, K) on the bm3d_profile lane's first denoise input (B = 13, 128 px):
``bm3d_aggregate_packed_kernel`` on its plan (``packed``), the design it
replaced, ``bm3d_aggregate_kernel<0, 0>`` on 2 x 2 tiles (``prev``), and one
``index_add_`` of the per-pixel terms into zeroed planes (``index_add``),
in turns (packed, prev, index_add, index_add, prev, packed); then the
packed kernel on other plans beside its own (variant, packed, packed,
variant): each tile edge and warps a CTA of :data:`TILE_EDGES` x
:data:`WARPS` (``tile_<edge>_w<warps>``) and other lane groups a warp
(``groups_<n>``; ``groups_1`` packs no lanes: a member a warp, the rest of
its lanes idle), and :data:`PACKED_VARIANTS` of its source on its plan.
Each
kernel and plan is held to the plain version first: within 1e-5 of the
planes' magnitude, bit for bit on dyadic values, and 20 calls bit for bit
the first. Prints one JSON line a row, then ptxas's registers and spills
for each packed instantiation.

Part ``compiled``: the (8, 16) kernel beside variants of its source that
change one constant: ``two_warps`` (``kWarps = 2``, the warp count before
the fixed-order fold), ``fold_streams`` (the fold adds as it loads at every
size), ``fold_all_at_once`` (the fold issues all of a pixel's loads first
at every size) and ``lane_tests`` (the tile kernel tests at every block
whether a lane owns each patch value, as it must where block^2 is not a
multiple of 32). Each is built with the port's ``nvcc`` flags into
``build/pnp_svrg_tpu_torch/variants/`` and called through the same entry
point as the kernel. The arguments are real stage-1 BM3D aggregations at
the shapes ``chip_smoke.py`` checks: the headline batch (B = 13, 128 px),
one 128 px image, one 256 px image and 36 lanes at 128 px. Prints one
JSON line a shape: each build's device ms, whether 20 calls repeat the
first bit for bit, and its largest difference from the built kernel (0
for the fold variants, whose order of adds is the built kernel's).

Every time is the summed device records of 50 calls under
``torch.profiler``. Both parts run by default; the last line is the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import math
import subprocess

import torch

from pnp_svrg_tpu_torch.convert import load_headline_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DParams, _ref_grid, stage1_aggregate_inputs
from pnp_svrg_tpu_torch.examples.k1_variants import first_input
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.utils.io import load_image

# Variants of the packed kernel's source, timed at the run-time rows on
# each row's plan: members in flight a warp for patches of 3-8 values a lane.
PACKED_VARIANTS = {
    "in_flight_2": ("constexpr int kInFlight = Q <= 2 ? kUnroll : 4;",
                    "constexpr int kInFlight = Q <= 2 ? kUnroll : (Q <= 4 ? 4 : 2);"),
    "in_flight_8": ("constexpr int kInFlight = Q <= 2 ? kUnroll : 4;", "constexpr int kInFlight = kUnroll;"),
}
VARIANTS = {  # name -> (text of the built source, its replacement)
    "two_warps": ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
    "fold_streams": ("constexpr long long kFewPixels = 1 << 17;", "constexpr long long kFewPixels = 0;"),
    "fold_all_at_once": ("constexpr long long kFewPixels = 1 << 17;",
                         "constexpr long long kFewPixels = 1LL << 62;"),
    "lane_tests": ("constexpr bool kFull = BLOCK > 0 && BLOCK * BLOCK % 32 == 0;",
                   "constexpr bool kFull = false;"),
}
REPS, REPEATS = 50, 20
# The run-time rows (block, step, search, K), as chip_smoke.ENVELOPE_K2 and
# ENVELOPE_K2_WIDE name them (the last two: windows past the compiled
# kernel's 2 x 2 tiles, where the replaced design does not fit either).
ROWS = {"golden": (4, 2, 3, 4), "block2": (2, 1, 3, 4), "block6": (6, 3, 6, 8),
        "block8_k8": (8, 4, 8, 8), "block16": (16, 8, 8, 16), "search40": (8, 3, 40, 32),
        "search_widest": (8, 3, 95, 16)}
TILE_EDGES, WARPS = (2, 3, 4, 5, 6, 8, 10, 12), (1, 2, 4)


def build_variants(variants: dict, kernel: str) -> dict:
    """name -> the bound entry point of ``kernel`` in each variant's library."""
    src = (_build.SRC_DIR / "bm3d_aggregate.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in variants.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        cu = out_dir / f"bm3d_aggregate_{name}.cu"
        cu.write_text(src.replace(old, new))
        so = out_dir / f"bm3d_aggregate_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{log}")
        fns[name] = k2.bind(ctypes.CDLL(str(so)))[kernel]
    return fns


def shapes() -> dict:
    """label -> the (idx, est, wgt, kaiser, h, w, geometry) of a stage-1
    aggregation at that shape."""
    prob, _ = load_headline_problems("cuda")
    x = prob.x_init.contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one(path, size):
        img = torch.as_tensor(load_image(path, size, size), device="cuda")[None]
        return (img + 0.1 * torch.randn(img.shape, generator=gen, device="cuda")).contiguous()

    inputs = {"b13_128px": x, "b1_128px": one("Set12/04.png", 128), "b1_256px": one("Set12/01.png", 256),
              "b36_128px": torch.cat([x, x, x[:10]]).contiguous()}
    params = BM3DParams(search=8)
    return {label: stage1_aggregate_inputs(img, estimate_sigma(img), params)[1]
            for label, img in inputs.items()}


def device_ms(fn) -> float:
    """Summed device time of one call of ``fn`` over :data:`REPS` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    records = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in records) / REPS / 1e3


def kernel_split(fn) -> dict:
    """Device ms of one call of ``fn`` by kernel name (the tiles, the fold),
    over :data:`REPS` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(bm3d_aggregate_\w+?)(?:<|\(|$)", e.name)
            name = name.group(1) if name else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / REPS / 1e3
    return out


def held_to_plain(call, args) -> dict:
    """K2's rules for ``call(idx, est, wgt, kai, h, w)``: within 1e-5 of the
    planes' magnitude of the plain version on ``args``, bit for bit on
    dyadic values with the same rows, and :data:`REPEATS` calls bit for bit
    the first."""
    idx, est, wgt, kai, h, w = args
    got = call(idx, est, wgt, kai, h, w)
    want = k2.bm3d_aggregate_plain(idx, est, wgt, kai, h, w)
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    gen = torch.Generator(device=idx.device).manual_seed(0)
    d_est = 0.125 * torch.randint(0, 17, est.shape, generator=gen, device=idx.device).float() - 1.0
    d_wgt = 2.0 ** torch.randint(-2, 3, wgt.shape, generator=gen, device=idx.device).float()
    d_kai = 0.25 * torch.randint(0, 5, kai.shape, generator=gen, device=idx.device).float() + 0.25
    dyadic = all(torch.equal(a, b) for a, b in zip(call(idx, d_est, d_wgt, d_kai, h, w),
                                                    k2.bm3d_aggregate_plain(idx, d_est, d_wgt, d_kai, h, w)))
    repeat = all(all(torch.equal(a, b) for a, b in zip(call(idx, est, wgt, kai, h, w), got))
                 for _ in range(REPEATS))
    return {"rel_err": err, "ok_1e-5": err <= 1e-5, "dyadic_bitwise": dyadic, "repeat_bitwise": repeat}


def index_add_call(idx, est, wgt, kai, h, w):
    """The library yardstick of ``chip_smoke.aggregate_record``: the same
    sums as one ``index_add_`` of per-pixel terms (made here, outside the
    returned call) into planes zeroed in the call."""
    b, p, bb = est.shape
    block, g = math.isqrt(bb), wgt.shape[1]
    ww = w - block + 1
    wk = wgt[..., None, None] * kai
    terms = torch.cat([(est.view(b, g, -1, bb) * wk).reshape(-1), wk.expand(b, g, p // g, bb).reshape(-1)])
    ky = torch.arange(block, device=idx.device).repeat_interleave(block)
    kx = torch.arange(block, device=idx.device).repeat(block)
    pix = ((idx.long() // ww)[..., None] + ky) * w + (idx.long() % ww)[..., None] + kx
    pix = (pix + torch.arange(b, device=idx.device)[:, None, None] * (h * w)).reshape(-1)
    flat = torch.cat([pix, pix + b * h * w])
    return lambda: torch.zeros(2 * b * h * w, device=idx.device).index_add_(0, flat, terms)


def packed_ptxas() -> dict:
    """ptxas's register and spill lines for each packed instantiation, from
    this process's build of the library (empty if it was built before)."""
    out, name = {}, None
    for ln in _build.BUILD_LOG.get("bm3d_aggregate", "").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "packed" in ln else None
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = out.get(name, "") + ln.strip() + "; "
    return out


def runtime_rows(rows) -> None:
    """Part ``runtime`` (module docstring) at ``rows`` of :data:`ROWS`."""
    fns = k2._lib()
    source = build_variants(PACKED_VARIANTS, k2.K2_KERNELS[1])
    z, sigma, _ = first_input()
    for label in rows:
        block, step, search, k = ROWS[label]
        params = BM3DParams(block=block, step=step, search=search, group_ht=k, match_dtype="bfloat16")
        idx, est, wgt, kai, h, w, geom = stage1_aggregate_inputs(z, sigma, params)[1]
        grid = tuple(_ref_grid(h, block, step).tolist())
        plans = {f"tile_{edge}_w{n}": dict(tile=edge, warps=n) for edge in TILE_EDGES for n in WARPS}
        plans |= {f"groups_{n}": dict(groups=n) for n in sorted({1, max(1, k2.lane_groups(block) // 2)})}
        own = geom.packed(k)
        packed = {"packed": own}
        for name, kw in plans.items():
            plan = k2.make_packed_plan(h, w, grid, grid, search, block, k, z.device, **kw)
            if (plan.tile, plan.warps, plan.groups) != (own.tile, own.warps, own.groups) \
                    and plan.smem_bytes <= 227 * 1024:
                packed[name] = plan

        def call(name, *a):
            if name == "prev":
                return k2.launch(k2.PREV_DESIGN, fns[k2.PREV_DESIGN], *a, geom)
            if name in source:
                return k2.launch(k2.K2_KERNELS[1], source[name], *a, geom, own)
            return k2.launch(k2.K2_KERNELS[1], fns[k2.K2_KERNELS[1]], *a, geom, packed[name])

        names = ["prev"] * (geom.smem_bytes <= 227 * 1024) + [*packed, *source]
        calls = {name: (lambda name=name: call(name, idx, est, wgt, kai, h, w)) for name in names}
        calls["index_add"] = index_add_call(idx, est, wgt, kai, h, w)
        rec = {"row": label, "block": block, "step": step, "search": search, "k": k,
               "est": list(est.shape), "plans": {}}
        for name, pk in packed.items():
            rec["plans"][name] = {"tile": pk.tile, "warps": pk.warps, "groups": pk.groups,
                                  "footprint": [pk.fh, pk.fw], "smem_bytes": pk.smem_bytes,
                                  "scratch_bytes": pk.scratch_bytes(est.shape[0]),
                                  "ctas": len(pk.tile_oy) * len(pk.tile_ox) * est.shape[0]}
        rec["plans"]["prev"] = {"tile": 2, "footprint": [geom.fh, geom.fw], "smem_bytes": geom.smem_bytes,
                                "scratch_bytes": geom.scratch_bytes(est.shape[0])}
        rec["checks"] = {name: held_to_plain(lambda *a, name=name: call(name, *a), (idx, est, wgt, kai, h, w))
                         for name in names}
        rec["by_kernel_ms"] = {name: kernel_split(calls[name]) for name in ("packed", "prev") if name in names}
        times = {name: [] for name in calls}
        for name in ("packed", "prev", "index_add", "index_add", "prev", "packed"):
            if name in calls:
                times[name].append(device_ms(calls[name]))
        for name in names:
            if name not in ("prev", "packed"):
                for v in (name, "packed", "packed", name):
                    times[v].append(device_ms(calls[v]))
        rec["ms"] = times
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ptxas": packed_ptxas()}), flush=True)


def compiled_shapes() -> None:
    """Part ``compiled`` (module docstring)."""
    fns = {"built": k2._lib()[k2.K2_KERNELS[0]], **build_variants(VARIANTS, k2.K2_KERNELS[0])}
    for label, args in shapes().items():
        idx, est, wgt, kai, h, w, geom = args
        calls = {name: (lambda fn=fn: k2.launch(k2.K2_KERNELS[0], fn, idx, est, wgt, kai, h, w, geom))
                 for name, fn in fns.items()}
        first = {name: call() for name, call in calls.items()}
        rec = {"shape": label, "est": list(est.shape), "scratch_bytes": geom.scratch_bytes(est.shape[0])}
        for name, call in calls.items():
            rec[name] = {
                "repeat_bitwise": all(all(torch.equal(a, b) for a, b in zip(call(), first[name]))
                                      for _ in range(REPEATS)),
                "max_abs_vs_built": max((a - b).abs().max().item() for a, b in zip(first[name], first["built"])),
            }
        order = list(calls) + list(calls)[::-1]
        times = {name: [] for name in calls}
        for name in order:
            times[name].append(device_ms(calls[name]))
        for name in calls:
            rec[name]["ms"] = times[name]
        print(json.dumps(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("compiled", "runtime"), action="append")
    ap.add_argument("--row", choices=tuple(ROWS), action="append", help="part runtime's rows (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs a CUDA card")
    parts = args.part or ["runtime", "compiled"]
    if "runtime" in parts:
        runtime_rows(args.row or tuple(ROWS))
    if "compiled" in parts:
        compiled_shapes()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
