"""Time K2's design choices on the card: the kernel as built beside
variants of its source that change one constant.

    python -m pnp_svrg_tpu_torch.examples.k2_variants

Variants of ``csrc/bm3d_aggregate.cu``: ``two_warps`` (``kWarps = 2``, the
warp count before the fixed-order fold), ``fold_streams`` (the fold adds as
it loads at every size), ``fold_all_at_once`` (the fold issues all of a
pixel's loads first at every size) and ``lane_tests`` (the tile kernel tests
at every block whether a lane owns each patch value, as it must where
block^2 is not a multiple of 32). Each is built with the port's ``nvcc``
flags into ``build/pnp_svrg_tpu_torch/variants/`` and called through the
same entry point as the kernel. The arguments are real stage-1 BM3D
aggregations at the shapes ``chip_smoke.py`` checks: the headline batch
(B = 13, 128 px), one 128 px image, one 256 px image and 36 lanes at
128 px. Prints one JSON line a shape: each build's device ms (the summed
device records of 50 calls under ``torch.profiler``, in turns: built,
variants, variants reversed, built), whether 20 calls repeat the first bit
for bit, and its largest difference from the built kernel (0 for the fold
variants, whose order of adds is the built kernel's); then the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from pnp_svrg_tpu_torch.convert import load_headline_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DParams, stage1_aggregate_inputs
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.utils.io import load_image

VARIANTS = {  # name -> (text of the built source, its replacement)
    "two_warps": ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
    "fold_streams": ("constexpr long long kFewPixels = 1 << 17;", "constexpr long long kFewPixels = 0;"),
    "fold_all_at_once": ("constexpr long long kFewPixels = 1 << 17;",
                         "constexpr long long kFewPixels = 1LL << 62;"),
    "lane_tests": ("constexpr bool kFull = BLOCK > 0 && BLOCK * BLOCK % 32 == 0;",
                   "constexpr bool kFull = false;"),
}
REPS, REPEATS = 50, 20


def build_variants() -> dict:
    """name -> the bound entry point of each variant's library."""
    src = (_build.SRC_DIR / "bm3d_aggregate.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in VARIANTS.items():
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
        fns[name] = k2.bind(ctypes.CDLL(str(so)).bm3d_aggregate_launch)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs a CUDA card")
    fns = {"built": k2._lib(), **build_variants()}
    for label, args in shapes().items():
        idx, est, wgt, kai, h, w, geom = args
        calls = {name: (lambda fn=fn: k2.launch(fn, idx, est, wgt, kai, h, w, geom)) for name, fn in fns.items()}
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
