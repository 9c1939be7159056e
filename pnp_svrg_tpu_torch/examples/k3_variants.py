"""Time K3's cluster kernels against the designs they replaced, and against
variants of their plans and sources, on the card.

    python -m pnp_svrg_tpu_torch.examples.k3_variants [--rows 13,21 21,31] [--quick]

The rows are ``chip_smoke.py``'s K3 envelope rows, (patch size, distance):
``nlm_cluster_kernel<P>`` at (7, 11) (skimage's defaults), (1, 1) and
(11, 15), and past distance 15 at (7, 17) and (11, 17);
``nlm_cluster_rt_kernel`` at (13, 21) and (21, 31). Each runs on the NLM
lanes' real inputs: B = 1 (the csmri_nlm lane's ``13.png`` after its first
step, h = sigma from its estimate) and B = 9 (the 3 x 3 grid's lanes, each
after two steps at its own (eta, modifier)). At each, the row's kernel on
its plan (``built``) and the design it replaced (``prev``:
``nlm_any_kernel<P>`` up to (11, 15), else ``nlm_rt_serial_kernel``) are
timed in turns (built, prev, prev, built); then each variant beside the
built kernel (variant, built, built, variant):

- plans: ``cluster_<n>`` (n CTAs a cluster, warps as the plan allows),
  ``warps_<n>`` (n warps a CTA, the plan's cluster), ``rows_<n>`` (the
  other count of output rows a thread, the plan's cluster and warps) and,
  for the run-time kernel, ``cols_<n>`` (the other canvas) and a grid of
  (cluster, warps) at 1, 2, 4 and 8 CTAs of 4, 6 and 8 warps
  (``grid_<cluster>x<warps>``);
- source: ``serial_sums`` (the cluster kernel's box sums, each its P
  terms one after another, ``kDoublingTree = false``: the sums
  nlm_any_kernel takes), and ``rt_min_ctas_<n>`` (the run-time kernel's
  launch bounds asking room for n CTAs of 8 warps an SM: a register
  budget of 65,536 / (256 n) a thread).

Each is held to the plain version first: within 1e-5 max abs with and
without row bounds (16, 112), NaN everywhere at h = 0, and two calls bit for
bit equal. Each timing is the summed device records of 50 calls under
``torch.profiler``. Prints one JSON line a row and batch, then ptxas's
registers and spills for each build's cluster kernels and the card's name
and power limit. Variants build into ``build/pnp_svrg_tpu_torch/variants/``
with the port's ``nvcc`` flags. ``--quick`` times the built kernel and the
replaced design only. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess

import torch

from pnp_svrg_tpu_torch.convert import load_nlm_problem, nlm_params
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma

ROWS = ((7, 11), (1, 1), (11, 15), (7, 17), (11, 17), (13, 21), (21, 31))
# name -> (text of the built source, its replacement, the kernel it changes)
VARIANTS = {
    "serial_sums": ("constexpr bool kDoublingTree = true;", "constexpr bool kDoublingTree = false;",
                    k3.K3_KERNELS[1]),
    "rt_min_ctas_2": ("constexpr int kRtMinCtas = 1;", "constexpr int kRtMinCtas = 2;", k3.K3_KERNELS[2]),
    "rt_min_ctas_3": ("constexpr int kRtMinCtas = 1;", "constexpr int kRtMinCtas = 3;", k3.K3_KERNELS[2]),
}
REPS = 50


def build_variants() -> tuple:
    """(name -> :func:`nlm.bind` of each variant's library, name -> ptxas's
    output of each build, the built library's included)."""
    src = (_build.SRC_DIR / "nlm.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new, _) in ({"built": ("", "", None)} | VARIANTS).items():
        if old and src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not once in the source")
        cu = out_dir / f"nlm_{name}.cu"
        cu.write_text(src.replace(old, new) if old else src)
        so = out_dir / f"nlm_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{logs[name]}")
        if name != "built":
            fns[name] = k3.bind(ctypes.CDLL(str(so)))
    return fns, logs


def cluster_ptxas(log: str) -> dict:
    """ptxas's register and spill lines for each cluster kernel in a build's
    output (``nlm_cluster_kernel``, ``nlm_cluster_rt_kernel``,
    ``nlm_rt_serial_kernel``), by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if any(k in ln for k in ("cluster", "rt_serial")) else None
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = out.get(name, "") + ln.strip() + "; "
    return out


def nlm_inputs() -> dict:
    """{"b1": (z, h), "b9": (z, h)}: the inputs of ``chip_smoke.nlm_check_inputs``
    (the csmri_nlm lane's image after one full-gradient step and its h =
    sigma; the grid's nine lanes after two steps, the first denoised by the
    plain version, each at its own (eta, modifier))."""
    cfg = nlm_params()
    prob = load_nlm_problem("cuda")

    def steps(eta, mod, n):
        x = prob.x_init
        for s in range(n):
            z = x - eta * prob.grad_full(x)
            h = estimate_sigma(z) * mod
            if s + 1 < n:
                x = k3.nlm_denoise_plain(z, h, h)
        return z, h

    lanes = [steps(e, m, 2) for e, m in itertools.product(cfg["etas"], cfg["mods"])]
    return {"b1": steps(cfg["eta"], cfg["sigma_modifier"], 1),
            "b9": (torch.cat([z for z, _ in lanes]).contiguous(), torch.cat([h for _, h in lanes]))}


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


BOUNDS = (None, (16, 112))


def held_to_plain(call, z, h, wants: dict) -> dict:
    """K3's rules for ``call(z, hs, ss, bounds)``; ``wants``: the plain
    version's output at each of :data:`BOUNDS`."""
    errs = {}
    for bounds in BOUNDS:
        errs[str(bounds)] = (call(z, h, h, bounds) - wants[bounds]).abs().max().item()
    zero = torch.zeros(z.shape[0], device=z.device)
    first = call(z, h, h, None)
    return {"max_abs_err": errs, "ok_1e-5": max(errs.values()) <= 1e-5,
            "nan_at_h0": bool(torch.isnan(call(z, zero, zero, None)).all()),
            "repeat_bitwise": bool(torch.equal(call(z, h, h, None), first))}


class Call:
    """One K3 kernel, library and plan at a (patch size, distance)."""

    def __init__(self, kernel: str, fns: dict, pd: tuple, plan: tuple | None = None):
        self.kernel, self.fns, self.pd, self.plan = kernel, fns, pd, plan

    def __call__(self, z, hs, ss, bounds=None):
        b, hh, ww = z.shape
        lo, hi = bounds or (0, hh)
        out = torch.empty_like(z)
        hs = hs.expand(b).contiguous()
        ss = ss.expand(b).contiguous()
        k3.launch(self.kernel, self.fns, z, hs, ss, out, *self.pd, lo, hi, self.plan)
        return out


def plan_calls(kernel: str, fns: dict, pd: tuple, plan: tuple) -> dict:
    """The plan variants of a row (module docstring), by name."""
    shifts = (2 * pd[1] + 1) ** 2
    c, w, rows = plan[:3]
    rest = plan[3:]
    calls = {}
    for n in (1, 2, 4, 8):
        warps = min(k3.CLUSTER_MAX_WARPS, max(1, c * w // n))
        if (n, warps) != (c, w) and n * warps <= shifts:
            calls[f"cluster_{n}"] = Call(kernel, fns, pd, (n, warps, rows) + rest)
    for n in (4, 6, 8):
        if n != w and c * n <= shifts:
            calls[f"warps_{n}"] = Call(kernel, fns, pd, (c, n, rows) + rest)
    other = 12 - rows
    calls[f"rows_{other}"] = Call(kernel, fns, pd, (c, w, other) + rest)
    if kernel == k3.K3_KERNELS[2]:
        cols = 96 - plan[3]
        if k3.rt_smem(*pd, k3.CLUSTER_MAX_WARPS, rows, cols) <= k3._MAX_SMEM:
            calls[f"cols_{cols}"] = Call(kernel, fns, pd, (c, w, rows, cols))
        for n, warps in itertools.product((1, 2, 4, 8), (4, 6, 8)):
            if (n, warps) != (c, w) and n * warps <= shifts:
                calls[f"grid_{n}x{warps}"] = Call(kernel, fns, pd, (n, warps) + plan[2:])
    return calls


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="*", default=None, help="rows as P,D (default: all of ROWS)")
    ap.add_argument("--quick", action="store_true", help="time the built kernel and the replaced design only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: needs a CUDA card")
    rows = [tuple(int(v) for v in r.split(",")) for r in args.rows] if args.rows else ROWS
    built = k3._lib()
    variants, logs = ({}, {}) if args.quick else build_variants()
    inputs = nlm_inputs()
    for pd, (label, (z, h)) in itertools.product(rows, inputs.items()):
        b, hh, ww = z.shape
        kernel, prev = k3.nlm_kernel_name(*pd), k3.prev_design(*pd)
        plan = k3.device_plan(built, z.device, b, hh, ww, *pd)
        calls = {"built": Call(kernel, built, pd), "prev": Call(prev, built, pd)}
        if not args.quick:
            calls |= plan_calls(kernel, built, pd, plan)
            calls |= {name: Call(kernel, fns, pd) for name, fns in variants.items()
                      if VARIANTS[name][2] == kernel}
        rec = {"row": f"p{pd[0]}_d{pd[1]}_{label}", "images": [b, hh, ww], "kernel": kernel, "prev": prev,
               "plan": list(plan), "plans": {name: list(c.plan) for name, c in calls.items() if c.plan},
               "checks": {}}
        wants = {bounds: k3.nlm_denoise_plain(z, h, h, *pd, row_valid_bounds=bounds) for bounds in BOUNDS}
        rec["checks"] = {name: held_to_plain(c, z, h, wants) for name, c in calls.items()}
        times = {name: [] for name in calls}
        for name in ("built", "prev", "prev", "built"):
            times[name].append(device_ms(lambda name=name: calls[name](z, h, h)))
        for name in calls:
            if name not in ("built", "prev"):
                for v in (name, "built", "built", name):
                    times[v].append(device_ms(lambda v=v: calls[v](z, h, h)))
        rec["ms"] = times
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ptxas": {name: cluster_ptxas(log) for name, log in logs.items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
