"""Time K3's cluster kernel against the design it replaced, and against
variants of its plan and source, on the card.

    python -m pnp_svrg_tpu_torch.examples.k3_variants

The rows are ``chip_smoke.py``'s K3 envelope rows, (patch size, distance)
= (7, 11) (skimage's defaults), (1, 1) and (11, 15), each on the NLM lanes'
real inputs: B = 1 (the csmri_nlm lane's ``13.png`` after its first
step, h = sigma from its estimate) and B = 9 (the 3 x 3 grid's lanes, each
after two steps at its own (eta, modifier)). At each,
``nlm_cluster_kernel<P>`` on its plan (``cluster``) and ``nlm_any_kernel<P>``
(``prev``) are timed in turns (cluster, prev, prev, cluster); then each
variant beside the built kernel (variant, cluster, cluster, variant):

- plans: ``cluster_<n>`` (n CTAs a cluster, warps as the plan allows),
  ``warps_<n>`` (n warps a CTA, the plan's cluster) and ``rows_<n>``
  (the other count of output rows a thread, the plan's cluster and warps);
- source: ``serial_sums`` (each box sum its P terms one after another,
  ``kDoublingTree = false``: the sums nlm_any_kernel takes).

Each is held to the plain version first: within 1e-5 max abs with and
without row bounds (16, 112), NaN everywhere at h = 0, and two calls bit for
bit equal. Each timing is the summed device records of 50 calls under
``torch.profiler``. Prints one JSON line a row and batch, then ptxas's
registers and spills for each build's cluster kernels and the card's name
and power limit. Variants build into ``build/pnp_svrg_tpu_torch/variants/``
with the port's ``nvcc`` flags. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess

import torch

from pnp_svrg_tpu_torch.convert import load_nlm_problem, nlm_params
from pnp_svrg_tpu_torch.ops.cuda import _build
from pnp_svrg_tpu_torch.ops.cuda import nlm as k3
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma

ROWS = ((7, 11), (1, 1), (11, 15))
VARIANTS = {  # name -> (text of the built source, its replacement)
    "serial_sums": ("constexpr bool kDoublingTree = true;", "constexpr bool kDoublingTree = false;"),
}
REPS = 50


def build_variants() -> tuple:
    """(name -> :func:`nlm.bind` of each variant's library, name -> ptxas's
    output of each build, the built library's included)."""
    src = (_build.SRC_DIR / "nlm.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in ({"built": ("", "")} | VARIANTS).items():
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
    output, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "nlm_cluster_kernel" in ln else None
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


def held_to_plain(call, z, h) -> dict:
    """K3's rules for ``call(z, hs, ss, bounds)``."""
    errs = {}
    for bounds in (None, (16, 112)):
        want = k3.nlm_denoise_plain(z, h, h, *call.pd, row_valid_bounds=bounds)
        errs[str(bounds)] = (call(z, h, h, bounds) - want).abs().max().item()
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: needs a CUDA card")
    built = k3._lib()
    variants, logs = build_variants()
    inputs = nlm_inputs()
    cluster = k3.K3_KERNELS[1]
    for pd, (label, (z, h)) in itertools.product(ROWS, inputs.items()):
        b, hh, ww = z.shape
        plan = k3.device_plan(built, z.device, b, hh, ww, *pd)
        calls = {"cluster": Call(cluster, built, pd), "prev": Call(k3.PREV_DESIGN, built, pd)}
        c, w, rows = plan
        for n in (1, 2, 4, 8):
            warps = min(k3.CLUSTER_MAX_WARPS, max(1, c * w // n))
            if (n, warps) != (c, w) and n * warps <= (2 * pd[1] + 1) ** 2:
                calls[f"cluster_{n}"] = Call(cluster, built, pd, (n, warps, rows))
        for n in (4, 6, 8):
            if n != w and c * n <= (2 * pd[1] + 1) ** 2:
                calls[f"warps_{n}"] = Call(cluster, built, pd, (c, n, rows))
        other = 12 - rows
        calls[f"rows_{other}"] = Call(cluster, built, pd, (c, w, other))
        calls |= {name: Call(cluster, fns, pd) for name, fns in variants.items()}
        rec = {"row": f"p{pd[0]}_d{pd[1]}_{label}", "images": [b, hh, ww], "plan": list(plan),
               "plans": {name: list(c.plan) for name, c in calls.items() if c.plan},
               "checks": {name: held_to_plain(c, z, h) for name, c in calls.items()}}
        times = {name: [] for name in calls}
        for name in ("cluster", "prev", "prev", "cluster"):
            times[name].append(device_ms(lambda name=name: calls[name](z, h, h)))
        for name in calls:
            if name not in ("cluster", "prev"):
                for v in (name, "cluster", "cluster", name):
                    times[v].append(device_ms(lambda v=v: calls[v](z, h, h)))
        rec["ms"] = times
        print(json.dumps(rec), flush=True)
    print(json.dumps({"ptxas": {name: cluster_ptxas(log) for name, log in logs.items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)


if __name__ == "__main__":
    main()
