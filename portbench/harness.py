"""One run of one cell: set-up, the measured window, the check, one result line.

The window runs whole reconstructions (a ``pnp_*`` call of the program on
the cell's batch, then its result read back to the host) closed-loop, back
to back, each with a generator seeded from the run's seed and its index. It
opens at the first dispatch after the warm-up and closes when the result of
the first reconstruction that ends after ``--seconds`` is on the host (and
every reconstruction the check samples has run). ``image_iters_per_s`` is
lanes x trace entries of every reconstruction completed, over the window.

The program gets a pass-through denoiser (it calls only the program
denoiser's ``denoise``) and a pass-through problem (it forwards every
attribute; ``select_mb`` also keeps the minibatch the program's sampler
drew). On the sampled rounds the states are copied to pinned host memory
without waiting for the device, for the check after the window
(``check.py``). With ``--trace 1`` whole reconstructions run under ``torch.profiler`` inside the window,
opened after an idle marker; the denoiser wrapper brackets each call with a
marker kernel and a ``record_function`` range, so each device record is
attributed to the denoiser or the rest by its place in the device's order.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from types import SimpleNamespace

import torch

from portbench import check as checking
from portbench import inputs as common
from portbench import spec

DENOISE, READBACK, RECONSTRUCTION = "portbench.denoise", "portbench.readback", "portbench.reconstruction"
RANGES = (DENOISE, READBACK, RECONSTRUCTION)
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the idle marker and the denoiser's brackets
OWN_COPY = "Pinned"  # the benchmark's own copies go to pinned host memory ("Device -> Pinned"), the program's do not
MARKER_IDLE_S = 0.02  # host seconds between the idle marker and the profiled reconstruction
IDLE_GAP_NS = 10_000_000  # the device's idle time after the idle marker is at least this
PROFILES, PROFILE_TRIES = 2, 10
FORBIDDEN = ("jax", "jaxlib", "flax", "pnp_svrg_tpu")
K1, K2 = "bm3d_match", "bm3d_aggregate"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``pnp_svrg_tpu_torch`` is neither)."""
    return sorted(m for m in (sys.modules if modules is None else modules) if m.split(".")[0] in FORBIDDEN)


class Store:
    """Host copies of device tensors, made without waiting for the device."""

    def __init__(self, device):
        self.pin = torch.device(device).type == "cuda"
        self.buf: dict = {}
        self.kept: set = set()

    def reserve(self, key, shape, dtype) -> None:
        self.buf[key] = torch.empty(shape, dtype=dtype, pin_memory=self.pin)

    def keep(self, key, t: torch.Tensor) -> None:
        self.buf[key].copy_(t.detach().reshape(self.buf[key].shape), non_blocking=True)
        self.kept.add(key)

    def get(self, key, device) -> torch.Tensor:
        return self.buf[key].to(device)


class Denoiser:
    """The pass-through denoiser handed to the loop."""

    def __init__(self, inner, capture=None, store=None, marks: bool = False):
        self.inner, self.capture, self.store, self.marks = inner, capture, store, marks
        self.calls, self.last = 0, None

    def denoise(self, x, sigma_est, t):
        c = self.calls
        self.calls += 1
        if self.marks:
            torch.cuda._sleep(1)
            with torch.profiler.record_function(DENOISE):
                out = self.inner.denoise(x, sigma_est, t)
            torch.cuda._sleep(1)
        else:
            out = self.inner.denoise(x, sigma_est, t)
        cap = self.capture
        if cap is not None:
            if c == cap.calls[0] - 1:
                self.store.keep((cap.recon, "start"), out)
            if c in cap.calls:
                j = cap.calls.index(c)
                self.store.keep((cap.recon, "in", j), x)
                self.store.keep((cap.recon, "out", j), out)
        self.last = out
        return out


class Problem:
    """The pass-through problem handed to the loop."""

    def __init__(self, inner, capture=None, store=None):
        self._inner, self._capture, self._store = inner, capture, store
        self._draws, self._meta = 0, None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def select_mb(self, generator, k):
        """The program's draw; draw ``d`` of the reconstruction is kept where
        the check samples it."""
        mb = self._inner.select_mb(generator, k)
        d, cap = self._draws, self._capture
        self._draws += 1
        self._meta = (tuple(mb.shape), mb.dtype)
        if cap is not None and d in cap.draws:
            self._store.keep((cap.recon, "mb", cap.draws.index(d)), mb)
        return mb


class Run:
    """A cell set up on a device for one seed."""

    def __init__(self, cell: spec.Cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, torch.device(device), trace
        cfg, traffic = cell.config, cell.traffic
        self.algo = cell.reference("algo")
        t0 = time.perf_counter()
        self.inputs = cell.problem.make_inputs(cfg, traffic, seed, self.device, cell.root)
        self.sync()
        self.timings = {"inputs_s": time.perf_counter() - t0}
        self.lanes = self.inputs["x"].shape[0]
        self.problem = cell.problem.program_problem(self.inputs)
        self.denoiser = cell.denoiser.program_denoiser(cfg, traffic, self.device, cell.root)
        self.eta = self._eta(torch.float32)
        self.entries = self.algo.entries(traffic)
        self.plan = self._plan()
        self.store = Store(self.device)
        self.attempted = self.failed = self.iters = 0
        self.errors, self.answer_faults, self.profiles, self.profile_notes = [], [], [], []
        self.complete = []  # complete profiles; two that recorded as many records become ``profiles``
        self.truth, self.first_psnr = self.inputs["x"].reshape(self.lanes, -1).double().cpu(), None

    def _eta(self, dtype) -> torch.Tensor:
        lanes = self.cell.traffic.get("lanes")
        etas = ([lane["eta"] for lane in lanes] if lanes else [self.cell.traffic["eta"]] * self.lanes)
        return torch.tensor(etas, dtype=dtype, device=self.device)

    def _plan(self) -> dict:
        """The sampled reconstructions and, for each, its sampled round,
        drawn from the seed: reconstruction index -> capture."""
        chk, traffic = self.cell.traffic["check"], self.cell.traffic
        rng = common.rng(self.seed, common.PLAN)
        recons = sorted(int(r) for r in rng.choice(chk["among_first"], size=chk["reconstructions"], replace=False))
        plan = {}
        for r in recons:
            i = int(rng.integers(0, self.algo.rounds(traffic)))
            plan[r] = SimpleNamespace(recon=r, round=i, calls=self.algo.round_calls(traffic, i),
                                      draws=self.algo.round_draws(traffic, i))
        return plan

    def warm_up(self) -> None:
        """A short reconstruction of the cell's own shapes (the loop module's
        ``warm_up``: the gradients, the steps, both BM3D stages): builds and
        loads every kernel the window runs. Then the host buffers the check
        copies into."""
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(common.derive(self.seed, common.WARM_UP))
        prob = Problem(self.problem)
        out = self.cell.loop.call(prob, Denoiser(self.denoiser), self.eta, self.cell.traffic, gen, warm_up=True)
        out["image"].to("cpu")
        img = tuple(self.inputs["x"].shape)
        self.store.reserve("last", img, torch.float32)
        for cap in self.plan.values():
            self.store.reserve((cap.recon, "start"), img, torch.float32)
            for j in range(len(cap.calls)):
                self.store.reserve((cap.recon, "in", j), img, torch.float32)
                self.store.reserve((cap.recon, "out", j), img, torch.float32)
            for j in range(len(cap.draws)):
                self.store.reserve((cap.recon, "mb", j), *prob._meta)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
        self.sync()
        self.timings["warm_up_s"] = time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def reconstruct(self, idx: int, profiled: bool) -> None:
        cap = self.plan.get(idx)
        gen = torch.Generator(device=self.device).manual_seed(common.derive(self.seed, common.RECONSTRUCTION, idx))
        den = Denoiser(self.denoiser, cap, self.store, marks=profiled)
        prob = Problem(self.problem, cap, self.store)
        try:
            with torch.profiler.record_function(RECONSTRUCTION) if profiled else contextlib.nullcontext():
                out = self.cell.loop.call(prob, den, self.eta, self.cell.traffic, gen)
                self.store.keep("last", den.last)
                with torch.profiler.record_function(READBACK) if profiled else contextlib.nullcontext():
                    image = out["image"].to("cpu")
                last = self.store.buf["last"].reshape(image.shape)
        except Exception as exc:  # noqa: BLE001 - a reconstruction that raises fails its lanes
            self.attempted += self.lanes
            self.failed += self.lanes
            self.errors.append(f"reconstruction {idx}: {exc!r}")
            return
        self.attempted += self.lanes
        self.failed += int((~torch.isfinite(image).reshape(self.lanes, -1).all(dim=1)).sum())
        if idx == 0:
            err = (image.reshape(self.lanes, -1).double() - self.truth) ** 2
            self.first_psnr = (-10 * torch.log10(err.mean(dim=1))).tolist()
        self.iters += self.lanes * self.entries
        if not torch.equal(image.view(torch.int32), last.view(torch.int32)):  # bit for bit, NaN too
            self.answer_faults.append(f"reconstruction {idx}: its image is not its last denoiser output")

    def window(self, seconds: float) -> float:
        """Reconstructions back to back; returns the window's seconds."""
        last_capture = max(self.plan)
        t0 = time.perf_counter()
        idx = 0
        while True:
            want = self.trace and len(self.profiles) < PROFILES and idx > last_capture
            if want and idx - last_capture > PROFILE_TRIES + PROFILES:
                raise RuntimeError(f"no complete profile in {PROFILE_TRIES + PROFILES} reconstructions: "
                                   f"{self.profile_notes}")
            if want:
                self._profiled(idx)
            else:
                self.reconstruct(idx, False)
            idx += 1
            if (time.perf_counter() - t0 >= seconds and idx > last_capture
                    and (not self.trace or len(self.profiles) >= PROFILES)):
                break
            if len(self.errors) >= 3:
                break
        self.reconstructions = idx
        return time.perf_counter() - t0

    def _profiled(self, idx: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        from pnp_svrg_tpu_torch.ops.cuda.bm3d_aggregate import bm3d_aggregate
        from pnp_svrg_tpu_torch.ops.cuda.bm3d_match import bm3d_match

        before = (bm3d_match.launches, bm3d_aggregate.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(MARKER_IDLE_S)
            t0 = time.perf_counter()
            self.reconstruct(idx, True)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        calls = {K1: bm3d_match.launches - before[0], K2: bm3d_aggregate.launches - before[1]}
        rec = read_profile(prof, calls, self.algo.denoises(self.cell.traffic), wall_s)
        if not rec["complete"]:
            self.profile_notes.append({"reconstruction": idx, **rec["counts"]})
            return
        same = [p for p in self.complete if p["counts"]["records"] == rec["counts"]["records"]]
        self.complete.append(rec)
        if same:
            self.profiles = [same[0], rec]

    def captures(self) -> tuple:
        """The sampled rounds' states, on the device, and the faults of
        sampled states the program never produced."""
        out, missing = [], []
        for cap in self.plan.values():
            if cap.recon >= self.reconstructions:
                continue
            want = ([(cap.recon, "start")] if cap.calls[0] > 0 else []) + [
                (cap.recon, part, j) for part in ("in", "out") for j in range(len(cap.calls))] + [
                (cap.recon, "mb", j) for j in range(len(cap.draws))]
            lost = [key for key in want if key not in self.store.kept]
            if lost:
                missing.append(f"reconstruction {cap.recon}, round {cap.round}: no {lost[:3]} from the program")
                continue
            start = (self.store.get((cap.recon, "start"), self.device) if cap.calls[0] > 0
                     else self.inputs["x_init"])
            out.append({
                "index": cap.round, "recon": cap.recon, "start": start.reshape(self.lanes, -1),
                "inputs": [self.store.get((cap.recon, "in", j), self.device) for j in range(len(cap.calls))],
                "outputs": [self.store.get((cap.recon, "out", j), self.device) for j in range(len(cap.calls))],
                "draws": [self.store.get((cap.recon, "mb", j), self.device) for j in range(len(cap.draws))],
            })
        return out, missing


def read_profile(prof, calls: dict, denoises: int, wall_s: float) -> dict:
    """One profiled reconstruction's device records, attributed. The records
    are taken in launch order (their CUPTI correlation ids; one stream, so
    the device ran them in that order), the profile's opening marker (the
    record before the host's 20 ms pause) left out; each denoiser marker toggles between the denoiser and the rest. The
    busy time is the records' union, each idle gap is labelled by the record
    the device waited for (inside a denoiser call, the readback, or the
    loop), and what the host's ``wall_s`` holds beyond the records' span is
    the host's launch and return. ``complete`` where K1's and K2's records
    equal the program's launch counters (K2 is two records a counted
    launch), every denoiser call left both its markers, and every record
    starts after the one launched before it ended (a record whose time was
    misplaced breaks that)."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    annotation = lambda e: getattr(e, "is_user_annotation", lambda: False)()  # noqa: E731
    dev = [(e.correlation_id(), e.start_ns(), e.duration_ns(), e.name()) for e in evs
           if e.device_type() == DeviceType.CUDA and not annotation(e) and e.name() not in RANGES]
    by_launch = all(r[0] > 0 for r in dev) and len({r[0] for r in dev}) == len(dev)
    dev.sort()
    if len(dev) > 1 and MARKER in dev[0][3] and dev[1][1] - (dev[0][1] + dev[0][2]) > IDLE_GAP_NS:
        dev.pop(0)  # the opening marker (the profiler may have lost it)
    marks = k1 = k2 = misplaced = 0
    in_den, den_ns, other_ns, k1_ns, k2_ns, busy = False, 0, 0, 0, 0, 0
    by_name: dict = {}
    gaps = []
    last_end = None
    for _, start, dur, name in dev:
        if last_end is not None:
            if start < last_end - 1000:
                misplaced += 1
            elif start > last_end:
                label = "denoise" if in_den else ("readback" if "DtoH" in name and OWN_COPY not in name else "loop")
                gaps.append((label, (start - last_end) / 1e9))
        last_end = max(last_end or 0, start + dur)
        if MARKER in name:
            marks += 1
            in_den = not in_den
            continue
        if OWN_COPY in name:
            continue
        busy += dur
        by_name[name] = by_name.get(name, 0) + dur
        if in_den:
            den_ns += dur
        else:
            other_ns += dur
        if K1 in name:
            k1, k1_ns = k1 + 1, k1_ns + dur
        elif K2 in name:
            k2, k2_ns = k2 + 1, k2_ns + dur
    span = (last_end - dev[0][1]) / 1e9 if dev else 0.0
    gaps.append(("host launch and return", max(wall_s - span, 0.0)))
    counts = {"k1_records": k1, "k1_launches": calls[K1], "k2_records": k2, "k2_launches": calls[K2],
              "markers": marks, "denoiser_calls": denoises, "records": sum(1 for r in dev if MARKER not in r[3]
                                                                          and OWN_COPY not in r[3]),
              "misplaced": misplaced, "by_launch": by_launch}
    complete = (by_launch and k1 == calls[K1] and k2 == 2 * calls[K2] and marks == 2 * denoises and not misplaced)
    return {"complete": complete, "counts": counts, "wall_s": wall_s, "busy_s": busy / 1e9,
            "denoise_s": den_ns / 1e9, "other_s": other_ns / 1e9, "k1_s": k1_ns / 1e9, "k2_s": k2_ns / 1e9,
            "by_name": {n: v / 1e9 for n, v in by_name.items()}, "gaps": gaps}


def trace_summary(run: Run) -> SimpleNamespace:
    """What the metric readers read: the profiled reconstructions together
    (``rate``: their image-iterations over their wall time)."""
    ps = run.profiles
    records = [p["counts"]["records"] for p in ps]
    total = lambda key: sum(p[key] for p in ps)  # noqa: E731
    by_name: dict = {}
    for p in ps:
        for n, v in p["by_name"].items():
            by_name[n] = by_name.get(n, 0.0) + v
    return SimpleNamespace(
        cell=run.cell, lanes=run.lanes, reconstructions=len(ps), iters=len(ps) * run.lanes * run.entries,
        denoiser_calls=len(ps) * run.algo.denoises(run.cell.traffic), records=sum(records),
        wall_s=total("wall_s"), busy_s=total("busy_s"), denoise_s=total("denoise_s"), other_s=total("other_s"),
        k1_s=total("k1_s"), k2_s=total("k2_s"), k1_calls=sum(p["counts"]["k1_launches"] for p in ps),
        k2_calls=sum(p["counts"]["k2_launches"] for p in ps), by_name=by_name,
        rate=len(ps) * run.lanes * run.entries / total("wall_s"),
        gaps=[g for p in ps for g in p["gaps"]])


def breakdown(t: SimpleNamespace) -> dict:
    ops = sorted(t.by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             err=sys.stderr) -> dict:
    """Set up, warm up, measure, check; prints and returns the result."""
    run = Run(cell, seed, device, trace)
    run.warm_up()
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    window_s = run.window(seconds)
    run.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rate = run.iters / window_s
    metrics: dict = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu", "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result: dict = {}
    if trace:
        t = trace_summary(run)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev |= {"busy_s": t.busy_s / t.reconstructions, "window_s": t.wall_s / t.reconstructions}
        result["breakdown"] = breakdown(t)
    else:
        e2e = {"image_iters_per_s": rate, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    caps, missing = run.captures()
    refs, inputs = _free_program(run)
    readings = [checking.round_readings(refs, inputs, cell.traffic, run._eta(torch.float64), c) for c in caps]
    faults = [f for r in readings for f in r["faults"]] + missing + run.answer_faults + run.errors
    if len(caps) < len(run.plan):
        faults.append(f"{len(caps)} of {len(run.plan)} sampled rounds checked")
    ok, compared = checking.verdict(readings, cell.limits["limits"], faults)
    ok = ok and run.failed == 0
    result = {"correct": ok, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": dev, **result,
              "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in compared.items()}}
    result["checks"]["failed_lanes"] = {"value": run.failed, "limit": 0}
    result["checks"]["faults"] = {"value": len(faults), "limit": 0}
    for f in faults[:20]:
        print(f"fault: {f}", file=err)
    print(f"window {window_s:.3f} s, {run.reconstructions} reconstructions, setup {setup_s:.3f} s, "
          f"rounds checked {[(c['recon'], c['index']) for c in caps]}, {run.timings}", file=err)
    print(f"first reconstruction's PSNR a lane (dB): {run.first_psnr}", file=err)
    if trace:
        print(f"profiles {[p['counts'] for p in run.profiles]}, rejected {run.profile_notes}", file=err)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=err)
    return result


def _free_program(run: Run) -> tuple:
    """The reference's modules and the inputs; the program's state dropped
    and the device's cache emptied first, so that the reference sets no peak
    the window would read."""
    cell = run.cell
    inputs = run.inputs
    run.problem = run.denoiser = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    refs = {"problem": cell.reference("problem"), "algo": run.algo,
            "denoise": cell.reference("denoiser").make(cell.config, cell.traffic, run.device, cell.root)}
    return refs, inputs


def finish(result: dict, out=sys.stdout, err=sys.stderr) -> int:
    """The JAX check, then the result line; the process's exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}", file=err)
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0
