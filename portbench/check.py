"""The comparison that decides ``correct``.

A reconstruction amplifies rounding (block matching is discrete, and near
the stability edge one ulp of a start moves the end by tenths of a dB), so
two whole trajectories are no tight comparison. The check therefore follows
the program step by step from the program's own states, on sampled rounds
(``reference/<algo>.py``'s ``round_calls``) of sampled reconstructions of
the window:
the round's start point, each step's denoiser input and output, and each
minibatch the program drew. For each step it compares

* ``update_gap``: the step the program took (its iterate less the
  denoiser's input) against the reference update (``reference/<algo>.py``
  on the reference gradients of ``reference/<problem>.py``, float64), as
  ``||u - u_ref|| / ||u_ref||``, the worst lane and step;
* ``denoise_gap`` and ``denoise_gap_q90``: the program's denoiser output
  against the reference denoiser (``reference/<denoiser>.py``, with its own
  noise estimate) on the same input, as the median and the 90th percentile
  over a lane's pixels of ``|d - d_ref|`` over the RMS of ``d_ref``, the
  worst lane and step. Quantiles, because block matching is discrete: where
  two candidate patches lie within rounding of each other, K1 and the
  reference's plain matcher may keep different ones, and the groups that
  hold them differ (up to 2e-4 of the image's norm on the card) while most
  pixels agree to rounding; a lower precision, or a wrong noise level or
  transform, moves every pixel. The median sees a fault over most of a
  lane, the 90th percentile one over a tenth of it (border tiles, a subset
  of reference blocks, one region's aggregation).

The round's start point is the output of the step before it (the check
makes no assumption that it is right: that step's own check covers it where
it is sampled) or, for the first round, the benchmark's ``x_init``. A
minibatch that is no minibatch of the stated size, a step that was never
taken, or a non-finite state is a fault. The control is the same reference
one precision step lower put in the program's place (``tf32=True``)."""

from __future__ import annotations

import torch


NAMES = ("update_gap", "denoise_gap", "denoise_gap_q90")


def lane_gap(got: torch.Tensor, want: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(B,) ``||got - want|| / ||base||`` over each lane's pixels, in float64."""
    b = want.shape[0]
    d = got.reshape(b, -1).double() - want.reshape(b, -1).double()
    return torch.linalg.vector_norm(d, dim=-1) / torch.linalg.vector_norm(base.reshape(b, -1).double(), dim=-1)


def quantile_gaps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(B,) median and (B,) 90th percentile over each lane's pixels of
    ``|got - want|``, over the RMS of ``want``, in float64."""
    b = want.shape[0]
    d = (got.reshape(b, -1).double() - want.reshape(b, -1).double()).abs()
    rms = torch.linalg.vector_norm(want.reshape(b, -1).double(), dim=-1) / d.shape[1] ** 0.5
    return d.median(dim=-1).values / rms, torch.quantile(d, 0.9, dim=-1) / rms


def _worst(values: list) -> float:
    t = torch.stack(values)
    return float("inf") if bool(torch.isnan(t).any()) else float(t.max())


def round_readings(refs: dict, inputs: dict, traffic: dict, eta: torch.Tensor, cap: dict,
                   control: bool = False) -> dict:
    """The numbers (``NAMES``) for one captured round. ``refs``: the cell's
    reference modules (``problem``, ``algo``) and its denoiser ``denoise``;
    ``eta``: (B,) float64 steps; ``cap``: the round's ``index``, ``start``,
    ``inputs``, ``outputs``, ``draws`` (device tensors). With ``control``
    also the control's readings of each number."""
    problem, algo, den = refs["problem"], refs["algo"], refs["denoise"]
    faults = []
    for mb in cap["draws"]:
        why = problem.minibatch_fault(inputs, mb, traffic["mini_batch_size"])
        if why:
            faults.append(why)
    states = [cap["start"], *cap["inputs"], *cap["outputs"]]
    if not all(bool(torch.isfinite(s).all()) for s in states):
        faults.append("a captured state is not finite")
    outs = [o.reshape(cap["start"].shape) for o in cap["outputs"]]
    steps = algo.updates(problem, inputs, cap["start"], outs, cap["draws"], eta, traffic, cap["index"])
    ctrl_steps = (algo.updates(problem, inputs, cap["start"], outs, cap["draws"], eta.float(), traffic,
                               cap["index"], tf32=True) if control else None)
    got, ctrl = {n: [] for n in NAMES}, {n: [] for n in NAMES}
    for j, ((z, u_ref), x_in, out) in enumerate(zip(steps, cap["inputs"], cap["outputs"])):
        x_in = x_in.reshape(z.shape)
        got["update_gap"].append(lane_gap(z.double() - x_in.double(), u_ref, u_ref))
        img = x_in.reshape(out.shape)
        d_ref = den(img)
        for n, g in zip(NAMES[1:], quantile_gaps(out, d_ref)):
            got[n].append(g)
        if control:
            ctrl["update_gap"].append(lane_gap(ctrl_steps[j][1], u_ref, u_ref))
            for n, g in zip(NAMES[1:], quantile_gaps(den(img, True), d_ref)):
                ctrl[n].append(g)
    out = {n: _worst(got[n]) for n in NAMES} | {"faults": faults}
    if control:
        out["control"] = {n: _worst(ctrl[n]) for n in NAMES}
    return out


def verdict(readings: list, limits: dict, faults: list) -> tuple:
    """(correct, {name: (worst reading, limit)}) over every checked round."""
    worst = {name: max(r[name] for r in readings) if readings else float("inf") for name in limits}
    ok = bool(readings) and not faults and all(worst[n] <= limits[n] for n in limits)
    return ok, {n: (worst[n], limits[n]) for n in limits}
