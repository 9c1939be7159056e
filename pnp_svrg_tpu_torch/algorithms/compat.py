"""Reference-compatible wall-clock API.

Port of ``pnp_svrg_tpu/algorithms/compat.py``. The loops of
``algorithms/loops.py`` take fixed iteration budgets and never wait for the
device; this module gives the *reference-shaped* API instead: loops budgeted
in wall-clock seconds (``tt``) that return the dict the reference algorithms
return, ``{z, time_per_iter, psnr_per_iter, gradient_time, denoise_time,
algo_name}``, and the ``tune_pnp_*`` adapters with the hyperopt-style loss
``PSNR(x_init) - PSNR(z)``.

Each step is a gradient sub-step and a denoise sub-step, each closed by a
:func:`~pnp_svrg_tpu_torch.utils.profiling.fence` and timed on the host
clock, so the gradient/denoise split is measured as the reference measures
it; every step also reads its PSNR back. The loop is therefore host-bound by
design; use the loops for throughput.

Problems have one lane (``batch_size == 1``). The step size is
``eta * lr_decay**i`` formed in Python float64 and rounded to float32 where
it multiplies the gradient, as the JAX compat API forms it (not the loops'
f32 power, :func:`~pnp_svrg_tpu_torch.algorithms.loops.step_schedule`).
Minibatches come from a ``torch.Generator(seed)`` on the problem's device
or, for exact parity with another implementation, are injected
(``masks``, one per inner step in draw order; for SAGA also ``slots`` and
``mb0``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from pnp_svrg_tpu_torch.algorithms.loops import TOL
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from pnp_svrg_tpu_torch.utils.profiling import fence


def compat_step(eta: float, lr_decay: float, i: int) -> float:
    """The step size of round ``i``: ``eta * lr_decay**i`` in Python
    float64, rounded to float32 (exactly representable, so the product with
    an f32 gradient is the JAX compat API's)."""
    return float(np.float32(eta * lr_decay**i))


def _split_timed(problem, denoiser):
    """(denoise-step, psnr) callables of a one-lane problem."""
    if problem.batch_size != 1:
        raise ValueError(f"the compat API runs one-lane problems, got {problem.batch_size} lanes")

    def denoise_step(z, t: int):
        img = z.reshape(1, problem.h, problem.w)
        tt = torch.full((1,), t, dtype=torch.int32, device=z.device)
        return denoiser.denoise(img, estimate_sigma(img), tt).reshape(z.shape)

    def psnr(z) -> torch.Tensor:
        return problem.psnr(z)[0]

    return denoise_step, psnr


def _round2(x) -> float:
    # Reference PSNRs are rounded to 2 decimals (problem.py:35).
    return float(np.round(float(x), 2))


class _Minibatches:
    """Minibatches in draw order: injected ``masks`` (a leading step axis)
    or drawn from a ``torch.Generator(seed)`` on the problem's device."""

    def __init__(self, problem, k: int, seed: int, masks=None):
        self.problem, self.k, self.masks, self.used = problem, k, masks, 0
        self.generator = None
        if masks is None:
            self.generator = torch.Generator(device=problem.device).manual_seed(seed)
        elif tuple(masks.shape[1:]) != tuple(problem.mb_shape(k)):
            raise ValueError(f"masks must be (steps,) + {tuple(problem.mb_shape(k))}, "
                             f"got {tuple(masks.shape)}")

    def __call__(self) -> torch.Tensor:
        if self.masks is None:
            return self.problem.select_mb(self.generator, self.k)
        if self.used >= self.masks.shape[0]:
            raise ValueError(f"the {self.masks.shape[0]} injected minibatches are used up")
        self.used += 1
        return self.masks[self.used - 1]


def _run_wallclock(
    problem,
    denoiser,
    tt: float,
    grad_fn,
    algo_name: str,
    eta: float,
    lr_decay: float,
    converge_check: bool,
    diverge_check: bool,
    outer_snapshot=None,
    t2: int | None = None,
    max_iters: int | None = None,
):
    """Shared wall-clock loop skeleton (reference pnp_gd.py:8-84 layout).

    ``max_iters`` optionally caps the number of *inner* gradient+denoise
    steps (svrg/sarah run ``max_iters / t2`` outer cycles): the
    iteration-budget mode that compares this API with the loops at matched
    counts; the reference's budget is wall-clock only.
    """
    denoise_step, psnr = _split_timed(problem, denoiser)
    z = problem.x_init.reshape(1, -1)
    time_per_iter = [0.0]
    psnr_per_iter = [_round2(psnr(z))]
    gradient_time = 0.0
    denoise_time = 0.0
    t = 0
    i = 0
    inner_done = 0
    elapsed = time.perf_counter()

    def budget_left():
        if max_iters is not None and inner_done >= max_iters:
            return False
        return (time.perf_counter() - elapsed) < tt

    break_out = False
    while budget_left() and not break_out:
        snap_state = None
        if outer_snapshot is not None:
            t0 = time.perf_counter()
            # May advance z (SARAH continues from the denoised step-1 point
            # in canonical mode), consume a denoiser call, and choose what
            # the snapshot log entry records (SARAH logs the step-1 point
            # even in faithful mode, where z itself stays put).
            z, snap_state, t, log_psnr = outer_snapshot(z, t)
            fence(z)
            time_per_iter.append(time.perf_counter() - t0)
            psnr_per_iter.append(_round2(log_psnr))
        inner_iters = t2 if t2 is not None else 1
        for _ in range(inner_iters):
            if not budget_left():
                break
            start_psnr = psnr_per_iter[-1]
            g0 = time.perf_counter()
            v, snap_state = grad_fn(z, i, snap_state)
            z = z - compat_step(eta, lr_decay, i) * v.reshape(z.shape)
            fence(z)
            g1 = time.perf_counter()
            gradient_time += g1 - g0
            d0 = time.perf_counter()
            t += 1
            z = denoise_step(z, t)
            fence(z)
            d1 = time.perf_counter()
            denoise_time += d1 - d0
            inner_done += 1
            time_per_iter.append((g1 - g0) + (d1 - d0))
            psnr_per_iter.append(_round2(psnr(z)))
            if converge_check and abs(start_psnr - psnr_per_iter[-1]) < TOL:
                break_out = True
                break
            if diverge_check and psnr_per_iter[-1] < 0:
                break_out = True
                break
        i += 1
    return {
        "z": z.reshape(-1),
        "time_per_iter": time_per_iter,
        "psnr_per_iter": psnr_per_iter,
        "gradient_time": gradient_time,
        "denoise_time": denoise_time,
        "algo_name": algo_name,
    }


def pnp_gd(
    problem,
    denoiser,
    eta: float,
    tt: float,
    verbose: bool = False,
    lr_decay: float = 1.0,
    converge_check: bool = True,
    diverge_check: bool = False,
    max_iters: int | None = None,
) -> dict[str, Any]:
    def grad_fn(z, i, _):
        return problem.grad_full(z), None

    return _run_wallclock(
        problem, denoiser, tt, grad_fn, "PnP GD", eta, lr_decay,
        converge_check, diverge_check, max_iters=max_iters,
    )


def pnp_sgd(
    problem,
    denoiser,
    eta: float,
    tt: float,
    mini_batch_size: int,
    verbose: bool = False,
    lr_decay: float = 1.0,
    converge_check: bool = True,
    diverge_check: bool = False,
    seed: int = 0,
    max_iters: int | None = None,
    masks: torch.Tensor | None = None,
) -> dict[str, Any]:
    draw = _Minibatches(problem, mini_batch_size, seed, masks)

    def grad_fn(z, i, _):
        return problem.grad_stoch(z, draw()) / mini_batch_size, None

    return _run_wallclock(
        problem, denoiser, tt, grad_fn, "PnP SGD", eta, lr_decay,
        converge_check, diverge_check, max_iters=max_iters,
    )


def pnp_svrg(
    problem,
    denoiser,
    eta: float,
    tt: float,
    T2: int,
    mini_batch_size: int,
    verbose: bool = False,
    lr_decay: float = 1.0,
    converge_check: bool = True,
    diverge_check: bool = False,
    variant: str = "svrg",
    seed: int = 0,
    max_iters: int | None = None,
    masks: torch.Tensor | None = None,
) -> dict[str, Any]:
    draw = _Minibatches(problem, mini_batch_size, seed, masks)
    _, psnr_fn = _split_timed(problem, denoiser)

    def outer_snapshot(z, t):
        return z, (z, problem.grad_full(z).reshape(z.shape)), t, psnr_fn(z)

    def grad_fn(z, i, snap):
        w, mu = snap
        if variant == "faithful":
            return mu, snap
        mb = draw()
        g_z = problem.grad_stoch(z, mb).reshape(z.shape)
        g_w = problem.grad_stoch(w, mb).reshape(z.shape)
        return (g_z - g_w) / mini_batch_size + mu, snap

    return _run_wallclock(
        problem, denoiser, tt, grad_fn, "PnP SVRG", eta, lr_decay,
        converge_check, diverge_check, outer_snapshot=outer_snapshot, t2=T2,
        max_iters=max_iters,
    )


def pnp_saga(
    problem,
    denoiser,
    eta: float,
    tt: float,
    mini_batch_size: int,
    hist_size: int = 50,
    verbose: bool = False,
    lr_decay: float = 1.0,
    converge_check: bool = True,
    diverge_check: bool = False,
    seed: int = 0,
    max_iters: int | None = None,
    masks: torch.Tensor | None = None,
    slots: torch.Tensor | None = None,
    mb0: torch.Tensor | None = None,
) -> dict[str, Any]:
    """Table-based SAGA: ``mb0`` fills the (hist_size, N) table, then each
    step draws a minibatch and a slot (injected: ``masks`` and ``slots``
    (steps,), one a step)."""
    injected = (masks is not None, slots is not None, mb0 is not None)
    if any(injected) and not all(injected):
        raise ValueError("inject masks, slots and mb0 together")
    draw = _Minibatches(problem, mini_batch_size, seed, masks)
    if mb0 is None:
        mb0 = draw()
    slot_list = None if slots is None else [int(s) for s in slots]

    def stoch(z, mb):
        return problem.grad_stoch(z, mb).reshape(1, -1) / mini_batch_size

    g0 = stoch(problem.x_init.reshape(1, -1), mb0)
    state = {"table": g0.repeat(hist_size, 1), "tsum": g0 * hist_size, "prev": g0}

    def next_slot() -> int:
        if slot_list is None:
            return int(torch.randint(0, hist_size, (1,), generator=draw.generator,
                                     device=problem.device))
        return slot_list[draw.used - 1]

    def grad_fn(z, i, _):
        g = stoch(z, draw())
        slot = next_slot()
        state["tsum"] = state["tsum"] + g - state["table"][slot]
        state["table"][slot] = g[0]
        v = g - state["prev"] + state["tsum"] / hist_size
        state["prev"] = g
        return v, None

    return _run_wallclock(
        problem, denoiser, tt, grad_fn, "PnP SAGA", eta, lr_decay,
        converge_check, diverge_check, max_iters=max_iters,
    )


def pnp_sarah(
    problem,
    denoiser,
    eta: float,
    tt: float,
    T2: int,
    mini_batch_size: int,
    verbose: bool = False,
    lr_decay: float = 1.0,
    converge_check: bool = True,
    diverge_check: bool = False,
    variant: str = "sarah",
    seed: int = 0,
    max_iters: int | None = None,
    masks: torch.Tensor | None = None,
) -> dict[str, Any]:
    draw = _Minibatches(problem, mini_batch_size, seed, masks)
    denoise_step, psnr_fn = _split_timed(problem, denoiser)
    state = {}

    def outer_snapshot(z, t):
        v_prev = problem.grad_full(z).reshape(z.shape)
        # Step-1 point: one full-gradient step, denoised (pnp_sarah.py:36-48).
        w1 = denoise_step(z - compat_step(eta, 1.0, 0) * v_prev, t + 1)
        state.update(w_prev=z, v_prev=v_prev, w_fix=w1)
        # Canonical mode continues from the denoised step-1 point (as
        # loops.pnp_sarah does); faithful keeps z at the outer-start point,
        # with w1 only the frozen recursion anchor (pnp_sarah.py:72).
        z_next = z if variant == "faithful" else w1
        return z_next, w1, t + 1, psnr_fn(w1)

    def grad_fn(z, i, snap):
        if variant == "faithful":
            # Reference recursion: anchor frozen at the step-1 point,
            # w_previous = the latest denoised iterate, the incoming z
            # (pnp_sarah.py:97-98).
            anchor, w_prev = state["w_fix"], z
        else:
            # Canonical SARAH: differences of the two most recent iterates.
            anchor, w_prev = z, state["w_prev"]
        mb = draw()
        v = (problem.grad_stoch(anchor, mb).reshape(z.shape)
             - problem.grad_stoch(w_prev, mb).reshape(z.shape)) / mini_batch_size + state["v_prev"]
        state["v_prev"] = v
        state["w_prev"] = z
        return v, snap

    return _run_wallclock(
        problem, denoiser, tt, grad_fn, "PnP SARAH", eta, lr_decay,
        converge_check, diverge_check, outer_snapshot=outer_snapshot, t2=T2,
        max_iters=max_iters,
    )


def _make_tuner(runner, param_names):
    """Build a tune_pnp_* adapter (reference e.g. ``pnp_svrg.py:107-132``):
    ``args`` in the order of ``param_names``; ``dstrength`` becomes the
    denoiser's ``sigma_modifier`` where the denoiser has a
    ``denoise_strength``."""

    def tuner(args, problem, denoiser, tt, lr_decay=1.0, verbose=False,
              converge_check=True, diverge_check=True):
        kwargs = dict(zip(param_names, args))
        dstrength = kwargs.pop("dstrength", None)
        if dstrength is not None and hasattr(denoiser, "denoise_strength"):
            denoiser = dataclasses.replace(denoiser, sigma_modifier=float(dstrength))
        result = runner(
            problem=problem, denoiser=denoiser, tt=tt, lr_decay=lr_decay,
            verbose=verbose, converge_check=converge_check,
            diverge_check=diverge_check, **kwargs,
        )
        init_psnr = _round2(problem.psnr(problem.x_init)[0])
        final_psnr = _round2(problem.psnr(result["z"])[0])
        return {
            "loss": init_psnr - final_psnr,
            "status": "ok",
            **result,
        }

    return tuner


tune_pnp_gd = _make_tuner(pnp_gd, ("eta", "dstrength"))
tune_pnp_sgd = _make_tuner(pnp_sgd, ("eta", "mini_batch_size", "dstrength"))
tune_pnp_svrg = _make_tuner(pnp_svrg, ("eta", "mini_batch_size", "T2", "dstrength"))
tune_pnp_saga = _make_tuner(
    pnp_saga, ("eta", "mini_batch_size", "dstrength", "hist_size")
)
tune_pnp_sarah = _make_tuner(pnp_sarah, ("eta", "mini_batch_size", "T2", "dstrength"))
