"""The five PnP loops: GD, SGD, SVRG, SAGA and SARAH.

Port of ``pnp_svrg_tpu/algorithms/loops.py``. PyTorch runs eagerly, so each
``lax.scan`` becomes a Python loop over device tensors; nothing in a loop
reads a value back to the host. Problems carry a leading batch axis (B
lanes), and the state is (B, N).

Step skeleton (shared by the five loops):

    v     <- gradient estimate                  (the loop's own)
    z     <- z - eta * lr_decay**i * v
    sigma <- estimate_sigma(z)
    z     <- denoiser(z, sigma, t)
    log PSNR(z)

``i`` is the iteration for GD, SGD and SAGA and the outer round for SVRG and
SARAH. Every lane carries its own ``done`` latch (convergence
``|dPSNR| < 1e-5`` or divergence ``PSNR < 0`` when asked for), which freezes
its state, and its own step counter ``t``. ``eta`` may be a scalar or (B,).

The stochastic loops take their minibatches from a ``torch.Generator`` or,
for exact parity with another implementation, injected (``masks``, and for
SAGA also ``slots`` and ``mb0``): a minibatch has the problem's
``mb_shape(k)``: (B, H, W) 0/1 masks for CSMRI, (B, M) masks for Deblur,
(B, k) row indices for phase retrieval.

Every result holds ``z`` (B, N), ``image`` (B, H, W), ``psnr_per_iter``
(T, B) in the reference's layout, ``final_psnr``, the per-step
``psnr_before_denoise`` and ``sigma_est``, and the ``algo_name`` tag.
"""

from __future__ import annotations

from typing import Any

import torch

from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma

TOL = 1e-5  # reference convergence tolerance (pnp_gd.py:7)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device``; to CUDA through pinned memory without a
    host wait, so that a loop started under ``set_sync_debug_mode("error")``
    runs."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def step_schedule(eta, lr_decay: float, n: int, device) -> torch.Tensor:
    """The (n,) + eta.shape step sizes ``eta * lr_decay**i``, i = 0..n-1, as
    the JAX package rounds them: an f32 power of an f32 ``lr_decay`` at an
    f32 ``i``, times an f32 ``eta``. The power is taken on the CPU
    (``torch.pow`` there matches XLA's bit for bit; CUDA's need not) and
    moved to ``device`` once. An ``eta`` already on the card is multiplied
    there: one f32 product, correctly rounded on either device, and no copy
    of ``eta`` back to the host."""
    device = torch.device(device)
    powers = torch.pow(torch.tensor(lr_decay, dtype=torch.float32),
                       torch.arange(n, dtype=torch.float32))
    eta = torch.as_tensor(eta, dtype=torch.float32)
    powers = powers.reshape((n,) + (1,) * eta.dim())
    if eta.device.type == "cpu":
        return _to_device(eta * powers, device)
    return eta.to(device) * _to_device(powers, device)


def _denoise_step(problem, denoiser, z_flat, v, step_size, t):
    """Gradient update + sigma estimate + denoise; returns
    (z', psnr after, psnr before denoising, sigma estimate)."""
    z_flat = z_flat - step_size[..., None] * v.reshape(z_flat.shape)
    img = z_flat.reshape(-1, problem.h, problem.w)
    psnr_mid = problem.psnr(img)
    sig = estimate_sigma(img)
    img = denoiser.denoise(img, sig, t)
    return img.reshape(z_flat.shape), problem.psnr(img), psnr_mid, sig


def _check_done(done, start_psnr, psnr_after, converge_check, diverge_check):
    newly = torch.zeros_like(done)
    if converge_check:
        newly = newly | ((start_psnr - psnr_after).abs() < TOL)
    if diverge_check:
        newly = newly | (psnr_after < 0)
    return done | newly


class _Run:
    """The state and logs every loop shares: ``z``, the step counter ``t``,
    the ``done`` latch and the trace."""

    def __init__(self, problem, denoiser, eta, lr_decay, n_steps, checks):
        self.problem, self.denoiser, self.checks = problem, denoiser, checks
        b = problem.x_init.shape[0]
        dev = problem.device
        self.sched = step_schedule(eta, lr_decay, n_steps, dev).reshape(n_steps, -1).expand(n_steps, b)
        self.z = problem.x_init.reshape(b, -1)
        self.t = torch.zeros(b, dtype=torch.int32, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.trace = [problem.psnr(self.z)]
        self.mids, self.sigs = [], []

    def step(self, v, step):
        """One update of ``z`` with direction ``v``; logs it and returns the
        unlatched denoised iterate."""
        z = self.z
        start_psnr = self.problem.psnr(z)
        z_new, psnr_after, psnr_mid, sig = _denoise_step(
            self.problem, self.denoiser, z, v, step, self.t + 1)
        done_new = _check_done(self.done, start_psnr, psnr_after, *self.checks)
        self.z = torch.where(self.done[:, None], z, z_new)
        self.t = torch.where(self.done, self.t, self.t + 1)
        self.trace.append(torch.where(self.done, start_psnr, psnr_after))
        self.mids.append(psnr_mid)
        self.sigs.append(sig)
        self.done = done_new
        return z_new

    def result(self, name: str, log_shape: tuple) -> dict:
        b = self.z.shape[0]
        psnr_trace = torch.stack(self.trace)
        return {
            "z": self.z,
            "image": self.z.reshape(b, self.problem.h, self.problem.w),
            "psnr_per_iter": psnr_trace,
            "final_psnr": psnr_trace[-1],
            "psnr_before_denoise": torch.stack(self.mids).reshape(log_shape + (b,)),
            "sigma_est": torch.stack(self.sigs).reshape(log_shape + (b,)),
            "algo_name": name,
        }


def _check_masks(masks, generator, lead: tuple, problem, k: int, what: str = "masks"):
    if masks is not None:
        want = lead + tuple(problem.mb_shape(k))
        if tuple(masks.shape) != want:
            raise ValueError(f"{what} must be {want}, got {tuple(masks.shape)}")
    elif generator is None:
        raise ValueError(f"needs a generator or injected {what}")


def _minibatch(problem, masks, index, generator, k):
    return masks[index] if masks is not None else problem.select_mb(generator, k)


def pnp_gd(
    problem,
    denoiser,
    eta,
    n_iters: int,
    generator: torch.Generator | None = None,
    lr_decay: float = 1.0,
    converge_check: bool = False,
    diverge_check: bool = False,
) -> dict:
    """Full-gradient PnP descent (deterministic; ``generator`` is unused).
    ``psnr_per_iter`` is ``[init, n_iters entries]``."""
    del generator
    run = _Run(problem, denoiser, eta, lr_decay, n_iters, (converge_check, diverge_check))
    for i in range(n_iters):
        run.step(problem.grad_full(run.z), run.sched[i])
    return run.result("PnP GD", (n_iters,))


def pnp_sgd(
    problem,
    denoiser,
    eta,
    n_iters: int,
    mini_batch_size: int,
    generator: torch.Generator | None = None,
    lr_decay: float = 1.0,
    converge_check: bool = False,
    diverge_check: bool = False,
    masks: torch.Tensor | None = None,
) -> dict:
    """Minibatch stochastic PnP descent: ``v = g(z, mb) / b``. Injected
    ``masks`` have shape ``(n_iters,) + problem.mb_shape(mini_batch_size)``."""
    _check_masks(masks, generator, (n_iters,), problem, mini_batch_size)
    run = _Run(problem, denoiser, eta, lr_decay, n_iters, (converge_check, diverge_check))
    b = float(mini_batch_size)
    for i in range(n_iters):
        mb = _minibatch(problem, masks, i, generator, mini_batch_size)
        run.step(problem.grad_stoch(run.z, mb) / b, run.sched[i])
    return run.result("PnP SGD", (n_iters,))


def pnp_svrg(
    problem,
    denoiser,
    eta,
    n_outer: int,
    t2: int,
    mini_batch_size: int,
    generator: torch.Generator | None = None,
    lr_decay: float = 1.0,
    variant: str = "svrg",
    converge_check: bool = False,
    diverge_check: bool = False,
    masks: torch.Tensor | None = None,
) -> dict:
    """Stochastic variance-reduced PnP.

    ``variant="svrg"``: the published control variate
    ``v = (g(z, mb) - g(w, mb)) / b + mu``; ``"faithful"``: the reference
    code's ``v = mu``. Injected ``masks`` have shape
    ``(n_outer, t2) + problem.mb_shape(mini_batch_size)``.
    ``psnr_per_iter`` is ``[init, (snapshot, t2 inner) x n_outer]``;
    ``psnr_before_denoise`` and ``sigma_est`` are (n_outer, t2, B)."""
    if variant not in ("svrg", "faithful"):
        raise ValueError(f"unknown svrg variant {variant!r}")
    if variant == "svrg":
        _check_masks(masks, generator, (n_outer, t2), problem, mini_batch_size)
    run = _Run(problem, denoiser, eta, lr_decay, n_outer, (converge_check, diverge_check))
    mbs = float(mini_batch_size)
    for i in range(n_outer):
        z = run.z
        mu = problem.grad_full(z).reshape(z.shape)  # full-gradient snapshot
        w_snap = z
        run.trace.append(problem.psnr(z))
        for j in range(t2):
            if variant == "svrg":
                mb = _minibatch(problem, masks, (i, j), generator, mini_batch_size)
                g_z = problem.grad_stoch(run.z, mb).reshape(z.shape)
                g_w = problem.grad_stoch(w_snap, mb).reshape(z.shape)
                v = (g_z - g_w) / mbs + mu
            else:
                v = mu
            run.step(v, run.sched[i])
    return run.result("PnP SVRG", (n_outer, t2))


def pnp_saga(
    problem,
    denoiser,
    eta,
    n_iters: int,
    mini_batch_size: int,
    generator: torch.Generator | None = None,
    hist_size: int = 50,
    lr_decay: float = 1.0,
    converge_check: bool = False,
    diverge_check: bool = False,
    masks: torch.Tensor | None = None,
    slots: torch.Tensor | None = None,
    mb0: torch.Tensor | None = None,
    table_axis=None,
    table_shards: int = 1,
) -> dict:
    """Table-based approximate SAGA with a (hist_size, B, N) gradient history
    and uniformly random slot replacement; the table's sum is kept as a
    running sum: ``v = g - prev + sum / hist_size``.

    Injected minibatches: ``mb0`` (``problem.mb_shape(k)``, the one that fills
    the table), ``masks`` ``(n_iters,) + mb_shape(k)`` and ``slots``
    (n_iters,) int, one slot a step shared by every lane, as the JAX package
    draws it.

    ``table_axis`` / ``table_shards`` shard the table over an axis object of
    ``parallel/mesh.py`` (the meas axis of ``parallel/meas.py``, whose
    gradients are already replicated): each shard holds ``hist_size //
    table_shards`` slots, on a leading axis of its process's shards. The
    slot is drawn from the global range with the replicated generator (or
    injected); only its owner rewrites the row, and the evicted row reaches
    every shard through one psum of (row where mine, else 0), so the update
    sequence is the unsharded table's, bit for bit. The running sum stays
    replicated."""
    if hist_size % table_shards:
        raise ValueError(f"hist_size {hist_size} not divisible by {table_shards} table shards")
    if table_shards > 1 and table_axis is None:
        raise ValueError("table_shards > 1 requires a bound table_axis")
    if isinstance(table_axis, str):
        raise TypeError(f"table_axis must be an axis object (parallel/mesh.py), not the name "
                        f"{table_axis!r}; run_batch resolves a mesh axis's name")
    if table_axis is not None and table_axis.size != table_shards:
        raise ValueError(f"table_axis has {table_axis.size} shards, table_shards is {table_shards}")
    injected = (masks is not None, slots is not None, mb0 is not None)
    if any(injected) and not all(injected):
        raise ValueError("inject masks, slots and mb0 together")
    _check_masks(masks, generator, (n_iters,), problem, mini_batch_size)
    if mb0 is not None:
        _check_masks(mb0, None, (), problem, mini_batch_size, "mb0")
        if tuple(slots.shape) != (n_iters,):
            raise ValueError(f"slots must be ({n_iters},), got {tuple(slots.shape)}")
    run = _Run(problem, denoiser, eta, lr_decay, n_iters, (converge_check, diverge_check))
    dev = problem.device
    b = float(mini_batch_size)
    if mb0 is None:
        mb0 = problem.select_mb(generator, mini_batch_size)
        slots = torch.randint(0, hist_size, (n_iters,), generator=generator, device=dev)
    hist_local = hist_size // table_shards
    slots = slots.to(device=dev, dtype=torch.int64).reshape(n_iters, 1)
    local_slots, owners = slots % hist_local, slots // hist_local
    held = table_axis.shards if table_axis is not None else range(1)
    shard_ids = torch.arange(held.start, held.stop, device=dev)
    z = run.z
    g0 = problem.grad_stoch(z, mb0).reshape(z.shape) / b
    table = g0[None, None].repeat(len(shard_ids), hist_local, 1, 1)  # (shards here, slots, B, N)
    tsum = g0 * hist_size
    prev = g0
    for i in range(n_iters):
        mb = _minibatch(problem, masks, i, generator, mini_batch_size)
        g = problem.grad_stoch(run.z, mb).reshape(z.shape) / b
        mine = (owners[i] == shard_ids)[:, None, None]  # (shards here, 1, 1)
        row = table.index_select(1, local_slots[i])[:, 0]
        mine_rows = torch.where(mine, row, 0.0)
        old = table_axis.psum(mine_rows) if table_axis is not None else mine_rows[0]
        table_new = table.index_copy(1, local_slots[i], torch.where(mine, g, row)[:, None])
        tsum_new = tsum + g - old
        v = g - prev + tsum_new / hist_size
        done = run.done[:, None]  # the latch before this step
        run.step(v, run.sched[i])
        table = torch.where(done[None, None], table, table_new)
        tsum = torch.where(done, tsum, tsum_new)
        prev = torch.where(done, prev, g)
    return run.result("PnP SAGA", (n_iters,))


def pnp_sarah(
    problem,
    denoiser,
    eta,
    n_outer: int,
    t2: int,
    mini_batch_size: int,
    generator: torch.Generator | None = None,
    lr_decay: float = 1.0,
    variant: str = "sarah",
    converge_check: bool = False,
    diverge_check: bool = False,
    masks: torch.Tensor | None = None,
) -> dict:
    """Recursive variance-reduced PnP (SARAH).

    Each outer round takes one full-gradient "step-1" point with plain
    ``eta`` (no ``lr_decay``), then ``t2`` inner steps
    ``v = (g(anchor, mb) - g(w_prev, mb)) / b + v_prev``.
    ``variant="sarah"``: the canonical recursion, anchor = z, w_prev = the
    step's incoming z, starting from the step-1 point. ``"faithful"``: the
    reference code, which starts from the outer point and anchors every
    inner step at the frozen step-1 point, with w_prev = the denoised
    iterate. Injected ``masks`` have shape
    ``(n_outer, t2) + problem.mb_shape(mini_batch_size)``.
    ``psnr_per_iter`` is ``[init, (step-1, t2 inner) x n_outer]``."""
    if variant not in ("sarah", "faithful"):
        raise ValueError(f"unknown sarah variant {variant!r}")
    _check_masks(masks, generator, (n_outer, t2), problem, mini_batch_size)
    run = _Run(problem, denoiser, eta, lr_decay, n_outer, (converge_check, diverge_check))
    b = float(mini_batch_size)
    for i in range(n_outer):
        z = run.z
        w_prev = z
        v_prev = problem.grad_full(z).reshape(z.shape)
        # The step-1 point: one full-gradient step with plain eta (the
        # schedule's row 0, eta * 1), denoised; its PSNR is logged unlatched.
        w1, psnr1, _, _ = _denoise_step(problem, denoiser, z, v_prev, run.sched[0], run.t + 1)
        run.t = torch.where(run.done, run.t, run.t + 1)
        w1 = torch.where(run.done[:, None], z, w1)
        run.trace.append(psnr1)
        run.z, w_fix = (z, w1) if variant == "faithful" else (w1, w1)
        for j in range(t2):
            mb = _minibatch(problem, masks, (i, j), generator, mini_batch_size)
            z = run.z
            anchor = w_fix if variant == "faithful" else z
            v_next = (problem.grad_stoch(anchor, mb).reshape(z.shape)
                      - problem.grad_stoch(w_prev, mb).reshape(z.shape)) / b + v_prev
            done = run.done[:, None]  # the latch before this step
            z_new = run.step(v_next, run.sched[i])
            w_prev = torch.where(done, w_prev, z_new if variant == "faithful" else z)
            v_prev = torch.where(done, v_prev, v_next)
    return run.result("PnP SARAH", (n_outer, t2))


_ALGOS = {
    "gd": pnp_gd,
    "sgd": pnp_sgd,
    "svrg": pnp_svrg,
    "saga": pnp_saga,
    "sarah": pnp_sarah,
}


def run_pnp(algo: str, problem, denoiser, **kwargs) -> dict[str, Any]:
    """Dispatch to one of the five PnP loops by name."""
    try:
        fn = _ALGOS[algo]
    except KeyError:
        raise ValueError(f"unknown algorithm {algo!r}; have {sorted(_ALGOS)}")
    return fn(problem, denoiser, **kwargs)
