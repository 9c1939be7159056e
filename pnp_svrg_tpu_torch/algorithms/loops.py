"""PnP-SVRG reconstruction loop.

Port of ``pnp_svrg`` from ``pnp_svrg_tpu/algorithms/loops.py``. PyTorch runs
eagerly, so the two ``lax.scan`` levels become two Python loops over device
tensors; nothing in them reads a value back to the host.

Step skeleton (reference ``pnp_svrg.py``):

    v     <- gradient estimate
    z     <- z - eta * lr_decay**i * v      (i: the OUTER index)
    sigma <- estimate_sigma(z)
    z     <- denoiser(z, sigma, t)
    log PSNR(z)

Every lane carries its own ``done`` latch (convergence ``|dPSNR| < 1e-5`` or
divergence ``PSNR < 0`` when asked for), which freezes its state, and its own
step counter ``t``. ``eta`` may be a scalar or (B,).
"""

from __future__ import annotations

import torch

from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma

TOL = 1e-5  # reference convergence tolerance (pnp_gd.py:7)


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
    """Stochastic variance-reduced PnP over a batched problem.

    ``variant="svrg"``: the published control variate
    ``v = (g(z, mb) - g(w, mb)) / b + mu``; ``"faithful"``: the reference
    code's ``v = mu``. Minibatches come from ``generator`` (on the
    problem's device) or, for exact parity with another implementation, from
    ``masks`` shaped ``(n_outer, t2) + problem.mb_shape(mini_batch_size)``:
    (B, H, W) 0/1 masks for CSMRI, (B, M) masks for Deblur, (B, k) row
    indices for phase retrieval.

    Returns ``image`` (B, H, W), ``z`` (B, N), ``psnr_per_iter`` with the
    reference layout ``[init, (snapshot, t2 inner) x n_outer]`` (shape
    (1 + n_outer*(t2+1), B)), ``final_psnr``, and the per-step
    ``psnr_before_denoise`` and ``sigma_est`` (n_outer, t2, B).
    """
    if variant not in ("svrg", "faithful"):
        raise ValueError(f"unknown svrg variant {variant!r}")
    b, h, w = problem.x_init.shape
    if variant == "svrg":
        if masks is not None:
            want = (n_outer, t2) + tuple(problem.mb_shape(mini_batch_size))
            if tuple(masks.shape) != want:
                raise ValueError(f"masks must be {want}, got {tuple(masks.shape)}")
        elif generator is None:
            raise ValueError("variant='svrg' needs a generator or masks")
    dev = problem.device
    eta = torch.as_tensor(eta, dtype=torch.float32, device=dev).expand(b)
    mbs = float(mini_batch_size)

    z = problem.x_init.reshape(b, -1)
    t = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    trace = [problem.psnr(z)]
    mids, sigs = [], []
    for i in range(n_outer):
        mu = problem.grad_full(z).reshape(z.shape)  # full-gradient snapshot
        w_snap = z
        trace.append(problem.psnr(z))
        step = eta * lr_decay ** float(i)
        for j in range(t2):
            start_psnr = problem.psnr(z)
            if variant == "svrg":
                mb = masks[i, j] if masks is not None else problem.select_mb(generator, mini_batch_size)
                g_z = problem.grad_stoch(z, mb).reshape(z.shape)
                g_w = problem.grad_stoch(w_snap, mb).reshape(z.shape)
                v = (g_z - g_w) / mbs + mu
            else:
                v = mu
            z_new, psnr_after, psnr_mid, sig = _denoise_step(
                problem, denoiser, z, v, step, t + 1
            )
            done_new = _check_done(done, start_psnr, psnr_after, converge_check, diverge_check)
            z = torch.where(done[:, None], z, z_new)
            t = torch.where(done, t, t + 1)
            trace.append(torch.where(done, start_psnr, psnr_after))
            mids.append(psnr_mid)
            sigs.append(sig)
            done = done_new
    psnr_trace = torch.stack(trace)
    return {
        "z": z,
        "image": z.reshape(b, h, w),
        "psnr_per_iter": psnr_trace,
        "final_psnr": psnr_trace[-1],
        "psnr_before_denoise": torch.stack(mids).reshape(n_outer, t2, b),
        "sigma_est": torch.stack(sigs).reshape(n_outer, t2, b),
    }
