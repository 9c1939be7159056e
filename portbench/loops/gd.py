"""The program's PnP-GD on the traffic's schedule."""

from __future__ import annotations


def call(problem, denoiser, eta, traffic: dict, generator, warm_up: bool = False) -> dict:
    """A reconstruction; ``warm_up``: two steps, which run every shape a
    reconstruction runs."""
    from pnp_svrg_tpu_torch.algorithms.loops import pnp_gd

    return pnp_gd(problem, denoiser, eta, 2 if warm_up else traffic["n_iters"], generator=generator,
                  lr_decay=traffic["lr_decay"])
