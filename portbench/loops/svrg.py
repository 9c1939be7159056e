"""The program's PnP-SVRG on the traffic's schedule, minibatches drawn by
the program's own sampler (``problem.select_mb``)."""

from __future__ import annotations


def call(problem, denoiser, eta, traffic: dict, generator, warm_up: bool = False) -> dict:
    """A reconstruction; ``warm_up``: one outer round, which runs every shape
    a reconstruction runs."""
    from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg

    return pnp_svrg(problem, denoiser, eta, 1 if warm_up else traffic["n_outer"], traffic["t2"],
                    traffic["mini_batch_size"], generator=generator, lr_decay=traffic["lr_decay"], variant="svrg")
