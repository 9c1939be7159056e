"""The operations one image-iteration needs: a reconstruction's gradients
(``counts/<problem>.py``, as many as ``reference/<algo>.py`` says) and
denoiser calls (``counts/<denoiser>.py``), over its trace entries."""

from __future__ import annotations

import importlib


def flops_per_iter(cfg: dict, traffic: dict) -> float:
    problem = importlib.import_module(f"portbench.counts.{cfg['problem']}")
    denoiser = importlib.import_module(f"portbench.counts.{cfg['denoiser']}")
    algo = importlib.import_module(f"portbench.reference.{traffic['algo']}")
    full, stoch = algo.gradients(traffic)
    per_recon = (full * problem.full_gradient_flops(cfg)
                 + stoch * problem.minibatch_gradient_flops(cfg, traffic)
                 + algo.denoises(traffic) * denoiser.denoise_flops(cfg))
    return per_recon / algo.entries(traffic)
