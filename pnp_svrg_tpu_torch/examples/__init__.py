"""The scripts of the port, run as modules: the paper and demo drivers,

    python -m pnp_svrg_tpu_torch.examples.paper_csmri [--cpu] [--eta-scale auto|ref]
    python -m pnp_svrg_tpu_torch.examples.paper_deblur [--cpu] [--small]
    python -m pnp_svrg_tpu_torch.examples.paper_pr [--cpu] [--small] [--config auto|ref]
    python -m pnp_svrg_tpu_torch.examples.pnp_csmri_demo [--cpu] [--small]
    python -m pnp_svrg_tpu_torch.examples.rgb_csmri [--cpu] [--size N] [--algo A]

and the tuning, training and scaling scripts:

    python -m pnp_svrg_tpu_torch.examples.sweep_sampratio [--cpu] ...
    python -m pnp_svrg_tpu_torch.examples.sweep_snr
    python -m pnp_svrg_tpu_torch.examples.tune_set12
    python -m pnp_svrg_tpu_torch.examples.tune_csmri_nlm
    python -m pnp_svrg_tpu_torch.examples.tune_deblur
    python -m pnp_svrg_tpu_torch.examples.tune_pr
    python -m pnp_svrg_tpu_torch.examples.train_realsn --exp DIR [--cpu] ...
    python -m pnp_svrg_tpu_torch.examples.scaling [--world-size N] [--cpu] ...

Each is a port of the JAX script of the same name under ``examples/``, with
its arguments and output format; ``--cpu`` runs it on the CPU (the kernels'
plain versions), else it runs on the CUDA card. By default the drivers'
figures and metrics CSVs go under ``build/figures/`` and the tuners'
outputs under ``build/tuning/``, at the repository root (``build/`` is not
committed), never into ``figures/`` or over the committed tuned files
under ``data/`` or ``hyperparam-tuning/``; the training script writes
its ``--exp`` directory and, with ``--export``,
``checkpoints/<EXPORT>.npz`` as the JAX script does.
"""

from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "tuning"
FIGURES_DIR = OUT_DIR.parent / "figures"


def per_decay(chunk, evaluate) -> list:
    """Scores of a chunk of (eta, lr_decay, sigma_modifier) configurations,
    in chunk order, from one ``evaluate(sub_chunk)`` run per lr_decay: the
    port's loops take one scalar lr_decay a run (the JAX loops take one a
    lane)."""
    scores = [None] * len(chunk)
    for dec in dict.fromkeys(c[1] for c in chunk):
        idx = [j for j, c in enumerate(chunk) if c[1] == dec]
        for j, s in zip(idx, evaluate([chunk[j] for j in idx])):
            scores[j] = float(s)
    return scores
