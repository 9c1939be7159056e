"""Hyperparameter tuning: TPE search and sweep orchestration.

Port of ``pnp_svrg_tpu/tuning``: a self-contained tree-structured Parzen
estimator with a hyperopt-like ``fmin`` API (the reference's hyperopt,
``script_diff_sampratio_set12.py:122-129``), and the Set12 sweep grids as
batched ``run_pnp`` runs instead of ``multiprocessing.Pool`` fan-outs.
"""

from pnp_svrg_tpu_torch.tuning.tpe import (
    fmin,
    Uniform,
    LogUniform,
    QUniform,
    Choice,
    Trials,
)
from pnp_svrg_tpu_torch.tuning.sweep import (
    sweep_grid,
    SweepCell,
    make_batched_cell_objective,
)

__all__ = [
    "fmin",
    "Uniform",
    "LogUniform",
    "QUniform",
    "Choice",
    "Trials",
    "sweep_grid",
    "make_batched_cell_objective",
    "SweepCell",
]
