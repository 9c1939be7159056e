"""The PnP loops (GD, SGD, SVRG, SAGA, SARAH), their dispatcher, and the
reference-shaped wall-clock API (``compat``) with its ``tune_pnp_*``
adapters."""

from pnp_svrg_tpu_torch.algorithms import compat
from pnp_svrg_tpu_torch.algorithms.compat import (
    tune_pnp_gd,
    tune_pnp_saga,
    tune_pnp_sarah,
    tune_pnp_sgd,
    tune_pnp_svrg,
)
from pnp_svrg_tpu_torch.algorithms.loops import (
    pnp_gd,
    pnp_saga,
    pnp_sarah,
    pnp_sgd,
    pnp_svrg,
    run_pnp,
    step_schedule,
    TOL,
)

__all__ = [
    "pnp_gd", "pnp_sgd", "pnp_svrg", "pnp_saga", "pnp_sarah", "run_pnp", "TOL", "step_schedule",
    "compat", "tune_pnp_gd", "tune_pnp_sgd", "tune_pnp_svrg", "tune_pnp_saga", "tune_pnp_sarah",
]
