"""The PnP loops (GD, SGD, SVRG, SAGA, SARAH) and their dispatcher."""

from pnp_svrg_tpu_torch.algorithms.loops import (
    pnp_gd,
    pnp_saga,
    pnp_sarah,
    pnp_sgd,
    pnp_svrg,
    run_pnp,
    step_schedule,
)

__all__ = ["pnp_gd", "pnp_sgd", "pnp_svrg", "pnp_saga", "pnp_sarah", "run_pnp", "step_schedule"]
