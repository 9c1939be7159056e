"""Problem helpers, batching and the gradient checks."""

from pnp_svrg_tpu_torch.core.checks import GradientCheckError, grad_full_check, grad_stoch_check
from pnp_svrg_tpu_torch.core.problem import minmax_normalize, sigma_to_snr, snr_to_sigma

__all__ = [
    "snr_to_sigma",
    "sigma_to_snr",
    "minmax_normalize",
    "grad_full_check",
    "grad_stoch_check",
    "GradientCheckError",
]
